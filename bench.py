"""Benchmark: dataset-20-scale SLAM end-to-end on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "stages": {per-stage seconds}, "util": {per-stage utilization rows}}
(the stages/util keys are omitted under BENCH_STAGES=0)

Baseline (BASELINE.md, measured on the reference's own NumPy code, 1 CPU
core, dataset-20 shapes: 4,956 steps x 1,081 rays):
  scan matching 4,955 pairs   ~77 s
  OGM build 4,956 scans       ~287 s
  loop-closure ICPs (~494)    ~8 s
  -> ~372 s for the compute the reference spends nearly all its time in.

This benchmark runs the SAME work (batched ICP scan matching + loop
closures + pose-graph LM + log-odds map build) on synthetic data with
dataset-20 shapes, on device, and reports wall-clock with compile excluded.
vs_baseline = baseline_seconds / our_seconds (speedup factor). The JSON
names the device it ran on; without a GPU the script exits non-zero.
"""

import json
import os
import sys
import time


BASELINE_SECONDS = 372.0
# reference texture stage, measured via tools/texture_reference_bench.py
# (2026-08-19, 64 fabricated 480x640 frames through the reference's actual
# generate_texture_map: 126.6 ms/frame x 2,407 dataset-20 RGB frames)
TEXTURE_BASELINE_S = 304.6
# reference --filter_lidar stage, tools/filter_reference_bench.py
# (4.7 ms/scan x 4,956 scans)
FILTER_BASELINE_S = 23.1
N_STEPS = 4956
N_RAYS = 1081
N_RGB_FRAMES = 2407  # dataset-20 Kinect rgb track length


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main():
    import jax
    import numpy as np
    import jax.numpy as jnp

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from lidar_slam.config import SlamConfig
    from lidar_slam.models import occupancy, odometry, pose_graph, scan_matching
    from lidar_slam.models.slam import compute_loop_closures, loop_closure_candidates
    from lidar_slam.ops import icp as icp_ops
    from lidar_slam.ops import scan as scan_ops
    from lidar_slam.utils import io

    from lidar_slam.utils.runtime import (gpu_name_and_power_limit,
                                          report_devices, use_compile_cache)
    use_compile_cache()
    devs = report_devices()
    if devs[0].platform != "gpu":
        log(f"bench.py measures the GPU; JAX found {devs[0].platform}")
        sys.exit(2)
    card = gpu_name_and_power_limit()
    log(f"card: {card}")
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs), "nvidia_smi": card}

    log("generating dataset-20-shaped synthetic data (2 seeds)...")
    cfg = SlamConfig()
    cand = loop_closure_candidates(N_STEPS, 10)
    chunk = 64

    def prep(seed):
        data = io.synthetic_dataset(n_steps=N_STEPS, n_rays=N_RAYS, seed=seed)
        counts = jnp.asarray(data["encoder"]["counts"], jnp.float32)
        gyro = jnp.asarray(data["imu"]["angular_velocity"], jnp.float32)
        ranges = jnp.asarray(data["lidar"]["ranges"], jnp.float32)
        points, masks = scan_ops.scans_to_points(ranges, 0.1, 30.0, cfg.lidar)
        return counts, gyro, points, masks, icp_ops.lift_to_3d(points)

    # warm-up and timed runs use DIFFERENT data (same shapes): compiled code
    # is reused, and no result can be reused. The headline is the BEST of
    # the timed reps (each a full fresh-data run).
    warm = prep(20)
    timed_runs = [prep(21), prep(23), prep(24)]
    # data-adaptive slot count, shared so all runs compile identically —
    # ALWAYS including the stage-timing seeds (22, 25): a stage seed
    # needing more in-bounds cells than the e2e seeds would otherwise be
    # silently tail-truncated, biasing the stage/util rows vs the e2e
    # workload — and K must not depend on BENCH_STAGES, or the headline
    # would compile a different map build under different env settings.
    # The prepped stage tuples are kept and reused by the stage loop.
    stage_runs = {s: prep(s) for s in (22, 25)}
    K = max(occupancy.adaptive_ray_cells(w[2], w[3], cfg.map, 30.0)
            for w in [warm] + timed_runs + list(stage_runs.values()))
    log(f"adaptive ray slots K = {K}")

    def pipeline(inputs):
        counts, gyro, points, masks, pts3 = inputs
        poses_odom = odometry.poses_from_odometry(counts, gyro)
        sm = scan_matching.poses_from_scan_matching(
            poses_odom, points, masks, cfg.icp, chunk_size=chunk)
        max_d, max_y = odometry.max_step_gates(counts, gyro)
        loop_T, accept, _, _ = compute_loop_closures(
            pts3, masks, cand, 10, max_d, max_y, chunk_size=chunk)
        opt = pose_graph.optimize_trajectory(
            sm.poses, sm.relative_poses, jnp.asarray(cand),
            jnp.asarray(cand + 10), loop_T, accept, cfg.pose_graph)
        grid = occupancy.build_logodds(opt.poses, points, masks, cfg.map, K)
        return opt.poses, grid, sm, accept

    filter_s = None
    # warm-up: compiles every kernel at the real shapes
    log("warm-up (compiling)...")
    t0 = time.time()
    poses, grid, sm, accept = pipeline(warm)
    jax.block_until_ready((poses, grid))
    log(f"warm-up done in {time.time() - t0:.1f}s "
        f"(icp iters mean {float(jnp.mean(sm.iters)):.1f}, "
        f"loops accepted {int(jnp.sum(accept))})")

    # optional-path timing: DBSCAN + statistical filters at full scale
    # (the reference baseline excludes them too). Warm-up, then best of 2
    # on distinct inputs.
    from lidar_slam.ops import filters

    def filter_pass(pts, mks):
        fm = filters.dbscan_filter_scans(pts, mks)
        fm = filters.statistical_filter_scans(pts, fm)
        return fm

    filter_pass(warm[2], warm[3]).block_until_ready()  # compile + warm
    kept = None
    for fr in range(2):
        pts_f, mks_f = timed_runs[fr][2], timed_runs[fr][3]
        jax.block_until_ready((pts_f, mks_f))
        t0 = time.time()
        fm = filter_pass(pts_f, mks_f).block_until_ready()
        leg = time.time() - t0
        if filter_s is None or leg < filter_s:
            filter_s, kept = leg, float(jnp.mean(fm))
    log(f"filter path (DBSCAN+statistical, {N_STEPS}x{N_RAYS}): "
        f"{filter_s:.3f}s (kept {kept:.3f} of rays)")

    log("timed runs (fresh data each)...")
    reps = []
    for timed in timed_runs:
        t0 = time.time()
        poses, grid, sm, accept = pipeline(timed)
        jax.block_until_ready((poses, grid))
        reps.append(time.time() - t0)
    elapsed = min(reps)
    log(f"timed reps: {[f'{r:.3f}' for r in reps]} -> best {elapsed:.3f}s")

    stages = {}
    util = {}
    if os.environ.get("BENCH_STAGES") != "0":
        # per-stage wall clock on further fresh seeds (the runtime memoizes
        # value-identical computations, so stage timing needs fresh values);
        # the sync after every stage makes the sum slightly exceed e2e.
        # TWO passes, keep the second: the first execution of each stage
        # in a process pays a one-time executable-load cost.
        for stage_seed in (22, 25):
            counts, gyro, points, masks, pts3 = stage_runs[stage_seed]
            # drain the prep queue so the first stage timer doesn't absorb it
            jax.block_until_ready((counts, gyro, points, masks, pts3))
            t = time.time()
            poses_odom = odometry.poses_from_odometry(counts, gyro)
            poses_odom.block_until_ready()
            stages["odometry_s"] = round(time.time() - t, 3)
            t = time.time()
            sm3 = scan_matching.poses_from_scan_matching(
                poses_odom, points, masks, cfg.icp, chunk_size=chunk)
            sm3.poses.block_until_ready()
            stages["scan_matching_s"] = round(time.time() - t, 3)
            t = time.time()
            max_d, max_y = odometry.max_step_gates(counts, gyro)
            loop_T, accept3, loop_err, loop_it = compute_loop_closures(
                pts3, masks, cand, 10, max_d, max_y, chunk_size=chunk)
            loop_T.block_until_ready()
            stages["loop_closures_s"] = round(time.time() - t, 3)
            t = time.time()
            opt = pose_graph.optimize_trajectory(
                sm3.poses, sm3.relative_poses, jnp.asarray(cand),
                jnp.asarray(cand + 10), loop_T, accept3, cfg.pose_graph)
            opt.poses.block_until_ready()
            stages["pose_graph_s"] = round(time.time() - t, 3)
            t = time.time()
            grid3 = occupancy.build_logodds(opt.poses, points, masks,
                                            cfg.map, K)
            grid3.block_until_ready()
            stages["map_build_s"] = round(time.time() - t, 3)
        log(f"scan-matching iters: mean {float(jnp.mean(sm3.iters)):.1f} "
            f"p50 {float(jnp.percentile(sm3.iters, 50)):.0f} "
            f"p90 {float(jnp.percentile(sm3.iters, 90)):.0f} "
            f"max {int(jnp.max(sm3.iters))}")
        for k, v in stages.items():
            log(f"stage {k}: {v:.3f}s")

        # scan matching: executed chunk-iterations under the phased-resort
        # schedule = sum over depths t of ceil(live_t / chunk), and the
        # stage time per executed chunk-iteration
        iters = np.asarray(sm3.iters)
        executed = int(sum(int(np.ceil((iters > t).sum() / chunk))
                           for t in range(int(iters.max()))))
        util["sm_chunk_iters_executed"] = executed
        util["sm_ms_per_chunk_iter"] = round(
            stages["scan_matching_s"] * 1e3 / max(executed, 1), 3)

        # pose graph: whole-solve wall clock and LM iterations
        util["lm_solve_ms"] = round(stages["pose_graph_s"] * 1e3, 1)
        util["lm_iterations"] = int(opt.iterations)

    # ---- texture stage: the reference's hot loop #4 at the FULL
    # dataset-20 frame count (2,407 x 480x640). Frames are synthesized per
    # batch by the loader (values vary per batch; bytes and shapes match
    # the real sensor stream). Decode is excluded here (tools/texture_bench.py).
    # Each engine is timed once: the raw-bytes device engine and, when the
    # native library builds, the host paint-op projector.
    texture_s = None
    if os.environ.get("BENCH_TEXTURE") != "0":
        from lidar_slam.models import texture as texture_mod
        from lidar_slam.utils import native as native_mod

        H, W = 480, 640
        base_rng = np.random.default_rng(30)
        base_disp = base_rng.integers(300, 800, (16, H, W)).astype(np.uint16)
        base_rgb = base_rng.integers(0, 255, (16, H, W, 3)).astype(np.uint8)
        disp_buf = np.empty_like(base_disp)

        def tex_loader(ids):
            # cheap per-batch value variation (the +offset stays within the
            # valid disparity range), written into one reused buffer: every
            # consumer copies or consumes the frames inside the same call
            b = len(ids)
            off = np.uint16(int(ids[0]) % 97)
            np.add(base_disp[:b], off, out=disp_buf[:b])
            return disp_buf[:b], base_rgb[:b]

        tex_grid = np.zeros((cfg.map.width, cfg.map.height), np.uint8)
        tex_poses = np.asarray(base_rng.normal(0, 5.0, (N_RGB_FRAMES, 3)),
                               np.float32)
        frame_ids = np.arange(N_RGB_FRAMES)
        projectors = ["device"] + (["native"] if native_mod.available()
                                   else [])
        for proj in projectors:
            texture_mod.generate_texture_map(  # warm-up (compiling)
                tex_poses[:23], np.arange(23), np.arange(23), tex_grid,
                tex_loader, cfg.map, cfg.camera, batch_size=16,
                projector=proj)
            t0 = time.time()
            texture_mod.generate_texture_map(
                tex_poses, frame_ids, frame_ids, tex_grid, tex_loader,
                cfg.map, cfg.camera, batch_size=16, projector=proj)
            leg = time.time() - t0
            util[f"texture_{proj}_ms_per_frame"] = round(
                leg * 1e3 / N_RGB_FRAMES, 3)
            log(f"texture stage ({proj} projector, {N_RGB_FRAMES} frames): "
                f"{leg:.3f}s")
            texture_s = leg if texture_s is None else min(texture_s, leg)
        stages["texture_s"] = round(texture_s, 3)

    pairs_per_s = (N_STEPS - 1) / elapsed  # headline convenience numbers
    log(f"e2e {elapsed:.2f}s | {pairs_per_s:.0f} scan-pairs/s equivalent | "
        f"speedup vs reference CPU {BASELINE_SECONDS / elapsed:.1f}x")
    if util:
        log(f"utilization: {util}")

    out = {
        "metric": "dataset20_slam_e2e_seconds",
        "value": round(elapsed, 3),
        "unit": "s",
        "vs_baseline": round(BASELINE_SECONDS / elapsed, 2),
        "device": device,
    }
    if stages:
        out["stages"] = stages
        out["util"] = util
    # SUPERSET: the reference's full `--mode gtsam --filter_lidar
    # --generate_texture_map` run (SURVEY.md section 3.1) — core pipeline +
    # scan filters + texture, each side measured at dataset-20 scale
    # (reference rows: BASELINE.md; tools/*_reference_bench.py)
    if texture_s is not None:
        sup = elapsed + filter_s + texture_s
        sup_base = BASELINE_SECONDS + FILTER_BASELINE_S + TEXTURE_BASELINE_S
        out["superset"] = {
            "metric": "dataset20_full_gtsam_filter_texture_seconds",
            "value": round(sup, 3),
            "baseline_s": round(sup_base, 1),
            "vs_baseline": round(sup_base / sup, 2),
            "composition_s": {"core": round(elapsed, 3),
                              "filter": round(filter_s, 3),
                              "texture": round(texture_s, 3)},
        }
        log(f"superset (core+filter+texture): {sup:.3f}s vs reference "
            f"{sup_base:.0f}s = {sup_base / sup:.1f}x")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
