"""Smoke test of the SLAM pipeline on NVIDIA GPUs, checked against the CPU.

    python chip_smoke.py                  # one GPU: phases 0, 1 and 2
    python chip_smoke.py --four           # four GPUs: phases 0 and 3 only
    python chip_smoke.py --ate-reference  # the CPU ATE that phase 1's bound
                                          # comes from (run once, on the host)

Phase 0 refuses anything but a GPU and prints the card. Phase 1 runs
`main.py --mode gtsam --filter_lidar` through main.main on a dataset-20-shaped
synthetic log (4,956 scans x 1,081 rays, 1201 x 1201 grid at 0.05 m,
interval-10 loop closures), then times each stage of models/slam.run_slam on
a fresh seed and bounds the trajectory's ATE. Phase 2 runs each stage at real
widths on the GPU and, in this same process, on JAX's CPU backend with the
same inputs, and prints each observed error beside its tolerance. Phase 3
(--four) runs the sharded paths on four GPUs against one GPU.

Every failed check is reported; any failure exits non-zero without the last
line. The last line of stdout is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np

N_SCANS = 4956          # dataset 20 (reference outputs/poses_odom_20.npy)
FIXED_INTERVAL = 10     # main.py --fixed_interval default
SEED = 0                # main.py --synthetic's seed
# ATE RMSE (m) of phase 1's optimised trajectory against ground truth, as
# `--ate-reference` measured it on the CPU backend for the same seed (PERF.md).
# The GPU's stages agree with the CPU's to ~1e-5 (phase 2), so the bound
# allows 5% or 1 cm over the CPU value, whichever is larger.
ATE_CPU_M = 5.051879247504136
ATE_BOUND_M = max(1.05 * ATE_CPU_M, ATE_CPU_M + 0.01)

# ---- phase 2 tolerances, each with its reason --------------------------
# NN: the argmin runs on float32 |t|^2 - 2 s.t; its rounding error grows
# with the squared range, so a chosen neighbour may be worse than the exact
# (float64 KDTree) one by 1e-6 m^2 plus 8 float32 ulps of |s|^2 + max|t|^2.
NN_ABS_M2 = 1e-6
NN_ULPS = 8
# ICP in float64 on both backends: reductions in another order move the
# iterates by ~1e-15, so transforms agree to 1e-5 and a stopping test
# |de| < thresh may flip on rounding in at most 1% of pairs.
ICP_T_TOL = 1e-5
ICP_ITERS_AGREE = 0.99
# ICP in float32 (the pipeline's dtype): the same reordering moves the
# iterates by ~1e-7, enough to flip a near-tie correspondence; one flipped
# match of ~1,000 moves T by ~(ray spacing)/1000 ~ 4e-5, and a pair sees a
# few, so transforms are held to 1e-3.
ICP_T_TOL_F32 = 1e-3
# Map: the GPU's scatter-add runs on atomics in an order that changes from
# run to run, so float32 sums may differ in their last bits (|diff| ~1e-6
# at |log-odds| <= 20); the uint8 map may then differ only where the
# log-odds is zero up to that rounding.
MAP_TOL = 1e-4
# Pose graph in float64 on both backends. The pipeline's float32 solve of
# the 4,956-pose chain is itself ~1e-3 away from the float64 optimum
# (rounding amplified by the chain's conditioning), so the GPU's float32
# solve is held to twice the CPU's float32 distance from it, plus 1e-4.
PG_TOL = 1e-4
# Online: 200 float32 steps; each step's ICP can flip a near-tie
# correspondence (~1e-4, as for ICP_T_TOL_F32) and the track composes them.
ONLINE_TOL = 2e-3
# Texture: the device engine runs the unproject chain in float32, the
# native projector in float64 (and the GPU may contract multiply-adds the
# CPU does not), so a pixel within rounding of a cell boundary can land in
# the neighbouring cell; at most 1e-3 of the painted cells may differ.
TEXTURE_CELLS = 1e-3


def log(msg):
    print(msg, flush=True)


class Checks:
    """Prints every check with its observed value and tolerance; remembers
    the failures."""

    def __init__(self):
        self.failed = []

    def check(self, name, ok, detail):
        log(f"[{'ok' if ok else 'FAIL'}] {name}: {detail}")
        if not ok:
            self.failed.append(name)

    def within(self, name, observed, tol):
        self.check(name, bool(observed <= tol),
                   f"observed {observed:.3e}, tolerance {tol:.1e}")


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Problem sizes; the defaults are the real widths the card is held to."""
    scans: int = N_SCANS
    pairs: int = 64          # one ICP chunk (scan_matching chunk_size)
    map_scans: int = 256
    filter_scans: int = 256
    frames: int = 256        # 480 x 640 RGB-D frames
    online_steps: int = 200


@contextlib.contextmanager
def default_device(dev):
    """Make `dev` the default device for every thread (the texture engine
    uploads from a prefetch thread, which a thread-local context misses)."""
    import jax

    prev = jax.config.jax_default_device
    jax.config.update("jax_default_device", dev)
    try:
        yield
    finally:
        jax.config.update("jax_default_device", prev)


def run_on(dev, fn, *args, **kw):
    """fn(*args, **kw) with the array arguments placed on `dev`; returns
    the result fetched to the host."""
    import jax

    with default_device(dev):
        args = [jax.device_put(a, dev) if isinstance(a, np.ndarray) else a
                for a in args]
        return jax.device_get(fn(*args, **kw))


def as_f64(args):
    """The float32 arrays among `args` in float64 (run under enable_x64)."""
    return tuple(a.astype(np.float64) if getattr(a, "dtype", None)
                 == np.float32 else a for a in args)


def load_log(seed, n_scans, cpu):
    """Synthetic dataset-20-shaped log: host arrays of the scans in the
    pipeline's fixed-shape layout."""
    from lidar_slam.config import SlamConfig
    from lidar_slam.ops import scan as scan_ops
    from lidar_slam.utils import io

    cfg = SlamConfig()
    data = io.synthetic_dataset(n_steps=n_scans, seed=seed)
    ranges = np.asarray(data["lidar"]["ranges"], np.float32)
    points, masks = run_on(cpu, scan_ops.scans_to_points, ranges, 0.1, 30.0,
                           cfg.lidar)
    return dict(data=data, cfg=cfg, ranges=ranges, points=points,
                masks=masks,
                pts3=np.concatenate([points, np.zeros_like(points[..., :1])],
                                    -1),
                counts=np.asarray(data["encoder"]["counts"], np.float32),
                gyro=np.asarray(data["imu"]["angular_velocity"], np.float32),
                gt=np.asarray(data["ground_truth"]))


# ---------------------------------------------------------------- phase 0
def phase_device(n_cards):
    """Return the GPUs, or None (with the reason printed) if JAX runs on
    something else: JAX falls back to the CPU silently when its CUDA plugin
    fails, so the platform is checked explicitly."""
    import jax

    from lidar_slam.utils import native
    from lidar_slam.utils.runtime import (gpu_name_and_power_limit,
                                          report_devices, use_compile_cache)

    use_compile_cache()
    devs = report_devices(sys.stdout)
    if devs[0].platform != "gpu":
        print(f"chip_smoke: JAX runs on {devs[0].platform}, not a GPU",
              file=sys.stderr)
        return None
    if len(devs) < n_cards:
        print(f"chip_smoke: needs {n_cards} GPUs, JAX sees {len(devs)}",
              file=sys.stderr)
        return None
    import jaxlib

    log("card (nvidia-smi name, power limit):")
    log(gpu_name_and_power_limit())  # as nvidia-smi prints it
    log(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}")
    log("native/libslamio.so: "
        + ("built" if native.available() else
           "not built (texture runs the device projector only)"))
    return devs


# ---------------------------------------------------------------- phase 1
def staged_run(log_, chunk=64):
    """models/slam.run_slam's gtsam + filter path stage by stage, each
    stage fenced with block_until_ready and timed; returns the times and
    the intermediates phase 2 reuses."""
    import jax
    import jax.numpy as jnp

    from lidar_slam.models import occupancy, odometry, pose_graph
    from lidar_slam.models import scan_matching
    from lidar_slam.models.slam import (compute_loop_closures,
                                        loop_closure_candidates)
    from lidar_slam.ops import filters, icp as icp_ops

    cfg = log_["cfg"]
    times = {}

    def stage(name, fn):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        times[name] = time.perf_counter() - t0
        return out

    points = jnp.asarray(log_["points"])
    masks = jnp.asarray(log_["masks"])
    counts, gyro = jnp.asarray(log_["counts"]), jnp.asarray(log_["gyro"])
    jax.block_until_ready((points, masks, counts, gyro))
    masks = stage("filter", lambda: filters.statistical_filter_scans(
        points, filters.dbscan_filter_scans(
            points, masks, eps=cfg.filter.dbscan_eps,
            min_samples=cfg.filter.dbscan_min_samples),
        k_std=cfg.filter.statistical_k_std))
    poses_odom = stage("odometry", lambda: odometry.poses_from_odometry(
        counts, gyro, dt=cfg.robot.dt))
    sm = stage("scan_matching", lambda: scan_matching.poses_from_scan_matching(
        poses_odom, points, masks, cfg.icp, chunk_size=chunk))
    max_d, max_y = odometry.max_step_gates(counts, gyro, cfg.robot.dt)
    cand = loop_closure_candidates(int(points.shape[0]), FIXED_INTERVAL)
    pts3 = icp_ops.lift_to_3d(points)
    loop_T, accept, _, _ = stage("loop_closures", lambda: compute_loop_closures(
        pts3, masks, cand, FIXED_INTERVAL, float(max_d), float(max_y),
        chunk_size=chunk))
    pg_cfg = dataclasses.replace(cfg.pose_graph, fixed_interval=FIXED_INTERVAL)
    opt = stage("pose_graph", lambda: pose_graph.optimize_trajectory(
        sm.poses, sm.relative_poses, jnp.asarray(cand),
        jnp.asarray(cand + FIXED_INTERVAL), loop_T, accept, pg_cfg))
    K = occupancy.adaptive_ray_cells(points, masks, cfg.map, 30.0)
    stage("map_build", lambda: occupancy.build_logodds(
        opt.poses, points, masks, cfg.map, K))
    pg_inputs = tuple(np.asarray(a) for a in (
        sm.poses, sm.relative_poses, cand, cand + FIXED_INTERVAL, loop_T,
        accept))
    return times, dict(sm_iters=np.asarray(sm.iters), pg_inputs=pg_inputs,
                       pg_cfg=pg_cfg)


def phase_main(checks, sizes, cpu, workdir):
    import main as cli
    from lidar_slam.models import slam
    from lidar_slam.utils import metrics

    log(f"== phase 1: main.py --mode gtsam --filter_lidar --synthetic "
        f"{sizes.scans}")
    t0 = time.perf_counter()
    cli.main(["--mode", "gtsam", "--filter_lidar", "--synthetic",
              str(sizes.scans), "--save_logodds",
              os.path.join(workdir, "map.npy"), "--output_dir", workdir])
    log(f"main.main: {time.perf_counter() - t0:.3f} s (compilation included)")
    poses = np.load(os.path.join(workdir, "poses_optimized_20.npy"))
    logodds = np.load(os.path.join(workdir, "map.npy"))
    checks.check("main: optimised poses finite, (N, 3)",
                 poses.shape == (sizes.scans, 3)
                 and bool(np.isfinite(poses).all()), f"shape {poses.shape}")
    checks.check("main: log-odds map finite, 1201 x 1201",
                 logodds.shape == (1201, 1201)
                 and bool(np.isfinite(logodds).all()),
                 f"shape {logodds.shape}, "
                 f"{int((logodds != 0).sum())} cells observed")
    log_ = load_log(SEED, sizes.scans, cpu)
    ate = metrics.ate_translation(poses, log_["gt"][:len(poses)])
    if sizes.scans == N_SCANS:
        checks.within("main: ATE RMSE (m) vs ground truth", ate["rmse"],
                      ATE_BOUND_M)
    else:
        log(f"main: ATE RMSE {ate['rmse']:.6f} m (no bound at this size)")

    # warm: the same shapes on a fresh seed, end to end and stage by stage
    fresh = load_log(SEED + 1, sizes.scans, cpu)
    t0 = time.perf_counter()
    res = slam.run_slam(fresh["counts"], fresh["gyro"], fresh["ranges"], 0.1,
                        30.0, mode="gtsam", filter_lidar=True,
                        fixed_interval=FIXED_INTERVAL, cfg=fresh["cfg"])
    log(f"run_slam (warm, seed {SEED + 1}): "
        f"{time.perf_counter() - t0:.6f} s end to end")
    checks.check("run_slam: poses and map finite",
                 bool(np.isfinite(res.poses).all()
                      and np.isfinite(res.logodds).all()),
                 f"{res.n_loop_closures} loop closures")
    staged_run(fresh)  # compiles the staged variants' glue
    times, inter = staged_run(fresh)
    for name, dt in times.items():
        log(f"stage {name}: {dt:.6f} s")
    log(f"stages total: {sum(times.values()):.6f} s; ICP iterations per "
        f"pair: mean {inter['sm_iters'].mean():.2f}, "
        f"max {int(inter['sm_iters'].max())}")
    return log_, poses, inter


def ate_reference(sizes, cpu):
    """Phase 1's main path on the CPU backend; prints the ATE the bound
    (ATE_CPU_M) comes from."""
    from lidar_slam.models import slam
    from lidar_slam.utils import metrics

    log_ = load_log(SEED, sizes.scans, cpu)
    with default_device(cpu):
        res = slam.run_slam(log_["counts"], log_["gyro"], log_["ranges"], 0.1,
                            30.0, mode="gtsam", filter_lidar=True,
                            fixed_interval=FIXED_INTERVAL, cfg=log_["cfg"])
    ate = metrics.ate_translation(res.poses_optimized, log_["gt"])
    log(f"CPU ATE (seed {SEED}, {sizes.scans} scans): rmse "
        f"{ate['rmse']!r} m, mean {ate['mean']!r} m, max {ate['max']!r} m")


# ---------------------------------------------------------------- phase 2
def compare_nn(checks, log_, gpu, cpu, sizes):
    from scipy.spatial import cKDTree

    from lidar_slam.models import odometry
    from lidar_slam.ops import icp as icp_ops, nn
    from lidar_slam.utils import se2

    B = sizes.pairs
    pts3 = log_["pts3"]
    # the ICP seeds scan matching uses: consecutive odometry increments
    odom = run_on(cpu, odometry.poses_from_odometry, log_["counts"][:B + 1],
                  log_["gyro"][:B + 1])
    seeds = run_on(cpu, lambda a, b: se2.TSE3_from_TSE2(
        se2.get_relative_pose(a, b)), odom[:-1], odom[1:])
    src = run_on(cpu, icp_ops._transform, pts3[1:B + 1], seeds)
    tgt, tmask, smask = pts3[:B], log_["masks"][:B], log_["masks"][1:B + 1]
    idx = run_on(gpu, nn.nearest_neighbors, src, tgt, tmask)
    idx_cpu = run_on(cpu, nn.nearest_neighbors, src, tgt, tmask)
    worst, worst_m2, flips, n = -np.inf, -np.inf, 0, 0
    for b in range(B):
        valid = np.flatnonzero(tmask[b])
        s64 = src[b].astype(np.float64)
        t64 = tgt[b].astype(np.float64)
        d_best, i_best = cKDTree(t64[valid]).query(s64)
        d_got = ((s64 - t64[idx[b]]) ** 2).sum(-1)
        tol = NN_ABS_M2 + NN_ULPS * 2.0 ** -23 * (
            (s64 ** 2).sum(-1) + (t64[valid] ** 2).sum(-1).max())
        live = smask[b]
        gap = (d_got - d_best ** 2)[live]
        worst = max(worst, float((gap / tol[live]).max()))
        worst_m2 = max(worst_m2, float(gap.max()))
        flips += int((idx[b] != valid[i_best])[live].sum())
        n += int(live.sum())
        if not tmask[b][idx[b]].all():
            worst = np.inf  # a masked target was chosen
    checks.check(f"NN ({B} x 1081 x 1081) vs float64 KDTree",
                 worst <= 1.0,
                 f"{flips} of {n} indices differ (near-ties); worst gap "
                 f"{worst:.3f} x tolerance ({NN_ABS_M2:.0e} m^2 + {NN_ULPS} "
                 f"f32 ulps of |s|^2 + max|t|^2), {worst_m2:.3e} m^2")
    log(f"NN GPU vs CPU (same float32 formula): "
        f"{int((idx != idx_cpu)[smask].sum())} of {n} indices differ")
    return seeds


def compare_icp(checks, log_, gpu, cpu, sizes, seeds):
    import jax

    from lidar_slam.ops import icp as icp_ops

    B = sizes.pairs
    cfg = log_["cfg"].icp
    pts3 = log_["pts3"]
    args = (pts3[1:B + 1], pts3[:B], log_["masks"][1:B + 1],
            log_["masks"][:B], seeds)
    kw = dict(epsilon=cfg.epsilon, max_iters=cfg.max_iters,
              stopping_thresh=cfg.stopping_thresh,
              normalize_error=cfg.normalize_error, planar=True)
    g = run_on(gpu, icp_ops.run_icp_batch, *args, **kw)
    c = run_on(cpu, icp_ops.run_icp_batch, *args, **kw)
    checks.within(f"ICP chunk ({B} pairs, f32): max |T_gpu - T_cpu|",
                  float(np.abs(g.T - c.T).max()), ICP_T_TOL_F32)
    log(f"ICP f32: iteration counts equal in {int((g.iters == c.iters).sum())}"
        f" of {B} pairs; mean {g.iters.mean():.2f} iterations")
    with jax.enable_x64(True):
        g = run_on(gpu, icp_ops.run_icp_batch, *as_f64(args), **kw)
        c = run_on(cpu, icp_ops.run_icp_batch, *as_f64(args), **kw)
    same = g.iters == c.iters
    checks.check(f"ICP chunk ({B} pairs, f64): iteration counts equal",
                 same.mean() >= ICP_ITERS_AGREE,
                 f"{int(same.sum())} of {B} pairs (need "
                 f">= {ICP_ITERS_AGREE:.0%}); mean {g.iters.mean():.2f} "
                 "iterations")
    checks.within(f"ICP chunk ({B} pairs, f64): max |T_gpu - T_cpu|",
                  float(np.abs(g.T - c.T).max()), ICP_T_TOL)


def compare_map(checks, log_, poses, gpu, cpu, sizes):
    from lidar_slam.models import occupancy

    n = sizes.map_scans
    cfg = log_["cfg"].map
    pts, masks = log_["points"][:n], log_["masks"][:n]
    K = occupancy.adaptive_ray_cells(pts, masks, cfg, 30.0)
    for compact in (True, False):
        name = "compact" if compact else "dense"
        g = run_on(gpu, occupancy.build_logodds, poses[:n], pts, masks,
                   cfg, K, compact=compact)
        c = run_on(cpu, occupancy.build_logodds, poses[:n], pts, masks,
                   cfg, K, compact=compact)
        checks.within(f"map {name} scatter ({n} scans, 1201^2, K={K}): "
                      "max |log-odds GPU - CPU|",
                      float(np.abs(g - c).max()), MAP_TOL)
        differ = (g < 0) != (c < 0)  # finalize_grid: 1 where log-odds < 0
        near_zero = np.abs(c) <= MAP_TOL
        checks.check(f"map {name} scatter: uint8 grid equal except at "
                     "|log-odds| <= 1e-4",
                     not (differ & ~near_zero).any(),
                     f"{int(differ.sum())} cells differ; {int(near_zero.sum())}"
                     f" cells at |log-odds| <= 1e-4 "
                     f"({int((near_zero & (c != 0)).sum())} of them nonzero)")


def compare_pose_graph(checks, inter, gpu, cpu):
    import jax

    from lidar_slam.models import pose_graph

    args, cfg = inter["pg_inputs"], inter["pg_cfg"]
    n = len(args[0])

    def gap(a, b):  # max pose difference, yaw wrapped
        d = np.abs(a.astype(np.float64) - b)
        d[:, 2] = np.abs(np.angle(np.exp(1j * (a[:, 2] - b[:, 2]))))
        return float(d.max())

    with jax.enable_x64(True):
        g64 = run_on(gpu, pose_graph.optimize_trajectory, *as_f64(args), cfg)
        c64 = run_on(cpu, pose_graph.optimize_trajectory, *as_f64(args), cfg)
    checks.within(f"pose graph LM ({n} poses, f64): max |GPU - CPU| "
                  f"({int(g64.iterations)} vs {int(c64.iterations)} "
                  "iterations)", gap(g64.poses, c64.poses), PG_TOL)
    g32 = run_on(gpu, pose_graph.optimize_trajectory, *args, cfg)
    c32 = run_on(cpu, pose_graph.optimize_trajectory, *args, cfg)
    cpu_gap = gap(c32.poses, c64.poses)
    checks.within(f"pose graph LM ({n} poses, f32): max |GPU f32 - f64 "
                  f"optimum| (CPU f32: {cpu_gap:.3e})",
                  gap(g32.poses, c64.poses), 2 * cpu_gap + PG_TOL)


def compare_filters(checks, log_, gpu, cpu, sizes):
    from lidar_slam.ops import filters

    n = sizes.filter_scans
    f = log_["cfg"].filter
    pts, masks = log_["points"][:n], log_["masks"][:n]
    kw = dict(eps=f.dbscan_eps, min_samples=f.dbscan_min_samples)
    g = run_on(gpu, filters.dbscan_filter_scans, pts, masks, **kw)
    c = run_on(cpu, filters.dbscan_filter_scans, pts, masks, **kw)
    checks.check(f"DBSCAN mask ({n} scans)", bool((g == c).all()),
                 f"{int((g != c).sum())} of {int(masks.sum())} points "
                 f"differ; {int(c.sum())} kept")
    gs = run_on(gpu, filters.statistical_filter_scans, pts, c,
                k_std=f.statistical_k_std)
    cs = run_on(cpu, filters.statistical_filter_scans, pts, c,
                k_std=f.statistical_k_std)
    checks.check(f"statistical mask ({n} scans)", bool((gs == cs).all()),
                 f"{int((gs != cs).sum())} points differ; {int(cs.sum())} "
                 "kept")


def compare_texture(checks, log_, gpu, cpu, sizes):
    from lidar_slam.models import texture
    from lidar_slam.utils import native

    cfg = log_["cfg"]
    F, H, W = sizes.frames, 480, 640
    rng = np.random.default_rng(30)
    base_disp = rng.integers(300, 800, (16, H, W)).astype(np.uint16)
    base_rgb = rng.integers(0, 255, (16, H, W, 3)).astype(np.uint8)

    def loader(ids):  # bench.py's frame pattern: per-batch value offsets
        off = np.uint16(int(ids[0]) % 97)
        return base_disp[:len(ids)] + off, base_rgb[:len(ids)]

    poses = np.asarray(rng.normal(0, 5.0, (F, 3)), np.float32)
    ids = np.arange(F)
    grid = np.zeros((cfg.map.width, cfg.map.height), np.uint8)
    kw = dict(map_cfg=cfg.map, cam_cfg=cfg.camera, batch_size=16)

    def paint(dev, projector):
        with default_device(dev):
            return texture.generate_texture_map(
                poses, ids, ids, grid, loader, projector=projector, **kw)

    def agree(name, got, want):
        painted = int((want.sum(-1) > 0).sum())
        differ = int((got != want).any(-1).sum())
        checks.check(name, differ <= TEXTURE_CELLS * painted,
                     f"{differ} of {painted} painted cells differ "
                     f"(tolerance {TEXTURE_CELLS:.0e} of them)")

    dev = paint(gpu, "device")
    checks.check(f"texture device projector ({F} x 480 x 640): finite",
                 bool(np.isfinite(dev).all()),
                 f"{int((dev.sum(-1) > 0).sum())} cells painted")
    agree("texture: device projector, GPU vs CPU", dev, paint(cpu, "device"))
    if not native.available():
        log("texture: native projector not built; no cross-engine check")
        return
    agree("texture: device projector (GPU) vs native projector", dev,
          paint(gpu, "native"))


def compare_online(checks, log_, gpu, cpu, sizes):
    from lidar_slam.models import online

    cfg = log_["cfg"]
    K = online.default_ray_cells(cfg, 30.0)
    n = sizes.online_steps + 1

    def track(dev):
        import jax

        with default_device(dev):
            c, g, p, m = jax.device_put(
                (log_["counts"][:n], log_["gyro"][:n], log_["points"][:n],
                 log_["masks"][:n]), dev)
            st = online.init_state(p[0], m[0], cfg, n_max=n, K=K)
            out = [np.asarray(st.pose)]
            for t in range(1, n):  # the step donates its state: copy out
                st = online.online_step(st, c[t], g[t], p[t], m[t], cfg, K=K)
                out.append(np.asarray(st.pose))
            return np.stack(out)

    g, c = track(gpu), track(cpu)
    checks.within(f"online: {sizes.online_steps} steps, max |pose GPU - CPU|",
                  float(np.abs(g - c).max()), ONLINE_TOL)


def run_one_card(gpu, cpu, sizes=Sizes()):
    """Phases 1 and 2 with `gpu` as the device under test and `cpu` as the
    reference backend; returns the names of the failed checks."""
    checks = Checks()
    with tempfile.TemporaryDirectory() as workdir:
        log_, poses, inter = phase_main(checks, sizes, cpu, workdir)
    log("== phase 2: each stage on the GPU vs the CPU backend")
    seeds = compare_nn(checks, log_, gpu, cpu, sizes)
    compare_icp(checks, log_, gpu, cpu, sizes, seeds)
    compare_map(checks, log_, poses, gpu, cpu, sizes)
    compare_pose_graph(checks, inter, gpu, cpu)
    compare_filters(checks, log_, gpu, cpu, sizes)
    compare_texture(checks, log_, gpu, cpu, sizes)
    compare_online(checks, log_, gpu, cpu, sizes)
    return checks.failed


# ---------------------------------------------------------------- phase 3
def run_four_cards(devs, cpu, sizes=Sizes()):
    """The sharded paths on four devices against one, with the tolerances
    tests/test_parallel.py holds them to on the 8-device CPU mesh."""
    import jax
    import jax.numpy as jnp

    from lidar_slam.config import IcpConfig, PoseGraphConfig
    from lidar_slam.models import occupancy, particle_filter as pf
    from lidar_slam.models import pose_graph
    from lidar_slam.ops.icp import run_icp_batch
    from lidar_slam.parallel import sharding
    from lidar_slam.parallel.mesh import make_mesh
    from lidar_slam.parallel.superstep import make_slam_step
    from lidar_slam.utils import se2

    checks = Checks()
    log("== phase 3: sharded paths on 4 GPUs vs 1 GPU")
    one = devs[0]
    mesh = make_mesh(4)
    mesh2 = make_mesh(4, axes=("dp", "rp"))  # (2, 2)
    log(f"meshes: {dict(mesh.shape)}, {dict(mesh2.shape)}")
    log_ = load_log(SEED, sizes.scans, cpu)
    cfg = log_["cfg"]
    pts, masks, pts3 = log_["points"], log_["masks"], log_["pts3"]
    gt = log_["gt"].astype(np.float32)

    # ICP pairs in float64, as in test_sharded_icp_matches_single_device,
    # seeded with the ground-truth increments
    B = sizes.pairs
    with jax.enable_x64(True):
        T0 = run_on(cpu, lambda a, b: se2.TSE3_from_TSE2(
            se2.get_relative_pose(a, b)), *as_f64((gt[:B], gt[1:B + 1])))
        args = as_f64((pts3[1:B + 1], pts3[:B], masks[1:B + 1], masks[:B],
                       T0))
        ref = run_on(one, run_icp_batch, *args, planar=True)
        got = jax.device_get(sharding.sharded_icp_batch(mesh)(
            *args, planar=True))
    checks.within(f"sharded ICP ({B} pairs, f64): max |T_4 - T_1|",
                  float(np.abs(got.T - ref.T).max()), 1e-9)
    checks.check("sharded ICP: iteration counts equal",
                 bool((got.iters == ref.iters).all()),
                 f"{int((got.iters == ref.iters).sum())} of {B}")

    # ray-sharded map over a 256-scan window, rays padded to a multiple of 4
    n = sizes.map_scans
    K = occupancy.adaptive_ray_cells(pts, masks, cfg.map, 30.0)
    pad = (-pts.shape[1]) % 4
    pts_r = np.pad(pts[:n], ((0, 0), (0, pad), (0, 0)))
    masks_r = np.pad(masks[:n], ((0, 0), (0, pad)))
    ref = run_on(one, occupancy.build_logodds, gt[:n], pts[:n], masks[:n],
                 cfg.map, K)
    got = np.asarray(sharding.sharded_build_logodds(mesh, cfg.map, K)(
        gt[:n], pts_r, masks_r))
    checks.within(f"ray-sharded map ({n} scans): max |4 - 1|",
                  float(np.abs(got - ref).max()), 1e-5)

    # scan-sharded map at dataset scale (4,956 = 4 x 1,239 scans)
    ref = run_on(one, occupancy.build_logodds, gt, pts, masks, cfg.map, K)
    got = np.asarray(sharding.sharded_build_logodds_scans(mesh, cfg.map, K)(
        gt, pts, masks))
    checks.within(f"scan-sharded map ({len(gt)} scans): max |4 - 1|",
                  float(np.abs(got - ref).max()), 1e-4)
    differ = (got < 0) != (ref < 0)
    checks.check("scan-sharded map: uint8 grid equal except at "
                 "|log-odds| <= 1e-4",
                 not (differ & (np.abs(ref) > 1e-4)).any(),
                 f"{int(differ.sum())} cells differ")

    # factor-sharded pose-graph LM on the ground-truth chain with noise
    rng = np.random.default_rng(3)
    poses0 = (gt + rng.normal(0, 0.05, gt.shape)).astype(np.float32)
    with default_device(one):
        T = se2.T_from_pose(jnp.asarray(gt))
        rel = np.asarray(jnp.einsum("nij,njk->nik", se2.inverse_T(T[:-1]),
                                    T[1:]))
        li = np.arange(0, len(gt) - FIXED_INTERVAL, FIXED_INTERVAL,
                       dtype=np.int32)
        lj = li + FIXED_INTERVAL
        lmeas = np.asarray(jnp.einsum("nij,njk->nik", se2.inverse_T(T[li]),
                                      T[lj]))
    lmask = np.ones(len(li), bool)
    pg_cfg = PoseGraphConfig(solver="banded", fixed_interval=FIXED_INTERVAL,
                             max_lm_iters=30, cost_rtol=1e-9)
    pg_args = (poses0, rel, li, lj, lmeas, lmask)
    solve4 = sharding.sharded_optimize_trajectory(mesh, pg_cfg)

    def pg_pair(args):
        ref = run_on(one, pose_graph.optimize_trajectory, *args, pg_cfg)
        return ref, jax.device_get(solve4(*args))

    # float64, with test_sharded_pose_graph_matches_single_device's 2e-5
    with jax.enable_x64(True):
        ref64, got64 = pg_pair(as_f64(pg_args))
    checks.within(f"sharded pose graph ({len(gt)} poses, f64): max |4 - 1| "
                  f"({int(got64.iterations)} vs {int(ref64.iterations)} "
                  "iterations)", float(np.abs(got64.poses - ref64.poses).max()),
                  2e-5)
    # float32: psum reassociation is amplified by the 4,956-pose chain's
    # conditioning, as the one-device float32 solve's own distance from the
    # float64 optimum shows; the 4-GPU solve is held to twice that + 1e-4
    ref32, got32 = pg_pair(pg_args)
    one_gap = float(np.abs(ref32.poses - ref64.poses).max())
    checks.within(f"sharded pose graph (f32): max |4-GPU f32 - f64 optimum| "
                  f"(1-GPU f32: {one_gap:.3e})",
                  float(np.abs(got32.poses - ref64.poses).max()),
                  2 * one_gap + 1e-4)

    # particle-sharded PF scoring: bit-identical
    im = (run_on(one, occupancy.build_logodds, gt[:n], pts[:n], masks[:n],
                 cfg.map, K) > 0).astype(np.float32)
    particles = (gt[n // 2][None] + rng.normal(0, 0.3, (256, 3))).astype(
        np.float32)
    ref = run_on(one, pf._score_particles, particles, pts[n // 2],
                 masks[n // 2], im, cfg.map)
    got = np.asarray(sharding.sharded_pf_score(mesh, cfg.map)(
        particles, pts[n // 2], masks[n // 2], im))
    checks.check("sharded PF scores (256 particles): bit-identical",
                 bool((got == ref).all()),
                 f"{int((got != ref).sum())} of 256 differ")

    # the fused superstep on the (dp, rp) mesh (rays padded to the rp
    # axis) vs a one-device map build at the poses it returns
    N = 32
    step = make_slam_step(mesh2, cfg.map, K, IcpConfig(),
                          PoseGraphConfig(max_lm_iters=2))
    pts3_r = np.pad(pts3[:N], ((0, 0), (0, pad), (0, 0)))
    out = jax.device_get(step(pts3_r, np.pad(masks[:N], ((0, 0), (0, pad))),
                              gt[:N], np.zeros((cfg.map.width,
                                                cfg.map.height), np.float32)))
    ref_map = run_on(one, occupancy.build_logodds, out.poses, pts[:N],
                     masks[:N], cfg.map, K)
    checks.check("superstep: poses finite", bool(np.isfinite(out.poses).all()),
                 f"graph cost {float(out.graph_cost):.4e}")
    checks.within("superstep: map vs 1-device build at its poses",
                  float(np.abs(out.logodds - ref_map).max()), 1e-4)
    return checks.failed


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run the sharded paths on four GPUs, nothing else")
    ap.add_argument("--ate-reference", action="store_true",
                    help="print the CPU ATE that phase 1's bound comes from")
    args = ap.parse_args(argv)

    devs = phase_device(4 if args.four else 1)
    if devs is None:
        return 2
    import jax

    cpu = jax.devices("cpu")[0]
    if args.ate_reference:
        ate_reference(Sizes(), cpu)
        return 0
    t0 = time.perf_counter()
    failed = (run_four_cards(devs[:4], cpu) if args.four
              else run_one_card(devs[0], cpu))
    log(f"chip_smoke: {time.perf_counter() - t0:.1f} s")
    if failed:
        print(f"chip_smoke: {len(failed)} check(s) failed: {failed}",
              file=sys.stderr)
        return 1
    print(ok_line(jax.devices()))
    return 0


def ok_line(devs):
    """The contract's last line, built from JAX's own device report."""
    return json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}})


if __name__ == "__main__":
    sys.exit(main())
