"""CLI driver for the ONLINE (streaming) SLAM mode — the serving entry.

The reference is batch-only (reference: main.py:67-192 loads the whole log
up front); this driver is the new-surface counterpart: it feeds one
synchronized (encoder, gyro, scan) tuple at a time through
models/online.online_step, maintaining the current pose and the causal
occupancy map, with optional periodic sliding-window refinement and
checkpoint/resume.

    python online_slam.py --synthetic 500                 # synthetic stream
    python online_slam.py --dataset 20 --dataset_path data/
    python online_slam.py --synthetic 500 --checkpoint ck.npz --resume
    python online_slam.py --synthetic 500 --localize map.npy  # PF-only
        # (map.npy from `main.py --save_logodds map.npy`; localization-only
        #  serving against a known map — models/particle_filter.py)

Each step is one jitted dispatch from the host; the step's time on the
H100 is not measured yet (PERF.md, Open questions).
"""

import argparse
import os
import sys
import time


def build_parser():
    p = argparse.ArgumentParser(description="Streaming SLAM (serving mode)")
    p.add_argument("--dataset", type=int, default=20)
    p.add_argument("--dataset_path", type=str, default="data/")
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="run on an N-step synthetic stream instead of npz")
    p.add_argument("--res", type=float, default=0.05)
    p.add_argument("--width", type=int, default=60)
    p.add_argument("--height", type=int, default=60)
    p.add_argument("--window", type=int, default=None,
                   help="sliding-window capacity (n_max poses retained); "
                        "default 8192. Ignored with --resume (the "
                        "checkpoint's ring buffers fix the window)")
    p.add_argument("--refine_every", type=int, default=0, metavar="S",
                   help="run the sliding-window pose-graph refinement "
                        "every S steps (0 = never)")
    p.add_argument("--refine_loops", type=str, default="none",
                   choices=["none", "fixed", "proximity", "descriptor"],
                   help="loop closures inside the periodic refinement: "
                        "'none' = between factors only; 'fixed' = gated "
                        "fixed-interval closures over the window's scans; "
                        "'proximity' / 'descriptor' = fixed + in-window "
                        "revisit detection (streaming loop closure; "
                        "descriptor is drift-independent)")
    p.add_argument("--robust_loss", type=str, default="none",
                   choices=["none", "huber", "cauchy"],
                   help="robust m-estimator on loop factors in refine")
    p.add_argument("--icp_metric", type=str, default="point",
                   choices=["point", "point_to_line"],
                   help="ICP correspondence metric for the streaming "
                        "scan matcher and refinement (same surface as "
                        "main.py): 'point' = reference parity; "
                        "'point_to_line' (PLICP) removes the "
                        "nearest-sample bias at ~3x fewer iterations")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="write the full online state here at the end "
                        "(and every --refine_every steps)")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint instead of starting fresh")
    p.add_argument("--relocalize_on_loss", action="store_true",
                   help="detect tracking loss (scan-match RMS above "
                        "--loss_rms): the lost step coasts on odometry "
                        "without painting the map, then certified global "
                        "relocalization against the causal map re-seeds "
                        "the stream (kidnapped-robot recovery)")
    p.add_argument("--loss_rms", type=float, default=0.3,
                   help="tracking-loss threshold: RMS point-to-"
                        "correspondence distance in meters (healthy "
                        "consecutive matches sit at mm-cm)")
    p.add_argument("--map_path", type=str, default="online_map.png")
    p.add_argument("--export_ros_map", type=str, default=None, metavar="STEM",
                   help="also export the final causal map as ROS map_server "
                        "STEM.pgm + STEM.yaml (nav2/AMCL-consumable)")
    p.add_argument("--poses_path", type=str, default=None,
                   help="save the streamed pose track (.npy)")
    p.add_argument("--localize", type=str, default=None, metavar="MAP.npy",
                   help="localization-only serving mode: instead of SLAM, "
                        "stream particle-filter localization against this "
                        "saved log-odds grid (.npy, e.g. main.py "
                        "--save_logodds output) — the map must have been "
                        "built with the same --res/--width/--height")
    p.add_argument("--particles", type=int, default=256,
                   help="particle count for --localize")
    p.add_argument("--x0", type=str, default=None, metavar="X,Y,YAW",
                   help="initial pose for --localize (default 0,0,0)")
    p.add_argument("--global_init", action="store_true",
                   help="kidnapped-robot start for --localize: certified "
                        "global relocalization on the first scan fixes the "
                        "initial pose (models/relocalization.py), and the "
                        "particles seed as a cloud around the fix — a blind "
                        "uniform spread would need O(map area x headings) "
                        "particles to contain the true pose")
    return p


def _run_localize(args, cfg, counts, gyro, points, masks):
    """Localization-only serving: stream PF steps against a saved map."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from lidar_slam.models import occupancy
    from lidar_slam.models.particle_filter import (PFConfig,
                                                   init_pf_state,
                                                   pf_step)
    from lidar_slam.models.odometry import v_from_encoder

    logodds = np.load(args.localize)
    if logodds.shape != (cfg.map.width, cfg.map.height):
        raise SystemExit(
            f"--localize: map {args.localize!r} has shape {logodds.shape} "
            f"but --res/--width/--height imply "
            f"({cfg.map.width}, {cfg.map.height}); pass the flags the map "
            "was built with")
    im = jnp.asarray(logodds > 0, jnp.float32)  # 1 at obstacles

    pf_cfg = PFConfig(n_particles=args.particles)
    x0 = jnp.zeros(3, jnp.float32)
    if args.x0 is not None:
        vals = [float(v) for v in args.x0.split(",")]
        if len(vals) != 3:
            raise SystemExit(f"--x0 wants X,Y,YAW, got {args.x0!r}")
        x0 = jnp.asarray(vals, jnp.float32)

    init_particles = None
    if args.global_init:
        # kidnapped-robot start: the certified multi-resolution search
        # fixes scan 0's pose anywhere in the map (alias-robust: top
        # candidates ICP-polished, lowest normalized error wins), then the
        # particles seed as a cloud around the fix. A blind uniform spread
        # was measured NOT to converge at serving particle counts (128
        # particles over a 30x30 m map x yaw: 6.8 m mean error).
        from lidar_slam.models.relocalization import (RelocConfig,
                                                      relocalize_refined)
        reach = 0.5 * max(cfg.map.world_max_x - cfg.map.world_min_x,
                          cfg.map.world_max_y - cfg.map.world_min_y)
        t_r = time.time()
        grid_res, pose_fix, icp_err = relocalize_refined(
            jnp.asarray(logodds, jnp.float32), cfg.map, points[0],
            masks[0], RelocConfig(search_radius=reach), n_candidates=4)
        print(f"global init: relocalized scan 0 to "
              f"{np.round(np.asarray(pose_fix), 3)} in "
              f"{time.time() - t_r:.1f}s (grid score "
              f"{float(grid_res.score):.0f}, certified="
              f"{bool(grid_res.certified)}, polish err "
              f"{float(icp_err):.2e})", file=sys.stderr)
        x0 = jnp.asarray(pose_fix, jnp.float32)
        rng = np.random.default_rng(0)
        cloud = np.asarray(x0)[None, :] + np.stack(
            [rng.normal(0, 2.0 * cfg.map.resolution, pf_cfg.n_particles),
             rng.normal(0, 2.0 * cfg.map.resolution, pf_cfg.n_particles),
             rng.normal(0, 0.05, pf_cfg.n_particles)], axis=-1)
        init_particles = jnp.asarray(cloud, jnp.float32)

    v_all = v_from_encoder(counts)
    wyaw_all = gyro[:, -1].astype(jnp.float32)
    state = init_pf_state(pf_cfg, x0, init_particles=init_particles)
    n = int(points.shape[0])
    track = [np.asarray(x0)]
    t0 = time.time()
    for t in range(1, n):
        state, (est, neff, _) = pf_step(state, v_all[t], wyaw_all[t],
                                        points[t], masks[t], im,
                                        cfg.map, pf_cfg)
        track.append(np.asarray(est))
    dt = time.time() - t0
    print(f"localized {n - 1} steps in {dt:.2f}s "
          f"({(n - 1) / dt:.0f} Hz incl. host dispatch, "
          f"{args.particles} particles); final pose "
          f"{np.round(track[-1], 3)} (Neff {float(neff):.0f})",
          file=sys.stderr)
    if args.poses_path:
        np.save(args.poses_path, np.asarray(track))
        print(f"pose track -> {args.poses_path}", file=sys.stderr)


def main(argv=None):
    args = build_parser().parse_args(argv)

    if args.localize:
        # fail fast on flags that only make sense for the SLAM stream —
        # silently ignoring them would misrepresent what ran
        for flag, name in ((args.resume, "--resume"),
                           (args.checkpoint, "--checkpoint"),
                           (args.refine_every, "--refine_every"),
                           (args.relocalize_on_loss, "--relocalize_on_loss")):
            if flag:
                raise SystemExit(f"--localize is localization-only; "
                                 f"{name} applies to the SLAM stream")
        if not os.path.exists(args.localize):
            raise SystemExit(f"--localize: map {args.localize!r} "
                             "does not exist")

    if args.resume:
        # a missing checkpoint under --resume must NOT silently fall through
        # to a fresh run: the final save_state would then OVERWRITE the path
        # the operator believed held their state (wrong cwd / typo'd path).
        # Validated before any backend/data work so the refusal is instant.
        if not args.checkpoint:
            raise SystemExit("--resume requires --checkpoint")
        if not os.path.exists(args.checkpoint):
            raise SystemExit(
                f"--resume: checkpoint {args.checkpoint!r} does not exist "
                "(refusing to start fresh and overwrite it; drop --resume "
                "for a new run)")

    import jax
    import jax.numpy as jnp
    import numpy as np

    from lidar_slam.config import MapConfig, SlamConfig
    from lidar_slam.models import occupancy, online
    from lidar_slam.ops import scan as scan_ops
    from lidar_slam.utils import io as io_utils
    from lidar_slam.utils.png import write_png
    from lidar_slam.utils.runtime import report_devices, use_compile_cache
    use_compile_cache()
    report_devices()

    import dataclasses
    cfg = SlamConfig(map=MapConfig.from_cli(args.res, args.width,
                                            args.height))
    if args.refine_loops in ("proximity", "descriptor") \
            or args.robust_loss != "none":
        cfg = dataclasses.replace(cfg, pose_graph=dataclasses.replace(
            cfg.pose_graph,
            loop_proposer=(args.refine_loops
                           if args.refine_loops in ("proximity",
                                                    "descriptor")
                           else cfg.pose_graph.loop_proposer),
            robust_loss=args.robust_loss))
    if args.icp_metric != "point":
        cfg = dataclasses.replace(
            cfg, icp=dataclasses.replace(cfg.icp, metric=args.icp_metric))
    if args.relocalize_on_loss:
        cfg = dataclasses.replace(cfg, online=dataclasses.replace(
            cfg.online, loss_rms_thresh=args.loss_rms))

    if args.synthetic:
        data = io_utils.synthetic_dataset(n_steps=args.synthetic, seed=0)
    else:
        data = io_utils.load_data(args.dataset,
                                  data_folder=args.dataset_path)
        from lidar_slam import sensors as sensors_mod
        enc = sensors_mod.Encoder.from_data(data["encoder"])
        imu = sensors_mod.Imu.from_data(data["imu"])
        lid = sensors_mod.Lidar.from_data(data["lidar"])
        sensors_mod.synchronize_sensors(enc, imu, lid, base_sensor_index=0)
        data = {
            "encoder": {"counts": enc.counts_synced},
            "imu": {"angular_velocity": imu.gyro_synced},
            "lidar": {"ranges": lid.ranges_synced,
                      "range_min": lid.range_min,
                      "range_max": lid.range_max},
        }

    counts = jnp.asarray(np.asarray(data["encoder"]["counts"]), jnp.float32)
    gyro = jnp.asarray(np.asarray(data["imu"]["angular_velocity"]),
                       jnp.float32)
    ranges = jnp.asarray(np.asarray(data["lidar"]["ranges"]), jnp.float32)
    rmin = float(np.asarray(data["lidar"].get("range_min", 0.1)))
    rmax = float(np.asarray(data["lidar"].get("range_max", 30.0)))
    points, masks = scan_ops.scans_to_points(ranges, rmin, rmax, cfg.lidar)
    n = int(points.shape[0])

    if args.localize:
        _run_localize(args, cfg, counts, gyro, points, masks)
        return

    K = online.default_ray_cells(cfg, rmax)

    start = 1
    window = 8192 if args.window is None else args.window
    if window <= 0:
        raise SystemExit(f"--window must be positive, got {window}")

    if args.resume:
        st = online.load_state(args.checkpoint)
        ck_window = int(st.poses_hist.shape[0])
        if args.window is not None and args.window != ck_window:
            print(f"warning: --window {args.window} ignored on resume; "
                  f"the checkpoint's ring buffers fix the window at "
                  f"{ck_window}", file=sys.stderr)
        start = int(st.step) + 1
        print(f"resumed from {args.checkpoint} at step {start - 1}",
              file=sys.stderr)
        if start >= n:
            # resume indices are positions in the SAME stream; a checkpoint
            # at/past the stream end means there is nothing left to feed
            print(f"stream exhausted: checkpoint is at step {start - 1} "
                  f"but the stream has only {n} steps; nothing to do "
                  "(pass a longer stream to continue this run)",
                  file=sys.stderr)
    else:
        st = online.init_state(points[0], masks[0], cfg,
                               n_max=window, K=K)

    # track row i = pose of global step (start - 1 + i): includes the
    # pre-loop pose so a fresh run covers step 0; a resumed run covers
    # [resume step, n) — the printed start index disambiguates
    track = [np.asarray(st.pose)]
    print(f"pose track starts at step {start - 1}", file=sys.stderr)
    t0 = time.time()
    for t in range(start, n):
        st = online.online_step(st, counts[t], gyro[t], points[t],
                                masks[t], cfg, K=K)
        if args.relocalize_on_loss and float(st.match_rms) > args.loss_rms:
            print(f"step {t}: tracking LOST (match RMS "
                  f"{float(st.match_rms):.2f} m > {args.loss_rms}); "
                  "relocalizing against the causal map...",
                  file=sys.stderr)
            st, grid_res, icp_err = online.relocalize_and_reseed(
                st, cfg, K=K)
            print(f"step {t}: relocalized to "
                  f"{np.round(np.asarray(st.pose), 3)} "
                  f"(grid score {float(grid_res.score):.0f}, certified="
                  f"{bool(grid_res.certified)}, polish err "
                  f"{float(icp_err):.2e}); stream re-seeded",
                  file=sys.stderr)
        track.append(np.asarray(st.pose))
        if args.refine_every and t % args.refine_every == 0:
            if args.refine_loops == "none":
                refined = online.refine(st, cfg)
            else:
                # the reference's per-step gates (main.py:94-101) — the
                # accept-all default admits identity-biased mid-window
                # closures that compress the trajectory
                from lidar_slam.models import odometry as odom_mod
                max_d, max_y = odom_mod.max_step_gates(counts, gyro,
                                                       cfg.robot.dt)
                lo = max(0, t + 1 - int(st.poses_hist.shape[0]))
                refined = online.refine(
                    st, cfg, scans=points[lo:t + 1],
                    scan_masks=masks[lo:t + 1],
                    max_distance=float(max_d), max_yaw_deg=float(max_y),
                    descriptor_range=(rmin, rmax))
            print(f"step {t}: refined window of {refined.shape[0]} poses "
                  f"(start step {online.window_start(st)})",
                  file=sys.stderr)
            if args.checkpoint:
                online.save_state(args.checkpoint, st)
    st.pose.block_until_ready()
    dt = time.time() - t0
    streamed = max(0, n - start)
    rate = f"{streamed / dt:.0f} Hz incl. host dispatch" if streamed else "idle"
    print(f"streamed {streamed} steps in {dt:.2f}s ({rate}); "
          f"final pose {np.asarray(st.pose)}", file=sys.stderr)

    if args.checkpoint:
        online.save_state(args.checkpoint, st)
        print(f"checkpoint -> {args.checkpoint}", file=sys.stderr)
    if args.poses_path:
        np.save(args.poses_path, np.asarray(track))
        print(f"pose track -> {args.poses_path}", file=sys.stderr)
    img = occupancy.render_logodds(st.logodds)
    write_png(args.map_path, img)
    print(f"causal map -> {args.map_path}", file=sys.stderr)
    if args.export_ros_map:
        from lidar_slam.utils import export
        pgm, yml = export.save_map_ros(np.asarray(st.logodds), cfg.map,
                                       args.export_ros_map)
        print(f"ROS map_server map -> {pgm} + {yml}", file=sys.stderr)


if __name__ == "__main__":
    main()
