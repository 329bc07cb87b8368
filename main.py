"""CLI driver: the reference's exact flag surface on the JAX engine.

Same flags, defaults, output paths, and stage banners as the reference
driver (reference: main.py:14-247, README.md:5-55):

  python main.py --mode gtsam --filter_lidar --generate_texture_map \
      --dataset 20 --dataset_path data/

Stage artifacts go to outputs/ with the reference's file names; map images
go to images/ or images_filtered/ depending on --filter_lidar, suffixed
_{mode}_{dataset}.png. When the dataset npz files are absent, pass
--synthetic N to run on a generated dataset-20-shaped world instead (the
real datasets are not shipped upstream; .gitignore:7-8).
"""

import argparse
import os


def build_parser():
    parser = argparse.ArgumentParser(description="Generate an Occupancy Grid Map")
    # Pose estimation settings (reference: main.py:17-20)
    parser.add_argument("--mode", type=str, default="odom",
                        help="The mode to use for pose estimation")
    parser.add_argument("--filter_lidar", action="store_true",
                        help="Filter the lidar data")
    parser.add_argument("--fixed_interval", type=int, default=10,
                        help="The fixed interval for loop closure")
    # Dataset settings (reference: main.py:22-24)
    parser.add_argument("--dataset", type=int, default=20,
                        help="The dataset number")
    parser.add_argument("--dataset_path", type=str, default="data/",
                        help="The path to the dataset")
    # Occupancy Grid Map settings (reference: main.py:26-29)
    parser.add_argument("--res", type=float, default=0.05,
                        help="The resolution of the map")
    parser.add_argument("--width", type=int, default=60,
                        help="The width of the map")
    parser.add_argument("--height", type=int, default=60,
                        help="The height of the map")
    # Generated images settings (reference: main.py:31-33)
    parser.add_argument("--logodds_map_path", type=str,
                        default="logodds_map.png",
                        help="The path to save the map")
    parser.add_argument("--texture_map_path", type=str,
                        default="texture_map.png",
                        help="The path to save the texture map")
    # Misc. settings (reference: main.py:35-36)
    parser.add_argument("--generate_texture_map", action="store_true",
                        help="Generate the texture map")
    # Extensions beyond the reference surface
    parser.add_argument("--synthetic", type=int, default=0, metavar="N",
                        help="Run on an N-step synthetic dataset instead of "
                             "reading npz files")
    parser.add_argument("--synthetic_revisit", type=int, default=0,
                        metavar="N",
                        help="Run on an N-step synthetic REVISIT scene (a "
                             "drifting circle driven back to its start; "
                             "--synthetic_laps laps) — the loop-closure "
                             "demo world for --loop_proposer")
    parser.add_argument("--synthetic_laps", type=int, default=1,
                        help="Laps for --synthetic_revisit (>=2 makes "
                             "every pose a revisit of the previous lap)")
    parser.add_argument("--output_dir", type=str, default="outputs/",
                        help="Directory for stage .npy artifacts")
    parser.add_argument("--save_logodds", type=str, default=None,
                        metavar="PATH.npy",
                        help="Also save the final log-odds grid (.npy) — "
                             "the map artifact online_slam.py --localize "
                             "consumes (new surface; implies building the "
                             "occupancy map even without "
                             "--generate_texture_map)")
    parser.add_argument("--load_poses", type=str, default=None,
                        help="Resume from a saved poses .npy: skip pose "
                             "estimation and only build maps/texture "
                             "(checkpoint/resume; stage artifacts in "
                             "outputs/ are the checkpoints)")
    parser.add_argument("--loop_proposer", type=str, default="fixed",
                        choices=["fixed", "proximity", "descriptor"],
                        help="Loop-closure proposer for --mode gtsam: "
                             "'fixed' = reference parity (i, i+interval "
                             "pairs only); 'proximity' adds revisit pairs "
                             "detected on the estimated trajectory; "
                             "'descriptor' adds appearance-based place "
                             "recognition (drift-independent). All extra "
                             "pairs are ICP-error gated (models/slam.py)")
    parser.add_argument("--robust_loss", type=str, default="none",
                        choices=["none", "huber", "cauchy"],
                        help="Robust m-estimator on loop factors in the "
                             "pose-graph solve (gtsam mEstimator analog)")
    parser.add_argument("--proximity_seed", type=str, default="identity",
                        choices=["identity", "estimate"],
                        help="Verification seeding for proximity revisit "
                             "pairs: 'estimate' seeds each pair's ICP "
                             "from the estimated relative pose (handles "
                             "ANY heading difference; pairs with "
                             "--proximity_trim < 1)")
    parser.add_argument("--proximity_trim", type=float, default=1.0,
                        help="Trimmed-ICP fraction for revisit "
                             "verification (partial-overlap scans; "
                             "0.55 measured best for ~180-degree "
                             "revisits at 270-degree FOV)")
    parser.add_argument("--icp_metric", type=str, default="point",
                        choices=["point", "point_to_line"],
                        help="Scan-matching correspondence metric: "
                             "'point' = reference parity; "
                             "'point_to_line' (PLICP) removes the "
                             "nearest-sample bias — 45-120x lower "
                             "trajectory drift on synthetic logs at "
                             "~3x fewer ICP iterations")
    parser.add_argument("--export_ros_map", type=str, default=None,
                        metavar="STEM",
                        help="Also export the occupancy map as ROS "
                             "map_server STEM.pgm + STEM.yaml "
                             "(nav2/AMCL-consumable)")
    parser.add_argument("--export_tum", type=str, default=None,
                        metavar="PATH",
                        help="Also export the final trajectory in TUM "
                             "format (timestamp x y z qx qy qz qw; "
                             "evo-compatible)")
    return parser


def banner(text):
    print("=" * 52)
    print(text)
    print("=" * 52)


def main(argv=None):
    args = build_parser().parse_args(argv)

    # persistent compile cache: repeat CLI runs at the same shapes skip the
    # XLA compile
    from lidar_slam.utils.runtime import report_devices, use_compile_cache
    use_compile_cache()
    report_devices()

    from lidar_slam import sensors
    from lidar_slam.config import MapConfig, SlamConfig
    from lidar_slam.models import slam
    from lidar_slam.utils import io

    dataset_num = args.dataset

    # output path derivation (reference: main.py:49-56)
    img_dir = "images_filtered/" if args.filter_lidar else "images/"
    logodds_map_path = img_dir + args.logodds_map_path
    texture_map_path = img_dir + args.texture_map_path
    logodds_map_path = (logodds_map_path.split(".")[0] + "_" + args.mode
                        + "_" + str(dataset_num) + ".png")
    texture_map_path = (texture_map_path.split(".")[0] + "_" + args.mode
                        + "_" + str(dataset_num) + ".png")

    banner("Command line arguments")
    for arg in vars(args):
        print(f"{arg}: {getattr(args, arg)}")
    print(f"output: {args.output_dir}")
    print("\n")

    banner("Loading the dataset and synchronizing the sensors...")
    if args.synthetic_revisit:
        data = io.synthetic_revisit_dataset(n_steps=args.synthetic_revisit,
                                            laps=args.synthetic_laps)
        print(f"(synthetic revisit scene, {args.synthetic_revisit} steps, "
              f"{args.synthetic_laps} lap(s))")
        args.synthetic = args.synthetic_revisit  # downstream gating
    elif args.synthetic:
        # --dataset routes the synthetic generator too: 21 gets the
        # 21-shaped geometry (different extents/range_max), so the
        # advertised {20,21} surface is exercisable without raw data
        if dataset_num == 21:
            data = io.synthetic_dataset_21(n_steps=args.synthetic)
        else:
            data = io.synthetic_dataset(n_steps=args.synthetic)
        print(f"(synthetic dataset, {args.synthetic} steps, "
              f"{dataset_num}-shaped)")
    else:
        data = io.load_data(dataset_num, io.DATASET_NAMES, args.dataset_path)
    encoder = sensors.Encoder.from_data(data["encoder"])
    lidar = sensors.Lidar.from_data(data["lidar"])
    imu = sensors.Imu.from_data(data["imu"])
    kinect = sensors.Kinect.from_data(data["rgbd"])
    sensors.synchronize_sensors(encoder, imu, lidar, base_sensor_index=0)
    print("Done!\n\n")

    banner("Running the SLAM pipeline...")
    import dataclasses
    cfg = SlamConfig(map=MapConfig.from_cli(args.res, args.width, args.height))
    if (args.loop_proposer != "fixed" or args.robust_loss != "none"
            or args.proximity_seed != "identity"
            or args.proximity_trim != 1.0):
        cfg = dataclasses.replace(
            cfg, pose_graph=dataclasses.replace(
                cfg.pose_graph, loop_proposer=args.loop_proposer,
                robust_loss=args.robust_loss,
                proximity_seed=args.proximity_seed,
                proximity_trim=args.proximity_trim))
    if args.icp_metric != "point":
        cfg = dataclasses.replace(
            cfg, icp=dataclasses.replace(cfg.icp, metric=args.icp_metric))
    if args.load_poses:
        result = slam.resume_from_poses(
            io.load_numpy(args.load_poses),
            lidar.ranges_synced, float(lidar.range_min),
            float(lidar.range_max), filter_lidar=args.filter_lidar, cfg=cfg,
            build_map=(args.generate_texture_map
                       or bool(args.save_logodds)
                       or bool(args.export_ros_map)))
        print(f"(resumed from {args.load_poses})")
    else:
        result = slam.run_slam(
            encoder.counts_synced, imu.gyro_synced, lidar.ranges_synced,
            float(lidar.range_min), float(lidar.range_max),
            mode=args.mode, filter_lidar=args.filter_lidar,
            fixed_interval=args.fixed_interval, cfg=cfg,
            build_map=(args.generate_texture_map
                       or bool(args.save_logodds)
                       or bool(args.export_ros_map)))

    if not args.load_poses:
        _save_stage_artifacts(io, result, args.output_dir, dataset_num)
    if args.save_logodds:
        io.save_numpy(result.logodds, args.save_logodds)
        print(f"log-odds grid saved at {args.save_logodds}")
    if args.export_ros_map:
        from lidar_slam.utils import export
        import numpy as np
        pgm, yml = export.save_map_ros(np.asarray(result.logodds), cfg.map,
                                       args.export_ros_map)
        print(f"ROS map_server map saved at {pgm} + {yml}")
    if args.export_tum:
        from lidar_slam.utils import export
        import numpy as np
        final = result.poses_optimized
        if final is None:
            final = result.poses_scan_matching
        if final is None:
            final = result.poses_odom
        final = np.asarray(final)
        stamps = np.asarray(encoder.stamps)[:final.shape[0]] \
            if len(encoder.stamps) >= final.shape[0] else None
        export.save_trajectory_tum(args.export_tum, final, stamps)
        print(f"TUM trajectory saved at {args.export_tum}")
    print("\n")

    if args.generate_texture_map:
        _generate_maps(args, cfg, result, lidar, encoder, kinect,
                       logodds_map_path, texture_map_path, dataset_num)


def _save_stage_artifacts(io, result, out, dataset_num):
    io.save_numpy(result.poses_odom, os.path.join(out, f"poses_odom_{dataset_num}.npy"))
    io.save_numpy(result.relative_poses_odom,
                  os.path.join(out, f"relative_poses_odom_{dataset_num}.npy"))
    print(f"poses_odom_{dataset_num}.npy saved at {out}")
    print(f"relative_poses_odom_{dataset_num}.npy saved at {out}")
    if result.poses_scan_matching is not None:
        io.save_numpy(result.poses_scan_matching,
                      os.path.join(out, f"poses_scan_matching_{dataset_num}.npy"))
        io.save_numpy(result.relative_poses_scan_matching,
                      os.path.join(out, f"relative_poses_scan_matching_{dataset_num}.npy"))
        print(f"poses_scan_matching_{dataset_num}.npy saved at {out}")
        print(f"relative_poses_scan_matching_{dataset_num}.npy saved at {out}")
    if result.poses_optimized is not None:
        io.save_numpy(result.poses_optimized,
                      os.path.join(out, f"poses_optimized_{dataset_num}.npy"))
        print(f"Added {result.n_loop_closures} loop closures")
        print(f"poses_optimized_{dataset_num}.npy saved at {out}")


def _generate_maps(args, cfg, result, lidar, encoder, kinect,
                   logodds_map_path, texture_map_path, dataset_num):
    from lidar_slam import sensors
    from lidar_slam.models import texture
    from lidar_slam.models.occupancy import OccupancyGridMap

    banner("Generating occupancy map...")
    ogm = OccupancyGridMap(cfg=cfg.map, range_max=float(lidar.range_max))
    ogm.grid_map_log_odds = result.logodds
    ogm.grid_map = result.grid_map
    os.makedirs(os.path.dirname(logodds_map_path) or ".", exist_ok=True)
    ogm.plot_log_odds_map(logodds_map_path)
    print(f"Occupancy (logodds) map saved at: {logodds_map_path}\n\n")

    banner("Generating the texture map...")
    rgb_pose_idx = sensors.Kinect.get_closest_stamps(
        encoder.stamps, kinect.rgb_stamps)
    disp_for_rgb = sensors.Kinect.get_closest_stamps(
        kinect.disp_stamps, kinect.rgb_stamps)
    if args.synthetic:
        print("(no RGBD frames for synthetic data; skipping texture)")
    else:
        loader = texture.disk_frame_loader(dataset_num, disp_for_rgb)
        # projector="auto": the C++ host projector uploads only paint ops
        # (~100x fewer bytes — the thin-link engine), falling back to the
        # on-device chain when the native library is absent
        tex = texture.generate_texture_map(
            result.poses, rgb_pose_idx, disp_for_rgb, result.grid_map,
            loader, cfg.map, cfg.camera, projector="auto")
        texture.plot_texture_map(tex, texture_map_path)
        print(f"Texture map saved at: {texture_map_path}")


if __name__ == "__main__":
    main()
