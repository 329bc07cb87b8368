"""ICP warm-up CLI (reference: code/icp_warm_up/test_icp.py:52-101).

  python warmup_icp.py --obj_name drill --num_pc 4 [--data_dir ./data]
"""

import argparse

from lidar_slam.models import warmup

if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--obj_name", type=str, default="drill",
                        help="Object name (drill or liq_container)")
    parser.add_argument("--num_pc", type=int, default=4,
                        help="Number of point clouds (1-4)")
    parser.add_argument("--data_dir", type=str, default="./data")
    parser.add_argument("--n_seeds", type=int, default=24)
    parser.add_argument("--export_ply", action="store_true",
                        help="also write images/<obj>_<i>.ply (aligned + "
                             "target clouds) for interactive 3-D viewers")
    parser.add_argument("--interactive", action="store_true",
                        help="open each alignment in an Open3D window "
                             "(reference UI; falls back to the PLY export "
                             "when open3d/a display is unavailable)")
    parser.add_argument("--synthetic", action="store_true",
                        help="run on synthetic clouds (the reference "
                             "gitignores its data/, so the .mat models "
                             "are not shipped)")
    args = parser.parse_args()

    from lidar_slam.utils.runtime import report_devices
    report_devices()

    if args.synthetic:
        source_pc = warmup.synthetic_model()
    else:
        source_pc = warmup.read_canonical_model(args.obj_name, args.data_dir)

    best_errors = {}
    for i in range(args.num_pc):
        if args.synthetic:
            target_pc = warmup.synthetic_pc(source_pc, i)
        else:
            target_pc = warmup.load_pc(args.obj_name, i, args.data_dir)
        best_T, best_err, errs = warmup.best_icp_alignment(
            source_pc, target_pc, n_seeds=args.n_seeds)
        best_errors[i] = round(best_err, 3)
        aligned = source_pc @ best_T[:3, :3].T + best_T[:3, 3]
        warmup.visualize_icp_result(source_pc, target_pc, aligned,
                                    f"images/{args.obj_name}_{i}.png")
        if args.interactive:
            if not warmup.view_interactive([aligned, target_pc]):
                print(f"PC {i}: open3d/display unavailable; writing "
                      f"images/{args.obj_name}_{i}.ply instead")
                warmup.export_ply(f"images/{args.obj_name}_{i}.ply",
                                  [aligned, target_pc])
        if args.export_ply:
            warmup.export_ply(f"images/{args.obj_name}_{i}.ply",
                              [aligned, target_pc])

    print("Best errors:")
    for i in range(args.num_pc):
        print(f"PC {i}: {best_errors[i]}")
