"""Compare trajectories / maps between runs (e.g. against the reference's
committed dataset-20 goldens).

  python tools/compare_runs.py --est outputs/poses_optimized_20.npy \
      --ref /root/reference/outputs/poses_optimized_20.npy
  python tools/compare_runs.py --est-map run_a_logodds.npy --ref-map run_b_logodds.npy
"""

import argparse
import json
import sys

import numpy as np

sys.path.insert(0, ".")

from lidar_slam.utils import metrics  # noqa: E402

if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--est", type=str, help="estimated poses .npy")
    p.add_argument("--ref", type=str, help="reference poses .npy")
    p.add_argument("--est-map", type=str, help="estimated logodds .npy")
    p.add_argument("--ref-map", type=str, help="reference logodds .npy")
    p.add_argument("--no-align", action="store_true")
    args = p.parse_args()

    report = {}
    if args.est and args.ref:
        est, ref = np.load(args.est), np.load(args.ref)
        report["ate"] = metrics.ate_translation(est, ref,
                                                align=not args.no_align)
        report["rpe_1"] = metrics.relative_pose_error(est, ref, delta=1)
    if args.est_map and args.ref_map:
        report["map"] = metrics.map_agreement(np.load(args.est_map),
                                              np.load(args.ref_map))
    print(json.dumps(report, indent=2))
