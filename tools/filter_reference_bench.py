"""Measure the REFERENCE scan-filter stage on this machine (BASELINE.md).

Runs the reference's actual DBSCAN_outliers_removal +
statistical_outliers_removal (reference: modules/localization.py:201-250,
invoked by main.py:86-87 under --filter_lidar) over dataset-20-shaped
synthetic scans, and prints ms/scan plus the 4,956-scan extrapolation.

Usage: python tools/filter_reference_bench.py [--scans 64]
"""

import argparse
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = "/root/reference"
DATASET20_SCANS = 4956


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scans", type=int, default=64)
    args = ap.parse_args()

    sys.path.insert(0, REPO)
    sys.path.insert(0, REF)
    import modules.localization as rloc
    from lidar_slam.utils import io

    data = io.synthetic_dataset(n_steps=args.scans, n_rays=1081, seed=0)
    ranges = np.asarray(data["lidar"]["ranges"])
    # the reference filters the ragged get_lidar_data output
    z_ts = rloc.get_lidar_data(ranges, float(data["lidar"]["range_min"]),
                               float(data["lidar"]["range_max"]))

    t0 = time.time()
    z_f = rloc.DBSCAN_outliers_removal(z_ts)
    rloc.statistical_outliers_removal(z_f)
    dt = time.time() - t0
    per_scan = dt / args.scans
    print(f"reference filter stage: {args.scans} scans in {dt:.2f}s "
          f"({per_scan * 1e3:.1f} ms/scan)")
    print(f"extrapolated dataset-20 ({DATASET20_SCANS} scans): "
          f"{per_scan * DATASET20_SCANS:.1f}s")


if __name__ == "__main__":
    main()
