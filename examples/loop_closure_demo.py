"""Revisit loop-closure demo: drive a circle back to its start with a
biased gyro, watch every pose estimate drift — then close the loop.

The reference can only close FIXED-INTERVAL pairs (reference main.py:161),
which span 10 poses and cannot anchor long-range drift. This demo runs the
same scene through three --mode gtsam configurations and prints the ATE
of each stage:

  fixed       reference parity (fixed-interval closures only)
  proximity   + metric-nearness revisit pairs (fails here BY DESIGN: the
              drift exceeds the search radius, every proposal is
              perceptually aliased, and the ICP-error gate rejects them
              all — drift never gets worse, but never gets fixed)
  descriptor  + appearance place recognition (range-histogram descriptors,
              drift-independent) — finds the true revisit and recovers

    python examples/loop_closure_demo.py [--steps 360] [--gyro_scale 0.97]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=360)
    parser.add_argument("--rays", type=int, default=541)
    parser.add_argument("--gyro_scale", type=float, default=0.97,
                        help="yaw-rate scale error simulating gyro "
                             "miscalibration (1.0 = unbiased)")
    parser.add_argument("--laps", type=int, default=1,
                        help="laps around the circle (>=2 makes every "
                             "pose a revisit of the previous lap)")
    args = parser.parse_args()

    from lidar_slam.utils.runtime import report_devices
    report_devices()
    import dataclasses

    import numpy as np

    from lidar_slam.config import IcpConfig, LidarConfig, SlamConfig
    from lidar_slam.models import slam
    from lidar_slam.utils import io

    data = io.synthetic_revisit_dataset(n_steps=args.steps,
                                        n_rays=args.rays,
                                        gyro_scale=args.gyro_scale,
                                        laps=args.laps)
    gt = data["ground_truth"]

    def ate(p):
        return float(np.linalg.norm(
            np.asarray(p)[:, :2] - gt[:, :2], axis=1).mean())

    cfg0 = SlamConfig(lidar=LidarConfig(n_rays=args.rays),
                      icp=IcpConfig(epsilon=0.001))
    variants = {
        "fixed": cfg0.pose_graph,
        "proximity": dataclasses.replace(
            cfg0.pose_graph, loop_proposer="proximity",
            proximity_radius=1.0),
        "descriptor": dataclasses.replace(
            cfg0.pose_graph, loop_proposer="descriptor",
            robust_loss="huber"),
    }
    for name, pg in variants.items():
        res = slam.run_slam(
            data["encoder"]["counts"], data["imu"]["angular_velocity"],
            data["lidar"]["ranges"], 0.1, 30.0, mode="gtsam",
            fixed_interval=10, cfg=dataclasses.replace(cfg0, pose_graph=pg),
            build_map=False, chunk_size=16)
        print(f"[{name:10s}] loops={res.n_loop_closures:3d}  "
              f"ATE odom {ate(res.poses_odom):.3f} m | "
              f"scan-matching {ate(res.poses_scan_matching):.3f} m | "
              f"optimized {ate(res.poses_optimized):.3f} m")
