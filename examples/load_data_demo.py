"""Raw-loader demo (parity with the reference starter code/load_data.py):
prints the shapes and time spans of every sensor stream, from real npz files
or the synthetic generator."""

import argparse
import os
import sys

# runnable from anywhere: python examples/load_data_demo.py
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lidar_slam.utils import io

if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=int, default=20)
    parser.add_argument("--dataset_path", type=str, default="data/")
    parser.add_argument("--synthetic", type=int, default=0)
    args = parser.parse_args()

    if args.synthetic:
        data = io.synthetic_dataset(n_steps=args.synthetic)
    else:
        data = io.load_data(args.dataset, io.DATASET_NAMES, args.dataset_path)

    enc, lid, imu, rgbd = (data["encoder"], data["lidar"], data["imu"],
                           data["rgbd"])
    print(f"encoder counts {enc['counts'].shape}, "
          f"span {enc['stamps'][-1] - enc['stamps'][0]:.1f}s")
    print(f"lidar ranges {lid['ranges'].shape}, "
          f"range [{float(lid['range_min'])}, {float(lid['range_max'])}] m, "
          f"angles [{float(lid['angle_min']):.3f}, "
          f"{float(lid['angle_max']):.3f}] rad")
    print(f"imu gyro {imu['angular_velocity'].shape}, "
          f"accel {imu['linear_acceleration'].shape}")
    print(f"kinect: {len(rgbd['disp_stamps'])} disparity stamps, "
          f"{len(rgbd['rgb_stamps'])} rgb stamps")
