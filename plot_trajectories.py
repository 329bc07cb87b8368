"""Overlay saved trajectories (reference: plot_trajectories.py:1-15).

Flag surface matches the reference CLI (--trajectory_files, --labels,
--figsize, --save_path, --title, same defaults); --poses and --out are
kept as shorter aliases.
"""

import argparse

from lidar_slam.utils import io
from lidar_slam.utils.plotting import plot_trajectories

if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="Plot multiple trajectories")
    parser.add_argument("--trajectory_files", "--poses", dest="poses",
                        type=str, nargs="+", required=True,
                        help="Paths to .npy trajectory files")
    parser.add_argument("--labels", type=str, nargs="+", default=None,
                        help="Labels for each trajectory, optional")
    parser.add_argument("--figsize", type=int, nargs=2, default=[10, 10],
                        help="Figure size")
    parser.add_argument("--save_path", "--out", dest="out", type=str,
                        default="images/trajectory.png",
                        help="Path to save plot")
    parser.add_argument("--title", type=str, default="Trajectories",
                        help="Title for plot")
    args = parser.parse_args()

    poses = [io.load_numpy(p) for p in args.poses]
    plot_trajectories(poses, args.out, labels=args.labels, title=args.title,
                      figsize=tuple(args.figsize))
    print(f"saved {args.out}")
