"""lidar_slam: a JAX/XLA 2-D LiDAR SLAM framework for one or more GPUs.

A ground-up rebuild of the capabilities of fadli0029/LiDAR-SLAM (2-D LiDAR
SLAM: encoder+gyro odometry, ICP scan matching, pose-graph optimization with
fixed-interval loop closures, log-odds occupancy grid mapping, RGB-D texture
mapping) designed for an accelerator: fixed shapes + masks instead of ragged
lists, vmap/scan instead of Python loops, brute-force distance matrices
instead of KDTrees, batched SVD Kabsch, scatter-add map updates, and an
in-JAX Levenberg-Marquardt pose-graph solver replacing GTSAM.
"""

__version__ = "0.1.0"

from . import config  # noqa: F401
from .config import SlamConfig  # noqa: F401
