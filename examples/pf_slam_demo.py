"""Particle-filter SLAM demo: no prior map — the filter localizes against
the occupancy map it is simultaneously building, bounding the drift of a
deliberately biased odometry. The full-SLAM counterpart of
particle_filter_demo.py (which localizes against a KNOWN map); see
models/pf_slam.py for the architecture.

    python examples/pf_slam_demo.py [--steps 240] [--particles 128]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=240)
    parser.add_argument("--rays", type=int, default=181)
    parser.add_argument("--particles", type=int, default=128)
    parser.add_argument("--encoder_bias", type=float, default=1.15,
                        help="encoder scale factor simulating calibration "
                             "error (1.0 = unbiased)")
    parser.add_argument("--map_out", type=str, default=None,
                        help="optional .npy path for the final log-odds map")
    args = parser.parse_args()

    from lidar_slam.utils.runtime import report_devices
    report_devices()
    import jax.numpy as jnp
    import numpy as np

    from lidar_slam.config import LidarConfig, MapConfig
    from lidar_slam.models import occupancy, odometry, pf_slam
    from lidar_slam.models.particle_filter import PFConfig
    from lidar_slam.ops import scan as scan_ops
    from lidar_slam.utils import io

    map_cfg = MapConfig(resolution=0.1, world_max_x=15, world_min_x=-15,
                        world_max_y=15, world_min_y=-15)
    data = io.synthetic_dataset(n_steps=args.steps, n_rays=args.rays, seed=5)
    gt = jnp.asarray(data["ground_truth"], jnp.float32)
    counts = jnp.asarray(data["encoder"]["counts"],
                         jnp.float32) * args.encoder_bias
    gyro = jnp.asarray(data["imu"]["angular_velocity"], jnp.float32)
    points, masks = scan_ops.scans_to_points(
        jnp.asarray(data["lidar"]["ranges"], jnp.float32), 0.1, 30.0,
        LidarConfig())
    K = int(occupancy.adaptive_ray_cells(points, masks, map_cfg, 30.0))

    odo = odometry.poses_from_odometry(counts, gyro, x_0=gt[0])
    err_odo = np.linalg.norm(np.asarray(odo)[:, :2] - np.asarray(gt)[:, :2],
                             axis=1)

    poses, logodds, aux = pf_slam.slam_particle_filter(
        counts, gyro, points[..., :2], masks, map_cfg,
        PFConfig(n_particles=args.particles), x0=gt[0], K=K)
    err = np.linalg.norm(np.asarray(poses)[:, :2] - np.asarray(gt)[:, :2],
                         axis=1)

    lo = np.asarray(logodds)
    print(f"map built: {lo.shape}, {int((lo > 0).sum())} occupied cells")
    print(f"dead reckoning (bias {args.encoder_bias}): "
          f"mean {err_odo.mean():.3f} m, final {err_odo[-1]:.3f} m")
    print(f"pf-slam ({args.particles} particles, no prior map): "
          f"mean {err.mean():.3f} m, final {err[-1]:.3f} m, "
          f"{int(np.asarray(aux['resampled']).sum())} resamples")
    if args.map_out:
        np.save(args.map_out, lo)
        print(f"log-odds map saved to {args.map_out}")
