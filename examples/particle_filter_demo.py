"""Particle-filter localization demo: build a map from a (synthetic) run,
bias the odometry, and watch the filter pull the estimate back to ground
truth. Completes the capability the reference's starter mapCorrelation was
shipped for (code/pr2_utils.py:12-43) but that was never built upstream.

    python examples/particle_filter_demo.py [--steps 240] [--particles 128]
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
    args = parser.parse_args()

    from lidar_slam.utils.runtime import report_devices
    report_devices()
    import jax.numpy as jnp
    import numpy as np

    from lidar_slam.config import LidarConfig, MapConfig
    from lidar_slam.models import occupancy, odometry
    from lidar_slam.models import particle_filter as pf
    from lidar_slam.ops import scan as scan_ops
    from lidar_slam.utils import io

    map_cfg = MapConfig(resolution=0.1, world_max_x=15, world_min_x=-15,
                        world_max_y=15, world_min_y=-15)
    data = io.synthetic_dataset(n_steps=args.steps, n_rays=args.rays, seed=5)
    gt = jnp.asarray(data["ground_truth"], jnp.float32)
    counts = jnp.asarray(data["encoder"]["counts"], jnp.float32)
    gyro = jnp.asarray(data["imu"]["angular_velocity"], jnp.float32)
    points, masks = scan_ops.scans_to_points(
        jnp.asarray(data["lidar"]["ranges"], jnp.float32), 0.1, 30.0,
        LidarConfig())

    K = occupancy.adaptive_ray_cells(points, masks, map_cfg, 30.0)
    logodds = occupancy.build_logodds(gt, points, masks, map_cfg, K)
    im = (logodds > 0).astype(jnp.float32)
    print(f"map: {im.shape}, {int(im.sum())} occupied cells")

    biased = counts * args.encoder_bias
    odo = odometry.poses_from_odometry(biased, gyro)
    err_odo = np.linalg.norm(np.asarray(odo)[:, :2] - np.asarray(gt)[:, :2],
                             axis=1)

    poses, aux = pf.localize_particle_filter(
        im, biased, gyro, points, masks, map_cfg,
        pf.PFConfig(n_particles=args.particles), x0=gt[0])
    err = np.linalg.norm(np.asarray(poses)[:, :2] - np.asarray(gt)[:, :2],
                         axis=1)

    print(f"dead reckoning (bias {args.encoder_bias}): "
          f"mean {err_odo.mean():.3f} m, final {err_odo[-1]:.3f} m")
    print(f"particle filter ({args.particles} particles): "
          f"mean {err.mean():.3f} m, final {err[-1]:.3f} m, "
          f"{int(np.asarray(aux['resampled']).sum())} resamples")
