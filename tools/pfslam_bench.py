"""Particle-filter SLAM benchmark: device-side cost per step.

slam_particle_filter runs the whole stream inside ONE lax.scan dispatch
(models/pf_slam.py), so the measured per-step cost is what a
directly-attached host would see. Per step the filter pays the PF
scoring (P x R endpoint gathers) PLUS the per-scan map update (the same
compacted scatter as the online ICP mode) and a (W, H) threshold pass for
the score image.

Run as the only process on the device:
    python tools/pfslam_bench.py [--steps 256] [--particles 256] [--reps 3]
"""

import argparse
import sys
import time

sys.path.insert(0, ".")


def log(m):
    print(m, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--rays", type=int, default=1081)
    ap.add_argument("--particles", type=int, default=256)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import jax
    from lidar_slam.utils.runtime import use_compile_cache
    use_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    from lidar_slam.config import LidarConfig, MapConfig
    from lidar_slam.models import occupancy, pf_slam
    from lidar_slam.models import particle_filter as pf
    from lidar_slam.ops import scan as scan_ops
    from lidar_slam.utils import io
    from lidar_slam.utils.runtime import report_devices

    log(f"device: {report_devices()[0]}")
    map_cfg = MapConfig()  # full 1201x1201 production grid
    cfg = pf.PFConfig(n_particles=args.particles)

    def prep(seed):
        data = io.synthetic_dataset(n_steps=args.steps, n_rays=args.rays,
                                    seed=seed)
        gt = jnp.asarray(data["ground_truth"], jnp.float32)
        counts = jnp.asarray(data["encoder"]["counts"], jnp.float32)
        gyro = jnp.asarray(data["imu"]["angular_velocity"], jnp.float32)
        points, masks = scan_ops.scans_to_points(
            jnp.asarray(data["lidar"]["ranges"], jnp.float32), 0.1, 30.0,
            LidarConfig())
        K = int(occupancy.adaptive_ray_cells(points, masks, map_cfg, 30.0))
        return counts, gyro, points[..., :2], masks, gt, K

    # compile + warm on one seed; time on fresh seeds (the runtime
    # memoizes value-identical computations). K is data-dependent — pin
    # the warm-up seed's K for every rep so a single compiled program is
    # measured (the bench harness does the same for the map stage).
    counts, gyro, pts, masks, gt, K = prep(0)
    t0 = time.time()
    poses, lo, _ = pf_slam.slam_particle_filter(counts, gyro, pts, masks,
                                                map_cfg, cfg, x0=gt[0], K=K)
    np.asarray(poses[:1]); np.asarray(lo[:1, :1])
    log(f"compile+first run: {time.time() - t0:.1f}s (K={K})")

    times = []
    for rep in range(1, args.reps + 1):
        counts, gyro, pts, masks, gt, _ = prep(rep)
        jax.block_until_ready((counts, gyro, pts, masks, gt))
        t0 = time.time()
        poses, lo, _ = pf_slam.slam_particle_filter(
            counts, gyro, pts, masks, map_cfg, cfg, x0=gt[0], K=K)
        np.asarray(poses[:1]); np.asarray(lo[:1, :1])
        dt = time.time() - t0
        times.append(dt)
        log(f"rep {rep}: {dt:.3f}s "
            f"({dt / args.steps * 1e3:.2f} ms/step, "
            f"{args.steps / dt:.0f} Hz at P={args.particles})")
    best = min(times)
    log(f"best: {best / args.steps * 1e3:.2f} ms/step = "
        f"{args.steps / best:.0f} Hz")


if __name__ == "__main__":
    main()
