"""Particle-filter localization benchmark: device-side cost per step.

localize_particle_filter runs the whole stream inside ONE lax.scan
dispatch (models/particle_filter.py), so the measured per-step cost is
what a directly-attached host would see. Scoring is the hot op: P
particles x 1,081 endpoint gathers per step.

Run as the only process on the device:
    python tools/pf_bench.py [--steps 256] [--particles 256] [--reps 3]
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
    from lidar_slam.models import occupancy
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
        K = occupancy.adaptive_ray_cells(points, masks, map_cfg, 30.0)
        logodds = occupancy.build_logodds(gt, points, masks, map_cfg, K)
        im = (logodds > 0).astype(jnp.float32)
        return im, counts, gyro, points, masks, gt

    # compile + warm on one seed; time on fresh seeds (the runtime
    # memoizes value-identical computations)
    im, counts, gyro, points, masks, gt = prep(0)
    t0 = time.time()
    poses, _ = pf.localize_particle_filter(im, counts, gyro, points, masks,
                                           map_cfg, cfg, x0=gt[0])
    np.asarray(poses[:1])
    log(f"compile+first run: {time.time() - t0:.1f}s")

    times = []
    for rep in range(1, args.reps + 1):
        im, counts, gyro, points, masks, gt = prep(rep)
        jax.block_until_ready((im, counts, gyro, points, masks, gt))
        t0 = time.time()
        poses, _ = pf.localize_particle_filter(im, counts, gyro, points,
                                               masks, map_cfg, cfg,
                                               x0=gt[0])
        np.asarray(poses[:1])
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
