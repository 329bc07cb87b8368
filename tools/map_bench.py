"""Map-build benchmark: the compacted vs the dense XLA scatter.

Dataset-20 shapes (4,956 scans x 1,081 rays on the 1201 x 1201 grid).
Warm-up and timed runs use different data values, and the two maps are
compared cell by cell.

    python tools/map_bench.py [n_steps]
"""

import os
import sys
import time

import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lidar_slam.config import SlamConfig  # noqa: E402
from lidar_slam.models import occupancy, odometry  # noqa: E402
from lidar_slam.ops import scan as scan_ops  # noqa: E402
from lidar_slam.utils import io  # noqa: E402
from lidar_slam.utils.runtime import (report_devices,  # noqa: E402
                                      use_compile_cache)


def log(m):
    print(m, file=sys.stderr, flush=True)


def main():
    n_steps = int(sys.argv[1]) if len(sys.argv) > 1 else 4956
    cfg = SlamConfig()
    use_compile_cache()
    report_devices()

    def prep(seed):
        data = io.synthetic_dataset(n_steps=n_steps, n_rays=1081, seed=seed)
        counts = jnp.asarray(data["encoder"]["counts"], jnp.float32)
        gyro = jnp.asarray(data["imu"]["angular_velocity"], jnp.float32)
        ranges = jnp.asarray(data["lidar"]["ranges"], jnp.float32)
        points, masks = scan_ops.scans_to_points(ranges, 0.1, 30.0, cfg.lidar)
        poses = odometry.poses_from_odometry(counts, gyro)
        return poses, points, masks

    warm = prep(20)
    timed = prep(21)
    K = max(occupancy.adaptive_ray_cells(warm[1], warm[2], cfg.map, 30.0),
            occupancy.adaptive_ray_cells(timed[1], timed[2], cfg.map, 30.0))
    cells = n_steps * 1081 * K  # (ray, slot) pairs the dense scatter visits
    log(f"K = {K}")

    def run(compact, name):
        t0 = time.time()
        occupancy.build_logodds(*warm, cfg.map, K,
                                compact=compact).block_until_ready()
        log(f"{name}: warm-up (compile) {time.time()-t0:.1f}s")
        t0 = time.time()
        g = occupancy.build_logodds(*timed, cfg.map, K, compact=compact)
        g.block_until_ready()
        dt = time.time() - t0
        log(f"{name}: {dt:.3f}s = {dt/n_steps*1e3:.4f} ms/scan, "
            f"{cells/dt:.4g} ray-slots/s")
        return g

    g_c = run(True, "compact scatter")
    g_d = run(False, "dense scatter")
    log(f"max |compact - dense| = {float(jnp.abs(g_c - g_d).max()):.2e}")
    u_c = np.asarray(occupancy.finalize_grid(g_c))
    u_d = np.asarray(occupancy.finalize_grid(g_d))
    log(f"uint8 maps equal: {bool((u_c == u_d).all())}")


if __name__ == "__main__":
    main()
