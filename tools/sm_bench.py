"""Scan-matching stage benchmark on the default device at dataset-20 scale.

Dependency-chained reps (each rep's input is perturbed by the previous
rep's output) so the runtime's value memoization cannot shortcut.

    python tools/sm_bench.py [chunk ...] [argsort|cumsum ...] \
                             [point|point_to_line ...] [scans=N]

Bare args combine as a product: chunk sizes (ints), phased-resort
partition names, and ICP metrics (PLICP = point_to_line).
"""

import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lidar_slam.config import SlamConfig
from lidar_slam.models import odometry, scan_matching
from lidar_slam.ops import scan as scan_ops
from lidar_slam.utils import io


def log(m):
    print(m, file=sys.stderr, flush=True)


def main():
    args = [a for a in sys.argv[1:]]
    partitions = [a for a in args if a in ("argsort", "cumsum")]
    metrics = [a for a in args if a in ("point", "point_to_line")]
    # carry-idx A/B (round 5): "noidx" = production default (correspondence
    # indices dropped from the phased carry), "idx" = round-4 baseline
    carries = [a for a in args if a in ("idx", "noidx")]
    n_steps = 4956
    scans_args = [a for a in args if a.startswith("scans=")]
    if scans_args:
        n_steps = int(scans_args[-1].split("=")[1])
    chunks = [int(c) for c in args if c.isdigit()] or [64]
    partitions = partitions or ["argsort"]
    metrics = metrics or ["point"]
    carries = carries or ["noidx"]
    cfg = SlamConfig()
    from lidar_slam.utils.runtime import report_devices, use_compile_cache
    use_compile_cache()
    log(f"device: {report_devices()[0]}")

    data = io.synthetic_dataset(n_steps=n_steps, n_rays=1081, seed=20)
    counts = jnp.asarray(data["encoder"]["counts"], jnp.float32)
    gyro = jnp.asarray(data["imu"]["angular_velocity"], jnp.float32)
    ranges = jnp.asarray(data["lidar"]["ranges"], jnp.float32)
    points, masks = scan_ops.scans_to_points(ranges, 0.1, 30.0, cfg.lidar)
    poses = odometry.poses_from_odometry(counts, gyro)

    import dataclasses
    import itertools
    for chunk, part, metric, cidx in itertools.product(
            chunks, partitions, metrics, carries):
        icp_cfg = dataclasses.replace(cfg.icp, metric=metric)

        def run(p):
            sm = scan_matching.poses_from_scan_matching(
                p, points, masks, icp_cfg, chunk_size=chunk,
                partition=part, carry_idx=(cidx == "idx"))
            return sm

        t0 = time.time()
        sm = run(poses)
        np.asarray(sm.poses)
        log(f"chunk={chunk} partition={part} metric={metric} carry={cidx}: "
            f"warm-up {time.time()-t0:.1f}s "
            f"(iters mean {float(jnp.mean(sm.iters)):.1f} "
            f"max {int(jnp.max(sm.iters))})")
        # FRESH-VALUE throwaway: the first fresh execution after the
        # warm-up can pay a one-time load cost, which must not land in
        # the first configuration's time
        sm = run(poses + 1e-7 * sm.poses)
        np.asarray(sm.poses)
        reps = 3
        p = poses
        t0 = time.time()
        for _ in range(reps):
            # dependency chain: tiny perturbation from previous output
            p = poses + 1e-7 * sm.poses
            sm = run(p)
        np.asarray(sm.poses)
        dt = (time.time() - t0) / reps
        log(f"chunk={chunk} partition={part} metric={metric} carry={cidx}: "
            f"{dt:.3f}s per run "
            f"(iters mean {float(jnp.mean(sm.iters)):.1f})")


if __name__ == "__main__":
    main()
