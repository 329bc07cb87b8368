"""Online (serving) mode benchmark: device-side cost per streamed scan.

Measures the jitted online_step at full scan size (1,081 rays, K=608,
map update included) with the whole stream inside ONE lax.scan dispatch —
the device-side per-step cost, without the host's per-step dispatch.

Run as the only process on the device:
    python tools/online_bench.py [--steps 256] [--reps 3]
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
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import jax
    from lidar_slam.utils.runtime import use_compile_cache
    use_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    from lidar_slam.config import SlamConfig
    from lidar_slam.models import online
    from lidar_slam.ops import scan as scan_ops
    from lidar_slam.utils import io

    cfg = SlamConfig()
    K = online.default_ray_cells(cfg)
    from lidar_slam.utils.runtime import report_devices
    log(f"device: {report_devices()[0]}, K = {K}")

    def prep(seed):
        data = io.synthetic_dataset(n_steps=args.steps + 1, seed=seed)
        counts = jnp.asarray(data["encoder"]["counts"], jnp.float32)
        gyro = jnp.asarray(data["imu"]["angular_velocity"], jnp.float32)
        ranges = jnp.asarray(data["lidar"]["ranges"], jnp.float32)
        points, masks = scan_ops.scans_to_points(ranges, 0.1, 30.0,
                                                 cfg.lidar)
        return counts, gyro, points, masks

    @jax.jit
    def stream(state, counts, gyro, points, masks):
        def step(st, inp):
            c, g, p, m = inp
            return online.online_step(st, c, g, p, m, cfg, K=K), None

        st, _ = jax.lax.scan(step, state,
                             (counts[1:], gyro[1:], points[1:], masks[1:]))
        return st

    times = []
    for rep in range(args.reps + 1):
        counts, gyro, points, masks = prep(40 + rep)
        st = online.init_state(points[0], masks[0], cfg, n_max=args.steps + 1,
                               K=K)
        jax.block_until_ready((counts, points, st.logodds))
        t0 = time.time()
        st = stream(st, counts, gyro, points, masks)
        st.pose.block_until_ready()
        dt = time.time() - t0
        label = "warm-up (compile)" if rep == 0 else f"rep {rep}"
        log(f"{label}: {args.steps} steps in {dt:.3f}s "
            f"({dt / args.steps * 1e3:.2f} ms/step, "
            f"{args.steps / dt:.0f} Hz)")
        if rep:
            times.append(dt)
    best = min(times)
    log(f"best: {best / args.steps * 1e3:.2f} ms/step = "
        f"{args.steps / best:.0f} Hz ({args.steps / best / 40:.1f}x the "
        "40 Hz sensor)")


if __name__ == "__main__":
    main()
