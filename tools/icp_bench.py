"""ICP kernel times at scan width on the default device.

Times, at one scan-matching chunk (64 pairs x 1,081 x 1,081 points):
  - the jnp nearest-neighbour argmin (ops/nn.py), which writes the
    (64, 1081, 1081) float32 distance tensor (299 MB) per call;
  - one whole planar ICP iteration (NN + gather + closed-form Kabsch);
and checks the non-planar path's batched 3x3 SVD Kabsch (ops/kabsch.py,
cuSOLVER on a GPU) against NumPy's SVD on 4,096 random problems.

    python tools/icp_bench.py [--reps 20]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(m):
    print(m, file=sys.stderr, flush=True)


def timed(fn, inputs):
    """Best wall time of fn over distinct inputs, after one warm-up call."""
    import jax

    jax.block_until_ready(fn(*inputs[0]))
    best = np.inf
    for args in inputs[1:]:
        jax.block_until_ready(args)
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from lidar_slam.ops import icp, kabsch, nn
    from lidar_slam.utils.runtime import (gpu_name_and_power_limit,
                                          report_devices, use_compile_cache)

    use_compile_cache()
    report_devices()
    log(f"card: {gpu_name_and_power_limit()}")
    B, P = 64, 1081
    rng = np.random.default_rng(0)

    def problem(i):
        ang = np.linspace(-0.75 * np.pi, 0.75 * np.pi, P)
        r = 2.0 + 8.0 * rng.random((B, P))
        tgt = np.stack([r * np.cos(ang), r * np.sin(ang), 0 * r], -1)
        src = tgt + rng.normal(0, 0.02, tgt.shape) * [1, 1, 0]
        mask = rng.random((B, P)) > 0.05
        T = np.tile(np.eye(4), (B, 1, 1))
        return tuple(jnp.asarray(a, jnp.float32 if a.dtype == np.float64
                                 else None) for a in (src, tgt, mask, T))

    probs = [problem(i) for i in range(args.reps + 1)]
    nn_fn = jax.jit(nn.nearest_neighbors)
    t_nn = timed(lambda s, t, m, T: nn_fn(s, t, m), probs)
    step = jax.jit(lambda s, t, m, T: icp.icp_iteration(
        s, t, m, m, T, planar=True))
    t_it = timed(step, probs)
    log(f"NN argmin ({B} x {P} x {P}): {t_nn * 1e3:.4f} ms "
        f"({B * P * P * 4 / t_nn / 1e9:.1f} GB/s of distance tensor)")
    log(f"planar ICP iteration ({B} pairs): {t_it * 1e3:.4f} ms")

    # non-planar Kabsch: batched 3x3 SVDs vs NumPy
    n = 4096
    a = rng.normal(size=(n, 64, 3)).astype(np.float32)
    R_true = np.linalg.qr(rng.normal(size=(n, 3, 3)))[0]
    R_true *= np.sign(np.linalg.det(R_true))[:, None, None]
    b = (a @ np.swapaxes(R_true, 1, 2)).astype(np.float32)
    fit = jax.jit(kabsch.kabsch)
    T = np.asarray(fit(jnp.asarray(a), jnp.asarray(b)))
    err = float(np.abs(T[:, :3, :3] - R_true).max())
    t_k = timed(fit, [(jnp.asarray(a + 1e-6 * i), jnp.asarray(b))
                      for i in range(args.reps + 1)])
    log(f"kabsch ({n} batched 3x3 SVDs): {t_k * 1e3:.4f} ms, max |R - "
        f"R_true| {err:.2e}")
    if err > 1e-4:
        sys.exit(f"kabsch rotations off by {err:.2e}")


if __name__ == "__main__":
    main()
