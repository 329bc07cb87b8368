"""Warm-up-harness benchmark: the 24-yaw-seed global ICP sweep on device.

SURVEY.md section 3.5 calls the reference's warm-up evaluation
(code/icp_warm_up/test_icp.py: 24 independent ICP problems per cloud) the
natural batched-ICP benchmark. The reference runs the seeds sequentially
on the CPU; here the sweep is one batched run_icp_batch call (3-D clouds,
full SVD Kabsch — the non-planar path). Synthetic clouds stand in for the
.mat models, which are not shipped.

Run as the only process on the device:
    python tools/warmup_bench.py [--points 5000] [--seeds 24] [--reps 3]
"""

import argparse
import sys
import time

sys.path.insert(0, ".")


def log(m):
    print(m, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=5000)
    ap.add_argument("--seeds", type=int, default=24)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    from lidar_slam.utils.runtime import use_compile_cache
    use_compile_cache()
    import numpy as np

    from lidar_slam.models import warmup

    from lidar_slam.utils.runtime import report_devices
    log(f"device: {report_devices()[0]}")

    def make_cloud(seed):
        """The shared synthetic box-shell model (warmup.synthetic_model —
        ONE recipe for the CLI, tests, and this bench) plus a rigidly moved
        full copy. The copy is NOT subsampled like warmup.synthetic_pc:
        the bench times repeated sweeps at one shape, and a per-seed target
        size would recompile every rep."""
        pts = warmup.synthetic_model(args.points, seed)
        r = np.random.default_rng(seed + 1000)
        yaw = r.uniform(-np.pi, np.pi)
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        tgt = pts @ R.T + r.uniform(-0.1, 0.1, 3)
        return pts.astype(np.float32), tgt.astype(np.float32)

    # warm-up compile
    src, tgt = make_cloud(0)
    t0 = time.time()
    T, err, errs = warmup.best_icp_alignment(src, tgt, n_seeds=args.seeds)
    log(f"compile+first sweep: {time.time() - t0:.1f}s "
        f"(best err {err:.2e})")

    times = []
    for rep in range(1, args.reps + 1):
        src, tgt = make_cloud(rep)
        t0 = time.time()
        T, err, errs = warmup.best_icp_alignment(src, tgt,
                                                 n_seeds=args.seeds)
        dt = time.time() - t0
        times.append(dt)
        log(f"rep {rep}: {args.seeds}-seed sweep on {args.points}-pt "
            f"clouds in {dt:.3f}s (best err {err:.2e})")
    best = min(times)
    log(f"best: {best:.3f}s for {args.seeds} ICPs "
        f"({best / args.seeds * 1e3:.1f} ms/seed incl. dispatch)")


if __name__ == "__main__":
    main()
