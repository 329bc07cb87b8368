"""Pose-graph LM benchmark on the default device at dataset-20 scale.

Builds a 4,956-pose chain graph with ~495 gated loop closures from
synthetic scan-matching-quality poses and times the full LM solve.
Run as the only process on the device:  python tools/lm_bench.py
"""

import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lidar_slam.config import PoseGraphConfig
from lidar_slam.models import pose_graph
from lidar_slam.utils import se2


def log(m):
    print(m, file=sys.stderr, flush=True)


def make_problem(seed, n=4956, interval=10):
    rng = np.random.default_rng(seed)
    # ground-truth smooth trajectory
    w = np.cumsum(rng.normal(0, 0.02, n))
    v = 0.12 + 0.05 * np.sin(np.arange(n) * 0.01)
    th = np.cumsum(w * 0.025)
    x = np.cumsum(v * np.cos(th) * 0.025)
    y = np.cumsum(v * np.sin(th) * 0.025)
    gt = np.stack([x, y, th], -1).astype(np.float32)

    T = se2.T_from_pose(jnp.asarray(gt))
    rel = se2.get_relative_pose(gt[:-1], gt[1:])
    rel_noisy = np.asarray(rel).copy()
    # noise on relative measurements (scan-matching quality)
    nz = rng.normal(0, [0.004, 0.004, 0.002], (n - 1, 3)).astype(np.float32)
    rel_noisy = np.asarray(se2.T_from_pose(
        se2.pose_from_T(jnp.asarray(rel_noisy)) + jnp.asarray(nz)))

    # integrate noisy chain for the init
    chain = se2.compose_chain(jnp.asarray(rel_noisy),
                              se2.T_from_pose(jnp.asarray(gt[0])))
    init = np.asarray(se2.pose_from_T(chain))

    cand = np.arange(0, n - interval - 1, interval, dtype=np.int32)
    loop_meas = se2.get_relative_pose(gt[cand], gt[cand + interval])
    lnz = rng.normal(0, [0.01, 0.01, 0.005], (len(cand), 3)).astype(np.float32)
    loop_meas = se2.T_from_pose(
        se2.pose_from_T(jnp.asarray(loop_meas)) + jnp.asarray(lnz))
    mask = jnp.asarray(rng.random(len(cand)) > 0.05)

    g = pose_graph.make_graph(jnp.asarray(rel_noisy), PoseGraphConfig(),
                              loop_i=jnp.asarray(cand),
                              loop_j=jnp.asarray(cand + interval),
                              loop_meas=loop_meas, loop_mask=mask)
    return jnp.asarray(init), g, gt


def main():
    cfg = PoseGraphConfig()
    from lidar_slam.utils.runtime import report_devices, use_compile_cache
    use_compile_cache()
    log(f"device: {report_devices()[0]}  cfg: max_lm={cfg.max_lm_iters} "
        f"cg={cfg.cg_iters}")
    warm = make_problem(0)
    timed = make_problem(1)

    def run(prob):
        init, g, gt = prob
        res = pose_graph.optimize_with_config(init, g, cfg)
        res.poses.block_until_ready()
        return res, gt

    t0 = time.time()
    res, _ = run(warm)
    log(f"warm-up (compile) {time.time()-t0:.1f}s  "
        f"iters={int(res.iterations)} cost={float(res.cost):.4f}")
    t0 = time.time()
    res, gt = run(timed)
    dt = time.time() - t0
    ate = float(jnp.sqrt(jnp.mean(
        (res.poses[:, :2] - jnp.asarray(gt[:, :2])) ** 2)))
    init_ate = float(jnp.sqrt(jnp.mean(
        (timed[0][:, :2] - jnp.asarray(gt[:, :2])) ** 2)))
    log(f"LM solve: {dt:.3f}s  iters={int(res.iterations)} "
        f"cost={float(res.cost):.4f}  ate {init_ate:.4f} -> {ate:.4f}")


if __name__ == "__main__":
    main()
