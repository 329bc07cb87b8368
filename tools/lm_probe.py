"""Per-iteration LM convergence probe on the bench's real pose-graph input.

Reconstructs the exact pose-graph problem bench.py's stage pass solves
(odometry -> scan matching -> loop closures on a dataset-20-shaped
synthetic seed), runs the traced LM solve, and prints the cost / lambda /
stall trajectory — the data needed to tell slow convergence, step
rejection ping-pong, and stall-exit padding apart.

Run as the only process on the device:  python tools/lm_probe.py [--seed 25]
"""

import argparse
import sys
import time

sys.path.insert(0, ".")


def log(m):
    print(m, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=25)
    ap.add_argument("--steps", type=int, default=4956)
    ap.add_argument("--rays", type=int, default=1081)
    args = ap.parse_args()

    import jax
    from lidar_slam.utils.runtime import use_compile_cache
    use_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    from lidar_slam.config import SlamConfig
    from lidar_slam.models import odometry, pose_graph, scan_matching
    from lidar_slam.models.slam import (compute_loop_closures,
                                        loop_closure_candidates)
    from lidar_slam.ops import icp as icp_ops
    from lidar_slam.ops import scan as scan_ops
    from lidar_slam.utils import io

    cfg = SlamConfig()
    from lidar_slam.utils.runtime import report_devices
    log(f"device: {report_devices()[0]}")
    data = io.synthetic_dataset(n_steps=args.steps, n_rays=args.rays,
                                seed=args.seed)
    counts = jnp.asarray(data["encoder"]["counts"], jnp.float32)
    gyro = jnp.asarray(data["imu"]["angular_velocity"], jnp.float32)
    ranges = jnp.asarray(data["lidar"]["ranges"], jnp.float32)
    points, masks = scan_ops.scans_to_points(ranges, 0.1, 30.0, cfg.lidar)
    pts3 = icp_ops.lift_to_3d(points)
    cand = loop_closure_candidates(args.steps, 10)

    log("running odometry + scan matching + loop closures...")
    poses_odom = odometry.poses_from_odometry(counts, gyro)
    sm = scan_matching.poses_from_scan_matching(poses_odom, points, masks,
                                                cfg.icp, chunk_size=64)
    max_d, max_y = odometry.max_step_gates(counts, gyro)
    loop_T, accept, _, _ = compute_loop_closures(pts3, masks, cand, 10,
                                                 max_d, max_y, chunk_size=64)
    g = pose_graph.make_graph(sm.relative_poses, cfg.pose_graph,
                              loop_i=jnp.asarray(cand),
                              loop_j=jnp.asarray(cand + 10),
                              loop_meas=loop_T, loop_mask=accept)
    pg = cfg.pose_graph

    def solve():
        return pose_graph._optimize_jit(
            sm.poses, g, max_iters=pg.max_lm_iters,
            lambda_init=pg.lambda_init, lambda_up=pg.lambda_up,
            lambda_down=pg.lambda_down, cg_iters=pg.cg_iters,
            cg_tol=pg.cg_tol, cost_rtol=pg.cost_rtol, solver=pg.solver,
            band=pg.fixed_interval, trace=True)

    t0 = time.time()
    res, hist = solve()
    res.poses.block_until_ready()
    np.asarray(res.poses[:1])
    log(f"traced solve (incl. compile): {time.time() - t0:.1f}s  "
        f"iters={int(res.iterations)}  cost={float(res.cost):.6f}  "
        f"final_lambda={float(res.final_lambda):.2e}")

    ran = np.asarray(hist["ran"])
    cost = np.asarray(hist["cost"], np.float64)
    lam = np.asarray(hist["lambda"], np.float64)
    stalls = np.asarray(hist["stalls"])
    c_prev = None
    for i in range(int(ran.sum())):
        rel = "" if c_prev is None else f"  rel_drop={(c_prev - cost[i]) / max(c_prev, 1.0):.3e}"
        # lambda_down on accept, lambda_up on reject; iteration 0 compares
        # against the configured lambda_init (lam[-1] would wrap around)
        lam_before = pg.lambda_init if c_prev is None else lam[i - 1]
        verdict = "accept" if lam[i] < lam_before else "REJECT"
        log(f"iter {i:2d}: cost={cost[i]:.9f}  lambda={lam[i]:.2e}  "
            f"stalls={int(stalls[i])}  {verdict}{rel}")
        c_prev = cost[i]

if __name__ == "__main__":
    main()
