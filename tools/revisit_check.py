"""Validation harness for proximity loop-closure detection.

Builds a synthetic revisit scene — a full circle driven back to its start
inside the raycast room, with a 3% gyro-scale bias so the estimated
trajectory drifts — and compares mode="gtsam" runs with the reference's
fixed-interval proposer vs the proximity proposer (+ robust loss).

Usage: python tools/revisit_check.py [n_steps] [laps]
       python tools/revisit_check.py --reverse [n_lap]
Prints proposal/acceptance stats, the ICP-error separation between true
and aliased pairs, and final ATE per configuration. --reverse runs the
OPPOSITE-HEADING benchmark instead (drive a circle, turn around, retrace
it backwards): fixed-interval vs prior-seeded trimmed proximity closures,
scored by cross-lap consistency (the gauge-free map-ghosting metric).
"""
import sys

import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np

sys.path.insert(0, ".")
from lidar_slam.config import (IcpConfig, LidarConfig, MapConfig,
                               PoseGraphConfig, SlamConfig)
from lidar_slam.models import slam
from lidar_slam.utils import io
from lidar_slam.utils.runtime import use_compile_cache


def revisit_scene(n_steps=360, n_rays=541, gyro_scale=0.97, seed=7, laps=1):
    """The shared revisit scene (io.synthetic_revisit_dataset) unpacked to
    (counts, gyro, ranges, gt)."""
    d = io.synthetic_revisit_dataset(n_steps=n_steps, n_rays=n_rays,
                                     gyro_scale=gyro_scale, seed=seed,
                                     laps=laps)
    return (d["encoder"]["counts"], d["imu"]["angular_velocity"],
            d["lidar"]["ranges"], d["ground_truth"])


def ate(poses, gt):
    return float(np.linalg.norm(poses[:, :2] - gt[:, :2], axis=1).mean())


def main_reverse():
    import dataclasses

    import jax.numpy as jnp
    from lidar_slam.utils import se2

    n_lap = int(sys.argv[2]) if len(sys.argv) > 2 else 360
    d = io.synthetic_reverse_lap_dataset(n_lap=n_lap)
    gt = d["ground_truth"]
    cfg0 = SlamConfig(lidar=LidarConfig(n_rays=d["lidar"]["ranges"].shape[1]),
                      icp=IcpConfig(epsilon=0.001))

    cj = np.arange(n_lap + 40, 2 * n_lap + 20, 20)
    ci = np.array([int(np.argmin(np.linalg.norm(
        gt[:n_lap, :2] - gt[j, :2], axis=1))) for j in cj])
    ctrue = np.asarray(se2.get_relative_pose(jnp.asarray(gt)[ci],
                                             jnp.asarray(gt)[cj]))

    def consistency(p):
        p = jnp.asarray(np.asarray(p))
        r = np.asarray(se2.get_relative_pose(p[ci], p[cj]))
        return float(np.mean(np.linalg.norm(
            r[:, :2, 2] - ctrue[:, :2, 2], axis=1)))

    variants = {
        "fixed": PoseGraphConfig(max_lm_iters=40),
        "proximity-seeded": PoseGraphConfig(
            max_lm_iters=40, loop_proposer="proximity",
            proximity_seed="estimate", proximity_trim=0.55,
            proximity_radius=2.0, robust_loss="huber"),
    }
    for name, pg in variants.items():
        res = slam.run_slam(
            d["encoder"]["counts"], d["imu"]["angular_velocity"],
            d["lidar"]["ranges"], 0.1, 30.0, mode="gtsam",
            fixed_interval=10,
            cfg=dataclasses.replace(cfg0, pose_graph=pg),
            build_map=False, chunk_size=16)
        print(f"[{name:16s}] loops={res.n_loop_closures:3d} "
              f"ate_sm={ate(res.poses_scan_matching, gt):.3f} "
              f"ate_opt={ate(res.poses_optimized, gt):.3f} "
              f"cross-lap consistency: sm "
              f"{consistency(res.poses_scan_matching)*100:.1f} cm -> opt "
              f"{consistency(res.poses_optimized)*100:.1f} cm")


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--reverse":
        return main_reverse()
    n_steps = int(sys.argv[1]) if len(sys.argv) > 1 else 360
    laps = int(sys.argv[2]) if len(sys.argv) > 2 else 1
    counts, gyro, ranges, gt = revisit_scene(n_steps, laps=laps)

    base_pg = PoseGraphConfig(max_lm_iters=30)
    cfg0 = SlamConfig(
        lidar=LidarConfig(n_rays=ranges.shape[1]),
        map=MapConfig(resolution=0.1, world_max_x=15, world_min_x=-15,
                      world_max_y=15, world_min_y=-15),
        icp=IcpConfig(epsilon=0.001),
        pose_graph=base_pg,
    )

    import dataclasses
    variants = {
        "fixed": base_pg,
        "proximity": dataclasses.replace(
            base_pg, loop_proposer="proximity", proximity_radius=1.0),
        "descriptor": dataclasses.replace(
            base_pg, loop_proposer="descriptor"),
        "descriptor+huber": dataclasses.replace(
            base_pg, loop_proposer="descriptor", robust_loss="huber"),
    }

    for name, pg in variants.items():
        cfg = dataclasses.replace(cfg0, pose_graph=pg)
        res = slam.run_slam(counts, gyro, ranges, 0.1, 30.0, mode="gtsam",
                            fixed_interval=10, cfg=cfg, build_map=False,
                            chunk_size=16)
        print(f"[{name:16s}] loops={res.n_loop_closures:3d} "
              f"ate_odom={ate(res.poses_odom, gt):.3f} "
              f"ate_sm={ate(res.poses_scan_matching, gt):.3f} "
              f"ate_opt={ate(res.poses_optimized, gt):.3f}")

    # error-separation diagnostics on the proximity proposals
    import jax.numpy as jnp
    from lidar_slam.ops import icp as icp_ops
    from lidar_slam.ops import scan as scan_ops
    from lidar_slam.models import odometry, scan_matching

    points, masks = scan_ops.scans_to_points(
        jnp.asarray(ranges), 0.1, 30.0, cfg0.lidar)
    poses_odom = odometry.poses_from_odometry(
        jnp.asarray(counts), jnp.asarray(gyro), dt=cfg0.robot.dt)
    sm = scan_matching.poses_from_scan_matching(
        poses_odom, points, masks, cfg0.icp, chunk_size=16)
    proposers = {
        "proximity": slam.proximity_loop_candidates(
            np.asarray(sm.poses), min_gap=100, radius=1.0,
            max_candidates=256, suppress_window=20),
        "descriptor": slam.descriptor_loop_candidates(
            ranges, masks, 0.1, 30.0, min_gap=100),
    }
    pts3 = icp_ops.lift_to_3d(points)
    for name, (pli, plj) in proposers.items():
        print(f"{name} proposals: {pli.size}")
        if not pli.size:
            continue
        pT, pacc, perr, _ = slam.compute_loop_closures_pairs(
            pts3, masks, jnp.asarray(pli), jnp.asarray(plj), 5.0, 0.0,
            chunk_size=16, gate_yaw=False)
        perr = np.asarray(perr)
        pacc = np.asarray(pacc) & (perr < 1e-4)
        keep = slam.suppress_verified_pairs(pli, plj, perr, pacc, 20)
        true_d = np.linalg.norm(gt[pli, :2] - gt[plj, :2], axis=1)
        for m in range(pli.size):
            tag = "TRUE " if true_d[m] < 1.0 else "FALSE"
            st = "KEEP" if keep[m] else ("acc" if pacc[m] else "rej")
            print(f"  ({int(pli[m]):3d},{int(plj[m]):3d}) {tag} "
                  f"gt_dist={true_d[m]:.2f} icp_err={perr[m]:.2e} {st}")


if __name__ == "__main__":
    use_compile_cache()
    main()
