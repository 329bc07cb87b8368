import numpy as np
import jax.numpy as jnp

from lidar_slam.config import IcpConfig, LidarConfig
from lidar_slam.models import odometry, scan_matching
from lidar_slam.ops import scan as scan_ops
from lidar_slam.utils import io, se2
from tests.test_icp import _np_icp


def _se2_of(T3):
    out = np.eye(3)
    out[:2, :2] = T3[:2, :2]
    out[:2, 2] = T3[:2, 3]
    return out


def test_matches_sequential_reference_spec():
    """Step-exact agreement with a sequential numpy/KDTree model of the
    reference stage (spec: modules/localization.py:95-134)."""
    rng = np.random.default_rng(0)
    n, P = 8, 120
    # ground-truth trajectory + world landmarks observed from each pose
    gt = np.cumsum(rng.normal(0, 0.05, (n, 3)), axis=0)
    world = rng.uniform(-4, 4, (400, 2))

    scans = []
    for i in range(n):
        c, s = np.cos(gt[i, 2]), np.sin(gt[i, 2])
        Rinv = np.array([[c, s], [-s, c]])
        local = (world - gt[i, :2]) @ Rinv.T
        idx = rng.choice(400, P, replace=False)
        scans.append(local[idx])
    scans = np.stack(scans)

    odom = gt + rng.normal(0, 0.01, gt.shape)  # noisy odometry
    masks = np.ones((n, P), bool)

    res = scan_matching.poses_from_scan_matching(
        jnp.asarray(odom), jnp.asarray(scans), jnp.asarray(masks),
        IcpConfig(epsilon=0.001), chunk_size=4)

    # sequential spec
    poses = [np.zeros(3)]
    chain = np.eye(3)
    rels = []
    for i in range(1, n):
        T_init = np.asarray(se2.get_relative_pose(jnp.asarray(odom[i - 1]),
                                                  jnp.asarray(odom[i])))
        T_init3 = np.eye(4)
        T_init3[:2, :2] = T_init[:2, :2]
        T_init3[:2, 3] = T_init[:2, 2]
        src = np.hstack([scans[i], np.zeros((P, 1))])
        tgt = np.hstack([scans[i - 1], np.zeros((P, 1))])
        T_icp, _, _ = _np_icp(src, tgt, T_init3, 0.001, 2000, 1e-4, False)
        rel = _se2_of(T_icp)
        rels.append(rel)
        chain = chain @ rel
        poses.append(np.array([chain[0, 2], chain[1, 2],
                               np.arctan2(chain[1, 0], chain[0, 0])]))

    np.testing.assert_allclose(np.asarray(res.relative_poses), np.stack(rels),
                               atol=1e-7)
    np.testing.assert_allclose(np.asarray(res.poses), np.stack(poses), atol=1e-6)


def test_improves_over_odometry_on_synthetic_world():
    data = io.synthetic_dataset(n_steps=60, n_rays=541, seed=11)
    cfg = LidarConfig(n_rays=541)
    pts, mask = scan_ops.scans_to_points(
        jnp.asarray(data["lidar"]["ranges"]), 0.1, 30.0, cfg)
    gt = data["ground_truth"]
    # corrupt odometry with a strong random walk; scan matching must pull the
    # trajectory back toward ground truth. NB point-to-point ICP at 0.5 deg
    # ray spacing has a known per-step rotation bias (NN snapping), identical
    # to the reference algorithm — so the corruption must dominate that bias.
    rng = np.random.default_rng(0)
    odom = gt + np.cumsum(rng.normal(0, 0.05, gt.shape), axis=0)

    res = scan_matching.poses_from_scan_matching(
        jnp.asarray(odom), pts, mask, IcpConfig(epsilon=0.001), chunk_size=16)
    refined = np.asarray(res.poses)

    err_odom = np.linalg.norm(odom[:, :2] - gt[:, :2], axis=1).mean()
    err_ref = np.linalg.norm(refined[:, :2] - gt[:, :2], axis=1).mean()
    assert np.isfinite(refined).all()
    assert err_ref < err_odom  # scan matching beats corrupted odometry
    assert res.poses.shape == (60, 3)
    assert res.relative_poses.shape == (59, 3, 3)


def test_chunk_size_invariance():
    """Results must not depend on the chunk partitioning."""
    rng = np.random.default_rng(1)
    n, P = 7, 60
    gt = np.cumsum(rng.normal(0, 0.05, (n, 3)), axis=0)
    world = rng.uniform(-3, 3, (300, 2))
    scans = []
    for i in range(n):
        c, s = np.cos(gt[i, 2]), np.sin(gt[i, 2])
        local = (world - gt[i, :2]) @ np.array([[c, s], [-s, c]]).T
        scans.append(local[rng.choice(300, P, replace=False)])
    scans = jnp.asarray(np.stack(scans))
    masks = jnp.ones((n, P), bool)
    odom = jnp.asarray(gt)

    r1 = scan_matching.poses_from_scan_matching(odom, scans, masks, chunk_size=2)
    r2 = scan_matching.poses_from_scan_matching(odom, scans, masks, chunk_size=6)
    np.testing.assert_allclose(np.asarray(r1.poses), np.asarray(r2.poses),
                               atol=1e-9)


def test_phased_schedule_matches_chunked():
    """The phased-resort schedule is a pure re-scheduling: per-pair
    transforms, errors, and iteration counts must match the plain chunked
    schedule exactly (scan_matching.icp_all_pairs docstring contract)."""
    from lidar_slam.ops import icp as icp_ops

    rng = np.random.default_rng(3)
    B, P = 21, 96  # deliberately NOT a multiple of the chunk size
    tgt = rng.uniform(-3, 3, (B, P, 2))
    ang = rng.normal(0, 0.15, B)
    off = rng.normal(0, 0.1, (B, 2))
    src = np.stack([
        tgt[i] @ np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]).T
        + o for i, (a, o) in enumerate(zip(ang, off))])
    src3 = np.asarray(icp_ops.lift_to_3d(jnp.asarray(src)))
    tgt3 = np.asarray(icp_ops.lift_to_3d(jnp.asarray(tgt)))
    masks = rng.random((B, P)) > 0.05
    init = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))

    outs = {}
    for schedule in ("chunked", "phased"):
        T, err, iters = scan_matching.icp_all_pairs(
            jnp.asarray(src3, jnp.float32), jnp.asarray(tgt3, jnp.float32),
            jnp.asarray(masks), jnp.asarray(masks), jnp.asarray(init),
            epsilon=1e-6, max_iters=60, chunk_size=8, planar=True,
            schedule=schedule)
        outs[schedule] = (np.asarray(T), np.asarray(err), np.asarray(iters))

    np.testing.assert_array_equal(outs["chunked"][2], outs["phased"][2])
    np.testing.assert_allclose(outs["chunked"][0], outs["phased"][0],
                               rtol=0, atol=0)
    np.testing.assert_allclose(outs["chunked"][1], outs["phased"][1],
                               rtol=0, atol=0)


def test_cumsum_partition_equals_argsort():
    """partition="cumsum" builds the IDENTICAL live-first permutation as
    the stable argsort, so every output (poses, errors, iteration counts)
    must match exactly."""
    import numpy as np

    from lidar_slam.config import IcpConfig, LidarConfig
    from lidar_slam.models import scan_matching
    from lidar_slam.ops import scan as scan_ops
    from lidar_slam.utils import io

    data = io.synthetic_dataset(n_steps=90, n_rays=121, seed=11)
    points, masks = scan_ops.scans_to_points(
        jnp.asarray(data["lidar"]["ranges"], jnp.float32), 0.1, 30.0,
        LidarConfig())
    poses = jnp.asarray(data["ground_truth"], jnp.float32)
    a = scan_matching.poses_from_scan_matching(
        poses, points, masks, IcpConfig(), chunk_size=16)
    b = scan_matching.poses_from_scan_matching(
        poses, points, masks, IcpConfig(), chunk_size=16,
        partition="cumsum")
    np.testing.assert_array_equal(np.asarray(a.poses), np.asarray(b.poses))
    np.testing.assert_array_equal(np.asarray(a.errors), np.asarray(b.errors))
    np.testing.assert_array_equal(np.asarray(a.iters), np.asarray(b.iters))
    assert int(jnp.max(a.iters)) > 1  # the phased path actually re-sorted


def test_point_to_line_metric_cuts_drift():
    """PLICP vs the reference point metric on a synthetic log: the
    point-to-point nearest-SAMPLE bias accumulates into meters of drift;
    the line metric tracks ground truth 10x+ closer with fewer
    iterations (full-scale numbers in PERF.md: 1.21 -> 0.027 m and
    2.20 -> 0.018 m at 360 steps)."""
    import numpy as np

    from lidar_slam.config import IcpConfig, LidarConfig
    from lidar_slam.models import odometry
    from lidar_slam.ops import scan as scan_ops
    from lidar_slam.utils import io

    d = io.synthetic_dataset(n_steps=120, n_rays=271, seed=3)
    gt = d["ground_truth"]
    points, masks = scan_ops.scans_to_points(
        jnp.asarray(d["lidar"]["ranges"]), 0.1, 30.0,
        LidarConfig(n_rays=271))
    poses_odom = odometry.poses_from_odometry(
        jnp.asarray(d["encoder"]["counts"], jnp.float32),
        jnp.asarray(d["imu"]["angular_velocity"], jnp.float32))

    ate = {}
    iters = {}
    for metric in ("point", "point_to_line"):
        sm = scan_matching.poses_from_scan_matching(
            poses_odom, points, masks,
            IcpConfig(epsilon=0.001, metric=metric), chunk_size=8)
        est = np.asarray(sm.poses)
        ate[metric] = float(np.linalg.norm(est[:, :2] - gt[:, :2],
                                           axis=1).mean())
        iters[metric] = float(np.asarray(sm.iters).mean())
    assert ate["point_to_line"] < ate["point"] / 5, (ate, iters)
    assert ate["point_to_line"] < 0.05, ate
