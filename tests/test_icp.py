import numpy as np
import jax.numpy as jnp
import pytest

from lidar_slam.ops import icp as icp_ops
from lidar_slam.ops.kabsch import kabsch
from lidar_slam.ops.nn import nearest_neighbors


def _rot(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])


# ---------------------------------------------------------------------------
# independent numpy spec model of the reference ICP loop
# (spec: modules/icp.py:100-189), used for step-exact cross-checks
# ---------------------------------------------------------------------------

def _np_kabsch(A, B):
    ca, cb = A.mean(0), B.mean(0)
    S = (A - ca).T @ (B - cb)
    U, _, Vt = np.linalg.svd(S)
    V = Vt.T
    d = np.linalg.det(V @ U.T)
    R = V @ np.diag([1.0, 1.0, d]) @ U.T
    t = cb - R @ ca
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def _np_error(A, B, normalize):
    err = np.sum((A - B) ** 2)
    if not normalize:
        return err
    allp = np.vstack([A, B])
    diag2 = np.sum((allp.max(0) - allp.min(0)) ** 2)
    return err / (diag2 * A.shape[0])


def _np_icp(src, tgt, T0, eps, max_iters, stop, normalize):
    from scipy.spatial import KDTree
    tree = KDTree(tgt)
    T = T0.copy()
    last = None
    k = 0
    while True:
        src_t = src @ T[:3, :3].T + T[:3, 3]
        _, idx = tree.query(src_t)
        matched = tgt[idx]
        T_new = _np_kabsch(src_t, matched) @ T
        err = _np_error(src_t, matched, normalize)
        T = T_new
        if err < eps:
            break
        if k >= max_iters:
            break
        if last is not None and abs(last - err) < stop:
            break
        last = err
        k += 1
    return T, err, k + 1


def _cloud(rng, n=200, spread=2.0):
    return rng.normal(0, spread, (n, 3)) * np.array([1.0, 1.0, 0.3])


def test_nearest_neighbors_matches_kdtree():
    from scipy.spatial import KDTree
    rng = np.random.default_rng(0)
    src = rng.normal(size=(128, 3))
    tgt = rng.normal(size=(150, 3))
    got = np.asarray(nearest_neighbors(jnp.asarray(src), jnp.asarray(tgt)))
    _, want = KDTree(tgt).query(src)
    np.testing.assert_array_equal(got, want)


def test_nearest_neighbors_respects_target_mask():
    rng = np.random.default_rng(1)
    src = rng.normal(size=(64, 3))
    tgt = rng.normal(size=(80, 3))
    mask = rng.random(80) > 0.5
    got = np.asarray(nearest_neighbors(jnp.asarray(src), jnp.asarray(tgt),
                                       jnp.asarray(mask)))
    from scipy.spatial import KDTree
    sub = np.where(mask)[0]
    _, want_sub = KDTree(tgt[sub]).query(src)
    np.testing.assert_array_equal(got, sub[want_sub])


def test_kabsch_recovers_known_transform():
    rng = np.random.default_rng(2)
    A = _cloud(rng)
    R = _rot(0.8)
    t = np.array([0.5, -1.2, 0.1])
    B = A @ R.T + t
    T = np.asarray(kabsch(jnp.asarray(A), jnp.asarray(B)))
    np.testing.assert_allclose(T[:3, :3], R, atol=1e-9)
    np.testing.assert_allclose(T[:3, 3], t, atol=1e-9)
    assert np.isclose(np.linalg.det(T[:3, :3]), 1.0)


def test_kabsch_reflection_guard():
    """Degenerate planar data that would invite a reflection: det stays +1."""
    rng = np.random.default_rng(3)
    A = rng.normal(size=(50, 3)) * np.array([1.0, 1.0, 0.0])
    B = A[:, [1, 0, 2]]  # mirrored correspondence
    T = np.asarray(kabsch(jnp.asarray(A), jnp.asarray(B)))
    assert np.linalg.det(T[:3, :3]) > 0.999


def test_kabsch_masked_equals_subset():
    rng = np.random.default_rng(4)
    A = _cloud(rng, 100)
    B = A @ _rot(0.3).T + np.array([1.0, 0.0, 0.0])
    w = rng.random(100) > 0.4
    T_masked = np.asarray(kabsch(jnp.asarray(A), jnp.asarray(B),
                                 jnp.asarray(w.astype(np.float64))))
    T_subset = _np_kabsch(A[w], B[w])
    np.testing.assert_allclose(T_masked, T_subset, atol=1e-9)


def test_icp_recovers_small_rigid_transform():
    rng = np.random.default_rng(5)
    src = _cloud(rng, 300)
    R, t = _rot(0.15), np.array([0.2, -0.1, 0.0])
    tgt = src @ R.T + t
    res = icp_ops.run_icp(jnp.asarray(src), jnp.asarray(tgt), epsilon=1e-9,
                          stopping_thresh=1e-12)
    T = np.asarray(res.T)
    np.testing.assert_allclose(T[:3, :3], R, atol=1e-5)
    np.testing.assert_allclose(T[:3, 3], t, atol=1e-5)
    assert float(res.error) < 1e-9


def test_icp_step_exact_vs_reference_spec():
    """Iteration-exact agreement with the numpy/KDTree spec model: same
    transform, same error, same iteration count."""
    rng = np.random.default_rng(6)
    src = _cloud(rng, 150)
    tgt = (src + rng.normal(0, 0.02, src.shape)) @ _rot(0.1).T
    T0 = np.eye(4)
    for normalize, eps in [(False, 1e-3), (True, 1e-3)]:
        want_T, want_err, want_iters = _np_icp(src, tgt, T0, eps, 2000, 1e-4, normalize)
        res = icp_ops.run_icp(jnp.asarray(src), jnp.asarray(tgt),
                              jnp.asarray(T0), epsilon=eps,
                              normalize_error=normalize)
        np.testing.assert_allclose(np.asarray(res.T), want_T, atol=1e-8,
                                   err_msg=f"normalize={normalize}")
        np.testing.assert_allclose(float(res.error), want_err, atol=1e-10)
        assert int(res.iters) == want_iters


def test_icp_2d_inputs_lift():
    rng = np.random.default_rng(7)
    src2 = rng.normal(size=(100, 2))
    R2 = _rot(0.2)[:2, :2]
    tgt2 = src2 @ R2.T + np.array([0.1, 0.05])
    res = icp_ops.run_icp(jnp.asarray(src2), jnp.asarray(tgt2), epsilon=1e-10,
                          stopping_thresh=1e-13)
    T = np.asarray(res.T)
    np.testing.assert_allclose(T[:2, :2], R2, atol=1e-6)
    np.testing.assert_allclose(T[2, 2], 1.0, atol=1e-9)


def test_icp_batch_pairs_converge_independently():
    """Pairs with different convergence speeds in one batch must each match
    their solo run (freezing semantics)."""
    rng = np.random.default_rng(8)
    B, P = 4, 120
    srcs, tgts = [], []
    for b in range(B):
        s = _cloud(rng, P)
        yaw = 0.05 * (b + 1)
        t = np.array([0.1 * b, -0.05 * b, 0.0])
        srcs.append(s)
        tgts.append(s @ _rot(yaw).T + t + rng.normal(0, 0.001 * b, s.shape))
    src = jnp.asarray(np.stack(srcs))
    tgt = jnp.asarray(np.stack(tgts))
    ones = jnp.ones((B, P), bool)
    eye = jnp.tile(jnp.eye(4), (B, 1, 1))
    batch = icp_ops.run_icp_batch(src, tgt, ones, ones, eye, epsilon=1e-6)
    for b in range(B):
        solo = icp_ops.run_icp(src[b], tgt[b], epsilon=1e-6)
        np.testing.assert_allclose(np.asarray(batch.T[b]), np.asarray(solo.T),
                                   atol=1e-9, err_msg=f"pair {b}")
        assert int(batch.iters[b]) == int(solo.iters)


def test_icp_masked_equals_filtered():
    """Masked invalid points must behave exactly like physically removing
    them (the ragged reference representation)."""
    rng = np.random.default_rng(9)
    P = 160
    src = _cloud(rng, P)
    tgt = src @ _rot(0.12).T + np.array([0.3, 0.0, 0.0])
    src_mask = rng.random(P) > 0.3
    tgt_mask = rng.random(P) > 0.3

    res_masked = icp_ops.run_icp(jnp.asarray(src), jnp.asarray(tgt),
                                 epsilon=1e-5,
                                 pc1_mask=jnp.asarray(src_mask),
                                 pc2_mask=jnp.asarray(tgt_mask))
    want_T, want_err, want_iters = _np_icp(src[src_mask], tgt[tgt_mask],
                                           np.eye(4), 1e-5, 2000, 1e-4, False)
    np.testing.assert_allclose(np.asarray(res_masked.T), want_T, atol=1e-8)
    np.testing.assert_allclose(float(res_masked.error), want_err, atol=1e-9)
    assert int(res_masked.iters) == want_iters


def test_kabsch_planar_equals_svd_on_planar_data():
    from lidar_slam.ops.kabsch import kabsch_planar
    rng = np.random.default_rng(11)
    A2 = rng.normal(size=(120, 2))
    R2 = _rot(0.4)[:2, :2]
    B2 = A2 @ R2.T + np.array([0.3, -0.7]) + rng.normal(0, 0.05, A2.shape)
    w = (rng.random(120) > 0.2).astype(np.float64)

    A3 = np.hstack([A2, np.zeros((120, 1))])
    B3 = np.hstack([B2, np.zeros((120, 1))])
    T_svd = np.asarray(kabsch(jnp.asarray(A3), jnp.asarray(B3), jnp.asarray(w)))
    T_pl = np.asarray(kabsch_planar(jnp.asarray(A2), jnp.asarray(B2),
                                    jnp.asarray(w)))
    np.testing.assert_allclose(T_pl[:2, :2], T_svd[:2, :2], atol=1e-9)
    np.testing.assert_allclose(T_pl[:2, 3], T_svd[:2, 3], atol=1e-9)


def test_icp_planar_equals_3d_svd_path():
    rng = np.random.default_rng(12)
    src2 = rng.normal(size=(150, 2))
    tgt2 = src2 @ _rot(0.1)[:2, :2].T + np.array([0.05, -0.03]) \
        + rng.normal(0, 0.01, src2.shape)
    r_planar = icp_ops.run_icp(jnp.asarray(src2), jnp.asarray(tgt2),
                               epsilon=1e-4, planar=True)
    r_svd = icp_ops.run_icp(jnp.asarray(src2), jnp.asarray(tgt2),
                            epsilon=1e-4, planar=False)
    np.testing.assert_allclose(np.asarray(r_planar.T), np.asarray(r_svd.T),
                               atol=1e-8)
    assert int(r_planar.iters) == int(r_svd.iters)


def test_icp_max_iters_cap():
    rng = np.random.default_rng(10)
    src = _cloud(rng, 80)
    tgt = rng.normal(size=(80, 3))  # unrelated clouds: never reaches epsilon
    res = icp_ops.run_icp(jnp.asarray(src), jnp.asarray(tgt), epsilon=0.0,
                          max_iters=5, stopping_thresh=0.0)
    assert int(res.iters) == 6  # reference runs max_iters+1 computes


def test_resume_equals_uninterrupted():
    """icp_step_batch + resume_icp_batch must reproduce run_icp_batch
    exactly — resuming changes only the schedule, never the math
    (ops/icp.py IcpCarry contract)."""
    rng = np.random.default_rng(8)
    B, P = 6, 80
    tgt = rng.uniform(-2, 2, (B, P, 2))
    ang = rng.normal(0, 0.1, B)
    src = np.stack([
        t @ np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]).T
        + rng.normal(0, 0.05, 2) for t, a in zip(tgt, ang)])
    s3 = icp_ops.lift_to_3d(jnp.asarray(src, jnp.float32))
    t3 = icp_ops.lift_to_3d(jnp.asarray(tgt, jnp.float32))
    m = jnp.ones((B, P), bool)
    init = jnp.tile(jnp.eye(4, dtype=jnp.float32), (B, 1, 1))
    kw = dict(epsilon=1e-6, max_iters=50, stopping_thresh=1e-7, planar=True)

    full = icp_ops.run_icp_batch(s3, t3, m, m, init, **kw)
    carry = icp_ops.initial_icp_carry(init, B, P, jnp.float32)
    for _ in range(3):  # three single steps, then resume to convergence
        carry = icp_ops.icp_step_batch(s3, t3, m, m, carry,
                                   normalize_error=False,
                                   nn_backend="jnp", **kw)
    res = icp_ops.resume_icp_batch(s3, t3, m, m, carry, **kw)
    np.testing.assert_array_equal(np.asarray(res.iters),
                                  np.asarray(full.iters))
    # eager single steps compile the body standalone, so XLA fusion (fma)
    # rounds differently than inside run_icp_batch's while_loop — the
    # iterate SEQUENCE is identical but floats differ at the ulp level
    np.testing.assert_allclose(np.asarray(res.T), np.asarray(full.T),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(res.error),
                               np.asarray(full.error), atol=1e-6)


def test_nearest_neighbor_dists_matches_reference_semantics():
    """nearest_neighbor_dists returns the argmin indices plus the TRUE
    squared distances of the chosen pairs (reference get_correspondences
    returns indices whose distances feed the error, modules/icp.py:29-41)."""
    from lidar_slam.ops.nn import nearest_neighbor_dists, nearest_neighbors

    rng = np.random.default_rng(9)
    src = jnp.asarray(rng.normal(size=(2, 40, 3)), jnp.float32)
    tgt = jnp.asarray(rng.normal(size=(2, 55, 3)), jnp.float32)
    mask = jnp.asarray(rng.random((2, 55)) > 0.3)
    idx, d2 = nearest_neighbor_dists(src, tgt, mask)
    np.testing.assert_array_equal(np.asarray(idx),
                                  np.asarray(nearest_neighbors(src, tgt, mask)))
    m = np.take_along_axis(np.asarray(tgt), np.asarray(idx)[..., None], -2)
    want = ((np.asarray(src) - m) ** 2).sum(-1)
    np.testing.assert_allclose(np.asarray(d2), want, atol=1e-6)


def _partial_overlap_problem(seed=11):
    """src and tgt share only 60% of their structure: src = [common, A],
    tgt = [common transformed, B] with A/B disjoint side structures. The
    whole-cloud fit is dragged by the A<->B mis-correspondences; trimmed
    ICP (trim <= 0.6) must use only the common part."""
    rng = np.random.default_rng(seed)
    common = np.concatenate([
        np.stack([np.linspace(-2, 2, 120), np.full(120, 1.5),
                  np.zeros(120)], 1),
        np.stack([np.full(120, -2.0), np.linspace(-1.5, 1.5, 120),
                  np.zeros(120)], 1),
    ])
    common += rng.normal(0, 0.005, common.shape)
    a_side = np.stack([np.linspace(2.5, 4.5, 160), np.full(160, -1.0),
                       np.zeros(160)], 1) + rng.normal(0, 0.005, (160, 3))
    b_side = np.stack([np.linspace(3.0, 5.0, 160), np.full(160, -2.0),
                       np.zeros(160)], 1) + rng.normal(0, 0.005, (160, 3))
    R, t = _rot(0.12), np.array([0.25, -0.15, 0.0])
    src = np.concatenate([common, a_side])
    tgt = np.concatenate([common @ R.T + t, b_side])
    return src, tgt, R, t


def test_trimmed_icp_partial_overlap():
    """Partial overlap: untrimmed ICP is dragged off the true transform by
    non-overlapping structure; trimmed ICP (TrICP) recovers it."""
    src, tgt, R, t = _partial_overlap_problem()
    full = icp_ops.run_icp_batch(
        jnp.asarray(src)[None], jnp.asarray(tgt)[None],
        jnp.ones((1, src.shape[0]), bool), jnp.ones((1, tgt.shape[0]), bool),
        jnp.eye(4)[None], epsilon=1e-12, stopping_thresh=1e-12, planar=True)
    trim = icp_ops.run_icp_batch(
        jnp.asarray(src)[None], jnp.asarray(tgt)[None],
        jnp.ones((1, src.shape[0]), bool), jnp.ones((1, tgt.shape[0]), bool),
        jnp.eye(4)[None], epsilon=1e-12, stopping_thresh=1e-12, planar=True,
        trim_fraction=0.55)
    T_full, T_trim = np.asarray(full.T[0]), np.asarray(trim.T[0])
    err_full = np.linalg.norm(T_full[:3, 3] - t)
    err_trim = np.linalg.norm(T_trim[:3, 3] - t)
    np.testing.assert_allclose(T_trim[:3, :3], R, atol=5e-3)
    assert err_trim < 0.02, err_trim
    assert err_full > 5 * err_trim, (err_full, err_trim)


def test_trim_fraction_one_is_parity():
    """trim_fraction=1.0 is bit-identical to the default path."""
    rng = np.random.default_rng(12)
    src = rng.normal(size=(1, 200, 3)); src[..., 2] = 0
    tgt = src + rng.normal(0, 0.02, src.shape); tgt[..., 2] = 0
    m = jnp.ones((1, 200), bool)
    a = icp_ops.run_icp_batch(jnp.asarray(src), jnp.asarray(tgt), m, m,
                              jnp.eye(4)[None], planar=True)
    b = icp_ops.run_icp_batch(jnp.asarray(src), jnp.asarray(tgt), m, m,
                              jnp.eye(4)[None], planar=True,
                              trim_fraction=1.0)
    np.testing.assert_array_equal(np.asarray(a.T), np.asarray(b.T))
    np.testing.assert_array_equal(np.asarray(a.error), np.asarray(b.error))
    assert int(a.iters[0]) == int(b.iters[0])


def _scanlike_cloud(rng, n=240):
    """Ray-ordered points along two wall segments (line structure with a
    corner), as a lidar scan would sample them."""
    a = np.stack([np.linspace(-3, 1, n // 2), np.full(n // 2, 2.0),
                  np.zeros(n // 2)], 1)
    b = np.stack([np.full(n - n // 2, 1.0),
                  np.linspace(2.0, -2.0, n - n // 2),
                  np.zeros(n - n // 2)], 1)
    return np.concatenate([a, b]) + rng.normal(0, 0.002, (n, 3)) * [1, 1, 0]


def test_scan_normals_planar():
    from lidar_slam.ops.kabsch import scan_normals_planar
    rng = np.random.default_rng(20)
    pts = _scanlike_cloud(rng)
    m = jnp.ones(pts.shape[0], bool)
    n, valid = scan_normals_planar(jnp.asarray(pts[:, :2]), m)
    n, valid = np.asarray(n), np.asarray(valid)
    # endpoints invalid (no two-sided neighbor); corner region may drop
    assert not valid[0] and not valid[-1]
    assert valid.sum() > 0.9 * pts.shape[0]
    # on the horizontal wall the normal is +/- y
    wall = valid[: pts.shape[0] // 2 - 2]
    ny = np.abs(n[: pts.shape[0] // 2 - 2, 1][wall])
    assert (ny > 0.99).all()


def test_plicp_recovers_transform_exactly():
    """On line-structured clouds, point-to-point ICP is biased by the
    sampling (nearest SAMPLE != nearest surface point) while PLICP
    recovers the true transform to sub-mm."""
    rng = np.random.default_rng(21)
    src = _scanlike_cloud(rng)
    # resample the same walls on a DIFFERENT grid (odd count, so the
    # sample positions interleave — like two scans from different poses):
    # nearest-SAMPLE correspondence is then systematically biased while
    # nearest-LINE is not
    tgt0 = _scanlike_cloud(np.random.default_rng(22), n=173)
    R, t = _rot(0.06), np.array([0.10, -0.06, 0.0])
    tgt = tgt0 @ R.T + t
    ms = jnp.ones((1, src.shape[0]), bool)
    mt = jnp.ones((1, tgt.shape[0]), bool)
    out = {}
    for metric in ("point", "point_to_line"):
        res = icp_ops.run_icp_batch(
            jnp.asarray(src)[None], jnp.asarray(tgt)[None], ms, mt,
            jnp.eye(4)[None], epsilon=1e-12, stopping_thresh=1e-10,
            planar=True, metric=metric)
        T = np.asarray(res.T[0])
        out[metric] = np.linalg.norm(T[:2, 3] - t[:2])
    assert out["point_to_line"] < 2e-3, out
    assert out["point_to_line"] < out["point"] / 3, out


def test_plicp_cycle_stop_bounded_iterations():
    """The 2-cycle stopping rule bounds PLICP iteration counts (limit
    cycles oscillate with |delta err| > stopping_thresh forever)."""
    from lidar_slam.config import IcpConfig, LidarConfig
    from lidar_slam.models import odometry, scan_matching
    from lidar_slam.ops import scan as scan_ops
    from lidar_slam.utils import io

    d = io.synthetic_dataset(n_steps=40, n_rays=271, seed=3)
    points, masks = scan_ops.scans_to_points(
        jnp.asarray(d["lidar"]["ranges"]), 0.1, 30.0,
        LidarConfig(n_rays=271))
    poses_odom = odometry.poses_from_odometry(
        jnp.asarray(d["encoder"]["counts"], jnp.float32),
        jnp.asarray(d["imu"]["angular_velocity"], jnp.float32))
    sm = scan_matching.poses_from_scan_matching(
        poses_odom, points, masks,
        IcpConfig(epsilon=0.001, metric="point_to_line"), chunk_size=8)
    assert int(np.asarray(sm.iters).max()) < 50
