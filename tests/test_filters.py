import numpy as np
import jax.numpy as jnp

from lidar_slam.ops import filters


def _scan_with_outliers(rng, n_core=80, n_out=8):
    """A dense blob (core cluster) plus isolated far points (outliers)."""
    blob = rng.normal(0, 0.02, (n_core, 2)) + np.array([1.0, 0.5])
    outs = rng.uniform(5, 8, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    return np.vstack([blob, outs])


def test_dbscan_mask_matches_sklearn():
    from sklearn.cluster import DBSCAN
    rng = np.random.default_rng(0)
    for trial in range(5):
        pts = _scan_with_outliers(rng)
        # add a second cluster and a borderline chain
        pts = np.vstack([pts, rng.normal(0, 0.03, (40, 2)) - 2.0,
                         np.linspace([0, 0], [0.5, 0], 12) + rng.normal(0, 0.005, (12, 2))])
        labels = DBSCAN(eps=0.1, min_samples=10).fit_predict(pts)
        want = labels != -1
        got = np.asarray(filters.dbscan_outlier_mask(
            jnp.asarray(pts), jnp.ones(len(pts), bool), 0.1, 10))
        np.testing.assert_array_equal(got, want, err_msg=f"trial {trial}")


def test_dbscan_masked_equals_subset():
    from sklearn.cluster import DBSCAN
    rng = np.random.default_rng(1)
    pts = _scan_with_outliers(rng, 60, 6)
    mask = rng.random(len(pts)) > 0.25
    got = np.asarray(filters.dbscan_outlier_mask(
        jnp.asarray(pts), jnp.asarray(mask), 0.1, 10))
    labels = DBSCAN(eps=0.1, min_samples=10).fit_predict(pts[mask])
    want_sub = labels != -1
    np.testing.assert_array_equal(got[mask], want_sub)
    assert not got[~mask].any()


def test_dbscan_labels_partition_matches_sklearn():
    from sklearn.cluster import DBSCAN
    rng = np.random.default_rng(2)
    pts = np.vstack([rng.normal(0, 0.02, (30, 2)),
                     rng.normal(0, 0.02, (30, 2)) + 3.0,
                     np.array([[10.0, 10.0]])])
    want = DBSCAN(eps=0.1, min_samples=5).fit_predict(pts)
    got = np.asarray(filters.dbscan_labels(
        jnp.asarray(pts), jnp.ones(len(pts), bool), 0.1, 5))
    # same noise set and same partition (label ids may differ)
    np.testing.assert_array_equal(got == -1, want == -1)
    for lab in set(want[want >= 0]):
        sel = want == lab
        assert len(set(got[sel])) == 1


def test_statistical_filter_matches_reference_spec():
    rng = np.random.default_rng(3)
    scans = [rng.uniform(0.5, 5.0, (50, 2)), rng.uniform(0.5, 25.0, (50, 2))]
    pts = np.stack(scans)
    masks = np.ones((2, 50), bool)

    got = np.asarray(filters.statistical_filter_scans(
        jnp.asarray(pts), jnp.asarray(masks), k_std=2.0))

    # spec: modules/localization.py:223-250 (pooled mean + 2 sigma, keep <)
    allp = pts.reshape(-1, 2)
    d = np.linalg.norm(allp, axis=1)
    thresh = d.mean() + 2.0 * d.std()
    want = (d < thresh).reshape(2, 50)
    np.testing.assert_array_equal(got, want)


def test_statistical_filter_ignores_masked_points():
    rng = np.random.default_rng(4)
    pts = np.vstack([rng.uniform(0.5, 2.0, (40, 2)),
                     np.full((10, 2), 500.0)])  # masked-out monsters
    masks = np.concatenate([np.ones(40, bool), np.zeros(10, bool)])
    got = np.asarray(filters.statistical_filter_scans(
        jnp.asarray(pts[None]), jnp.asarray(masks[None]), k_std=2.0))[0]
    # threshold computed over the 40 valid points only; all of them survive
    d = np.linalg.norm(pts[:40], axis=1)
    want = d < d.mean() + 2 * d.std()
    np.testing.assert_array_equal(got[:40], want)
    assert not got[40:].any()


def test_chunked_equals_unchunked():
    rng = np.random.default_rng(5)
    pts = np.stack([_scan_with_outliers(rng, 40, 4) for _ in range(7)])
    masks = np.ones(pts.shape[:2], bool)
    a = np.asarray(filters.dbscan_filter_scans(jnp.asarray(pts), jnp.asarray(masks),
                                               chunk_size=2))
    b = np.asarray(filters.dbscan_filter_scans(jnp.asarray(pts), jnp.asarray(masks),
                                               chunk_size=7))
    np.testing.assert_array_equal(a, b)


def test_dbscan_labels_long_chain_fixpoint():
    """A core chain longer than any fixed sweep count must collapse to one
    label (the propagation now iterates to fixpoint: the old
    64-sweep cap would mislabel chains with >64 hops)."""
    from lidar_slam.ops.filters import dbscan_labels
    P = 300
    pts = jnp.asarray(np.stack([np.arange(P) * 0.05,
                                np.zeros(P)], axis=-1))  # 5cm spacing chain
    mask = jnp.ones(P, bool)
    labels = np.asarray(dbscan_labels(pts, mask, eps=0.06, min_samples=2))
    assert (labels == 0).all(), np.unique(labels)
