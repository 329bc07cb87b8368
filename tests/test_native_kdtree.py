"""Native first-party oracles (native/slamio.cpp) vs their third-party and
on-device counterparts.

The reference's native layer is all third-party bindings (SURVEY.md section
2): scipy.spatial.KDTree for correspondences (modules/icp.py:40,161) and
sklearn DBSCAN for scan filtering (modules/localization.py:216-217). The
framework's native layer is first-party C++; these tests pin (a) the KDTree
against a float64 brute-force argmin and the production device NN path, and
(b) the DBSCAN against sklearn and the on-device density filter.
"""

import numpy as np
import pytest

from lidar_slam.utils import native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library not built")


def _brute(tgt, q):
    d = ((q[:, None, :].astype(np.float64)
          - tgt[None].astype(np.float64)) ** 2).sum(-1)
    idx = d.argmin(1)
    return idx, d[np.arange(len(q)), idx]


@pytest.mark.parametrize("dims", [2, 3])
def test_kdtree_matches_float64_bruteforce(dims):
    rng = np.random.default_rng(7)
    tgt = rng.normal(size=(1081, dims)).astype(np.float32)
    q = rng.normal(size=(777, dims)).astype(np.float32)
    idx, d2 = native.kdtree_query(tgt, q)
    bidx, bd2 = _brute(tgt, q)
    np.testing.assert_array_equal(idx, bidx)
    np.testing.assert_allclose(d2, bd2, rtol=1e-5)


def test_kdtree_tie_break_lowest_index():
    # duplicated target points: numpy argmin semantics pick the lowest index
    tgt = np.array([[1, 0], [0, 0], [0, 0], [1, 0], [0, 0]], np.float32)
    idx, d2 = native.kdtree_query(
        tgt, np.array([[0, 0.25], [0.9, -0.1]], np.float32))
    assert idx.tolist() == [1, 0]
    np.testing.assert_allclose(d2, [0.0625, 0.02], rtol=1e-6)


def test_kdtree_degenerate_inputs():
    # single target point; queries equal to targets (zero distance)
    tgt = np.array([[3.0, -2.0]], np.float32)
    idx, d2 = native.kdtree_query(tgt, np.array([[0.0, 0.0]], np.float32))
    assert idx.tolist() == [0]
    rng = np.random.default_rng(3)
    tgt = rng.normal(size=(64, 3)).astype(np.float32)
    idx, d2 = native.kdtree_query(tgt, tgt)
    np.testing.assert_array_equal(idx, np.arange(64))
    np.testing.assert_array_equal(d2, np.zeros(64, np.float32))

    with pytest.raises(ValueError):
        native.kdtree_query(tgt, rng.normal(size=(4, 2)).astype(np.float32))


def _clustered_points(rng, n):
    k = int(rng.integers(1, 5))
    centers = rng.uniform(-5, 5, (k, 2))
    return np.concatenate([
        centers[rng.integers(0, k, n // 2)]
        + rng.normal(0, 0.05, (n // 2, 2)),
        rng.uniform(-6, 6, (n - n // 2, 2)),
    ]).astype(np.float32)


def test_native_dbscan_matches_sklearn():
    """The C++ DBSCAN reproduces sklearn exactly: identical noise sets and
    a label bijection between the partitions (cluster ids are discovery-
    order on both sides but need not coincide)."""
    from sklearn.cluster import DBSCAN

    rng = np.random.default_rng(4)
    for trial in range(6):
        pts = _clustered_points(rng, int(rng.integers(50, 300)))
        eps = float(rng.uniform(0.05, 0.4))
        ms = int(rng.integers(3, 12))
        ours = native.dbscan(pts, eps, ms)
        sk = DBSCAN(eps=eps, min_samples=ms).fit_predict(
            pts.astype(np.float64))
        np.testing.assert_array_equal(ours == -1, sk == -1,
                                      err_msg=f"trial {trial} noise")
        fwd = {}
        for a, b in zip(ours, sk):
            if a == -1:
                continue
            assert fwd.setdefault(int(a), int(b)) == int(b), trial
        assert len(set(fwd.values())) == len(fwd), trial


def test_device_filter_conforms_to_native_dbscan():
    """The on-device density filter (ops/filters.py) keeps exactly the
    native oracle's non-noise points, and its canonical min-label
    clustering induces the same partition on CORE points (border points
    may legitimately attach to a different adjacent cluster: the device
    picks the minimum core label, BFS picks first-visited)."""
    import jax.numpy as jnp

    from lidar_slam.ops import filters

    rng = np.random.default_rng(9)
    for trial in range(4):
        n = 200
        pts = _clustered_points(rng, n)
        eps, ms = 0.15, 5
        ref = native.dbscan(pts, eps, ms)
        mask = jnp.ones(n, bool)
        keep = np.asarray(filters.dbscan_outlier_mask(
            jnp.asarray(pts), mask, eps, ms))
        np.testing.assert_array_equal(keep, ref != -1,
                                      err_msg=f"trial {trial} noise mask")

        labels = np.asarray(filters.dbscan_labels(
            jnp.asarray(pts), mask, eps, ms))
        # core points: >= ms neighbors incl. self within eps
        d2 = ((pts[:, None] - pts[None]) ** 2).sum(-1)
        core = (d2 <= eps * eps).sum(1) >= ms
        fwd = {}
        for a, b in zip(labels[core], ref[core]):
            assert b != -1 and a != -1
            assert fwd.setdefault(int(a), int(b)) == int(b), trial
        assert len(set(fwd.values())) == len(fwd), trial


def test_device_nn_conforms_to_native_kdtree():
    """The production brute-force argmin (ops/nn.py) returns the true nearest
    neighbor — checked point-for-point against the exact native tree on
    scan-shaped clouds, including masked targets."""
    import jax.numpy as jnp

    from lidar_slam.ops.nn import nearest_neighbors

    rng = np.random.default_rng(11)
    src = rng.uniform(-10, 10, size=(1081, 2)).astype(np.float32)
    tgt = rng.uniform(-10, 10, size=(1081, 2)).astype(np.float32)

    dev_idx = np.asarray(nearest_neighbors(jnp.asarray(src), jnp.asarray(tgt)))
    ref_idx, ref_d2 = native.kdtree_query(tgt, src)
    # allow only floating near-tie flips: where indices differ, the chosen
    # target's true distance must match the optimal one to f32 round-off
    diff = dev_idx != ref_idx
    if diff.any():
        chosen = ((src[diff] - tgt[dev_idx[diff]]) ** 2).sum(-1)
        np.testing.assert_allclose(chosen, ref_d2[diff], rtol=1e-5)
    assert diff.mean() < 0.001

    # masked path: restrict targets and compare against a tree on the subset
    mask = rng.random(1081) > 0.3
    sub = tgt[mask]
    sub_to_full = np.flatnonzero(mask)
    dev_idx = np.asarray(nearest_neighbors(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask)))
    ref_idx, ref_d2 = native.kdtree_query(sub, src)
    diff = dev_idx != sub_to_full[ref_idx]
    if diff.any():
        chosen = ((src[diff] - tgt[dev_idx[diff]]) ** 2).sum(-1)
        np.testing.assert_allclose(chosen, ref_d2[diff], rtol=1e-5)
    assert diff.mean() < 0.001
    assert mask[dev_idx].all()  # masked-out targets never selected


def test_stale_so_rebind_after_rebuild(tmp_path):
    """A stale .so (missing newer exports) must not poison a later rebind of
    the same path: _bind dlcloses the failed mapping, so after a rebuild the
    retry in _load binds the NEW image. glibc caches dlopen by path — without
    the dlclose the second _bind would silently return the stale library."""
    import os
    import shutil
    import subprocess

    stub = tmp_path / "stub.c"
    stub.write_text("int slamio_unrelated(void) { return 1; }\n")
    so = tmp_path / "libslamio_stale.so"
    subprocess.run(["gcc", "-shared", "-fPIC", "-o", str(so), str(stub)],
                   check=True)
    assert native._bind(str(so)) is None  # stale: lacks every export
    # "rebuild": the good library replaces the stale one at the SAME path
    shutil.copy(os.path.abspath(native._lib_path()), so)
    lib = native._bind(str(so))
    assert lib is not None


def test_decoders_agree_on_reference_committed_pngs():
    """Real-world codec conformance: the native libpng decoder and the pure
    -Python fallback decode the reference's committed map/texture PNGs
    (matplotlib-written RGBA, the only real image files in existence here)
    pixel-identically."""
    import glob
    import os

    from lidar_slam.utils.png import read_png

    paths = sorted(glob.glob("/root/reference/images/*.png"))
    if not paths:
        pytest.skip("reference images not available")
    for p in paths:
        a = read_png(p)
        b = native.read_png(p)
        assert a.shape == b.shape and a.dtype == b.dtype, os.path.basename(p)
        np.testing.assert_array_equal(a, b, err_msg=os.path.basename(p))
