"""Nearest-neighbour correspondences (ops/nn.py) against SciPy's KDTree.

Both formulations (the whole distance matrix, and the source axis in
chunks) must pick the exact nearest valid target, up to near-ties that
float32 rounding of the expanded distance can flip.
"""

from functools import partial

import numpy as np
import jax.numpy as jnp
import pytest
from scipy.spatial import cKDTree

from lidar_slam.ops.nn import (nearest_neighbor_dists, nearest_neighbors,
                               nearest_neighbors_chunked)

# a small source chunk, so that the chunked variant pads and loops
NN_FNS = {"full": nearest_neighbors,
          "chunked": partial(nearest_neighbors_chunked, src_chunk=48)}


def _assert_nearest(src, tgt, got, tgt_mask=None):
    """Each index names a valid target whose squared distance is the
    KDTree's optimum up to float32 rounding of |t|^2 - 2 s.t."""
    src, tgt, got = (np.asarray(a, np.float64) for a in (src, tgt, got))
    got = got.astype(int)
    mask = (np.ones(tgt.shape[:2], bool) if tgt_mask is None
            else np.asarray(tgt_mask))
    for b in range(src.shape[0]):
        assert mask[b][got[b]].all()
        valid = np.flatnonzero(mask[b])
        d_best, _ = cKDTree(tgt[b][valid]).query(src[b])
        d_got = ((src[b] - tgt[b][got[b]]) ** 2).sum(-1)
        scale = (src[b] ** 2).sum(-1) + (tgt[b][valid] ** 2).sum(-1).max()
        assert (d_got - d_best ** 2 <= 1e-6 + 8 * 2.0 ** -23 * scale).all()


@pytest.mark.parametrize("fn", NN_FNS)
def test_nn_matches_kdtree(fn):
    rng = np.random.default_rng(0)
    B, N, M = 3, 200, 150
    src = jnp.asarray(rng.normal(size=(B, N, 3)), jnp.float32)
    tgt = jnp.asarray(rng.normal(size=(B, M, 3)), jnp.float32)
    got = NN_FNS[fn](src, tgt)
    _assert_nearest(src, tgt, got)
    # away from near-ties the index itself is the KDTree's
    want = np.stack([cKDTree(np.asarray(tgt[b], np.float64))
                     .query(np.asarray(src[b], np.float64))[1]
                     for b in range(B)])
    assert np.mean(np.asarray(got) == want) > 0.999


@pytest.mark.parametrize("fn", NN_FNS)
def test_nn_respects_mask(fn):
    rng = np.random.default_rng(1)
    B, N, M = 2, 130, 257
    src = jnp.asarray(rng.normal(size=(B, N, 3)), jnp.float32)
    tgt = jnp.asarray(rng.normal(size=(B, M, 3)), jnp.float32)
    mask = jnp.asarray(rng.random((B, M)) > 0.4)
    _assert_nearest(src, tgt, NN_FNS[fn](src, tgt, mask), mask)


@pytest.mark.parametrize("fn", NN_FNS)
def test_nn_2d_points(fn):
    rng = np.random.default_rng(2)
    src = jnp.asarray(rng.normal(size=(1, 64, 2)), jnp.float32)
    tgt = jnp.asarray(rng.normal(size=(1, 90, 2)), jnp.float32)
    _assert_nearest(src, tgt, NN_FNS[fn](src, tgt))


@pytest.mark.parametrize("fn", NN_FNS)
def test_nn_exact_tie_lowest_index(fn):
    """Bit-identical duplicate targets resolve to the LOWEST index
    (reference numpy argmin tie-break, modules/icp.py:40)."""
    src = jnp.asarray([[[0.5, 0.5, 0.0]]], jnp.float32)  # (1, 1, 3)
    dup = [0.5, 0.6, 0.0]
    tgt = jnp.asarray([[[9, 9, 9], dup, [3, 3, 3], dup, dup]], jnp.float32)
    assert int(np.asarray(NN_FNS[fn](src, tgt))[0, 0]) == 1


@pytest.mark.parametrize("fn", NN_FNS)
def test_nn_matched_points_equal_gather(fn):
    """The matched points ICP gathers with take_along_axis are tgt[idx],
    and nearest_neighbor_dists reports their squared distances."""
    rng = np.random.default_rng(3)
    B, N, M = 2, 100, 170
    src = jnp.asarray(rng.normal(size=(B, N, 3)), jnp.float32)
    tgt = jnp.asarray(rng.normal(size=(B, M, 3)), jnp.float32)
    mask = jnp.asarray(rng.random((B, M)) > 0.2)
    idx = np.asarray(NN_FNS[fn](src, tgt, mask))
    matched = np.asarray(jnp.take_along_axis(tgt, jnp.asarray(idx)[..., None],
                                             axis=-2))
    want = np.stack([np.asarray(tgt)[b, idx[b]] for b in range(B)])
    np.testing.assert_array_equal(matched, want)
    idx_d, d2 = nearest_neighbor_dists(src, tgt, mask)
    np.testing.assert_array_equal(np.asarray(idx_d), idx)
    np.testing.assert_allclose(
        np.asarray(d2), ((np.asarray(src) - want) ** 2).sum(-1), rtol=1e-6)
