"""The clamp-affine scan algebra behind the scan-sharded map builder.

The per-scan map update v -> clamp(v + d, +/-c) (reference:
modules/ogm.py:188) composes associatively (ops/clamp_affine.py). These
tests pin the algebra itself; tests/test_parallel.py pins the 8-device
builder built on it.

Exactness strategy: with INTEGER-valued deltas every add and clamp is
exactly representable, so sequential and composed paths must agree
BITWISE even when clips bind — this isolates algebra bugs from float
rounding. Float-rounding behavior is pinned separately: bitwise equality
when no cell saturates, small tolerance at saturated cells.
"""

import numpy as np
import jax.numpy as jnp

from lidar_slam.ops import clamp_affine as ca

CLIP = 20.0


def _sequential(deltas, clip=CLIP, v0=None):
    v = np.zeros(deltas.shape[1:], deltas.dtype) if v0 is None else v0
    for d in deltas:
        v = np.clip(v + d, -clip, clip)
    return v


def _composed(deltas, clip=CLIP, v0=None):
    f = ca.identity(deltas.shape[1:], clip, dtype=deltas.dtype)
    for d in deltas:
        f = ca.update(f, jnp.asarray(d), clip)
    z = jnp.zeros(deltas.shape[1:], deltas.dtype) if v0 is None else v0
    return np.asarray(ca.apply(f, z)), f


def test_composed_equals_sequential_exact_integers():
    """Integer deltas: bitwise agreement with heavy clip saturation."""
    rng = np.random.default_rng(0)
    deltas = rng.integers(-7, 8, size=(60, 257)).astype(np.float32)
    got, _ = _composed(deltas)
    ref = _sequential(deltas)
    # saturation actually exercised?
    assert (np.abs(ref) == CLIP).any()
    np.testing.assert_array_equal(got, ref)


def test_update_matches_general_compose():
    rng = np.random.default_rng(1)
    deltas = rng.integers(-9, 10, size=(20, 64)).astype(np.float32)
    f = ca.identity((64,), CLIP, dtype=jnp.float32)
    g = ca.identity((64,), CLIP, dtype=jnp.float32)
    for d in deltas:
        d = jnp.asarray(d)
        f = ca.update(f, d, CLIP)
        g = ca.compose(g, ca.ClampAffine(d, jnp.full((64,), -CLIP, d.dtype),
                                         jnp.full((64,), CLIP, d.dtype)))
    for a, b in zip(f, g):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_compose_is_associative_and_tree_matches_fold():
    rng = np.random.default_rng(2)
    blocks = []
    for _ in range(5):
        deltas = rng.integers(-6, 7, size=(12, 128)).astype(np.float32)
        _, f = _composed(deltas)
        blocks.append(f)
    fold = blocks[0]
    for f in blocks[1:]:
        fold = ca.compose(fold, f)
    tree = ca.compose_tree(list(blocks))
    left = ca.compose(ca.compose(blocks[0], blocks[1]), blocks[2])
    right = ca.compose(blocks[0], ca.compose(blocks[1], blocks[2]))
    for a, b in zip(left, right):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(tree, fold):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_float_deltas_bitwise_when_unsaturated():
    """+/-log4-style f32 deltas, no cell ever reaches the rails: the
    composed value accumulates the same adds in the same order, so the
    result is bit-identical to sequential."""
    rng = np.random.default_rng(3)
    log4 = np.float32(np.log(4.0))
    deltas = (rng.integers(-1, 2, size=(12, 511)) * log4).astype(np.float32)
    ref = _sequential(deltas)
    assert np.abs(ref).max() < CLIP  # premise: nothing saturated (<= 12*log4)
    got, _ = _composed(deltas)
    np.testing.assert_array_equal(got, ref)


def test_float_deltas_near_sequential_when_saturated():
    """Saturating f32 log4 deltas: deviations bounded to ULP scale."""
    rng = np.random.default_rng(4)
    log4 = np.float32(np.log(4.0))
    deltas = (rng.integers(-3, 4, size=(80, 511)) * log4).astype(np.float32)
    ref = _sequential(deltas)
    assert (np.abs(ref) >= CLIP - 1e-6).any()
    got, _ = _composed(deltas)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_apply_nonzero_initial_grid():
    rng = np.random.default_rng(5)
    deltas = rng.integers(-5, 6, size=(25, 97)).astype(np.float32)
    v0 = np.clip(rng.integers(-20, 21, size=(97,)).astype(np.float32),
                 -CLIP, CLIP)
    ref = _sequential(deltas, v0=v0.copy())
    f = ca.identity((97,), CLIP, dtype=jnp.float32)
    for d in deltas:
        f = ca.update(f, jnp.asarray(d), CLIP)
    got = np.asarray(ca.apply(f, jnp.asarray(v0)))
    np.testing.assert_array_equal(got, ref)
