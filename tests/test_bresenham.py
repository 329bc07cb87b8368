import numpy as np
import jax.numpy as jnp

from lidar_slam.ops.bresenham import bresenham_cells, bresenham_fixed


# Golden conformance vectors for the ray caster
# (reference: code/pr2_utils.py:94-96 hardcoded expected rays).
GOLDEN = [
    ((0, 1, 10, 5), np.array([[0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10],
                              [1, 1, 2, 2, 3, 3, 3, 4, 4, 5, 5]]).T),
    ((0, 1, 9, 6), np.array([[0, 1, 2, 3, 4, 5, 6, 7, 8, 9],
                             [1, 2, 2, 3, 3, 4, 4, 5, 5, 6]]).T),
]


def _np_bresenham(sx, sy, ex, ey):
    """Independent scalar Bresenham implementing the reference's integer
    semantics (spec: modules/ogm.py:190-231) via the standard error-term
    formulation, for randomized cross-checks."""
    dx0, dy0 = abs(ex - sx), abs(ey - sy)
    steep = dy0 > dx0
    dx, dy = (dy0, dx0) if steep else (dx0, dy0)
    # minor increments where the accumulator m_k wraps
    cells = []
    minor = 0
    m_prev = dx // 2 if dx > 0 else 0
    for k in range(dx + 1):
        if k >= 1 and dy > 0:
            m_k = (dx // 2 - k * dy) % dx
            if m_k >= m_prev:
                minor += 1
            m_prev = m_k
        if steep:
            yy = sy + k if sy <= ey else sy - k
            xx = sx + minor if sx <= ex else sx - minor
        else:
            xx = sx + k if sx <= ex else sx - k
            yy = sy + minor if sy <= ey else sy - minor
        cells.append((xx, yy))
    return np.array(cells)


def test_golden_rays():
    for (args, want) in GOLDEN:
        got = np.asarray(bresenham_cells(*args))
        np.testing.assert_array_equal(got, want)


def test_golden_rays_reference_impl_agrees():
    # sanity: the test's own spec model also matches the goldens
    for (args, want) in GOLDEN:
        np.testing.assert_array_equal(_np_bresenham(*args), want)


def test_random_rays_all_octants():
    # one batched fixed-K call covering all octants (avoids per-ray compiles)
    rng = np.random.default_rng(0)
    s = rng.integers(-50, 50, (100, 2))
    e = rng.integers(-50, 50, (100, 2))
    K = 128
    xs, ys, mask = bresenham_fixed(
        jnp.asarray(s[:, 0]), jnp.asarray(s[:, 1]),
        jnp.asarray(e[:, 0]), jnp.asarray(e[:, 1]), K)
    xs, ys, mask = np.asarray(xs), np.asarray(ys), np.asarray(mask)
    for i in range(100):
        want = _np_bresenham(int(s[i, 0]), int(s[i, 1]), int(e[i, 0]), int(e[i, 1]))
        got = np.stack([xs[i][mask[i]], ys[i][mask[i]]], axis=1)
        np.testing.assert_array_equal(got, want, err_msg=f"ray {(s[i], e[i])}")


def test_degenerate_rays():
    # single point
    got = np.asarray(bresenham_cells(3, 4, 3, 4))
    np.testing.assert_array_equal(got, [[3, 4]])
    # axis-aligned
    got = np.asarray(bresenham_cells(0, 0, 4, 0))
    np.testing.assert_array_equal(got, [[0, 0], [1, 0], [2, 0], [3, 0], [4, 0]])
    got = np.asarray(bresenham_cells(0, 0, 0, -3))
    np.testing.assert_array_equal(got, [[0, 0], [0, -1], [0, -2], [0, -3]])
    # perfect diagonal
    got = np.asarray(bresenham_cells(0, 0, 3, 3))
    np.testing.assert_array_equal(got, [[0, 0], [1, 1], [2, 2], [3, 3]])


def test_batched_matches_scalar():
    rng = np.random.default_rng(1)
    n = 64
    s = rng.integers(-20, 20, (n, 2))
    e = rng.integers(-20, 20, (n, 2))
    K = 64
    xs, ys, mask = bresenham_fixed(
        jnp.asarray(s[:, 0]), jnp.asarray(s[:, 1]),
        jnp.asarray(e[:, 0]), jnp.asarray(e[:, 1]), K)
    xs, ys, mask = np.asarray(xs), np.asarray(ys), np.asarray(mask)
    for i in range(n):
        want = _np_bresenham(*s[i], *e[i])
        got = np.stack([xs[i][mask[i]], ys[i][mask[i]]], axis=1)
        np.testing.assert_array_equal(got, want)


def test_even_dx_tie_breaking():
    """Half-step ties (even dx) must round the reference's way: the 2:1 line
    (0,0)->(2,1) stays at y=0 through x=1 (not y=1)."""
    got = np.asarray(bresenham_cells(0, 0, 2, 1))
    np.testing.assert_array_equal(got, [[0, 0], [1, 0], [2, 1]])
    got = np.asarray(bresenham_cells(0, 0, 4, 2))
    np.testing.assert_array_equal(got, [[0, 0], [1, 0], [2, 1], [3, 1], [4, 2]])


def test_truncation_keeps_prefix():
    # K shorter than the ray: the first K cells survive, in order
    xs, ys, mask = bresenham_fixed(0, 0, 100, 37, 16)
    full = _np_bresenham(0, 0, 100, 37)
    got = np.stack([np.asarray(xs)[np.asarray(mask)], np.asarray(ys)[np.asarray(mask)]], axis=1)
    np.testing.assert_array_equal(got, full[:16])
