"""The map build's two XLA scatter engines against a per-ray reference.

models/occupancy.build_logodds scatters each scan's +/-log4 contributions
either over live (ray, slot) tiles only (compact=True, the default) or over
every slot (compact=False). Both must reproduce a plain reference that
traces every ray on its own with ops/bresenham.bresenham_cells and applies
the reference's update rule (modules/ogm.py:149-188) scan by scan.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from lidar_slam.config import LidarConfig, MapConfig
from lidar_slam.models.occupancy import (build_logodds, finalize_grid,
                                         max_ray_cells)
from lidar_slam.ops.bresenham import bresenham_cells

CFG = MapConfig(resolution=0.1, world_max_x=6, world_min_x=-6,
                world_max_y=6, world_min_y=-6)
K = max_ray_cells(CFG, 9.0)
ENGINES = {"compact": True, "dense": False}


def _per_ray_reference(poses, pts, masks, cfg, K, init=None):
    """Sequential float64 map build, one Bresenham trace per ray."""
    poses, pts, masks = (np.asarray(a, np.float64) for a in
                         (poses, pts, masks))
    p_rl = np.asarray(LidarConfig().p_rl[:2], np.float64)
    L = cfg.logodds_ratio
    grid = (np.zeros((cfg.width, cfg.height)) if init is None
            else np.asarray(init, np.float64).copy())

    def w2g(x, y):
        return (np.ceil((x - cfg.world_min_x) / cfg.resolution).astype(int) - 1,
                np.ceil((y - cfg.world_min_y) / cfg.resolution).astype(int) - 1)

    for (x, y, yaw), scan, mask in zip(poses, pts, masks):
        c, s = np.cos(yaw), np.sin(yaw)
        ex, ey = w2g(scan[:, 0] * c - scan[:, 1] * s + x,
                     scan[:, 0] * s + scan[:, 1] * c + y)
        sx, sy = w2g(x + p_rl[0], y + p_rl[1])
        for r in np.flatnonzero(mask):
            cells = np.asarray(bresenham_cells(int(sx), int(sy), int(ex[r]),
                                               int(ey[r])))[:K]
            ok = ((cells[:, 0] >= 0) & (cells[:, 0] < cfg.width)
                  & (cells[:, 1] >= 0) & (cells[:, 1] < cfg.height))
            cells = cells[ok]
            if len(cells):
                grid[cells[:-1, 0], cells[:-1, 1]] -= L
                grid[cells[-1, 0], cells[-1, 1]] += L
        grid = np.clip(grid, -cfg.logodds_clip, cfg.logodds_clip)
    return grid


def _assert_matches_reference(got, want):
    got = np.asarray(got, np.float64)
    np.testing.assert_allclose(got, want, atol=1e-4)
    # the uint8 map may differ only where the log-odds is zero up to rounding
    decided = np.abs(want) > 1e-4
    np.testing.assert_array_equal(
        np.asarray(finalize_grid(jnp.asarray(got)))[decided],
        np.asarray(finalize_grid(jnp.asarray(want)))[decided])


def _adversarial_scans(seed=0, n=10, r=96):
    rng = np.random.default_rng(seed)
    ang = rng.uniform(-np.pi, np.pi, (n, r))
    rad = rng.uniform(0.2, 9.0, (n, r))  # many endpoints exit the map
    pts = np.stack([rad * np.cos(ang), rad * np.sin(ang)], axis=-1)
    masks = rng.random((n, r)) > 0.1
    pts[0, :4] = 0.001                   # zero-length rays
    pts[1, 4] = [3.0, 0.0]               # axis-aligned rays
    pts[1, 5] = [0.0, -4.5]
    pts[1, 6] = [-2.0, 0.0]
    masks[2, :] = False                  # fully masked scan
    poses = np.cumsum(rng.normal(0, 0.15, (n, 3)), axis=0)
    poses[:, 2] = rng.uniform(-np.pi, np.pi, n)
    return poses, pts, masks


@pytest.mark.parametrize("engine", ENGINES)
def test_engine_matches_per_ray_reference(engine):
    poses, pts, masks = _adversarial_scans()
    got = build_logodds(jnp.asarray(poses), jnp.asarray(pts),
                        jnp.asarray(masks), CFG, K, compact=ENGINES[engine])
    want = _per_ray_reference(poses, pts, masks, CFG, K)
    _assert_matches_reference(got, want)
    assert (want != 0).sum() > 1000  # the case actually exercises the map


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("trial", range(10))
def test_engine_fuzz_random_configs(engine, trial):
    """Seeded fuzz over map geometries and ray patterns, with axis-aligned,
    45-degree and zero-length rays, and robots outside the map."""
    rng = np.random.default_rng([123, trial])
    res = float(rng.choice([0.05, 0.08, 0.1, 0.13, 0.2, 0.25]))
    ext_x = float(rng.uniform(2.0, 12.0))
    ext_y = float(rng.uniform(2.0, 12.0))
    cfg = MapConfig(resolution=res, world_max_x=ext_x, world_min_x=-ext_x,
                    world_max_y=ext_y, world_min_y=-ext_y)
    rmax = float(rng.uniform(0.5, 1.6)) * max(ext_x, ext_y)
    k = max_ray_cells(cfg, rmax)
    n, r = int(rng.integers(2, 5)), int(rng.integers(16, 64))
    ang = rng.uniform(-np.pi, np.pi, (n, r))
    rad = rng.uniform(0.05, rmax, (n, r))
    pts = np.stack([rad * np.cos(ang), rad * np.sin(ang)], axis=-1)
    pts[0, 0] = [rad[0, 0], 0.0]
    pts[0, 1] = [0.0, -rad[0, 1]]
    pts[0, 2] = [rad[0, 2], rad[0, 2]]
    pts[0, 3] = [1e-4, 1e-4]
    masks = rng.random((n, r)) > 0.1
    poses = np.cumsum(rng.normal(0, 0.3, (n, 3)), axis=0)
    if trial % 3 == 0:  # start outside the map entirely
        poses[:, 0] += ext_x * 1.2
    got = build_logodds(jnp.asarray(poses), jnp.asarray(pts),
                        jnp.asarray(masks), cfg, k, compact=ENGINES[engine])
    _assert_matches_reference(
        got, _per_ray_reference(poses, pts, masks, cfg, k))


@pytest.mark.parametrize("engine", ENGINES)
def test_engine_init_grid(engine):
    """An incremental build from a nonzero carried grid."""
    poses, pts, masks = _adversarial_scans(seed=11, n=6, r=96)
    init = np.clip(np.random.default_rng(5).normal(0, 8, (CFG.width,
                                                          CFG.height)),
                   -CFG.logodds_clip, CFG.logodds_clip)
    got = build_logodds(jnp.asarray(poses), jnp.asarray(pts),
                        jnp.asarray(masks), CFG, K, init=jnp.asarray(init),
                        compact=ENGINES[engine])
    _assert_matches_reference(
        got, _per_ray_reference(poses, pts, masks, CFG, K, init=init))


@pytest.mark.parametrize("engine", ENGINES)
def test_engine_large_k(engine):
    """Long rays at fine resolution (K = 768 slots; e.g. main.py --res
    0.025): the compact tiles must cover every slot of the longest ray."""
    cfg = MapConfig(resolution=0.025, world_max_x=10, world_min_x=-10,
                    world_max_y=10, world_min_y=-10)
    k = 768
    rng = np.random.default_rng(3)
    n, r = 4, 64
    ang = rng.uniform(-np.pi, np.pi, (n, r))
    dist = rng.uniform(1.0, 19.0, (n, r))
    pts = np.stack([dist * np.cos(ang), dist * np.sin(ang)], axis=-1)
    masks = np.ones((n, r), bool)
    poses = rng.normal(0, 0.5, (n, 3))
    got = build_logodds(jnp.asarray(poses), jnp.asarray(pts),
                        jnp.asarray(masks), cfg, k, compact=ENGINES[engine])
    want = _per_ray_reference(poses, pts, masks, cfg, k)
    _assert_matches_reference(got, want)
    assert (want != 0).sum() > 1000


def test_compact_equals_dense_at_dataset_geometry():
    """Dataset-shaped grid (0.05 m over 60 m, deep slot counts): the two
    engines scatter the same contributions in another order, so their
    maps agree to rounding and their uint8 maps exactly."""
    cfg = MapConfig(resolution=0.05, world_max_x=30, world_min_x=-30,
                    world_max_y=30, world_min_y=-30)
    k = max_ray_cells(cfg, 30.0)
    rng = np.random.default_rng(1)
    n, r = 4, 256
    ang = rng.uniform(-np.pi, np.pi, (n, r))
    rad = rng.uniform(0.3, 29.5, (n, r))
    pts = jnp.asarray(np.stack([rad * np.cos(ang), rad * np.sin(ang)],
                               axis=-1), jnp.float32)
    masks = jnp.asarray(rng.random((n, r)) > 0.1)
    poses = jnp.asarray(np.cumsum(rng.normal(0, 0.1, (n, 3)), 0),
                        jnp.float32)
    g_c = build_logodds(poses, pts, masks, cfg, k, compact=True)
    g_d = build_logodds(poses, pts, masks, cfg, k, compact=False)
    np.testing.assert_allclose(np.asarray(g_c), np.asarray(g_d), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(finalize_grid(g_c)),
                                  np.asarray(finalize_grid(g_d)))
    assert int((np.asarray(g_c) != 0).sum()) > 10000
