import numpy as np
import jax.numpy as jnp

from lidar_slam.config import MapConfig
from lidar_slam.models import occupancy


def test_adaptive_k_exactness():
    """The data-adaptive slot count must produce the IDENTICAL map as the
    range_max-sized one (it is a pure performance change)."""
    cfg = MapConfig(resolution=0.05, world_max_x=20, world_min_x=-20,
                    world_max_y=20, world_min_y=-20)
    rng = np.random.default_rng(0)
    N, R = 8, 128
    ang = rng.uniform(-np.pi, np.pi, (N, R))
    r = rng.uniform(0.3, 9.0, (N, R))  # data max 9 m << range_max 30 m
    pts = jnp.asarray(np.stack([r * np.cos(ang), r * np.sin(ang)], axis=-1))
    masks = jnp.asarray(rng.random((N, R)) > 0.1)
    poses = jnp.asarray(np.cumsum(rng.normal(0, 0.1, (N, 3)), axis=0))

    K_full = occupancy.max_ray_cells(cfg, 30.0)
    K_adap = occupancy.adaptive_ray_cells(pts, masks, cfg, 30.0)
    assert K_adap < K_full
    assert K_adap % 64 == 0

    g_full = occupancy.build_logodds(poses, pts, masks, cfg, K_full)
    g_adap = occupancy.build_logodds(poses, pts, masks, cfg, K_adap)
    np.testing.assert_array_equal(np.asarray(g_full), np.asarray(g_adap))


def test_adaptive_k_degenerate():
    cfg = MapConfig()
    pts = jnp.zeros((2, 4, 2))
    masks = jnp.zeros((2, 4), bool)
    assert occupancy.adaptive_ray_cells(pts, masks, cfg) == 64
    # never exceeds the range_max bound
    far = jnp.full((1, 4, 2), 1000.0)
    k = occupancy.adaptive_ray_cells(far, jnp.ones((1, 4), bool), cfg, 30.0)
    assert k <= -(-occupancy.max_ray_cells(cfg, 30.0) // 64) * 64 + 64


def test_compact_build_identical_to_dense():
    """The staircase-compacted scatter must produce the bit-identical map."""
    cfg = MapConfig(resolution=0.05, world_max_x=20, world_min_x=-20,
                    world_max_y=20, world_min_y=-20)
    rng = np.random.default_rng(7)
    N, R = 6, 200
    ang = rng.uniform(-np.pi, np.pi, (N, R))
    # mixed short/long rays incl. some beyond the map edge
    r = np.where(rng.random((N, R)) < 0.1,
                 rng.uniform(20, 35, (N, R)), rng.uniform(0.3, 8.0, (N, R)))
    pts = jnp.asarray(np.stack([r * np.cos(ang), r * np.sin(ang)], axis=-1))
    masks = jnp.asarray(rng.random((N, R)) > 0.1)
    poses = jnp.asarray(np.cumsum(rng.normal(0, 0.5, (N, 3)), axis=0))
    K = occupancy.max_ray_cells(cfg, 35.0)  # deliberately not 64-aligned

    dense = occupancy.build_logodds(poses, pts, masks, cfg, K, compact=False)
    comp = occupancy.build_logodds(poses, pts, masks, cfg, K, compact=True)
    np.testing.assert_array_equal(np.asarray(dense), np.asarray(comp))
