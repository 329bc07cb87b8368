import numpy as np
import jax.numpy as jnp

from lidar_slam.config import MapConfig
from lidar_slam.models import occupancy
from tests.test_bresenham import _np_bresenham

LOG4 = np.log(4.0)
P_RL = np.array([0.13323, 0.0])


def _np_world2grid(x, y, cfg):
    # spec: modules/ogm.py:117-123
    i = np.ceil((np.asarray(x) - cfg.world_min_x) / cfg.resolution).astype(np.int64) - 1
    j = np.ceil((np.asarray(y) - cfg.world_min_y) / cfg.resolution).astype(np.int64) - 1
    return i, j


def _np_update_map(logodds, pose, pts, cfg):
    """Independent numpy model of one scan update
    (spec: modules/ogm.py:149-188)."""
    x, y, yaw = pose
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -s], [s, c]])
    w = pts @ R.T + np.array([x, y])
    ox, oy = np.array([x, y]) + P_RL
    si, sj = _np_world2grid(ox, oy, cfg)
    ei, ej = _np_world2grid(w[:, 0], w[:, 1], cfg)
    W, H = cfg.width, cfg.height
    out = logodds.copy()
    for r in range(len(pts)):
        cells = _np_bresenham(int(si), int(sj), int(ei[r]), int(ej[r]))
        ok = (cells[:, 0] >= 0) & (cells[:, 0] < W) & (cells[:, 1] >= 0) & (cells[:, 1] < H)
        cells = cells[ok]
        if len(cells) == 0:
            continue
        out[cells[:-1, 0], cells[:-1, 1]] -= LOG4
        out[cells[-1, 0], cells[-1, 1]] += LOG4
    return np.clip(out, -20, 20)


def _random_scan(rng, n=64, rmax=8.0):
    angles = rng.uniform(-np.pi, np.pi, n)
    r = rng.uniform(0.2, rmax, n)
    return np.stack([r * np.cos(angles) + P_RL[0], r * np.sin(angles)], axis=1)


def test_world2grid_matches_spec():
    cfg = MapConfig(resolution=0.05, world_max_x=5, world_min_x=-5,
                    world_max_y=5, world_min_y=-5)
    rng = np.random.default_rng(0)
    x = rng.uniform(-6, 6, 100)
    y = rng.uniform(-6, 6, 100)
    gi, gj = occupancy.world2grid(jnp.asarray(x), jnp.asarray(y), cfg)
    wi, wj = _np_world2grid(x, y, cfg)
    np.testing.assert_array_equal(np.asarray(gi), wi)
    np.testing.assert_array_equal(np.asarray(gj), wj)


def test_grid2world_roundtrip():
    cfg = MapConfig()
    i = jnp.arange(0, cfg.width, 100)
    j = jnp.arange(0, cfg.height, 100)
    x, y = occupancy.grid2world(i, j, cfg)
    gi, gj = occupancy.world2grid(jnp.asarray(x) + cfg.resolution / 2,
                                  jnp.asarray(y) + cfg.resolution / 2, cfg)
    np.testing.assert_array_equal(np.asarray(gi), np.asarray(i))
    np.testing.assert_array_equal(np.asarray(gj), np.asarray(j))


def test_single_scan_update_matches_spec():
    cfg = MapConfig(resolution=0.1, world_max_x=10, world_min_x=-10,
                    world_max_y=10, world_min_y=-10)
    rng = np.random.default_rng(1)
    pts = _random_scan(rng)
    pose = np.array([0.5, -0.3, 0.7])
    K = occupancy.max_ray_cells(cfg, 8.0)

    got = occupancy.update_map(
        jnp.zeros((cfg.width, cfg.height), jnp.float32),
        jnp.asarray(pose), jnp.asarray(pts),
        jnp.ones(len(pts), bool), cfg, K)
    want = _np_update_map(np.zeros((cfg.width, cfg.height)), pose, pts, cfg)
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-5)


def test_update_with_out_of_map_endpoints():
    """Endpoints beyond the map edge: last in-bounds cell gets +log4
    (reference quirk, modules/ogm.py:181-185)."""
    cfg = MapConfig(resolution=0.5, world_max_x=3, world_min_x=-3,
                    world_max_y=3, world_min_y=-3)
    # ray straight +x to 10 m: far outside the 3 m map
    pts = np.array([[10.0, 0.0]])
    pose = np.zeros(3)
    K = occupancy.max_ray_cells(cfg, 12.0)
    got = np.asarray(occupancy.update_map(
        jnp.zeros((cfg.width, cfg.height), jnp.float32),
        jnp.asarray(pose), jnp.asarray(pts), jnp.ones(1, bool), cfg, K))
    want = _np_update_map(np.zeros((cfg.width, cfg.height)), pose, pts, cfg)
    np.testing.assert_allclose(got, want, atol=1e-6)
    # the boundary cell must hold +log4 (occupied), interior cells -log4
    assert got.max() == np.float32(LOG4)
    assert (got < 0).sum() > 0


def test_masked_rays_contribute_nothing():
    cfg = MapConfig(resolution=0.1, world_max_x=5, world_min_x=-5,
                    world_max_y=5, world_min_y=-5)
    rng = np.random.default_rng(2)
    pts = _random_scan(rng, n=32, rmax=4.0)
    mask = np.zeros(32, dtype=bool)
    mask[:16] = True
    K = occupancy.max_ray_cells(cfg, 4.0)
    got = occupancy.update_map(jnp.zeros((cfg.width, cfg.height), jnp.float32),
                               jnp.zeros(3), jnp.asarray(pts), jnp.asarray(mask), cfg, K)
    want = _np_update_map(np.zeros((cfg.width, cfg.height)), np.zeros(3), pts[:16], cfg)
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-5)


def test_build_map_multi_scan_matches_sequential_spec():
    cfg = MapConfig(resolution=0.1, world_max_x=8, world_min_x=-8,
                    world_max_y=8, world_min_y=-8)
    rng = np.random.default_rng(3)
    n_scans, n_rays = 5, 48
    poses = np.cumsum(rng.normal(0, 0.1, (n_scans, 3)), axis=0)
    pts = np.stack([_random_scan(rng, n_rays, 6.0) for _ in range(n_scans)])
    K = occupancy.max_ray_cells(cfg, 6.0)

    got = occupancy.build_logodds(jnp.asarray(poses), jnp.asarray(pts),
                                  jnp.ones((n_scans, n_rays), bool), cfg, K)
    want = np.zeros((cfg.width, cfg.height))
    for i in range(n_scans):
        want = _np_update_map(want, poses[i], pts[i], cfg)
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-4)


def test_clip_applied_per_scan():
    """Repeated observation of one cell saturates at the clip, and the clip
    happens after every scan (reference: modules/ogm.py:188)."""
    cfg = MapConfig(resolution=0.5, world_max_x=3, world_min_x=-3,
                    world_max_y=3, world_min_y=-3)
    pts = np.tile(np.array([[1.0, 0.0]]), (1, 1))
    n_scans = 40  # 40*log4 >> 20
    poses = np.zeros((n_scans, 3))
    ptss = np.tile(pts[None], (n_scans, 1, 1))
    K = occupancy.max_ray_cells(cfg, 4.0)
    got = np.asarray(occupancy.build_logodds(
        jnp.asarray(poses), jnp.asarray(ptss),
        jnp.ones((n_scans, 1), bool), cfg, K))
    assert got.max() <= 20.0 and got.min() >= -20.0
    assert np.isclose(got.max(), 20.0)


def test_finalize_grid_semantics():
    lo = jnp.asarray(np.array([[-5.0, 0.0, 5.0]], dtype=np.float32))
    grid = np.asarray(occupancy.finalize_grid(lo))
    # pmf = sigmoid(-logodds): -5 -> ~0.99 (FREE, marked 1); 0 -> 0.5 -> 0; +5 -> 0
    np.testing.assert_array_equal(grid, [[1, 0, 0]])


def test_ogm_class_wrapper(tmp_path):
    ogm = occupancy.OccupancyGridMap.create(0.1, 5, 5, -5, -5, range_max=6.0)
    rng = np.random.default_rng(4)
    poses = np.zeros((3, 3))
    pts = np.stack([_random_scan(rng, 32, 4.0) for _ in range(3)])
    ogm.build_map(poses, pts)
    assert ogm.grid_map.shape == (ogm.grid_map_width, ogm.grid_map_height)
    assert ogm.grid_map.dtype == np.uint8
    ogm.plot_log_odds_map(str(tmp_path / "lo.png"))
    ogm.plot_map(str(tmp_path / "map.png"))
    from lidar_slam.utils.png import read_png
    img = read_png(str(tmp_path / "lo.png"))
    assert img.shape == (ogm.grid_map_width, ogm.grid_map_height)
