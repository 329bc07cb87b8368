"""Global relocalization (models/relocalization.py).

Covers: the sliding-max pyramid against a brute-force pool, the beam
search's exactness certificate against exhaustive leaf enumeration, the
kidnapped-robot recovery on a synthetic world (any heading), and the ICP
polish. New surface — no reference analog; the scoring convention is
pinned to the particle filter's (hit map + world2grid cells).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from lidar_slam.config import LidarConfig, MapConfig
from lidar_slam.models import occupancy, relocalization as rl
from lidar_slam.ops import scan as scan_ops
from lidar_slam.utils import io as uio


def test_max_pyramid_matches_bruteforce():
    rng = np.random.default_rng(0)
    im = (rng.random((37, 29)) > 0.8).astype(np.float32)
    levels = rl.build_max_pyramid(jnp.asarray(im), 4)
    for k, m in enumerate(levels):
        w = 1 << k
        pad = np.pad(im, ((0, w), (0, w)))
        brute = np.max(np.stack([pad[di:di + 37, dj:dj + 29]
                                 for di in range(w) for dj in range(w)]), 0)
        assert np.array_equal(np.asarray(m), brute), f"level {k}"


@pytest.fixture(scope="module")
def world():
    """Small synthetic world: ground-truth map + robot-frame scans."""
    ds = uio.synthetic_dataset(n_steps=160, n_rays=541, seed=3)
    gt = jnp.asarray(ds["ground_truth"])
    pts, mask = scan_ops.scans_to_points(
        jnp.asarray(ds["lidar"]["ranges"]), 0.1, 30.0, LidarConfig())
    mcfg = MapConfig(world_max_x=16.0, world_min_x=-16.0,
                     world_max_y=16.0, world_min_y=-16.0, resolution=0.1)
    K = occupancy.max_ray_cells(mcfg, 30.0)
    lo = occupancy.build_logodds(gt, pts, mask, mcfg, K)
    return np.asarray(ds["ground_truth"]), pts, mask, mcfg, lo


def _brute_best(im, mcfg, pts, mask, cfg, center):
    """Exhaustive leaf enumeration over the search's FULL block tiling
    (the tiling rounds the window up to the coarsest block, so the brute
    grid must too for score equality to be a theorem)."""
    angles = (cfg.yaw_center - cfg.yaw_span / 2.0
              + cfg.yaw_span * np.arange(cfg.n_angles) / cfg.n_angles)
    ctr = jnp.asarray(center, jnp.float32)
    bi, bj, rm = rl._base_cells(pts, mask, ctr, angles, mcfg, cfg.max_rays)
    S = int(np.ceil(cfg.search_radius / mcfg.resolution))
    block = 1 << (cfg.n_levels - 1)
    T = -((-(2 * S + 1)) // block)
    off = np.arange(T * block, dtype=np.int32) - S
    a0, u0, v0 = np.meshgrid(np.arange(cfg.n_angles, dtype=np.int32),
                             off, off, indexing="ij")
    ai, oi, oj = map(jnp.asarray, (a0.ravel(), u0.ravel(), v0.ravel()))
    scores = rl._score_nodes(im, bi, bj, rm, ai, oi, oj,
                             jnp.ones(ai.shape, bool), leaf=True,
                             chunk=cfg.score_chunk)
    return float(jnp.max(scores))


def test_certified_search_is_exact(world):
    gt, pts, mask, mcfg, lo = world
    im = rl.hit_map(lo)
    cfg = rl.RelocConfig(n_angles=24, search_radius=2.0, n_levels=3,
                         beam=256, max_rays=96, score_chunk=4096)
    k = 80
    res = rl.relocalize(im, mcfg, pts[k], mask[k], cfg,
                        center=(float(gt[k, 0]), float(gt[k, 1])))
    assert bool(res.certified)
    brute = _brute_best(im, mcfg, pts[k], mask[k], cfg,
                        (float(gt[k, 0]), float(gt[k, 1])))
    assert float(res.score) == pytest.approx(brute)
    assert float(res.pruned_margin) >= 0.0


def test_tiny_beam_certificate_is_sound(world):
    """A starved beam may lose the optimum — but then it must SAY so:
    certified implies score == exhaustive optimum, at every beam size."""
    gt, pts, mask, mcfg, lo = world
    im = rl.hit_map(lo)
    k = 40
    base = dict(n_angles=16, search_radius=1.6, n_levels=3, max_rays=64,
                score_chunk=4096)
    brute = None
    for beam in (2, 8, 64):
        cfg = rl.RelocConfig(beam=beam, **base)
        if brute is None:
            brute = _brute_best(im, mcfg, pts[k], mask[k], cfg,
                                (float(gt[k, 0]), float(gt[k, 1])))
        res = rl.relocalize(im, mcfg, pts[k], mask[k], cfg,
                            center=(float(gt[k, 0]), float(gt[k, 1])))
        assert float(res.score) <= brute + 1e-6
        # certified => provably optimal; uncertified makes NO claim (the
        # beam may still have found the optimum without being able to
        # prove it — only the implication is a theorem).
        if bool(res.certified):
            assert float(res.score) == pytest.approx(brute)


def test_kidnapped_robot_recovery_any_heading(world):
    """No prior beyond 'within the window of the map center': the search
    must land within one cell + one angle step of ground truth, and the
    ICP polish must tighten translation below half a cell."""
    gt, pts, mask, mcfg, lo = world
    cfg = rl.RelocConfig(n_angles=72, search_radius=5.0, n_levels=4,
                         beam=512, max_rays=128)
    for k in (30, 120):
        grid_res, refined, err = rl.relocalize_refined(
            lo, mcfg, pts[k], mask[k], cfg, center=(0.0, 0.0))
        assert bool(grid_res.certified)
        g = np.asarray(grid_res.pose)
        dth = (g[2] - gt[k, 2] + np.pi) % (2 * np.pi) - np.pi
        assert abs(g[0] - gt[k, 0]) <= 1.5 * mcfg.resolution
        assert abs(g[1] - gt[k, 1]) <= 1.5 * mcfg.resolution
        assert abs(dth) <= 2 * np.pi / cfg.n_angles
        r = np.asarray(refined)
        dth_r = (r[2] - gt[k, 2] + np.pi) % (2 * np.pi) - np.pi
        assert np.hypot(r[0] - gt[k, 0], r[1] - gt[k, 1]) <= 1.2 * mcfg.resolution
        assert abs(dth_r) <= 2 * np.pi / cfg.n_angles
        assert float(err) < 1e-3


def test_leaf_score_is_exact_hit_count(world):
    """Leaf scoring == direct numpy count of subsampled endpoints landing
    on occupied cells (pins the scoring convention to the map builder's)."""
    gt, pts, mask, mcfg, lo = world
    im = rl.hit_map(lo)
    k = 100
    cfg = rl.RelocConfig(n_angles=1, yaw_center=float(gt[k, 2]),
                         yaw_span=0.0, search_radius=0.1, n_levels=1,
                         max_rays=128, score_chunk=256)
    res = rl.relocalize(im, mcfg, pts[k], mask[k], cfg,
                        center=(float(gt[k, 0]), float(gt[k, 1])))
    # zero-offset leaf: count by hand
    stride = max(1, -(-pts[k].shape[0] // cfg.max_rays))
    p = np.asarray(pts[k][::stride])
    m = np.asarray(mask[k][::stride])
    c, s = np.cos(gt[k, 2]), np.sin(gt[k, 2])
    xw = c * p[:, 0] - s * p[:, 1] + gt[k, 0]
    yw = s * p[:, 0] + c * p[:, 1] + gt[k, 1]
    gi = np.ceil((xw - mcfg.world_min_x) / mcfg.resolution).astype(int) - 1
    gj = np.ceil((yw - mcfg.world_min_y) / mcfg.resolution).astype(int) - 1
    ok = m & (gi >= 0) & (gi < mcfg.width) & (gj >= 0) & (gj < mcfg.height)
    hits = np.asarray(im)[np.clip(gi, 0, mcfg.width - 1),
                          np.clip(gj, 0, mcfg.height - 1)]
    manual = float(np.sum(np.where(ok, hits, 0.0)))
    # the search may find an offset scoring >= the zero-offset pose
    assert float(res.score) >= manual
    # and at zero search radius with the exact yaw the gt leaf is in the
    # grid, so the best must be >= manual; sanity: manual itself is large
    assert manual > 0.5 * m.sum() * 0.5


def test_occupied_points_centers_and_padding(world):
    gt, pts, mask, mcfg, lo = world
    out, m = rl.occupied_points(np.asarray(lo), mcfg, max_pts=128)
    assert out.shape == (128, 2) and m.shape == (128,)
    assert m.any()
    lo_np = np.asarray(lo)
    # every returned live point must be the center of an occupied cell
    xs, ys = out[m, 0], out[m, 1]
    gi = np.ceil((xs - mcfg.world_min_x) / mcfg.resolution).astype(int) - 1
    gj = np.ceil((ys - mcfg.world_min_y) / mcfg.resolution).astype(int) - 1
    assert (lo_np[gi, gj] > 0).all()
    # centers: re-derived world coords sit half a cell above the cell edge
    # (float32 storage => loose atol at |x| ~ tens of meters)
    assert np.allclose((xs - mcfg.world_min_x) / mcfg.resolution - gi, 0.5,
                       atol=1e-3)
