"""Global relocalization: multi-resolution correlative scan matching.

New surface (no reference analog — SURVEY.md lists mapCorrelation,
reference code/pr2_utils.py:12-43, as the course starter's intended
localization kernel; models/particle_filter.py completes the TRACKING
use, this module completes the GLOBAL one). Solves the kidnapped-robot
problem: given only an occupancy map and a single scan, find the robot
pose with no prior better than "somewhere in this window".

The classic solution is branch-and-bound over a max-pooled map pyramid
(Olson 2009; Cartographer's real-time loop closure). Best-first BnB is a
sequential, data-dependent tree walk — hostile to XLA. The XLA
restructuring here keeps the pyramid's admissible bound but replaces the
tree walk with a BATCHED coarse-to-fine beam plus a post-hoc exactness
certificate:

  - pyramid level k holds the sliding-window max of the hit map over
    2^k x 2^k cell windows (built in k doubling passes), so one gather-sum
    at level k upper-bounds the true score of EVERY leaf pose in the
    node's 2^k x 2^k translation block;
  - every level scores ALL its candidate nodes in one fixed-shape
    gather-sum over the subsampled scan (the particle-filter scoring
    shape, models/particle_filter._score_particles) and keeps the top
    `beam` nodes (lax.top_k). No data-dependent control flow anywhere;
  - instead of pruning-with-invariant, exactness is CERTIFIED after the
    fact: the best bound among nodes the beam dropped is recorded per
    level, and the returned leaf is provably the global optimum over the
    sampled pose grid iff no dropped bound exceeds its score
    (`certified`, with the margin in `pruned_margin`). If a run comes
    back uncertified, rerun with a larger beam.

The search grid is (n_angles yaw samples) x (every map cell in the
window); the certificate is exact over that grid, and the optional ICP
polish (`relocalize_refined`) recovers the sub-cell / sub-step remainder
against the occupied-cell centers, reusing ops/icp.py end to end.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import List, NamedTuple, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..config import MapConfig
from ..models import occupancy
from ..ops import icp as icp_ops
from ..utils import se2


@dataclass(frozen=True)
class RelocConfig:
    """Global-relocalization search parameters (new surface).

    The pose grid searched is exact: `n_angles` yaw samples spanning
    `yaw_span` around `yaw_center`, times every grid cell within
    `search_radius` meters of the search center. `n_levels` sets the
    coarsest translation block (2^(n_levels-1) cells); `beam` is the
    node budget carried between levels; `max_rays` subsamples the scan
    with a static stride (scoring cost is linear in it).
    """

    n_angles: int = 360
    yaw_center: float = 0.0
    yaw_span: float = 2.0 * np.pi
    search_radius: float = 10.0
    n_levels: int = 5
    beam: int = 1024
    max_rays: int = 256
    score_chunk: int = 16384  # nodes scored per lax.map step (memory bound)
    # ICP-polish target window: occupied cells within (max masked scan
    # range + icp_margin) of the grid candidate. Scales with the scan
    # instead of the search window, so dataset-scale maps don't dilute
    # the fixed-size target subsample with far-away cells.
    icp_margin: float = 5.0


class RelocResult(NamedTuple):
    pose: jnp.ndarray           # (3,) best grid pose (cell/angle resolution)
    score: jnp.ndarray          # () true hit count of the best leaf
    certified: jnp.ndarray      # () bool: provably optimal over the grid
    pruned_margin: jnp.ndarray  # () score - max dropped bound (>= 0 iff certified)


def hit_map(logodds: jnp.ndarray) -> jnp.ndarray:
    """Occupancy hit map for correlative scoring: 1.0 where the log-odds
    grid says obstacle, 0.0 elsewhere (the particle filter's convention,
    models/particle_filter.py)."""
    return (logodds > 0).astype(jnp.float32)


def build_max_pyramid(im: jnp.ndarray, n_levels: int) -> List[jnp.ndarray]:
    """Sliding-window max pyramid: level k holds, at full resolution,
    max over the 2^k x 2^k window anchored low at each cell.

    pool[k][i, j] = max(im[i:i+2^k, j:j+2^k]) with out-of-range cells
    treated as 0. im must be non-negative for the zero padding to be an
    upper bound, so it is clamped here — passing raw log-odds instead of
    hit_map(logodds) degrades scores but can no longer invalidate the
    certificate. Built in k doubling passes of three shifted maxima, so
    the whole pyramid costs O(n_levels) cheap elementwise passes instead
    of one O(window^2) pool per level.
    """
    im = jnp.maximum(im, 0.0)
    levels = [im]
    m = im
    for k in range(n_levels - 1):
        s = 1 << k
        mi = jnp.pad(m, ((0, s), (0, 0)))[s:, :]
        mj = jnp.pad(m, ((0, 0), (0, s)))[:, s:]
        mij = jnp.pad(m, ((0, s), (0, s)))[s:, s:]
        m = jnp.maximum(jnp.maximum(m, mi), jnp.maximum(mj, mij))
        levels.append(m)
    return levels


@partial(jax.jit, static_argnames=("leaf", "chunk"))
def _score_nodes(pool: jnp.ndarray, base_i: jnp.ndarray, base_j: jnp.ndarray,
                 rmask: jnp.ndarray, ai: jnp.ndarray, oi: jnp.ndarray,
                 oj: jnp.ndarray, live: jnp.ndarray,
                 leaf: bool, chunk: int) -> jnp.ndarray:
    """Score a node list against one pyramid level.

    pool (W, H) level map; base_i/base_j (A, R) endpoint cells of the
    subsampled scan at the search-center translation for each yaw sample;
    rmask (R,) ray validity; ai/oi/oj (n,) node (angle, cell-offset)
    coordinates; live (n,) False for padding (scored -inf). Nodes are
    scored in `chunk`-sized slices under lax.map so peak memory is
    O(chunk * R) regardless of n.

    Non-leaf levels gather with CLIPPED indices and no bounds mask: for
    an out-of-window anchor the clipped pooled value still upper-bounds
    every in-bounds leaf below it (children sit within 2^k of the anchor,
    inside the window the clipped cell's pool covers), and fully
    out-of-bounds subtrees score >= their true 0. Leaf level applies the
    true out-of-bounds mask so the returned score is the exact hit count.
    """
    W, H = pool.shape
    n = ai.shape[0]
    pad = (-n) % chunk
    ai_c = jnp.pad(ai, (0, pad)).reshape(-1, chunk)
    oi_c = jnp.pad(oi, (0, pad)).reshape(-1, chunk)
    oj_c = jnp.pad(oj, (0, pad)).reshape(-1, chunk)

    def score_chunk(node):
        a, u, v = node
        gi = base_i[a] + u[:, None]          # (chunk, R)
        gj = base_j[a] + v[:, None]
        vals = pool[jnp.clip(gi, 0, W - 1), jnp.clip(gj, 0, H - 1)]
        ok = rmask[None, :]
        if leaf:
            ok = ok & (gi >= 0) & (gi < W) & (gj >= 0) & (gj < H)
        return jnp.sum(jnp.where(ok, vals, 0.0), axis=1)

    scores = jax.lax.map(score_chunk, (ai_c, oi_c, oj_c)).reshape(-1)[:n]
    return jnp.where(live, scores, -jnp.inf)


@partial(jax.jit, static_argnames=("k",))
def _keep_top(scores: jnp.ndarray, ai, oi, oj, k: int):
    """Beam select: top-k nodes plus the best DROPPED score (the
    certificate input; -inf when nothing is dropped)."""
    n = scores.shape[0]
    if n <= k:
        return scores, ai, oi, oj, jnp.float32(-jnp.inf)
    top, idx = jax.lax.top_k(scores, k + 1)
    pruned_max = top[k]
    keep = idx[:k]
    return top[:k], ai[keep], oi[keep], oj[keep], pruned_max


def _base_cells(pts: jnp.ndarray, mask: jnp.ndarray, center: jnp.ndarray,
                angles: np.ndarray, map_cfg: MapConfig,
                max_rays: int) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Endpoint cells of the (stride-subsampled) scan for every yaw sample,
    translated to the search center. Returns (A, R') i/j cells + (R',) mask."""
    R = pts.shape[0]
    stride = max(1, -(-R // max_rays))  # ceil div: static shapes
    p = pts[::stride]
    m = mask[::stride]
    th = jnp.asarray(angles, jnp.float32)
    c, s = jnp.cos(th)[:, None], jnp.sin(th)[:, None]
    xw = c * p[None, :, 0] - s * p[None, :, 1] + center[0]
    yw = s * p[None, :, 0] + c * p[None, :, 1] + center[1]
    gi, gj = occupancy.world2grid(xw, yw, map_cfg)
    return gi.astype(jnp.int32), gj.astype(jnp.int32), m


def relocalize(im: jnp.ndarray, map_cfg: MapConfig, pts: jnp.ndarray,
               mask: jnp.ndarray, cfg: RelocConfig = RelocConfig(),
               center: Tuple[float, float] = (0.0, 0.0),
               score_fn=None, return_leaves: bool = False) -> RelocResult:
    """Find the scan's pose in the map by certified coarse-to-fine search.

    im (W, H) non-negative scoring map (hit_map(logodds)); pts (R, 2)
    robot-frame scan points; mask (R,) validity; center: search window
    center in world meters. The level loop is a short static Python loop
    (shapes per level are fixed by cfg), so the whole search compiles to
    ~3 programs regardless of map or window size. score_fn overrides the
    node scorer (same signature as _score_nodes — pass
    parallel.sharding.sharded_reloc_score(mesh) to shard the node axis
    over a device mesh, bit-identically).
    """
    score_nodes = _score_nodes if score_fn is None else score_fn
    angles = (cfg.yaw_center - cfg.yaw_span / 2.0
              + cfg.yaw_span * np.arange(cfg.n_angles) / cfg.n_angles)
    ctr = jnp.asarray(center, jnp.float32)
    base_i, base_j, rmask = _base_cells(pts, mask, ctr, angles, map_cfg,
                                        cfg.max_rays)
    pyramid = build_max_pyramid(im, cfg.n_levels)

    S = int(np.ceil(cfg.search_radius / map_cfg.resolution))
    kmax = cfg.n_levels - 1
    block = 1 << kmax
    T = -((-(2 * S + 1)) // block)
    us = np.arange(T, dtype=np.int32) * block - S
    a0, u0, v0 = np.meshgrid(np.arange(cfg.n_angles, dtype=np.int32), us, us,
                             indexing="ij")
    ai, oi, oj = (jnp.asarray(a0.ravel()), jnp.asarray(u0.ravel()),
                  jnp.asarray(v0.ravel()))
    live = jnp.ones(ai.shape, bool)

    pruned = []
    for k in range(kmax, -1, -1):
        scores = score_nodes(pyramid[k], base_i, base_j, rmask, ai, oi, oj,
                             live, leaf=(k == 0), chunk=cfg.score_chunk)
        if k == 0:
            break
        scores, ai, oi, oj, pmax = _keep_top(scores, ai, oi, oj, cfg.beam)
        pruned.append(pmax)
        s = 1 << (k - 1)
        n = ai.shape[0]
        ai = jnp.tile(ai, 4)
        di = jnp.repeat(jnp.asarray([0, s, 0, s], jnp.int32), n)
        dj = jnp.repeat(jnp.asarray([0, 0, s, s], jnp.int32), n)
        oi = jnp.tile(oi, 4) + di
        oj = jnp.tile(oj, 4) + dj
        # The block tiling rounds the window up to a multiple of the
        # coarsest block, so leaves can sit up to one block past the
        # requested radius — the window is covered, never truncated.
        live = jnp.tile(jnp.isfinite(scores), 4)

    best = jnp.argmax(scores)
    s_star = scores[best]
    res = jnp.float32(map_cfg.resolution)
    pose = jnp.stack([ctr[0] + oi[best].astype(jnp.float32) * res,
                      ctr[1] + oj[best].astype(jnp.float32) * res,
                      jnp.asarray(angles, jnp.float32)[ai[best]]])
    pruned_max = (jnp.stack(pruned).max() if pruned
                  else jnp.float32(-jnp.inf))
    result = RelocResult(pose=pose, score=s_star,
                         certified=pruned_max <= s_star,
                         pruned_margin=s_star - pruned_max)
    if not return_leaves:
        return result
    return result, (scores, ai, oi, oj)


def top_candidates(leaves, angles: np.ndarray, center, map_cfg: MapConfig,
                   n_best: int, nms_radius: float = 1.0,
                   nms_yaw: float = 0.35) -> Tuple[np.ndarray, np.ndarray]:
    """Distinct pose hypotheses from the leaf-level node list: greedy
    score-ranked non-max suppression over (translation, yaw) — two nodes
    are duplicates when both their distance is under `nms_radius` meters
    AND their yaw gap is under `nms_yaw` rad (same place at a different
    heading is a distinct hypothesis; the polish disambiguates).

    Host-side (relocalization is a rare event). Returns
    (poses (k, 3), scores (k,)) with k <= n_best.
    """
    scores, ai, oi, oj = (np.asarray(x) for x in leaves)
    res = map_cfg.resolution
    order = np.argsort(-scores)
    order = order[np.isfinite(scores[order])]
    kept: list[int] = []
    yaws = np.asarray(angles)
    for idx in order:
        x = center[0] + oi[idx] * res
        y = center[1] + oj[idx] * res
        th = yaws[ai[idx]]
        dup = False
        for j in kept:
            dx = x - (center[0] + oi[j] * res)
            dy = y - (center[1] + oj[j] * res)
            dth = abs((th - yaws[ai[j]] + np.pi) % (2 * np.pi) - np.pi)
            if dx * dx + dy * dy < nms_radius ** 2 and dth < nms_yaw:
                dup = True
                break
        if not dup:
            kept.append(int(idx))
            if len(kept) >= n_best:
                break
    poses = np.stack([
        np.asarray([center[0] + oi[j] * res, center[1] + oj[j] * res,
                    yaws[ai[j]]], np.float32) for j in kept])
    return poses, scores[kept]


def occupied_points(logodds: np.ndarray, map_cfg: MapConfig,
                    max_pts: int = 4096,
                    center: Tuple[float, float] | None = None,
                    radius: float | None = None) -> Tuple[np.ndarray, np.ndarray]:
    """Occupied-cell CENTERS as a fixed-shape (max_pts, 2) cloud + mask.

    Host-side prep for the ICP polish (relocalization is a rare event, not
    a per-step path). world2grid maps cell i to world (i*res, (i+1)*res]
    (the reference's ceil-1 convention), so the center is at (i+0.5)*res —
    the half-cell matters at ICP accuracy. Evenly subsamples when more
    than max_pts cells qualify; pads with mask=False otherwise.
    """
    lo = np.asarray(logodds)
    ii, jj = np.nonzero(lo > 0)
    x = (ii + 0.5) * map_cfg.resolution + map_cfg.world_min_x
    y = (jj + 0.5) * map_cfg.resolution + map_cfg.world_min_y
    if center is not None and radius is not None:
        keep = ((x - center[0]) ** 2 + (y - center[1]) ** 2) <= radius ** 2
        x, y = x[keep], y[keep]
    n = x.shape[0]
    if n > max_pts:
        sel = np.linspace(0, n - 1, max_pts).astype(np.int64)
        x, y = x[sel], y[sel]
        n = max_pts
    out = np.zeros((max_pts, 2), np.float32)
    out[:n, 0], out[:n, 1] = x, y
    m = np.zeros(max_pts, bool)
    m[:n] = True
    return out, m


def relocalize_refined(
    logodds: jnp.ndarray, map_cfg: MapConfig, pts: jnp.ndarray,
    mask: jnp.ndarray, cfg: RelocConfig = RelocConfig(),
    center: Tuple[float, float] = (0.0, 0.0),
    icp_max_iters: int = 100, icp_max_pts: int = 4096,
    score_fn=None, n_candidates: int = 1,
) -> Tuple[RelocResult, jnp.ndarray, jnp.ndarray]:
    """Grid search + ICP polish: returns (grid result, refined pose, icp err).

    The grid result is cell/angle-quantized; the polish runs planar ICP
    (ops/icp.py — T aligns src to tgt) from it against the occupied-cell
    centers near the candidate, recovering the sub-cell remainder.
    score_fn is forwarded to relocalize(), so the sharded multi-chip
    scorer (parallel.sharding.sharded_reloc_score) works through the
    polished entry point too.

    With n_candidates > 1, the top candidates by grid score (NMS'd over
    (translation, yaw) — top_candidates) are ALL polished in one batched
    ICP call and the lowest NORMALIZED ICP ERROR wins. Correlative hit
    counts alias in self-similar rooms (two walls can explain a scan
    almost equally well, especially on a sparse causal map); the
    continuous geometric fit separates the true pose from such aliases by
    orders of magnitude, so error-ranked selection is the robust mode for
    kidnapped-robot recovery. The returned grid RelocResult still
    describes the score-ranked best (its certificate applies to the grid
    score, not the final selection).
    """
    out = relocalize(hit_map(logodds), map_cfg, pts, mask, cfg, center,
                     score_fn=score_fn, return_leaves=True)
    grid_res, leaves = out
    angles = (cfg.yaw_center - cfg.yaw_span / 2.0
              + cfg.yaw_span * np.arange(cfg.n_angles) / cfg.n_angles)
    if n_candidates > 1:
        cand, _ = top_candidates(leaves, angles, center, map_cfg,
                                 n_candidates)
    else:
        cand = np.asarray(grid_res.pose, np.float32)[None]
    B = cand.shape[0]
    # target window scales with the scan: every map cell the scan could
    # plausibly touch from the candidate pose, plus a drift margin
    scan_reach = float(jnp.max(jnp.where(
        mask, jnp.linalg.norm(pts, axis=-1), 0.0)))
    lo_np = np.asarray(logodds)
    tgts = np.zeros((B, icp_max_pts, 2), np.float32)
    tgt_ms = np.zeros((B, icp_max_pts), bool)
    for b in range(B):
        tgts[b], tgt_ms[b] = occupied_points(
            lo_np, map_cfg, max_pts=icp_max_pts,
            center=(float(cand[b, 0]), float(cand[b, 1])),
            radius=scan_reach + cfg.icp_margin)
    cand_j = jnp.asarray(cand)
    src_w = se2.transform_points(pts[None], se2.T_from_pose(cand_j))
    res = icp_ops.run_icp_batch(
        icp_ops.lift_to_3d(src_w), icp_ops.lift_to_3d(jnp.asarray(tgts)),
        jnp.broadcast_to(mask, (B,) + mask.shape), jnp.asarray(tgt_ms),
        jnp.broadcast_to(jnp.eye(4, dtype=src_w.dtype), (B, 4, 4)),
        max_iters=icp_max_iters, normalize_error=True, planar=True)
    best = int(jnp.argmin(res.error))
    T2 = se2.TSE2_from_TSE3(res.T[best])
    refined = se2.pose_from_T(T2 @ se2.T_from_pose(cand_j[best]))
    return grid_res, refined, res.error[best]
