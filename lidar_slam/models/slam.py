"""End-to-end SLAM pipeline orchestration.

Capability parity with the reference driver flow (reference: main.py:67-247):
load -> synchronize -> scan prep -> optional filters -> odometry ->
[scan matching] -> [pose graph with fixed-interval loop closures] ->
occupancy grid -> [texture map]. Host code touches only file IO; every
compute stage is jitted device code over fixed-shape masked arrays.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SlamConfig
from ..ops import icp as icp_ops
from ..ops import scan as scan_ops
from ..utils import se2
from . import occupancy, odometry, pose_graph, scan_matching


@dataclasses.dataclass
class SlamResult:
    poses_odom: np.ndarray
    relative_poses_odom: np.ndarray
    poses: np.ndarray  # final poses for the selected mode
    poses_scan_matching: Optional[np.ndarray] = None
    relative_poses_scan_matching: Optional[np.ndarray] = None
    poses_optimized: Optional[np.ndarray] = None
    n_loop_closures: int = 0
    logodds: Optional[np.ndarray] = None
    grid_map: Optional[np.ndarray] = None


def loop_closure_candidates(n_poses: int, fixed_interval: int) -> np.ndarray:
    """Candidate indices i for closures (i, i+interval)
    (reference: main.py:161)."""
    return np.arange(0, n_poses - fixed_interval, fixed_interval)


@partial(jax.jit, static_argnames=("chunk_size", "gate_yaw",
                                   "trim_fraction", "epsilon",
                                   "stopping_thresh"))
def compute_loop_closures_pairs(
    points3: jnp.ndarray,
    masks: jnp.ndarray,
    loop_i: jnp.ndarray,
    loop_j: jnp.ndarray,
    max_distance: float,
    max_yaw_deg: float,
    chunk_size: int = 64,
    gate_yaw: bool = True,
    seed_T: jnp.ndarray | None = None,
    trim_fraction: float = 1.0,
    epsilon: float = 0.01,
    stopping_thresh: float = 1e-4,
):
    """Loop-closure ICPs for arbitrary (i, j) pairs, batched, with the
    reference gate semantics (main.py:161-172): identity-seeded ICP of
    scan i onto scan j with NORMALIZED error and the reference's default
    epsilon (0.01); accepted when translation < max_distance and (when
    gate_yaw) signed angle in degrees < max_yaw (the reference gates the
    signed angle, not its absolute value — replicated faithfully).
    gate_yaw=False is for proximity revisit pairs, whose relative heading
    is unconstrained by the per-step motion bound.

    seed_T (B, 3, 3) SE(2) seeds replace the identity seeds (prior-seeded
    verification — required for revisits with large heading difference,
    where identity is outside the true basin); with seeds the translation
    gate applies to the CORRECTION |t - t_seed| rather than |t| (the
    proposer's drift bound bounds the correction, not the transform).
    trim_fraction < 1 runs TRIMMED ICP (ops/icp.py) for partial-overlap
    pairs. epsilon/stopping_thresh default to the reference loop-ICP
    settings (0.01 normalized / 1e-4), under which the loop stops almost
    immediately — fine for the reference's near-identity gate, but
    seeded verification needs CONVERGED measurements: pass tight values
    (slam's seeded path uses 1e-9 / 1e-8). Defaults are exact
    reference-parity behavior.
    """
    src = points3[loop_i]
    tgt = points3[loop_j]
    sm = masks[loop_i]
    tm = masks[loop_j]
    B = src.shape[0]
    if seed_T is None:
        seeds = jnp.tile(jnp.eye(4, dtype=points3.dtype), (B, 1, 1))
    else:
        seeds = se2.TSE3_from_TSE2(jnp.asarray(seed_T, points3.dtype))
    T_icp, errors, iters = scan_matching.icp_all_pairs(
        src, tgt, sm, tm, seeds,
        epsilon=epsilon, stopping_thresh=stopping_thresh,
        normalize_error=True, chunk_size=chunk_size,
        planar=True, trim_fraction=trim_fraction)
    T2 = se2.TSE2_from_TSE3(T_icp)
    if seed_T is None:
        translation = jnp.linalg.norm(T2[:, :2, 2], axis=-1)
    else:
        translation = jnp.linalg.norm(
            T2[:, :2, 2] - jnp.asarray(seed_T)[:, :2, 2], axis=-1)
    accept = translation < max_distance
    if gate_yaw:
        angle = jnp.arctan2(T2[:, 1, 0], T2[:, 0, 0])
        accept = accept & (jnp.rad2deg(angle) < max_yaw_deg)
    return T2, accept, errors, iters


@partial(jax.jit, static_argnames=("fixed_interval", "chunk_size"))
def compute_loop_closures(
    points3: jnp.ndarray,
    masks: jnp.ndarray,
    cand: np.ndarray,
    fixed_interval: int,
    max_distance: float,
    max_yaw_deg: float,
    chunk_size: int = 64,
):
    """Fixed-interval loop-closure ICPs (reference: main.py:161-172) —
    compute_loop_closures_pairs over the (i, i+interval) pair set."""
    cand = jnp.asarray(cand)
    return compute_loop_closures_pairs(
        points3, masks, cand, cand + fixed_interval, max_distance,
        max_yaw_deg, chunk_size=chunk_size)


@partial(jax.jit, static_argnames=("min_gap", "k"))
def _nearest_revisits(pos: jnp.ndarray, min_gap: int, k: int):
    """Per pose j: indices and squared distances of the k nearest poses i
    with j - i >= min_gap. ONE all-pairs distance computation (the long
    axis is N ~ 5k poses: a (N, N) f32 grid is ~100 MB of HBM — fine on a
    chip; chunk over j for much longer logs)."""
    n = pos.shape[0]
    d2 = jnp.sum((pos[:, None, :] - pos[None, :, :]) ** 2, axis=-1)
    ii = jnp.arange(n)[:, None]
    jj = jnp.arange(n)[None, :]
    d2 = jnp.where((jj - ii) >= min_gap, d2, jnp.inf)
    neg, idx = jax.lax.top_k(-d2.T, k)  # per j: k smallest distances
    return idx, -neg


def proximity_loop_candidates(
    poses: np.ndarray,
    min_gap: int = 100,
    radius: float = 0.5,
    max_candidates: int = 256,
    suppress_window: int = 20,
    k: int = 4,
) -> tuple[np.ndarray, np.ndarray]:
    """Propose loop-closure pairs (i, j) by REVISIT proximity: pose j has
    passed within `radius` meters of a pose i at least `min_gap` steps
    earlier. New surface — the reference proposes only fixed-interval
    pairs (main.py:161), which never span more than `interval` poses and
    therefore cannot anchor long-range drift; revisit closures can.

    Proposals come from the ESTIMATED trajectory, so when that trajectory
    has drifted, the nearest earlier pose can be a false (perceptually
    aliased) match while the true revisit sits further down the ranking —
    hence each j contributes its `k` nearest valid i's, and non-max
    suppression is deliberately DEFERRED to after ICP verification
    (suppress_verified_pairs), where pairs rank by MEASURED error rather
    than estimated distance: under drift a false pair often looks closer
    than the true revisit next to it, so distance-ranked suppression would
    discard exactly the pairs that anchor the correction. Verification is
    one batched ICP over all proposals — a few hundred pairs cost ~the
    loop-closure stage itself — so over-proposing is cheap. Only under cap
    pressure (more than `max_candidates` qualifying pairs) is a LIGHT
    distance-ranked spread applied (window `suppress_window // 4`) so one
    dense neighborhood cannot crowd distant revisits out of the cap.

    Returns (loop_i, loop_j) int32 arrays, possibly empty. Verify with
    compute_loop_closures_pairs(..., gate_yaw=False) + the normalized-ICP-
    error gate (PoseGraphConfig.proximity_max_err — the decisive filter
    against aliased matches), then suppress_verified_pairs, and solve with
    solver="direct" (spans exceed any fixed band); a robust kernel
    (robust_loss) is recommended on top.
    """
    pos = jnp.asarray(np.asarray(poses)[:, :2], jnp.float32)
    n = int(pos.shape[0])
    if n <= min_gap:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32))
    k = min(k, n)
    idx, d2 = _nearest_revisits(pos, int(min_gap), int(k))
    idx = np.asarray(idx)   # (N, k) candidate i per j
    d2 = np.asarray(d2)
    jj, kk = np.where(d2 <= radius * radius)
    order = np.argsort(d2[jj, kk], kind="stable")
    cand_i = idx[jj, kk][order].astype(np.int64)
    cand_j = jj[order].astype(np.int64)
    if cand_j.size > max_candidates:
        light = max(1, suppress_window // 4)
        keep = _suppress_greedy(cand_i, cand_j, light, max_candidates)
        cand_i, cand_j = cand_i[keep], cand_j[keep]
    return (cand_i.astype(np.int32), cand_j.astype(np.int32))


@partial(jax.jit, static_argnames=("n_bins",))
def scan_descriptors(
    ranges: jnp.ndarray,
    masks: jnp.ndarray,
    range_min: float,
    range_max: float,
    n_bins: int = 64,
) -> jnp.ndarray:
    """Per-scan place-recognition descriptor: the normalized histogram of
    valid ranges over `n_bins` bins of [range_min, range_max].

    Yaw-tolerant by construction (a sensor rotation permutes which RAY
    sees which range; the histogram ignores ray order — exactly invariant
    at 360-degree FOV, tolerant within FOV overlap at 270), and cheap:
    one chunked one-hot contraction. New surface beyond the reference
    (which has no place recognition; its loop closures are fixed-interval
    only, main.py:161).
    """
    lo = jnp.asarray(range_min, jnp.float32)
    hi = jnp.asarray(range_max, jnp.float32)

    def hist_one(args):
        r, m = args  # (R,), (R,) — lax.map batches 256 of these per step
        idx = jnp.clip(((r - lo) / (hi - lo) * n_bins).astype(jnp.int32),
                       0, n_bins - 1)
        oh = jax.nn.one_hot(idx, n_bins, dtype=jnp.float32)  # (R, B)
        h = jnp.einsum("rb,r->b", oh, m.astype(jnp.float32))
        return h / jnp.maximum(h.sum(), 1.0)

    return jax.lax.map(hist_one, (jnp.asarray(ranges, jnp.float32), masks),
                       batch_size=256)


@partial(jax.jit, static_argnames=("min_gap", "k"))
def _nearest_descriptor_revisits(desc: jnp.ndarray, min_gap: int, k: int):
    """Per scan j: indices + squared descriptor distances of the k most
    similar scans i with j - i >= min_gap, plus the median consecutive-
    scan squared distance (the self-calibrating 'same place' scale).
    All-pairs distance is ONE (N, B) x (B, N) matmul."""
    from ..utils.precision import HIGHEST
    n2 = jnp.sum(desc * desc, axis=-1)
    g = jnp.dot(desc, desc.T, precision=HIGHEST)
    d2 = jnp.maximum(n2[:, None] + n2[None, :] - 2.0 * g, 0.0)
    cons = jnp.median(jnp.diagonal(d2, offset=1))
    ii = jnp.arange(desc.shape[0])[:, None]
    jj = jnp.arange(desc.shape[0])[None, :]
    d2m = jnp.where((jj - ii) >= min_gap, d2, jnp.inf)
    neg, idx = jax.lax.top_k(-d2m.T, k)  # per j: k most similar valid i
    return idx, -neg, cons


def descriptor_loop_candidates(
    ranges: np.ndarray,
    masks: np.ndarray,
    range_min: float,
    range_max: float,
    min_gap: int = 100,
    k: int = 4,
    n_bins: int = 64,
    rel_thresh: float = 4.0,
    max_candidates: int = 256,
    suppress_window: int = 20,
) -> tuple[np.ndarray, np.ndarray]:
    """Propose loop-closure pairs by APPEARANCE: scans i and j look alike
    (squared descriptor distance <= rel_thresh x the median consecutive-
    scan squared distance) and are at least min_gap steps apart.

    Unlike proximity_loop_candidates this needs no pose estimate at all,
    so it finds revisits regardless of accumulated drift — the regime
    where metric proximity fails (drift > search radius puts the true
    revisit further down the nearest-neighbor ranking than aliased
    matches; measured on the revisit scene, tests/test_loop_detection.py).
    Candidates are ordered most-similar-first and capped like the
    proximity proposer; verify + gate + NMS identically.
    """
    desc = scan_descriptors(jnp.asarray(np.asarray(ranges), jnp.float32),
                            jnp.asarray(masks), float(range_min),
                            float(range_max), n_bins=int(n_bins))
    idx, d2, cons = _nearest_descriptor_revisits(desc, int(min_gap), int(k))
    idx = np.asarray(idx)
    d2 = np.asarray(d2)
    thresh = float(rel_thresh) * float(cons)
    jj, kk = np.where(d2 <= thresh)
    order = np.argsort(d2[jj, kk], kind="stable")
    cand_i = idx[jj, kk][order].astype(np.int64)
    cand_j = jj[order].astype(np.int64)
    if cand_j.size > max_candidates:
        light = max(1, suppress_window // 4)
        keep = _suppress_greedy(cand_i, cand_j, light, max_candidates)
        cand_i, cand_j = cand_i[keep], cand_j[keep]
    return (cand_i.astype(np.int32), cand_j.astype(np.int32))


def _suppress_greedy(loop_i, loop_j, window, cap):
    """Greedy pair NMS in the given order: a pair is dropped when an
    already-kept pair is within `window` steps on BOTH endpoints. Returns
    the kept positions (host code — runs once per pipeline)."""
    sel = []
    for m in range(loop_i.size):
        i, j = int(loop_i[m]), int(loop_j[m])
        if any(abs(j - int(loop_j[s])) <= window
               and abs(i - int(loop_i[s])) <= window for s in sel):
            continue
        sel.append(m)
        if len(sel) >= cap:
            break
    return np.asarray(sel, np.int64)


def suppress_verified_pairs(
    loop_i: np.ndarray,
    loop_j: np.ndarray,
    errors: np.ndarray,
    accept: np.ndarray,
    window: int,
) -> np.ndarray:
    """Post-verification non-max suppression: among ACCEPTED pairs, keep
    them in ascending ICP-error order, dropping any within `window` steps
    of an already-kept pair on BOTH endpoints. Redundant closures of the
    same physical revisit add solve cost (the direct solver's Woodbury
    correction scales with the loop count) without adding information;
    ranking by measured error keeps the best-verified representative.
    Returns a boolean keep mask over all pairs (rejected pairs are False).
    """
    loop_i = np.asarray(loop_i)
    loop_j = np.asarray(loop_j)
    errors = np.asarray(errors)
    accept = np.asarray(accept)
    keep = np.zeros(loop_i.shape[0], bool)
    acc_pos = np.where(accept)[0]
    order = acc_pos[np.argsort(errors[acc_pos], kind="stable")]
    kept = _suppress_greedy(loop_i[order], loop_j[order], window,
                            cap=order.size)
    keep[order[kept]] = True
    return keep


def verify_revisit_pairs_seeded(
    pts3: jnp.ndarray,
    masks: jnp.ndarray,
    pli: np.ndarray,
    plj: np.ndarray,
    est_poses: jnp.ndarray,
    pg,
    chunk_size: int = 64,
) -> tuple[jnp.ndarray, np.ndarray, np.ndarray]:
    """Prior-seeded trimmed verification of revisit pairs
    (PoseGraphConfig.proximity_seed="estimate").

    Each pair's ICP is seeded from the ESTIMATED relative pose and run to
    CONVERGENCE (epsilon 1e-9 — the reference's loop-ICP epsilon of 0.01
    stops before refining anything) with TrICP trim pg.proximity_trim.
    Acceptance gates:
      - translation correction from the seed < 2 * proximity_radius and
        wrapped yaw correction < proximity_max_yaw_corr (the proposer's
        drift bound bounds the correction);
      - converged trimmed error < proximity_err_rel x the SELF-CALIBRATED
        noise floor: the median error of the same verification run on 32
        consecutive-scan pairs (guaranteed same-place, full overlap).
        An absolute threshold does not travel across scenes — the
        normalized trimmed error scales with ray density, room diagonal
        and scan baseline (measured: genuine revisits sit at 1e-6..1e-5
        in one scene and 2e-4 in another, while their ratio to the
        consecutive-pair floor stays within ~an order of magnitude).

    Returns (pT, accept, errors): SE(2) measurements (ICP convention
    T_j^-1 T_i — invert before feeding the pose graph), boolean gate,
    converged trimmed errors.
    """
    est_poses = jnp.asarray(est_poses)
    seed2 = se2.get_relative_pose(est_poses[plj], est_poses[pli])
    max_dist = 2.0 * pg.proximity_radius
    kw = dict(chunk_size=chunk_size, gate_yaw=False,
              trim_fraction=float(pg.proximity_trim),
              epsilon=1e-9, stopping_thresh=1e-8)
    pT, pacc, perr, _ = compute_loop_closures_pairs(
        pts3, masks, jnp.asarray(pli), jnp.asarray(plj),
        float(max_dist), 0.0, seed_T=seed2, **kw)
    # control batch: consecutive pairs define the converged-error floor
    n = int(est_poses.shape[0])
    cidx = jnp.asarray(np.linspace(0, n - 2, min(32, n - 1)).astype(np.int32))
    cs2 = se2.get_relative_pose(est_poses[cidx + 1], est_poses[cidx])
    _, _, cerr, _ = compute_loop_closures_pairs(
        pts3, masks, cidx, cidx + 1, float(max_dist), 0.0,
        seed_T=cs2, **kw)
    scale = float(np.median(np.asarray(cerr)))
    perr = np.asarray(perr)
    accept = np.asarray(pacc) & (perr < pg.proximity_err_rel * scale)
    pT_np, s_np = np.asarray(pT), np.asarray(seed2)
    dyaw = (np.arctan2(pT_np[:, 1, 0], pT_np[:, 0, 0])
            - np.arctan2(s_np[:, 1, 0], s_np[:, 0, 0]))
    dyaw = np.abs((dyaw + np.pi) % (2 * np.pi) - np.pi)
    accept = accept & (np.degrees(dyaw) < pg.proximity_max_yaw_corr)
    return pT, accept, perr


def resume_from_poses(
    poses: np.ndarray,
    ranges: np.ndarray,
    range_min: float,
    range_max: float,
    filter_lidar: bool = False,
    cfg: SlamConfig = SlamConfig(),
    build_map: bool = True,
) -> SlamResult:
    """Checkpoint/resume: rebuild maps from a saved pose trajectory.

    The pipeline checkpoints each stage's poses to outputs/*.npy (like the
    reference, main.py:110-189); this entry point restarts from any of those
    arrays, skipping pose estimation entirely (SURVEY.md section 5
    checkpoint/resume)."""
    poses = jnp.asarray(poses)
    points, masks = scan_ops.scans_to_points(
        jnp.asarray(ranges), range_min, range_max, cfg.lidar)
    if filter_lidar:
        from ..ops import filters
        masks = filters.dbscan_filter_scans(
            points, masks, eps=cfg.filter.dbscan_eps,
            min_samples=cfg.filter.dbscan_min_samples)
        masks = filters.statistical_filter_scans(
            points, masks, k_std=cfg.filter.statistical_k_std)

    result = SlamResult(
        poses_odom=np.asarray(poses),
        relative_poses_odom=np.asarray(
            se2.get_relative_pose(poses[:-1], poses[1:])),
        poses=np.asarray(poses),
    )
    if build_map:
        K = occupancy.adaptive_ray_cells(points, masks, cfg.map,
                                         float(range_max))
        logodds = occupancy.build_logodds(poses, points, masks, cfg.map, K)
        result.logodds = np.asarray(logodds)
        result.grid_map = np.asarray(occupancy.finalize_grid(logodds))
    return result


def run_slam(
    counts: np.ndarray,
    gyro: np.ndarray,
    ranges: np.ndarray,
    range_min: float,
    range_max: float,
    mode: str = "odom",
    filter_lidar: bool = False,
    fixed_interval: int = 10,
    cfg: SlamConfig = SlamConfig(),
    build_map: bool = True,
    chunk_size: int = 64,
) -> SlamResult:
    """Run the SLAM pipeline on synchronized sensor arrays.

    counts (N, 4) encoder; gyro (N, 3); ranges (N, n_rays) synchronized
    lidar. Modes mirror the reference CLI: 'odom', 'scan_matching', 'gtsam'
    (reference: main.py:18,116-192).
    """
    counts = jnp.asarray(counts)
    gyro = jnp.asarray(gyro)

    points, masks = scan_ops.scans_to_points(
        jnp.asarray(ranges), range_min, range_max, cfg.lidar)

    if filter_lidar:
        from ..ops import filters
        masks = filters.dbscan_filter_scans(
            points, masks, eps=cfg.filter.dbscan_eps,
            min_samples=cfg.filter.dbscan_min_samples)
        masks = filters.statistical_filter_scans(
            points, masks, k_std=cfg.filter.statistical_k_std)

    # gates for loop closures (reference: main.py:94-101)
    max_distance, max_yaw_deg = odometry.max_step_gates(counts, gyro,
                                                        cfg.robot.dt)

    poses_odom, rel_odom = odometry.poses_from_odometry(
        counts, gyro, dt=cfg.robot.dt, return_relative_poses=True)

    result = SlamResult(
        poses_odom=np.asarray(poses_odom),
        relative_poses_odom=np.asarray(rel_odom),
        poses=np.asarray(poses_odom),
    )
    final_poses = poses_odom

    if mode in ("scan_matching", "gtsam"):
        sm = scan_matching.poses_from_scan_matching(
            poses_odom, points, masks, cfg.icp, chunk_size=chunk_size)
        result.poses_scan_matching = np.asarray(sm.poses)
        result.relative_poses_scan_matching = np.asarray(sm.relative_poses)
        final_poses = sm.poses

    if mode == "gtsam":
        pts3 = icp_ops.lift_to_3d(points)
        cand = loop_closure_candidates(int(final_poses.shape[0]), fixed_interval)
        loop_T, accept, _, _ = compute_loop_closures(
            pts3, masks, cand, fixed_interval,
            float(max_distance), float(max_yaw_deg), chunk_size=chunk_size)

        # keep the banded solver's band in sync with the ACTUAL loop span:
        # the run_slam fixed_interval argument (CLI --fixed_interval)
        # overrides the config default, and band = cfg.fixed_interval in
        # optimize_with_config — a mismatch would silently drop loop
        # Hessian blocks that span more than `band` poses
        import dataclasses
        pg_cfg = dataclasses.replace(cfg.pose_graph,
                                     fixed_interval=fixed_interval)
        loop_i = jnp.asarray(cand)
        loop_j = jnp.asarray(cand + fixed_interval)

        if cfg.pose_graph.loop_proposer in ("proximity", "descriptor"):
            # revisit closures on top of the fixed-interval set; their
            # spans are unbounded, so the banded solver no longer applies
            pg = cfg.pose_graph
            seeded = False
            if pg.loop_proposer == "proximity":
                pli, plj = proximity_loop_candidates(
                    np.asarray(final_poses),
                    min_gap=pg.proximity_min_gap,
                    radius=pg.proximity_radius,
                    max_candidates=pg.proximity_max_candidates,
                    suppress_window=pg.proximity_suppress)
                max_dist = 2.0 * pg.proximity_radius
                seeded = pg.proximity_seed == "estimate"
            else:
                pli, plj = descriptor_loop_candidates(
                    ranges, masks, float(range_min), float(range_max),
                    min_gap=pg.proximity_min_gap,
                    n_bins=pg.descriptor_bins,
                    rel_thresh=pg.descriptor_rel_thresh,
                    max_candidates=pg.proximity_max_candidates,
                    suppress_window=pg.proximity_suppress)
                max_dist = pg.descriptor_max_dist
            if pli.size:
                if seeded:
                    # prior-seeded trimmed verification (any-heading
                    # revisits) with the self-calibrated error gate
                    pT, pacc, perr = verify_revisit_pairs_seeded(
                        pts3, masks, pli, plj, final_poses, pg,
                        chunk_size=chunk_size)
                else:
                    pT, pacc, perr, _ = compute_loop_closures_pairs(
                        pts3, masks, jnp.asarray(pli), jnp.asarray(plj),
                        float(max_dist), 0.0,
                        chunk_size=chunk_size, gate_yaw=False)
                    # the decisive gate: perceptually-aliased false
                    # revisits pass the translation test but stall at
                    # high ICP error
                    pacc = np.asarray(pacc) & (
                        np.asarray(perr) < cfg.pose_graph.proximity_max_err)
                # NMS after verification (error-ranked; see the
                # proximity_loop_candidates docstring for why not before)
                keep = suppress_verified_pairs(
                    pli, plj, np.asarray(perr), pacc,
                    cfg.pose_graph.proximity_suppress)
                if keep.any():
                    sel = np.where(keep)[0]
                    loop_i = jnp.concatenate([loop_i, jnp.asarray(pli[sel])])
                    loop_j = jnp.concatenate([loop_j, jnp.asarray(plj[sel])])
                    # CONVENTION: ICP aligning scan i onto scan j returns
                    # T_j^-1 T_i, but the loop residual (pose_graph.py
                    # rel_l = T_i^-1 T_j) wants the INVERSE. The reference
                    # feeds the uninverted ICP output to
                    # BetweenFactorPose2(i, j, .) (main.py:171) — harmless
                    # there because its gates only pass near-identity
                    # transforms, and kept for the fixed path (parity) —
                    # but revisit transforms are far from identity, where
                    # the flip corrupts translation by up to 2|t|.
                    loop_T = jnp.concatenate([loop_T, se2.inverse_T(pT[sel])])
                    accept = jnp.concatenate(
                        [accept, jnp.ones(sel.size, bool)])
                    pg_cfg = dataclasses.replace(pg_cfg, solver="direct")

        result.n_loop_closures = int(np.asarray(accept).sum())
        opt = pose_graph.optimize_trajectory(
            final_poses, sm.relative_poses, loop_i, loop_j, loop_T, accept,
            pg_cfg)
        result.poses_optimized = np.asarray(opt.poses)
        final_poses = opt.poses

    result.poses = np.asarray(final_poses)

    if build_map:
        K = occupancy.adaptive_ray_cells(points, masks, cfg.map,
                                         float(range_max))
        logodds = occupancy.build_logodds(final_poses, points, masks,
                                          cfg.map, K)
        result.logodds = np.asarray(logodds)
        result.grid_map = np.asarray(occupancy.finalize_grid(logodds))

    return result
