"""Online (streaming) SLAM: one jitted device step per incoming scan.

The reference is a batch pipeline (load the whole log, then process,
reference main.py:67-192); this module adds the serving-mode counterpart
the reference has no analog for: a robot feeding one synchronized
(encoder, gyro, scan) tuple at a time and reading back the current pose
and the causal occupancy map after every step.

Design:
  - ALL state (pose, odometry pose, log-odds grid, previous scan) lives in
    one NamedTuple of device arrays with fixed shapes, DONATED through the
    jitted step — zero host round-trips and zero reallocation per step;
  - the per-step update rule is the offline pipeline's: the ICP seed is
    the relative pose of consecutive ODOMETRY poses (reference
    modules/localization.py:116-118), the refined pose composes onto the
    refined chain (:127), and the map update applies the reference's
    per-ray log-odds rule with the per-scan clip (modules/ogm.py:149-188).
    Fed the same log step-by-step, the pose track equals
    scan_matching.poses_from_scan_matching to FLOAT TOLERANCE (~1e-4;
    offline composes via associative_scan, online sequentially, so the
    float reduction order differs — tests/test_online.py);
  - the map is CAUSAL (built from the pose estimate available at each
    step), which is what an online system can know — unlike the offline
    mode, which rasterizes with the final refined trajectory.

Optional trajectory refinement: `refine()` runs the offline gtsam
stage's pose-graph solve over a SLIDING WINDOW of the history (ring
buffers carried in the state retain the most recent n_max steps),
optionally with gated fixed-interval loop closures when the caller
provides the window's scans, returning a smoothed copy of the windowed
trajectory without touching the causal map. Once the stream exceeds
capacity, the chain before the window is marginalized into a prior: the
window-head pose is anchored at its online posterior estimate with the
prior noise model (reference main.py:149-150), so factors that slid out
keep constraining the window through that anchor instead of being
silently forgotten.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SlamConfig
from ..ops import icp as icp_ops
from ..utils import se2
from . import occupancy, odometry


class OnlineState(NamedTuple):
    pose: jnp.ndarray        # (3,) current refined pose
    odom_pose: jnp.ndarray   # (3,) dead-reckoning pose (seed source)
    logodds: jnp.ndarray     # (W, H) causal log-odds map
    prev_points: jnp.ndarray  # (P, 3) previous scan (z = 0)
    prev_mask: jnp.ndarray   # (P,)
    step: jnp.ndarray        # () int32 — 0 before the first scan
    # history RING buffers for refine(): slot s % N_max holds step s's pose
    # and the relative SE(2) from step s-1 to s, so the most recent N_max
    # steps are always retained (sliding window)
    poses_hist: jnp.ndarray  # (N_max, 3) refined poses
    rel_hist: jnp.ndarray    # (N_max, 3, 3) refined relative SE(2)
    # () f32 — tracking-health signal: final RMS point-to-correspondence
    # distance (meters) of this step's scan match (config.OnlineConfig)
    match_rms: jnp.ndarray


def default_ray_cells(cfg: SlamConfig, range_max: float = 30.0) -> int:
    """Per-ray slot budget derived from the map config + sensor range
    (occupancy.max_ray_cells) — the value online_step/init_state use when
    K is not given explicitly."""
    return occupancy.max_ray_cells(cfg.map, range_max)


def init_state(first_points: jnp.ndarray, first_mask: jnp.ndarray,
               cfg: SlamConfig = SlamConfig(), n_max: int = 8192,
               x0: jnp.ndarray | None = None,
               K: int | None = None) -> OnlineState:
    """State after observing the FIRST scan at the origin pose.

    The first scan is rasterized into the map at pose 0 (the offline
    build_map loops over ALL scans including index 0, reference
    ogm.py:56). K=None derives the ray slot budget from cfg
    (default_ray_cells)."""
    if K is None:
        K = default_ray_cells(cfg)
    pts3 = icp_ops.lift_to_3d(jnp.asarray(first_points)).astype(jnp.float32)
    mask = jnp.asarray(first_mask)
    pose0 = (jnp.zeros(3, jnp.float32) if x0 is None
             else jnp.asarray(x0, jnp.float32))
    W, H = cfg.map.width, cfg.map.height
    logodds = occupancy.update_map(jnp.zeros((W, H), jnp.float32), pose0,
                                   pts3[..., :2], mask, cfg.map, K)
    poses_hist = jnp.zeros((n_max, 3), jnp.float32).at[0].set(pose0)
    return OnlineState(
        pose=pose0,
        # distinct buffer: donated states must not alias leaves
        odom_pose=pose0 + 0.0,
        logodds=logodds,
        prev_points=pts3,
        prev_mask=mask,
        step=jnp.asarray(0, jnp.int32),
        poses_hist=poses_hist,
        rel_hist=jnp.tile(jnp.eye(3, dtype=jnp.float32), (n_max, 1, 1)),
        match_rms=jnp.asarray(0.0, jnp.float32),
    )


@partial(jax.jit, static_argnames=("cfg", "K", "update_map"),
         donate_argnums=(0,))
def online_step(
    state: OnlineState,
    counts: jnp.ndarray,   # (4,) encoder ticks for this interval
    gyro: jnp.ndarray,     # (3,) angular velocity
    points: jnp.ndarray,   # (P, 2) or (P, 3) scan in the robot frame
    mask: jnp.ndarray,     # (P,)
    cfg: SlamConfig = SlamConfig(),
    K: int | None = None,
    update_map: bool = True,
) -> OnlineState:
    """Advance the online SLAM state by one synchronized sensor tuple.

    Same math as the offline stages (module docstring); one fused device
    program per step, state donated (updated in place). K=None derives the
    ray slot budget from cfg (default_ray_cells) — pass the same K used at
    init_state when overriding.
    """
    if K is None:
        K = default_ray_cells(cfg)
    dt = cfg.robot.dt
    pts3 = icp_ops.lift_to_3d(jnp.asarray(points)).astype(jnp.float32)
    mask = jnp.asarray(mask)

    # 1. dead-reckoning advance (reference modules/localization.py:60-93)
    v = odometry.v_from_encoder(counts)
    odom_new = odometry.diff_drive_motion_model(state.odom_pose, v, gyro, dt)
    # ICP seed: relative pose of consecutive ODOMETRY poses — the
    # reference seeds every pair from odometry, not the refined chain
    # (modules/localization.py:116-118), which is what makes the offline
    # batch exact; online replicates it so the tracks agree
    seed2 = se2.get_relative_pose(state.odom_pose, odom_new)
    seed3 = se2.TSE3_from_TSE2(seed2)

    # 2. scan matching against the previous scan
    res = icp_ops.run_icp_batch(
        pts3[None], state.prev_points[None], mask[None],
        state.prev_mask[None], seed3[None],
        epsilon=cfg.icp.epsilon, max_iters=cfg.icp.max_iters,
        stopping_thresh=cfg.icp.stopping_thresh,
        normalize_error=cfg.icp.normalize_error, planar=True,
        metric=cfg.icp.metric)
    rel2 = se2.TSE2_from_TSE3(res.T[0])  # (3, 3)

    # tracking-health signal: RMS point-to-correspondence distance (m)
    # under the FINAL transform — recomputed here so it is in meters
    # regardless of the solver's error metric/normalization config
    idx_c = res.correspondences[0]
    src_t2 = se2.transform_points(pts3[:, :2], rel2)
    matched2 = state.prev_points[idx_c, :2]
    valid_c = mask & state.prev_mask[idx_c]
    d2 = jnp.sum((src_t2 - matched2) ** 2, axis=-1)
    rms = jnp.sqrt(jnp.sum(jnp.where(valid_c, d2, 0.0))
                   / jnp.maximum(jnp.sum(valid_c), 1)).astype(jnp.float32)

    # tracking-loss gate (config.OnlineConfig): while the match RMS is
    # above threshold, COAST on the odometry increment — a garbage ICP
    # result must neither steer the pose nor paint the map. The default
    # threshold is inf, in which case the gate is compiled out entirely
    # (bit-identical to the ungated step).
    detect = math.isfinite(cfg.online.loss_rms_thresh)
    if detect:
        lost = rms > cfg.online.loss_rms_thresh
        rel2 = jnp.where(lost, seed2, rel2)
    T_new = se2.p_matmul(se2.T_from_pose(state.pose), rel2)
    pose_new = se2.pose_from_T(T_new)

    # 3. causal map update (reference modules/ogm.py:149-188): the
    # single-scan compacted scatter of the offline build
    if update_map:
        def _paint(lo):
            return occupancy.build_logodds(
                pose_new[None], pts3[None, :, :2], mask[None], cfg.map, K,
                init=lo)
        if detect:
            logodds = jax.lax.cond(lost, lambda lo: lo, _paint,
                                   state.logodds)
        else:
            logodds = _paint(state.logodds)
    else:
        logodds = state.logodds

    step_new = state.step + 1
    n_max = state.poses_hist.shape[0]
    # ring buffers: slot s % n_max holds step s — the window always covers
    # the most recent min(step+1, n_max) steps (refine() reconstructs the
    # chronological order from the step counter)
    idx = step_new % n_max
    return OnlineState(
        pose=pose_new.astype(jnp.float32),
        odom_pose=odom_new.astype(jnp.float32),
        logodds=logodds,
        prev_points=pts3,
        prev_mask=mask,
        step=step_new,
        poses_hist=state.poses_hist.at[idx].set(pose_new),
        rel_hist=state.rel_hist.at[idx].set(rel2),
        match_rms=rms,
    )


def relocalize_and_reseed(state: OnlineState, cfg: SlamConfig,
                          K: int | None = None,
                          reloc_cfg=None, paint: bool = True):
    """Kidnapped-robot recovery for the streaming mode (host-side; a rare
    event, not a per-step path).

    Runs the certified global search + ICP polish
    (models/relocalization.relocalize_refined) for the CURRENT scan
    against the CAUSAL map, then re-seeds the stream at the recovered
    pose: the current history slot gets the recovered pose, and the slot's
    between-factor becomes the estimated jump (the kidnap was real motion
    the odometry never measured, so encoding it keeps refine()'s window
    chain consistent across the discontinuity). The held-out scan — the
    loss gate skipped its rasterization — is painted at the recovered
    pose when `paint`. odom_pose needs no rebase: it is only ever read
    through consecutive RELATIVE increments, which a teleport does not
    corrupt.

    Returns (new_state, RelocResult, icp_error).
    """
    from .relocalization import RelocConfig, relocalize_refined

    if K is None:
        K = default_ray_cells(cfg)
    m = cfg.map
    if reloc_cfg is None:
        # search the whole mapped area: centered on the map, radius
        # covering the diagonal of the half-extent
        reloc_cfg = RelocConfig(
            search_radius=0.5 * math.hypot(m.world_max_x - m.world_min_x,
                                           m.world_max_y - m.world_min_y),
            beam=cfg.online.reloc_beam,
            n_angles=cfg.online.reloc_n_angles,
            max_rays=cfg.online.reloc_max_rays)
    center = (0.5 * (m.world_min_x + m.world_max_x),
              0.5 * (m.world_min_y + m.world_max_y))
    grid_res, refined, icp_err = relocalize_refined(
        state.logodds, m, state.prev_points[:, :2], state.prev_mask,
        reloc_cfg, center=center,
        n_candidates=cfg.online.reloc_candidates)
    refined = jnp.asarray(refined, jnp.float32)

    n_max = state.poses_hist.shape[0]
    step = int(state.step)
    idx = step % n_max
    prev_pose = state.poses_hist[(step - 1) % n_max]
    jump = se2.get_relative_pose(prev_pose, refined).astype(jnp.float32)
    logodds = state.logodds
    if paint:
        logodds = occupancy.build_logodds(
            refined[None], state.prev_points[None, :, :2],
            state.prev_mask[None], m, K, init=logodds)
    new_state = state._replace(
        pose=refined,
        logodds=logodds,
        poses_hist=state.poses_hist.at[idx].set(refined),
        rel_hist=state.rel_hist.at[idx].set(jump),
        match_rms=jnp.asarray(0.0, jnp.float32),
    )
    return new_state, grid_res, icp_err


def window_start(state: OnlineState) -> int:
    """First step index covered by the retained sliding window."""
    n_max = state.poses_hist.shape[0]
    return max(0, int(state.step) + 1 - n_max)


def refine(state: OnlineState, cfg: SlamConfig = SlamConfig(),
           scans: jnp.ndarray | None = None,
           scan_masks: jnp.ndarray | None = None,
           max_distance: float = np.inf,
           max_yaw_deg: float = np.inf,
           descriptor_range: tuple[float, float] = (0.1, 30.0)) -> np.ndarray:
    """Smooth the retained trajectory window with the pose-graph solve of
    the offline gtsam stage (reference main.py:148-192).

    The ring buffers retain the most recent n = min(step+1, n_max) steps;
    the returned (n, 3) array covers global steps
    [window_start(state), state.step]. Past capacity, the evicted chain is
    MARGINALIZED into the prior: the window-head pose is anchored at its
    online posterior estimate under the prior noise model (reference
    main.py:149-150 anchors vertex 0 the same way), so the solve remains a
    well-posed fixed-gauge problem and the pre-window evidence keeps
    acting on the window through that anchor.

    With `scans` (>= n, P, 2 or 3) + `scan_masks` — the WINDOW's scans in
    chronological order (entry i = global step window_start + i; extra
    leading entries are ignored, the last n are used) — gated
    fixed-interval loop-closure ICPs are added exactly like the offline
    stage (gates default to accept-all; pass the odometry maxima for
    reference gating). With cfg.pose_graph.loop_proposer="descriptor"
    (place recognition over the window's scans — descriptors from
    per-point ranges ||p||, binned over `descriptor_range`) or
    "proximity" (metric nearness on the window's poses), in-window
    revisit closures are ALSO proposed, then ICP-verified, error-gated
    and NMS'd exactly like the offline path (models/slam.py) — streaming
    loop closure, the piece that lets a long-running robot correct drift
    when it re-enters mapped space. Without scans, between factors only.
    The causal map is untouched.
    """
    import dataclasses

    from ..ops import icp as _icp
    from . import pose_graph
    from .slam import (compute_loop_closures, compute_loop_closures_pairs,
                       descriptor_loop_candidates, loop_closure_candidates,
                       suppress_verified_pairs)

    n_max = state.poses_hist.shape[0]
    step = int(state.step)
    n = min(step + 1, n_max)
    start = step + 1 - n
    order = (start + np.arange(n)) % n_max
    poses = state.poses_hist[order]
    rel = state.rel_hist[(start + np.arange(1, n)) % n_max]
    interval = cfg.pose_graph.fixed_interval
    pg_cfg = cfg.pose_graph
    if scans is not None and n > interval + 1:
        if scan_masks is None:
            raise ValueError("refine: scans given without scan_masks")
        if scans.shape[0] < n or scan_masks.shape[0] < n:
            raise ValueError(
                f"refine needs the window's {n} scans+masks "
                f"(chronological), got {scans.shape[0]} scans / "
                f"{scan_masks.shape[0]} masks")
        # match the history dtype: under x64 (tests) caller scans can be
        # f64, which would scatter f64 values into the f32 graph arrays
        pts3 = _icp.lift_to_3d(
            jnp.asarray(scans[-n:], state.poses_hist.dtype))
        masks = jnp.asarray(scan_masks[-n:])
        cand = loop_closure_candidates(n, interval)
        loop_T, accept, _, _ = compute_loop_closures(
            pts3, masks, cand, interval, float(max_distance),
            float(max_yaw_deg))
        li = jnp.asarray(cand)
        lj = jnp.asarray(cand + interval)
        lm = loop_T
        if pg_cfg.loop_proposer in ("proximity", "descriptor"):
            seeded = False
            if pg_cfg.loop_proposer == "descriptor":
                # in-window place recognition: the descriptor is a
                # histogram of point ranges, which equals the offline
                # ranges-based one up to the lidar mounting offset
                # (consistent within a run)
                ranges = jnp.linalg.norm(pts3[..., :2], axis=-1)
                pli, plj = descriptor_loop_candidates(
                    ranges, masks, descriptor_range[0], descriptor_range[1],
                    min_gap=pg_cfg.proximity_min_gap,
                    n_bins=pg_cfg.descriptor_bins,
                    rel_thresh=pg_cfg.descriptor_rel_thresh,
                    max_candidates=pg_cfg.proximity_max_candidates,
                    suppress_window=pg_cfg.proximity_suppress)
                max_dist = pg_cfg.descriptor_max_dist
            else:
                from .slam import proximity_loop_candidates
                pli, plj = proximity_loop_candidates(
                    np.asarray(poses),
                    min_gap=pg_cfg.proximity_min_gap,
                    radius=pg_cfg.proximity_radius,
                    max_candidates=pg_cfg.proximity_max_candidates,
                    suppress_window=pg_cfg.proximity_suppress)
                max_dist = 2.0 * pg_cfg.proximity_radius
                seeded = pg_cfg.proximity_seed == "estimate"
            if pli.size:
                if seeded:
                    # prior-seeded trimmed verification (any-heading
                    # revisits; see models/slam.py)
                    from .slam import verify_revisit_pairs_seeded
                    pT, pacc, perr = verify_revisit_pairs_seeded(
                        pts3, masks, pli, plj, poses, pg_cfg)
                else:
                    pT, pacc, perr, _ = compute_loop_closures_pairs(
                        pts3, masks, jnp.asarray(pli), jnp.asarray(plj),
                        float(max_dist), 0.0, gate_yaw=False)
                    pacc = np.asarray(pacc) & (np.asarray(perr)
                                               < pg_cfg.proximity_max_err)
                keep = suppress_verified_pairs(
                    pli, plj, np.asarray(perr), pacc,
                    pg_cfg.proximity_suppress)
                if keep.any():
                    sel = np.where(keep)[0]
                    li = jnp.concatenate([li, jnp.asarray(pli[sel])])
                    lj = jnp.concatenate([lj, jnp.asarray(plj[sel])])
                    # invert: ICP(src=i, tgt=j) returns T_j^-1 T_i; the
                    # loop residual wants T_i^-1 T_j (see models/slam.py
                    # run_slam — the reference's own fixed path feeds the
                    # uninverted output, harmless only near identity)
                    lm = jnp.concatenate([lm, se2.inverse_T(pT[sel])])
                    accept = jnp.concatenate(
                        [accept, jnp.ones(sel.size, bool)])
                    # revisit spans exceed any fixed band
                    pg_cfg = dataclasses.replace(pg_cfg, solver="direct")
    else:
        li = jnp.zeros((0,), jnp.int32)
        lj = jnp.zeros((0,), jnp.int32)
        lm = jnp.zeros((0, 3, 3), jnp.float32)
        accept = jnp.zeros((0,), bool)
    # anchor the prior at the WINDOW HEAD's posterior estimate (reference
    # main.py:149-150 anchors vertex 0 at its initial estimate) — for a
    # within-capacity stream that is the trajectory start (an x0 != 0
    # start must not be snapped back to zero); past capacity it is the
    # marginalized summary of the evicted chain
    graph = pose_graph.make_graph(
        rel, pg_cfg, prior_pose=poses[0], loop_i=li, loop_j=lj,
        loop_meas=lm, loop_mask=accept)
    res = pose_graph.optimize_with_config(poses, graph, pg_cfg)
    return np.asarray(res.poses)


def save_state(path: str, state: OnlineState) -> None:
    """Checkpoint the full online state to one .npz (SURVEY.md section 5
    checkpoint/resume: the offline pipeline checkpoints stage arrays; the
    serving mode checkpoints its entire device state, so a restarted
    process resumes mid-stream with zero drift)."""
    np.savez(path, **{k: np.asarray(v)
                      for k, v in state._asdict().items()})


def load_state(path: str) -> OnlineState:
    """Restore a checkpoint written by save_state. Fields a newer schema
    added after the checkpoint was written default sensibly (match_rms=0),
    so pre-existing checkpoints keep resuming."""
    defaults = {"match_rms": jnp.asarray(0.0, jnp.float32)}
    with np.load(path) as d:
        return OnlineState(**{
            k: (jnp.asarray(d[k]) if k in d.files else defaults[k])
            for k in OnlineState._fields})
