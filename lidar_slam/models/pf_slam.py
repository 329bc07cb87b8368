"""Particle-filter SLAM: simultaneous localization AND occupancy mapping.

The reference pipeline localizes by ICP + GTSAM and maps afterwards with
the final trajectory (reference main.py:107-205); the course starter's
mapCorrelation (code/pr2_utils.py:12-43) was shipped for the OTHER classic
architecture — a particle-filter SLAM that scores motion hypotheses
against the map built so far and extends that map with the filtered
estimate every step. models/particle_filter.py completed the localization
half against a KNOWN map; this module closes the loop: no prior map, the
filter bootstraps its own.

Per step (one fused device program, state donated):
  1. predict   — per-particle noisy sinc diff-drive step
                 (_predict_particles, reference modules/localization.py:29-36);
  2. update    — map-correlation scores against the CURRENT causal map's
                 obstacle image (logodds > 0), log-weights via logsumexp;
  3. estimate  — weighted mean with the cumulative-yaw-continuous circular
                 yaw mean (_estimate_pose);
  4. map       — the reference per-scan log-odds update at the ESTIMATED
                 pose (occupancy.build_logodds with init — the same
                 compacted scatter as the offline/online modes;
                 reference modules/ogm.py:149-188);
  5. resample  — branchless systematic resample on Neff collapse.

Early steps see an all-unknown map (scores 0 everywhere), so the filter
degrades gracefully to dead reckoning until structure appears — no special
bootstrap phase is needed; the first scan is rasterized at x0 by init.

Design notes: fixed shapes throughout ((P, 3) particles,
(R, 2) + mask scans, (W, H) grid); the whole batch run is ONE lax.scan —
no Python loop touches a step; everything a step carries lives in one
NamedTuple of device arrays.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..config import MapConfig
from ..models import occupancy
from ..models.odometry import v_from_encoder
from .particle_filter import (PFConfig, _estimate_pose, _predict_particles,
                              _score_particles, _systematic_resample)


class PFSlamState(NamedTuple):
    """Streaming SLAM state: everything pf_slam_step carries between scans."""

    particles: jnp.ndarray  # (P, 3)
    logw: jnp.ndarray       # (P,) normalized log-weights
    key: jax.Array          # PRNG carry
    logodds: jnp.ndarray    # (W, H) causal log-odds map
    step: jnp.ndarray       # () int32 — number of scans consumed


def init_pf_slam(points0: jnp.ndarray, mask0: jnp.ndarray,
                 map_cfg: MapConfig, cfg: PFConfig = PFConfig(),
                 x0: jnp.ndarray | None = None,
                 key: jax.Array | None = None,
                 K: int | None = None,
                 init_particles: jnp.ndarray | None = None) -> PFSlamState:
    """Initial state: particles at x0 (or `init_particles` for a spread
    start) and the first scan rasterized at x0 — the map every later step
    scores against starts from real structure, exactly like the online
    ICP mode's init (models/online.py init_state)."""
    P = cfg.n_particles
    if x0 is None:
        x0 = jnp.zeros(3, jnp.float32)
    x0 = jnp.asarray(x0, jnp.float32)
    if key is None:
        key = jax.random.PRNGKey(0)
    if K is None:
        K = occupancy.max_ray_cells(map_cfg, 30.0)
    if init_particles is None:
        particles = jnp.broadcast_to(x0, (P, 3))
    else:
        particles = jnp.asarray(init_particles, jnp.float32)
    logodds = occupancy.build_logodds(
        x0[None], jnp.asarray(points0, jnp.float32)[None, :, :2],
        jnp.asarray(mask0)[None], map_cfg, K)
    return PFSlamState(particles=particles,
                       logw=jnp.full((P,), -jnp.log(P), jnp.float32),
                       key=key, logodds=logodds,
                       step=jnp.asarray(1, jnp.int32))


@partial(jax.jit, static_argnames=("map_cfg", "cfg", "K", "score_fn"),
         donate_argnums=(0,))
def pf_slam_step(state: PFSlamState, counts, gyro, pts, mask,
                 map_cfg: MapConfig, cfg: PFConfig = PFConfig(),
                 K: int | None = None, score_fn=None):
    """One streaming SLAM step (the PF analog of online.online_step).

    counts (4,) encoder ticks for this interval; gyro (3,) angular
    velocity; pts (R, 2) robot-frame scan + mask (R,). Returns
    (new_state, (est_pose (3,), neff, resampled)). The batch entry point
    slam_particle_filter is exactly lax.scan over this function.
    score_fn as in particle_filter.pf_step (multi-chip particle-sharded
    scoring — parallel/sharding.sharded_pf_score)."""
    if K is None:
        K = occupancy.max_ray_cells(map_cfg, 30.0)
    particles, logw, k, logodds, step = state
    P = cfg.n_particles
    k, k_v, k_w, k_u = jax.random.split(k, 4)

    v_t = v_from_encoder(jnp.asarray(counts, jnp.float32))
    w_t = jnp.asarray(gyro, jnp.float32)[-1]
    particles = _predict_particles(particles, v_t, w_t, k_v, k_w, cfg)

    # score against the causal map built so far (1 at obstacles)
    im = (logodds > 0).astype(jnp.float32)
    if score_fn is None:
        score = _score_particles(particles, pts, mask, im, map_cfg)
    else:
        score = score_fn(particles, pts, mask, im)
    logw = logw + cfg.temperature * score
    logw = logw - jax.scipy.special.logsumexp(logw)
    w = jnp.exp(logw)

    est = _estimate_pose(particles, w)

    # extend the map with this scan at the filtered estimate (reference
    # per-scan rule incl. the clip, modules/ogm.py:149-188)
    logodds = occupancy.build_logodds(
        est[None], jnp.asarray(pts, jnp.float32)[None, :, :2],
        jnp.asarray(mask)[None], map_cfg, K, init=logodds)

    neff = 1.0 / jnp.sum(w * w)
    do_rs = neff < cfg.resample_frac * P
    res = _systematic_resample(particles, w,
                               jax.random.uniform(k_u, (), jnp.float32))
    particles = jnp.where(do_rs, res, particles)
    logw = jnp.where(do_rs, jnp.full_like(logw, -jnp.log(P)), logw)

    new = PFSlamState(particles, logw, k, logodds, step + 1)
    return new, (est, neff, do_rs)


@partial(jax.jit, static_argnames=("map_cfg", "cfg", "K", "score_fn"))
def slam_particle_filter(
    counts: jnp.ndarray,
    gyro: jnp.ndarray,
    points: jnp.ndarray,
    masks: jnp.ndarray,
    map_cfg: MapConfig,
    cfg: PFConfig = PFConfig(),
    x0: jnp.ndarray | None = None,
    key: jax.Array | None = None,
    K: int | None = None,
    init_particles: jnp.ndarray | None = None,
    score_fn=None,
) -> Tuple[jnp.ndarray, jnp.ndarray, dict]:
    """Run particle-filter SLAM over a whole log in one device dispatch.

    counts (N, 4) encoder counts; gyro (N, 3); points (N, R, 2) robot-frame
    scans with masks (N, R); x0 (3,) initial pose. Step alignment matches
    odometry and localize_particle_filter (reference
    modules/localization.py:60-93): step i consumes encoder/gyro row i and
    scores/rasterizes scan i; scan 0 is rasterized at x0 by init.

    Returns ((N, 3) pose estimates, (W, H) final log-odds map, aux) with
    aux = {"neff": (N,), "resampled": (N,)} (entries 0 are init
    placeholders). The map is CAUSAL — built from the estimate available
    at each step — unlike the offline mode's final-trajectory rasterize.
    """
    P = cfg.n_particles
    if x0 is None:
        x0 = jnp.zeros(3, jnp.float32)
    x0 = jnp.asarray(x0, jnp.float32)
    if K is None:
        K = occupancy.max_ray_cells(map_cfg, 30.0)

    state0 = init_pf_slam(points[0], masks[0], map_cfg, cfg, x0, key, K,
                          init_particles)

    def step(carry, inp):
        c_t, g_t, pts, mask = inp
        return pf_slam_step(carry, c_t, g_t, pts, mask, map_cfg, cfg, K,
                            score_fn)

    inp = (counts[1:].astype(jnp.float32), gyro[1:].astype(jnp.float32),
           points[1:], masks[1:])
    final, (ests, neffs, flags) = jax.lax.scan(step, state0, inp)

    poses = jnp.concatenate([x0[None], ests], axis=0)
    aux = {
        "neff": jnp.concatenate([jnp.full((1,), float(P)), neffs]),
        "resampled": jnp.concatenate([jnp.zeros((1,), bool), flags]),
    }
    return poses, final.logodds, aux
