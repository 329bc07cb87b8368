"""Particle-filter localization against a known occupancy map.

The course starter ships mapCorrelation expressly as the scoring kernel of
a particle filter (reference: code/pr2_utils.py:12-43 — present upstream
but UNUSED by the pipeline; SURVEY.md component 17). The reference never
builds the filter; this model completes that capability for XLA:

  - the whole filter is ONE `lax.scan` over time steps — no Python loop
    touches a step;
  - each step is fully vectorized over particles: motion sampling (the
    same sinc diff-drive model as models/odometry.py, reference
    modules/localization.py:15-36), scoring (a gather-sum of occupancy
    values at each particle's scan endpoints — the per-particle analog of
    ops/correlation.map_correlation at zero offset; the particle cloud
    itself explores the offset space the reference's 9x9 grid scans), and
    a BRANCHLESS systematic resample (the resampled state is always
    computed and selected by `where` on the effective-sample-size test,
    keeping the step free of data-dependent control flow);
  - fixed shapes throughout: scans stay (R, 2) + validity mask.

State estimate per step: weighted particle mean for x/y; for yaw, the
circular (vector-sum) weighted mean re-anchored to the unwrapped branch of
the linear mean, so the returned track keeps cumulative-yaw continuity
(matching poses_from_odometry) instead of snapping to (-pi, pi].
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..config import MapConfig
from ..models import occupancy
from ..models.odometry import _sinc_half, v_from_encoder


@dataclass(frozen=True)
class PFConfig:
    """Particle-filter parameters (new surface — no reference analog)."""

    n_particles: int = 256
    sigma_v: float = 0.05       # m/s motion-noise std on linear velocity
    sigma_w: float = 0.05       # rad/s motion-noise std on yaw rate
    # log-weight gain per map-correlation unit. NOTE the score is a SUM
    # over rays (each ray = one observation), so posterior sharpness grows
    # with scan size — measured CORRECT, not a bug: at 1081 rays the sum
    # tracks 2x tighter than a mean-normalized variant (0.024 vs 0.044 m
    # mean err at 15% encoder bias); more rays are more evidence.
    temperature: float = 0.1
    resample_frac: float = 0.5  # resample when Neff < frac * n_particles
    dt: float = 1.0 / 40.0      # encoder period (reference FREQ = 40 Hz)


def _score_particles(particles: jnp.ndarray, pts: jnp.ndarray,
                     mask: jnp.ndarray, im: jnp.ndarray,
                     map_cfg: MapConfig) -> jnp.ndarray:
    """Map-correlation score of one scan under every particle pose.

    particles (P, 3); pts (R, 2) robot-frame scan points; mask (R,) bool;
    im (W, H) occupancy values (1 at obstacles). Returns (P,) sums of map
    values at each particle's world-frame endpoints (out-of-map/invalid
    points contribute 0) — mapCorrelation's inner sum (reference:
    code/pr2_utils.py:30-42) with the offset grid replaced by the
    particle cloud.

    Cell convention: world2grid (the OGM's ceil-1 indexing), NOT
    pr2_utils' round-half-even — deliberately self-consistent with
    build_logodds, so a scan scored at the pose it was mapped from hits
    every endpoint cell exactly (pinned by
    tests/test_particle_filter.py::test_score_consistent_with_map_builder).
    """
    c = jnp.cos(particles[:, 2])[:, None]
    s = jnp.sin(particles[:, 2])[:, None]
    xw = c * pts[None, :, 0] - s * pts[None, :, 1] + particles[:, 0:1]
    yw = s * pts[None, :, 0] + c * pts[None, :, 1] + particles[:, 1:2]
    gi, gj = occupancy.world2grid(xw, yw, map_cfg)
    ok = (mask[None, :] & (gi >= 0) & (gi < map_cfg.width)
          & (gj >= 0) & (gj < map_cfg.height))
    vals = im[jnp.clip(gi, 0, map_cfg.width - 1),
              jnp.clip(gj, 0, map_cfg.height - 1)]
    return jnp.sum(jnp.where(ok, vals, 0.0), axis=1)


def _systematic_resample(particles: jnp.ndarray, w: jnp.ndarray,
                         u: jnp.ndarray) -> jnp.ndarray:
    """Systematic resampling: one uniform draw u in [0, 1) places P evenly
    spaced pointers over the weight CDF. O(P log P), fixed-shape."""
    P = particles.shape[0]
    cdf = jnp.cumsum(w)
    pointers = (u + jnp.arange(P, dtype=w.dtype)) / P
    idx = jnp.searchsorted(cdf, pointers)
    return particles[jnp.clip(idx, 0, P - 1)]


def _predict_particles(particles: jnp.ndarray, v_t, w_t,
                       k_v: jax.Array, k_w: jax.Array,
                       cfg: PFConfig) -> jnp.ndarray:
    """Per-particle noisy diff-drive step (sinc-corrected, reference
    modules/localization.py:29-36). Shared by pf_step and pf_slam_step so
    the two filters' motion models cannot drift apart."""
    P = particles.shape[0]
    v_p = v_t + cfg.sigma_v * jax.random.normal(k_v, (P,), jnp.float32)
    w_p = w_t + cfg.sigma_w * jax.random.normal(k_w, (P,), jnp.float32)
    dth = w_p * cfg.dt
    kk = v_p * cfg.dt * _sinc_half(dth)
    mid = particles[:, 2] + dth / 2.0
    return jnp.stack([
        particles[:, 0] + kk * jnp.cos(mid),
        particles[:, 1] + kk * jnp.sin(mid),
        particles[:, 2] + dth,
    ], axis=-1)


def _estimate_pose(particles: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """Weighted particle mean; yaw is the circular mean re-anchored to the
    unwrapped branch of the weighted linear mean (cumulative-yaw continuity,
    matching poses_from_odometry — see module docstring)."""
    lin_yaw = jnp.sum(w * particles[:, 2])
    circ = jnp.arctan2(jnp.sum(w * jnp.sin(particles[:, 2])),
                       jnp.sum(w * jnp.cos(particles[:, 2])))
    return jnp.array([
        jnp.sum(w * particles[:, 0]),
        jnp.sum(w * particles[:, 1]),
        lin_yaw + jnp.arctan2(jnp.sin(circ - lin_yaw),
                              jnp.cos(circ - lin_yaw)),
    ])


class PFState(NamedTuple):
    """Streaming filter state: everything pf_step carries between scans."""

    particles: jnp.ndarray  # (P, 3)
    logw: jnp.ndarray       # (P,) normalized log-weights
    key: jax.Array          # PRNG carry


def init_pf_state(cfg: PFConfig = PFConfig(),
                  x0: jnp.ndarray | None = None,
                  key: jax.Array | None = None,
                  init_particles: jnp.ndarray | None = None) -> PFState:
    """Initial state: all particles at x0, or `init_particles` for a spread
    (relocalization) start."""
    P = cfg.n_particles
    if x0 is None:
        x0 = jnp.zeros(3, jnp.float32)
    if key is None:
        key = jax.random.PRNGKey(0)
    if init_particles is None:
        particles = jnp.broadcast_to(jnp.asarray(x0, jnp.float32), (P, 3))
    else:
        particles = jnp.asarray(init_particles, jnp.float32)
    return PFState(particles=particles,
                   logw=jnp.full((P,), -jnp.log(P), jnp.float32), key=key)


@partial(jax.jit, static_argnames=("map_cfg", "cfg", "score_fn"))
def pf_step(state: PFState, v_t, w_t, pts, mask, im,
            map_cfg: MapConfig, cfg: PFConfig = PFConfig(),
            score_fn=None):
    """One streaming filter step (the serving analog of online.online_step).

    v_t scalar velocity (from v_from_encoder), w_t scalar yaw rate, pts
    (R, 2) robot-frame scan + mask, im (W, H) occupancy. Returns
    (new_state, (est_pose (3,), neff, resampled)). The batch entry point
    localize_particle_filter is exactly lax.scan over this function, so
    streaming and batch tracks are identical by construction (pinned by
    tests/test_particle_filter.py).

    score_fn overrides the scoring kernel — same signature as the default
    `(particles, pts, mask, im) -> (P,) scores`. The multi-chip path
    (parallel/sharding.sharded_pf_score) shards exactly this call over the
    mesh (the (P, R) scoring is the filter's only super-O(P) work); all
    other per-step math stays replicated, which keeps the sharded filter
    bitwise identical to the single-device one.
    """
    particles, logw, k = state
    P = cfg.n_particles
    k, k_v, k_w, k_u = jax.random.split(k, 4)

    # predict: per-particle noisy diff-drive step (sinc-corrected,
    # reference modules/localization.py:29-36)
    particles = _predict_particles(particles, v_t, w_t, k_v, k_w, cfg)

    # update: map-correlation log-weights, normalized via logsumexp
    if score_fn is None:
        score = _score_particles(particles, pts, mask, im, map_cfg)
    else:
        score = score_fn(particles, pts, mask, im)
    logw = logw + cfg.temperature * score
    logw = logw - jax.scipy.special.logsumexp(logw)
    w = jnp.exp(logw)

    # estimate: weighted mean with the cumulative-yaw-continuous circular
    # yaw mean (see _estimate_pose)
    est = _estimate_pose(particles, w)

    # branchless systematic resample on Neff collapse
    neff = 1.0 / jnp.sum(w * w)
    do_rs = neff < cfg.resample_frac * P
    res = _systematic_resample(particles, w,
                               jax.random.uniform(k_u, (), jnp.float32))
    particles = jnp.where(do_rs, res, particles)
    logw = jnp.where(do_rs, jnp.full_like(logw, -jnp.log(P)), logw)

    return PFState(particles, logw, k), (est, neff, do_rs)


@partial(jax.jit, static_argnames=("map_cfg", "cfg", "score_fn"))
def localize_particle_filter(
    im: jnp.ndarray,
    counts: jnp.ndarray,
    gyro: jnp.ndarray,
    points: jnp.ndarray,
    masks: jnp.ndarray,
    map_cfg: MapConfig,
    cfg: PFConfig = PFConfig(),
    x0: jnp.ndarray | None = None,
    key: jax.Array | None = None,
    init_particles: jnp.ndarray | None = None,
    score_fn=None,
) -> Tuple[jnp.ndarray, dict]:
    """Track the robot pose through a known map.

    im (W, H) float occupancy (1 at obstacles — e.g. `logodds > 0`);
    counts (N, 4) encoder counts; gyro (N, 3); points (N, R, 2) robot-frame
    scans with masks (N, R); x0 (3,) initial pose. Step alignment matches
    odometry (reference modules/localization.py:60-93): step i uses
    encoder/gyro row i and is scored against scan i.

    init_particles (n_particles, 3) overrides the all-at-x0 start — e.g. a
    uniform spread over the map for GLOBAL (kidnapped-robot)
    relocalization; row 0 of the returned track is still x0 (a
    placeholder when the start is genuinely unknown).

    Returns ((N, 3) pose estimates, aux) where aux carries `neff` (N,)
    effective sample sizes and `resampled` (N,) bool (entries 0 are the
    initial-state placeholders). score_fn as in pf_step (multi-chip
    particle-sharded scoring — parallel/sharding.sharded_pf_score).
    """
    P = cfg.n_particles
    if x0 is None:
        x0 = jnp.zeros(3, jnp.float32)
    im = im.astype(jnp.float32)

    v_all = v_from_encoder(counts.astype(jnp.float32))  # (N,)
    wyaw_all = gyro[:, -1].astype(jnp.float32)          # (N,)

    def step(carry, inp):
        v_t, w_t, pts, mask = inp
        new_state, out = pf_step(carry, v_t, w_t, pts, mask, im,
                                 map_cfg, cfg, score_fn)
        return new_state, out

    inp = (v_all[1:], wyaw_all[1:], points[1:], masks[1:])
    state0 = init_pf_state(cfg, x0, key, init_particles)
    _, (ests, neffs, flags) = jax.lax.scan(step, state0, inp)

    poses = jnp.concatenate([x0[None].astype(jnp.float32), ests], axis=0)
    aux = {
        "neff": jnp.concatenate([jnp.full((1,), float(P)), neffs]),
        "resampled": jnp.concatenate([jnp.zeros((1,), bool), flags]),
    }
    return poses, aux
