"""SE(2)/SE(3) pose algebra as pure, batch-friendly jnp functions.

Capability parity with the reference pose helpers
(reference: modules/utils.py:140-240, modules/localization.py:162-177), but
designed for XLA: every function is shape-polymorphic over leading batch
dimensions so `vmap`/`scan` compose freely, and nothing mutates.

Conventions: a "pose" is a (..., 3) array (x, y, theta); an SE(2) transform is
(..., 3, 3); an SE(3) transform is (..., 4, 4).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .precision import einsum as p_einsum, matmul as p_matmul


def T_from_pose(pose: jnp.ndarray) -> jnp.ndarray:
    """Pose (..., 3) -> SE(2) matrix (..., 3, 3). (reference: modules/utils.py:178-194)"""
    x, y, th = pose[..., 0], pose[..., 1], pose[..., 2]
    c, s = jnp.cos(th), jnp.sin(th)
    zero = jnp.zeros_like(x)
    one = jnp.ones_like(x)
    rows = [
        jnp.stack([c, -s, x], axis=-1),
        jnp.stack([s, c, y], axis=-1),
        jnp.stack([zero, zero, one], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)


def pose_from_T(T: jnp.ndarray) -> jnp.ndarray:
    """SE(2) (..., 3, 3) or SE(3) (..., 4, 4) -> pose (..., 3).
    (reference: modules/utils.py:196-210)"""
    if T.shape[-1] == 4:
        T = TSE2_from_TSE3(T)
    x = T[..., 0, 2]
    y = T[..., 1, 2]
    th = jnp.arctan2(T[..., 1, 0], T[..., 0, 0])
    return jnp.stack([x, y, th], axis=-1)


def TSE2_from_TSE3(T_SE3: jnp.ndarray) -> jnp.ndarray:
    """SE(3) (..., 4, 4) -> SE(2) (..., 3, 3), keeping the xy block.
    (reference: modules/utils.py:212-225)"""
    batch = T_SE3.shape[:-2]
    T = jnp.broadcast_to(jnp.eye(3, dtype=T_SE3.dtype), batch + (3, 3))
    T = T.at[..., :2, :2].set(T_SE3[..., :2, :2])
    T = T.at[..., :2, 2].set(T_SE3[..., :2, 3])
    return T


def TSE3_from_TSE2(T_SE2: jnp.ndarray) -> jnp.ndarray:
    """SE(2) (..., 3, 3) -> SE(3) (..., 4, 4) with zero z / identity z-rotation.
    (reference: modules/utils.py:227-240)"""
    batch = T_SE2.shape[:-2]
    T = jnp.broadcast_to(jnp.eye(4, dtype=T_SE2.dtype), batch + (4, 4))
    T = T.at[..., :2, :2].set(T_SE2[..., :2, :2])
    T = T.at[..., :2, 3].set(T_SE2[..., :2, 2])
    return T


def inverse_T(T: jnp.ndarray) -> jnp.ndarray:
    """Closed-form rigid-transform inverse for (..., 3, 3) SE(2) or (..., 4, 4) SE(3).

    The reference inverts with a general LU solve (np.linalg.inv,
    modules/utils.py:175); on a device the closed form [R^T, -R^T t] is cheaper and
    exactly orthogonal-preserving.
    """
    d = T.shape[-1] - 1
    R = T[..., :d, :d]
    t = T[..., :d, d]
    Rt = jnp.swapaxes(R, -1, -2)
    tinv = -p_einsum("...ij,...j->...i", Rt, t)
    out = jnp.broadcast_to(jnp.eye(d + 1, dtype=T.dtype), T.shape)
    out = out.at[..., :d, :d].set(Rt)
    out = out.at[..., :d, d].set(tinv)
    return out


def get_relative_pose(pose_t1: jnp.ndarray, pose_t2: jnp.ndarray) -> jnp.ndarray:
    """Relative SE(2) transform T1^-1 @ T2, (..., 3, 3).
    (reference: modules/utils.py:161-176, modules/localization.py:162-177)"""
    T1 = T_from_pose(pose_t1)
    T2 = T_from_pose(pose_t2)
    return p_matmul(inverse_T(T1), T2)


def transform_points(points: jnp.ndarray, T: jnp.ndarray) -> jnp.ndarray:
    """Apply homogeneous transform T to points.

    points: (..., N, 2) with T (..., 3, 3), or (..., N, 3) with T (..., 4, 4).
    (reference: modules/utils.py:140-159)
    """
    d = points.shape[-1]
    if T.shape[-1] != d + 1:
        raise ValueError(
            f"Invalid point/transform shapes: points {points.shape}, T {T.shape}"
        )
    R = T[..., :d, :d]
    t = T[..., :d, d]
    return p_einsum("...ij,...nj->...ni", R, points) + t[..., None, :]


def compose_chain(relative_Ts: jnp.ndarray, T0: jnp.ndarray | None = None) -> jnp.ndarray:
    """Prefix-compose a chain of relative transforms into global transforms.

    Input (N, 3, 3) relative transforms T_{i->i+1}; output (N+1, 3, 3) global
    transforms [T0, T0@R0, T0@R0@R1, ...]. The reference does this with a
    sequential Python loop (modules/localization.py:112-130); matrix
    composition is associative, so on device it is a `lax.associative_scan` —
    O(log N) depth instead of O(N).
    """
    n = relative_Ts.shape[0]
    eye = jnp.eye(3, dtype=relative_Ts.dtype)
    if T0 is None:
        T0 = eye
    chain = jnp.concatenate([T0[None], relative_Ts], axis=0)  # (N+1, 3, 3)
    return jax.lax.associative_scan(p_matmul, chain)


def wrap_angle(theta: jnp.ndarray) -> jnp.ndarray:
    """Wrap angles to (-pi, pi]."""
    return jnp.arctan2(jnp.sin(theta), jnp.cos(theta))


def _ab(omega: jnp.ndarray):
    """a = sin(w)/w, b = (1-cos(w))/w with series guards at w = 0."""
    small = jnp.abs(omega) < 1e-6
    w = jnp.where(small, 1.0, omega)
    a = jnp.where(small, 1.0 - omega * omega / 6.0, jnp.sin(w) / w)
    b = jnp.where(small, omega / 2.0, (1.0 - jnp.cos(w)) / w)
    return a, b


def log_se2(T: jnp.ndarray) -> jnp.ndarray:
    """SE(2) logarithm: (..., 3, 3) -> (..., 3) tangent (vx, vy, omega).

    The full chart (with the V-matrix coupling of rotation into translation),
    matching GTSAM's Pose2 log map — the error model of the factors the
    reference builds (reference: main.py:148-172 via gtsam.BetweenFactorPose2).
    """
    omega = jnp.arctan2(T[..., 1, 0], T[..., 0, 0])
    tx, ty = T[..., 0, 2], T[..., 1, 2]
    a, b = _ab(omega)
    den = a * a + b * b
    # V^-1 = [[a, b], [-b, a]] / (a^2 + b^2)
    vx = (a * tx + b * ty) / den
    vy = (-b * tx + a * ty) / den
    return jnp.stack([vx, vy, omega], axis=-1)


def exp_se2(xi: jnp.ndarray) -> jnp.ndarray:
    """SE(2) exponential: (..., 3) tangent (vx, vy, omega) -> (..., 3, 3)."""
    vx, vy, omega = xi[..., 0], xi[..., 1], xi[..., 2]
    a, b = _ab(omega)
    tx = a * vx - b * vy
    ty = b * vx + a * vy
    return T_from_pose(jnp.stack([tx, ty, omega], axis=-1))
