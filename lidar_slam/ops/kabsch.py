"""Masked, batched Kabsch rigid alignment (SVD with reflection guard).

Capability parity with the reference's per-pair Kabsch fit
(reference: modules/icp.py:43-74), generalized to weights/masks and leading
batch dimensions so thousands of scan pairs solve in one batched 3x3 SVD
(on a GPU, XLA hands batched SVDs and determinants to cuSOLVER).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..utils.precision import einsum as p_einsum, matmul as p_matmul


def masked_centroid(pts: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """Weighted centroid over the points axis. pts (..., N, D), w (..., N)."""
    wsum = jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1e-12)
    return jnp.sum(pts * w[..., None], axis=-2) / wsum


def kabsch(
    src: jnp.ndarray,
    tgt: jnp.ndarray,
    w: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Rigid transform T (D+1, D+1) minimizing sum w_i ||R src_i + t - tgt_i||^2.

    src/tgt (..., N, D); w (..., N) weights (bool masks work). The returned
    rotation has det(R) = +1 via the diag(1, .., det) correction
    (reference: modules/icp.py:62-67).
    """
    D = src.shape[-1]
    if w is None:
        w = jnp.ones(src.shape[:-1], dtype=src.dtype)
    w = w.astype(src.dtype)

    cs = masked_centroid(src, w)
    ct = masked_centroid(tgt, w)
    X = (src - cs[..., None, :]) * w[..., None]
    Y = tgt - ct[..., None, :]
    S = p_einsum("...nd,...ne->...de", X, Y)  # (..., D, D)

    U, _, Vt = jnp.linalg.svd(S)
    V = jnp.swapaxes(Vt, -1, -2)
    Ut = jnp.swapaxes(U, -1, -2)
    det = jnp.linalg.det(p_matmul(V, Ut))
    corr = jnp.concatenate(
        [jnp.ones(det.shape + (D - 1,), dtype=src.dtype), det[..., None]], axis=-1
    )
    R = p_matmul(V * corr[..., None, :], Ut)
    t = ct - p_einsum("...de,...e->...d", R, cs)

    T = jnp.zeros(src.shape[:-2] + (D + 1, D + 1), dtype=src.dtype)
    T = T.at[..., :D, :D].set(R)
    T = T.at[..., :D, D].set(t)
    T = T.at[..., D, D].set(1.0)
    return T


def scan_normals_planar(
    pts: jnp.ndarray,
    mask: jnp.ndarray,
    max_gap: float = 0.5,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Per-point 2-D normals of a lidar scan from its RAY-ORDER neighbors.

    pts (..., P, 2) in scan order, mask (..., P). The surface tangent at
    ray i is p_{i+1} - p_{i-1}; the normal is its perpendicular,
    normalized. A normal is valid only when both neighbors are valid and
    the tangent chord is shorter than `max_gap` (depth discontinuities —
    a chord jumping between surfaces is not a tangent). The first/last
    ray have no two-sided neighbor (the scan is NOT circular at 270-degree
    FOV) and are invalid. New surface (point-to-line ICP); the reference
    has no normal machinery.
    """
    nxt = jnp.roll(pts, -1, axis=-2)
    prv = jnp.roll(pts, 1, axis=-2)
    mn = jnp.roll(mask, -1, axis=-1)
    mp = jnp.roll(mask, 1, axis=-1)
    d = nxt - prv
    d2 = jnp.sum(d * d, axis=-1)
    valid = mask & mn & mp & (d2 < max_gap * max_gap) & (d2 > 1e-12)
    # endpoints wrap via roll — sever the false first<->last adjacency
    valid = valid.at[..., 0].set(False).at[..., -1].set(False)
    inv = jnp.where(d2 > 1e-12, 1.0 / jnp.sqrt(d2), 0.0)
    n = jnp.stack([-d[..., 1] * inv, d[..., 0] * inv], axis=-1)
    return n, valid


def fit_point_to_line_planar(
    src: jnp.ndarray,
    tgt: jnp.ndarray,
    normals: jnp.ndarray,
    w: jnp.ndarray,
) -> jnp.ndarray:
    """One point-to-line Gauss-Newton step (PLICP, Censi 2008): the SE(2)
    transform minimizing sum_i w_i (n_i . (R src_i + t - tgt_i))^2 with
    the rotation linearized about 0 (standard per-iteration treatment —
    the OUTER ICP loop supplies the large rotation via composition).

    src (..., N, 2) current-iterate source points, tgt/normals (..., N, 2)
    the MATCHED target points and their normals, w (..., N) weights.
    Closed form: params x = (tx, ty, theta), rows a_i = (n_x, n_y,
    n . J p) with J p = (-p_y, p_x), b_i = n . (q - p); solve the 3x3
    normal equations (batched — thousands of pairs in one tiny solve,
    the shape XLA tiles well). A relative Tikhonov term (1e-8 x mean
    diagonal) keeps rank-2 geometries (straight corridors: translation
    along the wall unobservable) finite instead of exploding.
    Returns (..., 4, 4) SE(3) transforms rotating about z (the exact
    rotation R(theta*), not its linearization).
    """
    w = w.astype(src.dtype)
    jp = jnp.stack([-src[..., 1], src[..., 0]], axis=-1)  # J p
    a3 = jnp.sum(normals * jp, axis=-1)
    A = jnp.concatenate([normals, a3[..., None]], axis=-1)  # (..., N, 3)
    b = jnp.sum(normals * (tgt - src), axis=-1)
    Aw = A * w[..., None]
    H = p_einsum("...ni,...nj->...ij", Aw, A)
    g = p_einsum("...ni,...n->...i", Aw, b)
    tr = (H[..., 0, 0] + H[..., 1, 1] + H[..., 2, 2]) / 3.0
    damp = (1e-8 * tr + 1e-12)[..., None, None] * jnp.eye(3, dtype=src.dtype)
    x = jnp.linalg.solve(H + damp, g[..., None])[..., 0]
    theta = x[..., 2]
    c, s = jnp.cos(theta), jnp.sin(theta)
    batch = src.shape[:-2]
    T = jnp.broadcast_to(jnp.eye(4, dtype=src.dtype), batch + (4, 4))
    T = T.at[..., 0, 0].set(c)
    T = T.at[..., 0, 1].set(-s)
    T = T.at[..., 1, 0].set(s)
    T = T.at[..., 1, 1].set(c)
    T = T.at[..., 0, 3].set(x[..., 0])
    T = T.at[..., 1, 3].set(x[..., 1])
    return T


def kabsch_planar(
    src: jnp.ndarray,
    tgt: jnp.ndarray,
    w: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Closed-form planar Kabsch: (..., N, 2) clouds -> (..., 4, 4) SE(3)
    transforms rotating about z only.

    For z = 0 clouds (the whole 2-D SLAM pipeline: the reference lifts scans
    to 3-D with zero z, modules/icp.py:153-156), the 3x3 cross-covariance is
    rank-deficient — an iterative SVD can stall on it (observed ~10^4 x
    slowdowns on an earlier accelerator). The in-plane optimum is closed-form:
    theta* = atan2(S01 - S10, S00 + S11), identical to the SVD + det-guard
    result on planar data, with zero iterative work.
    """
    if w is None:
        w = jnp.ones(src.shape[:-1], dtype=src.dtype)
    w = w.astype(src.dtype)

    cs = masked_centroid(src, w)
    ct = masked_centroid(tgt, w)
    X = (src - cs[..., None, :]) * w[..., None]
    Y = tgt - ct[..., None, :]
    S = p_einsum("...nd,...ne->...de", X, Y)  # (..., 2, 2)

    theta = jnp.arctan2(S[..., 0, 1] - S[..., 1, 0],
                        S[..., 0, 0] + S[..., 1, 1])
    c, s = jnp.cos(theta), jnp.sin(theta)
    tx = ct[..., 0] - (c * cs[..., 0] - s * cs[..., 1])
    ty = ct[..., 1] - (s * cs[..., 0] + c * cs[..., 1])

    batch = src.shape[:-2]
    T = jnp.broadcast_to(jnp.eye(4, dtype=src.dtype), batch + (4, 4))
    T = T.at[..., 0, 0].set(c)
    T = T.at[..., 0, 1].set(-s)
    T = T.at[..., 1, 0].set(s)
    T = T.at[..., 1, 1].set(c)
    T = T.at[..., 0, 3].set(tx)
    T = T.at[..., 1, 3].set(ty)
    return T
