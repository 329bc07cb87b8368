"""Nearest-neighbor correspondences as brute-force masked distance argmin.

The reference finds correspondences with a SciPy KDTree (C) rebuilt per scan
pair and queried per ICP iteration (reference: modules/icp.py:29-41,161).
Tree queries do not batch on an accelerator; the replacement is a dense
distance matrix — exact (not approximate), batched over pairs, and fused by
XLA: d(i,j) = ||s_i||^2 - 2 s_i . t_j + ||t_j||^2, row argmin. At scan
scale (64 pairs x 1081 x 1081) XLA writes the (B, P, P) distance tensor
(299 MB) to device memory once per ICP iteration.

`nearest_neighbors_chunked` has identical semantics with the source axis
processed in chunks, for clouds whose full distance tensor would not fit.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..utils.precision import einsum as p_einsum

_BIG = 1e30


def nearest_neighbors(
    src: jnp.ndarray,
    tgt: jnp.ndarray,
    tgt_mask: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Index of the nearest target point for every source point.

    src (..., N, D), tgt (..., M, D), tgt_mask (..., M) bool; returns
    (..., N) int32. Masked-out target points are never selected (their
    distance is +inf). Exact, like the KDTree it replaces; ties resolve to
    the lowest index (argmin), matching numpy semantics.
    """
    # ||s||^2 - 2 s.t + ||t||^2 ; the ||s||^2 term is constant per row and
    # does not affect the argmin, so skip it.
    cross = p_einsum("...nd,...md->...nm", src, tgt)
    t2 = jnp.sum(tgt * tgt, axis=-1)
    d = t2[..., None, :] - 2.0 * cross
    if tgt_mask is not None:
        d = jnp.where(tgt_mask[..., None, :], d, _BIG)
    return jnp.argmin(d, axis=-1).astype(jnp.int32)


def nearest_neighbors_chunked(
    src: jnp.ndarray,
    tgt: jnp.ndarray,
    tgt_mask: jnp.ndarray | None = None,
    src_chunk: int = 2048,
) -> jnp.ndarray:
    """`nearest_neighbors` with the source axis processed in chunks.

    Bounds peak memory at (B, src_chunk, M) instead of (B, N, M) — required
    for warm-up-scale clouds (tens of thousands of points) where the full
    distance tensor would not fit in HBM. Exact same indices.
    src (B, N, D), tgt (B, M, D) -> (B, N) int32.
    """
    import jax

    B, N, D = src.shape
    C = min(src_chunk, N)
    n_chunks = -(-N // C)
    pad = n_chunks * C - N
    srcp = jnp.pad(src, ((0, 0), (0, pad), (0, 0)))
    chunks = jnp.moveaxis(srcp.reshape(B, n_chunks, C, D), 1, 0)

    def one(chunk):
        return nearest_neighbors(chunk, tgt, tgt_mask)

    idx = jax.lax.map(one, chunks)  # (n_chunks, B, C)
    return jnp.moveaxis(idx, 0, 1).reshape(B, n_chunks * C)[:, :N]


def nearest_neighbor_dists(
    src: jnp.ndarray,
    tgt: jnp.ndarray,
    tgt_mask: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Like `nearest_neighbors` but also returns the true squared distances."""
    idx = nearest_neighbors(src, tgt, tgt_mask)
    matched = jnp.take_along_axis(tgt, idx[..., None], axis=-2)
    d2 = jnp.sum((src - matched) ** 2, axis=-1)
    return idx, d2
