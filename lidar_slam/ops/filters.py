"""Scan outlier filters as pure mask updates.

Capability parity with the reference's optional --filter_lidar stage
(reference: main.py:86-87, modules/localization.py:201-250). The reference
calls sklearn DBSCAN (Cython) per scan and then drops points whose range
exceeds mean + k*sigma over all scans pooled, physically shrinking the
ragged arrays. Here both filters only update validity masks over the fixed
(N, P) scan batch.

NB: the pipeline defaults (eps = 0.1 m, min_samples = 10,
reference main.py:86) assume full 1081-ray scans: at 0.25 deg spacing wall
points are ~4-7 cm apart at typical ranges. On downsampled scans (fewer
rays) the same eps legitimately classifies nearly every point as noise —
the reference would do the same.

DBSCAN insight: the pipeline never uses cluster LABELS — only the outlier
set (label == -1, reference localization.py:218). A point is a non-outlier
iff it is a core point (>= min_samples neighbors within eps, self included)
or within eps of a core point. That predicate needs no connected-components
iteration, just one masked distance matrix per scan — the same matmul-shaped
computation as the ICP correspondence kernel. A full label assignment (for
API completeness) is provided via iterated min-label propagation.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..utils.precision import einsum as p_einsum

_BIG = 1e30


def _pair_d2(pts: jnp.ndarray) -> jnp.ndarray:
    """(..., P, P) squared pairwise distances."""
    x2 = jnp.sum(pts * pts, axis=-1)
    cross = p_einsum("...nd,...md->...nm", pts, pts)
    d2 = x2[..., :, None] - 2.0 * cross + x2[..., None, :]
    return jnp.maximum(d2, 0.0)


@partial(jax.jit, static_argnames=("min_samples",))
def dbscan_outlier_mask(
    pts: jnp.ndarray,
    mask: jnp.ndarray,
    eps: float,
    min_samples: int,
) -> jnp.ndarray:
    """Non-outlier mask per scan batch: (..., P, 2|3) points, (..., P) valid.

    Matches sklearn DBSCAN noise semantics (neighborhood is d <= eps,
    self-inclusive; reference call site: modules/localization.py:216-218).
    """
    eps = jnp.asarray(eps, pts.dtype)
    d2 = _pair_d2(pts)
    neigh = (d2 <= eps * eps) & mask[..., None, :] & mask[..., :, None]
    counts = jnp.sum(neigh, axis=-1)
    core = (counts >= min_samples) & mask
    border = jnp.any(neigh & core[..., None, :], axis=-1)
    return mask & (core | border)


def dbscan_labels(
    pts: jnp.ndarray,
    mask: jnp.ndarray,
    eps: float,
    min_samples: int,
) -> jnp.ndarray:
    """Full DBSCAN cluster labels (-1 noise) via min-label propagation over
    the core-connectivity graph, iterated TO FIXPOINT (a lax.while_loop on
    label change, so arbitrarily long core chains are labeled correctly —
    convergence needs at most the component diameter sweeps, bounded by P).
    Label ids are canonical minima, not sklearn's visit order. Provided for
    API completeness (the pipeline only consumes the outlier mask)."""
    P = pts.shape[-2]
    eps = jnp.asarray(eps, pts.dtype)
    d2 = _pair_d2(pts)
    neigh = (d2 <= eps * eps) & mask[..., None, :] & mask[..., :, None]
    counts = jnp.sum(neigh, axis=-1)
    core = (counts >= min_samples) & mask

    idx = jnp.arange(P)
    labels = jnp.where(core, idx, P)  # P = "unassigned"
    core_adj = neigh & core[..., None, :] & core[..., :, None]

    def sweep(lab):
        neigh_min = jnp.min(jnp.where(core_adj, lab[..., None, :], P), axis=-1)
        return jnp.where(core, jnp.minimum(lab, neigh_min), lab)

    def cond(state):
        _, changed, it = state
        return changed & (it < P)

    def body(state):
        lab, _, it = state
        new = sweep(lab)
        return new, jnp.any(new != lab), it + 1

    labels, _, _ = jax.lax.while_loop(cond, body,
                                      (labels, jnp.asarray(True), 0))
    # borders adopt the minimum core neighbor's label
    border_lab = jnp.min(jnp.where(neigh & core[..., None, :],
                                   labels[..., None, :], P), axis=-1)
    labels = jnp.where(core, labels, border_lab)
    return jnp.where(mask & (labels < P), labels, -1)


@partial(jax.jit, static_argnames=("min_samples", "chunk_size"))
def dbscan_filter_scans(
    points: jnp.ndarray,
    masks: jnp.ndarray,
    eps: float = 0.1,
    min_samples: int = 10,
    chunk_size: int = 16,
) -> jnp.ndarray:
    """Per-scan DBSCAN outlier removal over the (N, P, 2) batch
    (reference: modules/localization.py:201-221, main.py:86).

    Chunked with lax.map to bound the N x P x P distance working set while
    keeping the whole filter one device dispatch."""
    N, P = points.shape[0], points.shape[1]
    C = min(chunk_size, N)
    n_chunks = -(-N // C)
    pad = n_chunks * C - N
    pts = jnp.pad(points, ((0, pad), (0, 0), (0, 0)))
    mks = jnp.pad(masks, ((0, pad), (0, 0)))

    def one(args):
        p, m = args
        return dbscan_outlier_mask(p, m, eps, min_samples)

    out = jax.lax.map(one, (pts.reshape(n_chunks, C, P, -1),
                            mks.reshape(n_chunks, C, P)))
    return out.reshape(n_chunks * C, P)[:N]


@jax.jit
def statistical_filter_scans(
    points: jnp.ndarray,
    masks: jnp.ndarray,
    k_std: float = 2.0,
) -> jnp.ndarray:
    """Drop points with range >= mean + k*sigma over ALL scans pooled
    (reference: modules/localization.py:223-250, main.py:87; the reference
    keeps strictly-less-than, population std)."""
    d = jnp.linalg.norm(points, axis=-1)
    w = masks.astype(points.dtype)
    n = jnp.maximum(jnp.sum(w), 1.0)
    mean = jnp.sum(d * w) / n
    var = jnp.sum((d - mean) ** 2 * w) / n
    thresh = mean + k_std * jnp.sqrt(var)
    return masks & (d < thresh)
