"""Batched masked ICP: the framework's #1 hot kernel.

Capability parity with the reference ICP (reference: modules/icp.py:100-189,
call sites modules/localization.py:115-123 and main.py:161-172), redesigned
for XLA:

  - correspondences are an exact brute-force masked distance argmin
    (ops/nn.py) instead of a per-pair SciPy KDTree;
  - the rigid fit is one batched 3x3 SVD Kabsch (ops/kabsch.py) instead of
    per-pair numpy SVDs;
  - the data-dependent iteration count lives in a single `lax.while_loop`
    whose carry holds ALL pairs in the batch: converged pairs freeze (their
    state stops updating) while the rest keep iterating, so thousands of
    scan pairs run lockstep on device with no host round-trips.

Reference stopping semantics preserved exactly (modules/icp.py:163-181):
the transform is composed BEFORE the break checks, and the reported error is
measured against the pre-update transform — so the returned T is one Kabsch
step ahead of the returned error. Stop when (a) error < epsilon, (b) the
iteration counter reaches max_iters, or (c) |last_err - err| <
stopping_thresh (skipped on the first iteration).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .kabsch import kabsch, kabsch_planar
from .nn import nearest_neighbors
from ..utils.precision import einsum as p_einsum, matmul as p_matmul

_INF = jnp.inf


class IcpResult(NamedTuple):
    T: jnp.ndarray  # (..., 4, 4) final transforms
    error: jnp.ndarray  # (...,) final (possibly normalized) error
    iters: jnp.ndarray  # (...,) iterations executed per pair
    correspondences: jnp.ndarray  # (..., P) final correspondence indices


def _transform(pts: jnp.ndarray, T: jnp.ndarray) -> jnp.ndarray:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return p_einsum("...ij,...nj->...ni", R, pts) + t[..., None, :]


def _masked_minmax(pts: jnp.ndarray, mask: jnp.ndarray):
    big = jnp.asarray(_INF, pts.dtype)
    mn = jnp.min(jnp.where(mask[..., None], pts, big), axis=-2)
    mx = jnp.max(jnp.where(mask[..., None], pts, -big), axis=-2)
    return mn, mx


def _error(src_t, matched, mask, normalize: bool, d2=None):
    """Masked squared error; optional bbox-diagonal normalization
    (reference: modules/icp.py:76-98 — the bbox spans the transformed source
    AND the corresponded target points, and N is the source point count).
    d2 overrides the per-point squared residuals (point-to-line metric)."""
    if d2 is None:
        d2 = jnp.sum((src_t - matched) ** 2, axis=-1)
    err = jnp.sum(jnp.where(mask, d2, 0.0), axis=-1)
    if not normalize:
        return err
    mn1, mx1 = _masked_minmax(src_t, mask)
    mn2, mx2 = _masked_minmax(matched, mask)
    mn = jnp.minimum(mn1, mn2)
    mx = jnp.maximum(mx1, mx2)
    diag2 = jnp.sum((mx - mn) ** 2, axis=-1)
    n = jnp.maximum(jnp.sum(mask, axis=-1), 1)
    return err / (diag2 * n)


def _trim_mask(d2: jnp.ndarray, mask: jnp.ndarray,
               trim_fraction: float) -> jnp.ndarray:
    """Per pair: the mask restricted to the best `trim_fraction` of VALID
    points by squared correspondence distance (trimmed ICP, Chetverikov's
    TrICP selection rule). Points sharing the threshold distance are all
    kept, so the kept count can slightly exceed ceil(q * n_valid)."""
    big = jnp.asarray(_INF, d2.dtype)
    d2m = jnp.where(mask, d2, big)
    order = jnp.sort(d2m, axis=-1)  # invalid sink to the end
    n_valid = jnp.sum(mask, axis=-1)
    k = jnp.clip(jnp.ceil(trim_fraction * n_valid).astype(jnp.int32),
                 1, jnp.maximum(n_valid, 1))
    thresh = jnp.take_along_axis(order, (k - 1)[..., None], axis=-1)
    return mask & (d2m <= thresh)


def icp_iteration(
    src: jnp.ndarray,
    tgt: jnp.ndarray,
    src_mask: jnp.ndarray,
    tgt_mask: jnp.ndarray,
    T_prev: jnp.ndarray,
    normalize_error: bool = False,
    planar: bool = False,
    nn_backend: str = "jnp",
    trim_fraction: float = 1.0,
    metric: str = "point",
):
    """One batched ICP iteration (reference semantics: modules/icp.py:100-121).

    Returns (T_next, correspondences, error) where error is measured at
    T_prev (pre-update) like the reference. With planar=True (z = 0 clouds,
    i.e. the whole 2-D SLAM pipeline) the rigid fit uses the closed-form
    in-plane Kabsch instead of a rank-deficient 3x3 SVD — equivalent result,
    no iterative SVD (which can stall on degenerate matrices).

    trim_fraction < 1.0 selects TRIMMED ICP (TrICP): each iteration the
    rigid fit and the error use only the best `trim_fraction` of valid
    source points by correspondence distance — the standard estimator for
    PARTIAL-OVERLAP alignment (revisit scans that share only part of the
    scene; the reference's whole-cloud fit drags the pose toward the
    non-overlapping structure and its error prefers aliased alignments —
    PERF.md round-3 negative result). 1.0 is the reference-parity path
    with zero added work.

    metric="point_to_line" (planar only) replaces the Kabsch fit with a
    point-to-line Gauss-Newton step against the matched target points'
    local surface lines (PLICP — kabsch.fit_point_to_line_planar) and the
    error with the squared point-to-LINE distance. Point-to-point
    correspondence on sampled surfaces carries a half-ray-spacing bias
    (the nearest SAMPLE is not the nearest SURFACE point) that the line
    metric removes; it also converges in far fewer iterations. "point"
    (default) is the reference-parity metric.
    """
    src_t = _transform(src, T_prev)
    if nn_backend == "chunked":
        from .nn import nearest_neighbors_chunked

        idx = nearest_neighbors_chunked(src_t, tgt, tgt_mask)
        matched = jnp.take_along_axis(tgt, idx[..., None], axis=-2)
    else:
        idx = nearest_neighbors(src_t, tgt, tgt_mask)
        matched = jnp.take_along_axis(tgt, idx[..., None], axis=-2)
    fit_mask = src_mask
    if trim_fraction < 1.0:
        d2 = jnp.sum((src_t - matched) ** 2, axis=-1)
        fit_mask = _trim_mask(d2, src_mask, trim_fraction)
    if metric == "point_to_line":
        # PLICP (planar only): fit + error against the matched target
        # points' surface lines; falls back to point-to-point for the
        # matches whose target normal is invalid (discontinuity/boundary)
        from .kabsch import fit_point_to_line_planar, scan_normals_planar

        nrm, nvalid = scan_normals_planar(tgt[..., :2], tgt_mask)
        n_m = jnp.take_along_axis(nrm, idx[..., None], axis=-2)
        nv_m = jnp.take_along_axis(nvalid, idx, axis=-1)
        w_pl = fit_mask & nv_m
        T_fit = fit_point_to_line_planar(src_t[..., :2], matched[..., :2],
                                         n_m, w_pl)
        dpl2 = jnp.sum(n_m * (src_t[..., :2] - matched[..., :2]),
                       axis=-1) ** 2
        err = _error(src_t, matched, w_pl, normalize_error, d2=dpl2)
    elif planar:
        T_fit = kabsch_planar(src_t[..., :2], matched[..., :2],
                              w=fit_mask.astype(src.dtype))
        err = _error(src_t, matched, fit_mask, normalize_error)
    else:
        T_fit = kabsch(src_t, matched, w=fit_mask.astype(src.dtype))
        err = _error(src_t, matched, fit_mask, normalize_error)
    T_next = p_matmul(T_fit, T_prev)
    return T_next, idx, err


class IcpCarry(NamedTuple):
    """Mid-run ICP state for a batch of pairs; resumable via
    resume_icp_batch (pairs frozen at done=True never update again)."""
    T: jnp.ndarray  # (B, 4, 4)
    err: jnp.ndarray  # (B,)
    last_err: jnp.ndarray  # (B,)
    last_err2: jnp.ndarray  # (B,) error two iterations back (cycle stop)
    idx: jnp.ndarray | None  # (B, P) int32, or None for schedules that
    # never read correspondences back (None removes the carry's largest
    # field — (B, P) ≈ 22 MB at dataset scale — from every per-phase
    # permutation and per-chunk slice/update; T/err/k are unaffected)
    k: jnp.ndarray  # (B,) int32
    done: jnp.ndarray  # (B,) bool


def _icp_body(src, tgt, src_mask, tgt_mask, c: IcpCarry,
              epsilon, max_iters, stopping_thresh, normalize_error,
              planar, nn_backend, trim_fraction=1.0,
              metric="point") -> IcpCarry:
    """One iteration of the batched ICP loop: live pairs advance one Kabsch
    step and evaluate the reference's three stopping rules; done pairs
    freeze (reference loop body: modules/icp.py:167-181)."""
    T_new, idx, err = icp_iteration(src, tgt, src_mask, tgt_mask, c.T,
                                    normalize_error, planar=planar,
                                    nn_backend=nn_backend,
                                    trim_fraction=trim_fraction,
                                    metric=metric)
    live = ~c.done
    # stopping rules evaluated with this iteration's error
    hit_eps = err < epsilon
    hit_iters = c.k >= max_iters
    first = jnp.isinf(c.last_err)
    hit_delta = (~first) & (jnp.abs(c.last_err - err) < stopping_thresh)
    if metric == "point_to_line":
        # correspondence limit cycles (the pose flip-flops between two
        # states with |delta err| > stopping_thresh forever) are common
        # with the long point-to-line step; also stop when the error
        # matches the one TWO iterations back. Disabled for the "point"
        # metric — its stopping semantics are reference parity.
        first2 = jnp.isinf(c.last_err2)
        hit_delta = hit_delta | (
            (~first2) & (jnp.abs(c.last_err2 - err) < stopping_thresh))
    done_new = c.done | (live & (hit_eps | hit_iters | hit_delta))
    sel = live[:, None, None]
    return IcpCarry(
        T=jnp.where(sel, T_new, c.T),
        err=jnp.where(live, err, c.err),
        last_err=jnp.where(live, err, c.last_err),
        last_err2=jnp.where(live, c.last_err, c.last_err2),
        idx=None if c.idx is None else jnp.where(live[:, None], idx, c.idx),
        k=jnp.where(live, c.k + 1, c.k),
        done=done_new,
    )


def _icp_while(src, tgt, src_mask, tgt_mask, carry: IcpCarry,
               epsilon, max_iters, stopping_thresh, normalize_error,
               planar, nn_backend, trim_fraction=1.0,
               metric="point") -> IcpCarry:
    """Iterate every live pair in the batch to its own convergence."""

    def cond(c: IcpCarry):
        return jnp.any(~c.done)

    def body(c: IcpCarry):
        return _icp_body(src, tgt, src_mask, tgt_mask, c,
                         epsilon, max_iters, stopping_thresh,
                         normalize_error, planar, nn_backend,
                         trim_fraction, metric)

    return jax.lax.while_loop(cond, body, carry)


def initial_icp_carry(init_T: jnp.ndarray, B: int, P: int,
                      dtype, with_idx: bool = True) -> IcpCarry:
    return IcpCarry(
        T=init_T.astype(dtype),
        err=jnp.full((B,), _INF, dtype),
        last_err=jnp.full((B,), _INF, dtype),
        last_err2=jnp.full((B,), _INF, dtype),
        idx=jnp.zeros((B, P), jnp.int32) if with_idx else None,
        k=jnp.zeros((B,), jnp.int32),
        done=jnp.zeros((B,), bool),
    )


@partial(jax.jit, static_argnames=("epsilon", "max_iters", "stopping_thresh",
                                   "normalize_error", "planar", "nn_backend",
                                   "trim_fraction", "metric"))
def run_icp_batch(
    src: jnp.ndarray,
    tgt: jnp.ndarray,
    src_mask: jnp.ndarray,
    tgt_mask: jnp.ndarray,
    init_T: jnp.ndarray,
    epsilon: float = 0.01,
    max_iters: int = 2000,
    stopping_thresh: float = 1e-4,
    normalize_error: bool = False,
    planar: bool = False,
    nn_backend: str = "jnp",
    trim_fraction: float = 1.0,
    metric: str = "point",
) -> IcpResult:
    """Run ICP to convergence for a whole batch of pairs.

    src/tgt (B, P, 3) point clouds, src_mask/tgt_mask (B, P) validity,
    init_T (B, 4, 4) initial transforms. Defaults mirror the reference
    signature (modules/icp.py:123-133).
    """
    B, P = src.shape[0], src.shape[1]
    init = initial_icp_carry(init_T, B, P, src.dtype)
    out = _icp_while(src, tgt, src_mask, tgt_mask, init,
                     epsilon, max_iters, stopping_thresh, normalize_error,
                     planar, nn_backend, trim_fraction, metric)
    return IcpResult(T=out.T, error=out.err, iters=out.k, correspondences=out.idx)


@partial(jax.jit, static_argnames=("epsilon", "max_iters", "stopping_thresh",
                                   "normalize_error", "planar", "nn_backend",
                                   "trim_fraction", "metric"))
def resume_icp_batch(
    src, tgt, src_mask, tgt_mask, carry: IcpCarry,
    epsilon: float = 0.01,
    max_iters: int = 2000,
    stopping_thresh: float = 1e-4,
    normalize_error: bool = False,
    planar: bool = False,
    nn_backend: str = "jnp",
    trim_fraction: float = 1.0,
    metric: str = "point",
) -> IcpResult:
    """Continue a batch of pairs from a mid-run IcpCarry to convergence.

    The iterate sequence of each pair is identical to running
    run_icp_batch start-to-finish; resuming only changes the SCHEDULE
    (which pairs share a while_loop), never the math."""
    out = _icp_while(src, tgt, src_mask, tgt_mask, carry,
                     epsilon, max_iters, stopping_thresh, normalize_error,
                     planar, nn_backend, trim_fraction, metric)
    return IcpResult(T=out.T, error=out.err, iters=out.k,
                     correspondences=out.idx)


def icp_step_batch(
    src, tgt, src_mask, tgt_mask, carry: IcpCarry,
    epsilon: float, max_iters: int, stopping_thresh: float,
    normalize_error: bool, planar: bool, nn_backend: str,
    trim_fraction: float = 1.0,
    metric: str = "point",
) -> IcpCarry:
    """Exactly ONE iteration of the batched ICP loop (the body of
    _icp_while), for two-phase schedules that sort pairs by difficulty
    after the first iteration. Bit-identical to one while_loop pass."""
    return _icp_body(src, tgt, src_mask, tgt_mask, carry,
                     epsilon, max_iters, stopping_thresh, normalize_error,
                     planar, nn_backend, trim_fraction, metric)


def lift_to_3d(pts: jnp.ndarray) -> jnp.ndarray:
    """Append z = 0 to 2-D points (reference: modules/icp.py:153-156)."""
    if pts.shape[-1] == 2:
        return jnp.concatenate([pts, jnp.zeros(pts.shape[:-1] + (1,), pts.dtype)],
                               axis=-1)
    return pts


def run_icp(
    pc1: jnp.ndarray,
    pc2: jnp.ndarray,
    init_transform: jnp.ndarray | None = None,
    epsilon: float = 0.01,
    max_iters: int = 2000,
    stopping_thresh: float = 1e-4,
    normalize_error: bool = False,
    pc1_mask: jnp.ndarray | None = None,
    pc2_mask: jnp.ndarray | None = None,
    planar: bool | None = None,
) -> IcpResult:
    """Single-pair convenience wrapper mirroring the reference entry point
    (reference: modules/icp.py:123-189). 2-D inputs are lifted to z = 0 and
    automatically use the closed-form planar solver."""
    pc1 = jnp.asarray(pc1)
    if planar is None:
        planar = pc1.shape[-1] == 2
    pc1 = lift_to_3d(pc1)
    pc2 = lift_to_3d(jnp.asarray(pc2))
    if init_transform is None:
        init_transform = jnp.eye(4, dtype=pc1.dtype)
    if pc1_mask is None:
        pc1_mask = jnp.ones(pc1.shape[:-1], bool)
    if pc2_mask is None:
        pc2_mask = jnp.ones(pc2.shape[:-1], bool)
    res = run_icp_batch(
        pc1[None], pc2[None], pc1_mask[None], pc2_mask[None],
        jnp.asarray(init_transform)[None],
        epsilon=epsilon, max_iters=max_iters,
        stopping_thresh=stopping_thresh, normalize_error=normalize_error,
        planar=planar)
    return IcpResult(T=res.T[0], error=res.error[0], iters=res.iters[0],
                     correspondences=res.correspondences[0])
