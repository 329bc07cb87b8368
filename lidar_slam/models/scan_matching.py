"""Scan matching: ICP-refined odometry over all consecutive scan pairs.

Capability parity with the reference scan-matching stage
(reference: modules/localization.py:95-134), redesigned for XLA. The
reference runs ~5k sequential ICPs in a Python loop; but each pair's ICP is
seeded from the ODOMETRY relative pose, not from the refined chain
(localization.py:116-118), so every pair is independent — the whole stage is

  1. one batched ICP over all consecutive pairs (chunked to bound the
     B x P x P correspondence working set), then
  2. one associative-scan prefix composition of the refined relative
     SE(2) transforms (O(log N) depth).

This batching is exact, not an approximation — see SURVEY.md section 7.6.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import IcpConfig
from ..ops import icp as icp_ops
from ..utils import se2


class ScanMatchResult(NamedTuple):
    poses: jnp.ndarray  # (N, 3) refined trajectory
    relative_poses: jnp.ndarray  # (N-1, 3, 3) refined relative SE(2)
    errors: jnp.ndarray  # (N-1,) final ICP errors
    iters: jnp.ndarray  # (N-1,) ICP iterations per pair


def icp_all_pairs(
    src: jnp.ndarray,
    tgt: jnp.ndarray,
    src_mask: jnp.ndarray,
    tgt_mask: jnp.ndarray,
    init_T: jnp.ndarray,
    epsilon: float = 0.001,
    max_iters: int = 2000,
    stopping_thresh: float = 1e-4,
    normalize_error: bool = False,
    chunk_size: int = 64,
    planar: bool = True,
    nn_backend: str = "jnp",
    schedule: str = "phased",
    partition: str = "cumsum",
    trim_fraction: float = 1.0,
    metric: str = "point",
    carry_idx: bool = False,
):
    """Batched ICP over B pairs, processed in fixed-size chunks.

    Chunking bounds device memory (each chunk's correspondence search is a
    C x P x P distance problem) and limits convergence coupling (a chunk
    iterates until its slowest pair converges). Inputs are padded to a whole
    number of chunks; padding pairs run with a single valid point and
    converge immediately.

    schedule="phased" (default): every outer phase runs ONE iteration for
    every still-live pair, then re-compacts live pairs to the front (stable
    sort on the done flag) before the next phase; chunks whose pairs are
    all done cost one predicate. This executes ceil(live_t / C) chunk
    iterations at every iteration depth t — the optimum for any
    chunk-granular schedule, with no difficulty predictor. (A single
    up-front sort by post-first-iteration error was measured USELESS at
    dataset-20 scale: 612 executed chunk-iterations vs 608 unsorted vs 338
    ideal — error does not predict iterations-to-converge. Phased executes
    ~350.) The schedule changes only which pairs share a dispatch; every
    pair's iterate sequence (and the returned T/error/iteration count) is
    identical to schedule="chunked".

    partition selects how the phased schedule computes the live-first
    permutation: "cumsum" (default; 2-pass stable partition via two
    cumulative sums + one scatter) or "argsort" (stable sort on the done
    flag — XLA lowers it to a ~log^2 n bitonic network over ~5k keys per
    phase). Both build the IDENTICAL permutation (live pairs in original
    order, then dead; CPU-equality-tested), so iterate sequences and
    results are bit-identical; on the H100 the two are not yet timed.
    """
    B, P = src.shape[0], src.shape[1]
    C = min(chunk_size, B)
    n_chunks = -(-B // C)
    pad = n_chunks * C - B

    def pad0(x):
        widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, widths)

    if pad:
        src_p, tgt_p = pad0(src), pad0(tgt)
        src_mask_p, tgt_mask_p = pad0(src_mask), pad0(tgt_mask)
        # padded masks are all-False; give targets one valid point so the
        # argmin is well defined, and sources none so the error is 0 < eps
        tgt_mask_p = tgt_mask_p.at[B:, 0].set(True)
        init_p = jnp.concatenate(
            [init_T, jnp.tile(jnp.eye(4, dtype=init_T.dtype), (pad, 1, 1))], axis=0)
    else:
        src_p, tgt_p, src_mask_p, tgt_mask_p, init_p = src, tgt, src_mask, tgt_mask, init_T

    kwargs = dict(epsilon=epsilon, max_iters=max_iters,
                  stopping_thresh=stopping_thresh,
                  normalize_error=normalize_error,
                  planar=planar, nn_backend=nn_backend,
                  trim_fraction=trim_fraction, metric=metric)

    def resh(x):
        return x.reshape((n_chunks, C) + x.shape[1:])

    if schedule == "chunked":
        def chunk(args):
            s, t, sm, tm, i0 = args
            res = icp_ops.run_icp_batch(s, t, sm, tm, i0, **kwargs)
            return res.T, res.error, res.iters

        # one dispatch for all chunks: lax.map runs them sequentially on
        # device (each chunk's while_loop to its own convergence), avoiding
        # ~n_chunks host->device dispatch latencies
        T, errs, its = jax.lax.map(chunk, (resh(src_p), resh(tgt_p),
                                           resh(src_mask_p), resh(tgt_mask_p),
                                           resh(init_p)))
        return (T.reshape((-1, 4, 4))[:B], errs.reshape(-1)[:B],
                its.reshape(-1)[:B])

    # --- phased-resort schedule ---
    tmap = jax.tree_util.tree_map
    flat = lambda x: x.reshape((-1,) + x.shape[2:])

    # phase 0: one iteration for every pair (work any schedule must do)
    def phase0(args):
        s, t, sm, tm, i0 = args
        # with_idx=False (default): the phased path never reads
        # correspondences back out of the carry, and idx is its largest
        # field — (B, P) int32 ≈ 22 MB at dataset scale, re-gathered by
        # every phase's live-first permutation and sliced/updated by every
        # chunk step. Dropping it changes no T/err/k value (bit-identity
        # tested vs "chunked"); carry_idx=True keeps it (A/B baseline,
        # tools/sm_bench.py).
        carry = icp_ops.initial_icp_carry(i0, C, P, s.dtype,
                                          with_idx=carry_idx)
        return icp_ops.icp_step_batch(s, t, sm, tm, carry, **kwargs)

    c = tmap(flat, jax.lax.map(
        phase0, (resh(src_p), resh(tgt_p), resh(src_mask_p),
                 resh(tgt_mask_p), resh(init_p))))

    state = (c, jnp.arange(c.done.shape[0]))

    def cond(st):
        return jnp.any(~st[0].done)

    def body(st):
        c, orig = st
        # live pairs to the front (stable sort on the done flag), so live
        # work occupies exactly the first ceil(live / C) chunks and the
        # fori_loop below never touches a dead chunk (the earlier
        # map-with-cond visited all n_chunks, paying a predicate + branch
        # for each dead one — ~1,400 dead-chunk visits at dataset scale)
        if partition == "cumsum":
            live = ~c.done
            n_live = jnp.sum(live)
            pos = jnp.where(live, jnp.cumsum(live) - 1,
                            n_live + jnp.cumsum(c.done) - 1)
            order = jnp.zeros_like(pos).at[pos].set(
                jnp.arange(pos.shape[0]))
        else:
            order = jnp.argsort(c.done, stable=True)
        c = tmap(lambda x: x[order], c)
        orig = orig[order]
        n_live_chunks = (jnp.sum(~c.done) + C - 1) // C

        def chunk_body(i, cc):
            # only the carry and the original-pair indices travel through
            # the resort; live chunks gather their (C, P, ...) point
            # slices here, so a phase moves O(live-chunks x C x P) point
            # bytes instead of re-permuting the full padded arrays
            # (~100 MB/phase at dataset scale)
            off = i * C
            oidx = jax.lax.dynamic_slice_in_dim(orig, off, C)
            cchunk = tmap(
                lambda x: jax.lax.dynamic_slice_in_dim(x, off, C), cc)
            new = icp_ops.icp_step_batch(src_p[oidx], tgt_p[oidx],
                                         src_mask_p[oidx], tgt_mask_p[oidx],
                                         cchunk, **kwargs)
            return tmap(
                lambda full, nw: jax.lax.dynamic_update_slice_in_dim(
                    full, nw, off, 0), cc, new)

        c = jax.lax.fori_loop(0, n_live_chunks, chunk_body, c)
        return (c, orig)

    c, orig = jax.lax.while_loop(cond, body, state)
    inv = jnp.argsort(orig)
    return c.T[inv][:B], c.err[inv][:B], c.k[inv][:B]


@partial(jax.jit, static_argnames=("cfg", "chunk_size", "partition",
                                   "carry_idx"))
def poses_from_scan_matching(
    x_ts: jnp.ndarray,
    points: jnp.ndarray,
    masks: jnp.ndarray,
    cfg: IcpConfig = IcpConfig(),
    chunk_size: int = 64,
    partition: str = "cumsum",
    carry_idx: bool = False,
) -> ScanMatchResult:
    """Refine an odometry trajectory with batched consecutive-pair ICP.

    x_ts (N, 3) odometry poses; points (N, P, 2) robot-frame scan points;
    masks (N, P) ray validity. Matches reference semantics
    (modules/localization.py:112-130): pair i aligns scan i to scan i-1,
    seeded with the odometry relative pose lifted to SE(3); refined global
    poses are the prefix composition of the per-pair results starting at the
    origin.
    """
    x_ts = jnp.asarray(x_ts)
    pts3 = icp_ops.lift_to_3d(jnp.asarray(points))
    masks = jnp.asarray(masks)

    seeds2 = se2.get_relative_pose(x_ts[:-1], x_ts[1:])  # (N-1, 3, 3)
    seeds3 = se2.TSE3_from_TSE2(seeds2)

    T_icp, errors, iters = icp_all_pairs(
        pts3[1:], pts3[:-1], masks[1:], masks[:-1], seeds3,
        epsilon=cfg.epsilon, max_iters=cfg.max_iters,
        stopping_thresh=cfg.stopping_thresh,
        normalize_error=cfg.normalize_error, chunk_size=chunk_size,
        planar=True, partition=partition, metric=cfg.metric,
        carry_idx=carry_idx)

    rel2 = se2.TSE2_from_TSE3(T_icp)  # (N-1, 3, 3)
    chain = se2.compose_chain(rel2)  # (N, 3, 3)
    poses = se2.pose_from_T(chain)
    return ScanMatchResult(poses=poses, relative_poses=rel2,
                           errors=errors, iters=iters)
