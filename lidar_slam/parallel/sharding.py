"""Sharded execution of the SLAM hot paths over a device mesh.

Design (new surface — the reference is single-threaded, SURVEY.md section 5):

  - ICP batches shard over "dp": every pair is independent, so pjit with a
    batch sharding partitions the whole while_loop body (NN distance
    matrices, Kabsch SVDs) with zero communication except the loop-condition
    `any(~done)` reduction, which XLA lowers to a cheap all-reduce over the interconnect (NVLink on a GPU host).
  - Map building shards RAYS over the mesh inside shard_map: each device
    scatter-adds its ray shard's +/-log4 contributions into a local grid
    delta, a psum combines deltas across devices, and the (replicated) carry grid
    applies the reference's per-scan clip. This is exact — identical to the
    sequential reference semantics, because within-scan contributions are a
    pure sum.
  - The pose-graph LM shards the FACTOR axis (sharded_optimize_trajectory
    -> models/pose_graph.optimize_sharded): poses replicate, each device
    linearizes its shard of between + loop factors and scatters into a
    local gradient + super-block banded Hessian, one fused psum per LM
    iteration combines them, and the SPIKE solve + damping control flow
    run replicated. The per-iteration cost is dominated by the batched
    linearization (PERF.md pose-graph floor), which divides by D.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import MapConfig
from ..models.occupancy import _compact_scan_update
from ..models.texture import frames_to_cells
from ..ops.icp import run_icp_batch


def sharded_icp_batch(mesh: Mesh, axis: str = "dp"):
    """Return a jitted run_icp_batch whose pair batch is sharded over `axis`.

    Pad the batch to a multiple of the axis size before calling."""
    batch_sh = NamedSharding(mesh, P(axis))
    t_sh = NamedSharding(mesh, P(axis))

    def fn(src, tgt, src_mask, tgt_mask, init_T, **kw):
        src = jax.device_put(src, batch_sh)
        tgt = jax.device_put(tgt, batch_sh)
        src_mask = jax.device_put(src_mask, batch_sh)
        tgt_mask = jax.device_put(tgt_mask, batch_sh)
        init_T = jax.device_put(init_T, t_sh)
        return run_icp_batch(src, tgt, src_mask, tgt_mask, init_T, **kw)

    return fn


def sharded_build_logodds(mesh: Mesh, cfg: MapConfig, K: int,
                          axis: str = "dp"):
    """Return a jitted map builder sharding RAYS over `axis`.

    poses (N, 3) replicated; points (N, R, 2) and masks (N, R) sharded on R.
    R must be a multiple of the axis size (pad rays with mask=False).
    Each device runs the single-chip pipeline's compacted scatter on its
    ray shard. Exactness: within a scan the contributions are a pure sum,
    so psum-of-deltas + carry clip reproduces the sequential reference
    semantics (modules/ogm.py:149-188) on any mesh.
    """

    @jax.jit
    def build(poses, points, masks):
        def shard_fn(poses_l, points_l, masks_l):
            def step(grid, inp):
                pose, pts, m = inp
                zeros = jax.lax.pcast(
                    jnp.zeros((cfg.width, cfg.height), jnp.float32),
                    axis, to="varying")
                delta = _compact_scan_update(zeros, pose, pts, m, cfg, K)
                delta = jax.lax.psum(delta, axis)
                grid = jnp.clip(grid + delta, -cfg.logodds_clip,
                                cfg.logodds_clip)
                return grid, None

            init = jnp.zeros((cfg.width, cfg.height), jnp.float32)
            grid, _ = jax.lax.scan(step, init, (poses_l, points_l, masks_l))
            return grid

        return jax.shard_map(
            shard_fn, mesh=mesh,
            in_specs=(P(), P(None, axis, None), P(None, axis)),
            out_specs=P(),
        )(poses, points, masks)

    return build


def sharded_build_logodds_scans(mesh: Mesh, cfg: MapConfig, K: int,
                                axis: str = "dp"):
    """Return a jitted map builder sharding SCANS (the long axis) over `axis`.

    The per-scan clipped update v -> clamp(v + delta_t, +/-clip) is a
    clamp-affine function of the carried grid, and clamp-affine slope-1
    functions compose associatively (ops/clamp_affine.py) — so the
    sequential-in-time reference semantics (modules/ogm.py:149-188) admits
    scan parallelism: device d walks its CONTIGUOUS block of N/D scans
    locally, composing (a, lo, hi) grids; blocks merge with log2(D)
    elementwise composes after one all_gather. Compare the ray-sharded
    builder (sharded_build_logodds): that path keeps the sequential scan
    over all N scans on every device and psums a full (W, H) grid PER SCAN
    — N dependent collectives and N x grid_bytes of interconnect traffic vs ONE
    gather of 3 grids here, and each device walks only N/D scans instead
    of N scans at R/D rays (the walk's per-scan fixed costs don't shrink
    with ray count, so scan sharding is the one that actually divides the
    map wall by D).

    poses (N, 3), points (N, R, 2), masks (N, R), all sharded on scan axis
    0; N must be a multiple of the axis size — pad with mask=False scans
    (an all-masked scan contributes the identity function). Exactness: the
    per-scan deltas come from the SAME engine as the single-chip build;
    the composed result is bit-identical to sequential wherever the
    running cell value never saturates at +/-clip and within a few ULPs at
    saturated cells (analysis in ops/clamp_affine.py).
    """
    from ..ops import clamp_affine as ca

    n_dev = mesh.shape[axis]

    @jax.jit
    def build(poses, points, masks, init=None):
        c = cfg.logodds_clip

        def shard_fn(poses_l, points_l, masks_l):
            def step(f, inp):
                pose, pts, m = inp
                zeros = jax.lax.pcast(
                    jnp.zeros((cfg.width, cfg.height), jnp.float32),
                    axis, to="varying")
                delta = _compact_scan_update(zeros, pose, pts, m, cfg, K)
                return ca.update(f, delta, c), None

            # under vma checking the carry must be varying like the deltas
            f0 = jax.tree.map(
                lambda x: jax.lax.pcast(x, axis, to="varying"),
                ca.identity((cfg.width, cfg.height), c))
            f, _ = jax.lax.scan(step, f0, (poses_l, points_l, masks_l))
            # stack a leading device axis for the P(axis) output
            return jax.tree.map(lambda x: x[None], f)

        fs = jax.shard_map(
            shard_fn, mesh=mesh,
            in_specs=(P(axis), P(axis, None, None), P(axis, None)),
            out_specs=ca.ClampAffine(P(axis), P(axis), P(axis)),
        )(poses, points, masks)

        # merge blocks in scan order: F = f_{D-1} o ... o f_0, log2(D) depth
        total = ca.compose_tree(
            [jax.tree.map(lambda x: x[d], fs) for d in range(n_dev)])
        v0 = (jnp.zeros((cfg.width, cfg.height), jnp.float32)
              if init is None else init)
        return ca.apply(total, v0)

    return build


def sharded_texture_paint(mesh: Mesh, map_cfg: MapConfig, cam_cfg,
                          axis: str = "dp"):
    """Return a jitted texture painter sharding FRAMES over `axis`.

    The texture stage is the remaining embarrassingly-parallel hot path
    (models/texture.py): painting is a scatter-max of GLOBAL point sequence
    numbers (last-writer-wins, reference modules/texture_mapping.py:96), and
    sequence numbers are unique — so per-device local paints combine exactly
    with one pmax (the winner) plus one psum that selects the single
    device holding each cell's winning color. Exact on any mesh.

    Returned fn(winner, cell_color, disp, rgb, poses, frame_mask, base):
      winner (W*H,) int32 / cell_color (W*H,) int32 — replicated carry from
      earlier batches (init: -1 / 0); disp (B, H, W) float32|uint16,
      rgb (B, H, W, 3) uint8, poses (B, 3), frame_mask (B,) bool (False =
      padding frame, contributes nothing — B must be a multiple of the axis
      size); base = global point index of frame 0 (frame-major, b*H*W per
      processed batch, matching models/texture.generate_texture_map).
    """
    n_dev = mesh.shape[axis]

    @jax.jit
    def paint(winner, cell_color, disp, rgb, poses, frame_mask, base):
        hw = disp.shape[1] * disp.shape[2]
        b_local = disp.shape[0] // n_dev

        def shard_fn(disp_l, rgb_l, poses_l, fmask_l):
            lin, colors, _ = frames_to_cells(disp_l, rgb_l, poses_l,
                                             map_cfg, cam_cfg)
            # padding frames contribute nothing
            fm = jnp.repeat(fmask_l, hw)
            lin = jnp.where(fm, lin, -1)
            base_l = base + jax.lax.axis_index(axis) * (b_local * hw)
            seq = base_l + jnp.arange(lin.shape[0], dtype=jnp.int32)
            upd = jnp.where(lin >= 0, seq, -1)
            safe = jnp.where(lin >= 0, lin, 0)
            # NB: build from the STATIC cell count, not full_like(winner):
            # closing over the outer jit's sharded array inside shard_map
            # trips the mesh-context check (Auto vs Manual)
            local_w = jnp.full((map_cfg.width * map_cfg.height,), -1,
                               jnp.int32).at[safe].max(upd)
            local_c = jnp.where(
                local_w >= 0,
                jnp.take(colors, jnp.clip(local_w - base_l, 0,
                                          colors.shape[0] - 1)),
                0)
            # cross-device combine: unique seq numbers => exactly one
            # device matches the pmax wherever it is >= 0
            wmax = jax.lax.pmax(local_w, axis)
            sel = (local_w == wmax) & (wmax >= 0)
            cmax = jax.lax.psum(jnp.where(sel, local_c, 0), axis)
            return wmax, cmax

        wmax, cmax = jax.shard_map(
            shard_fn, mesh=mesh,
            in_specs=(P(axis), P(axis), P(axis), P(axis)),
            out_specs=(P(), P()),
        )(disp, rgb, poses, frame_mask)

        winner_new = jnp.maximum(winner, wmax)
        cell_color = jnp.where(winner_new > winner, cmax, cell_color)
        return winner_new, cell_color

    return paint


def sharded_paint_ops(mesh: Mesh, map_cfg: MapConfig, axis: str = "dp"):
    """Return a jitted painter sharding a PAINT-OP stream over `axis`.

    Multi-chip half of the texture stage's paint-op engine (the native
    host projector, models/texture.py projector="native"): the host emits
    per-frame last-writer-wins (cell, color) ops; here the op stream
    splits across devices, each scatter-maxes its slice locally, and the
    slices combine exactly with the same pmax-winner / psum-color-select
    as sharded_texture_paint (sequence numbers are globally unique, so
    exactly one device holds each cell's winning color).

    Returned fn(winner, cell_color, ops, base): winner/cell_color (W*H,)
    int32 replicated carries; ops (2, PAD) int32 (row 0 cells with -1
    padding, row 1 colors; PAD must be a multiple of the axis size, in
    frame order so later ops win); base = global sequence number of op 0.
    """
    n_dev = mesh.shape[axis]
    ncells = map_cfg.width * map_cfg.height

    @jax.jit
    def paint(winner, cell_color, ops, base):
        if ops.shape[1] % n_dev:
            raise ValueError(f"op stream length {ops.shape[1]} is not "
                             f"divisible by the {n_dev}-way '{axis}' axis")
        pad_local = ops.shape[1] // n_dev

        def shard_fn(ops_l):
            lin, colors = ops_l[0], ops_l[1]
            base_l = base + jax.lax.axis_index(axis) * pad_local
            seq = base_l + jnp.arange(pad_local, dtype=jnp.int32)
            upd = jnp.where(lin >= 0, seq, -1)
            safe = jnp.where(lin >= 0, lin, 0)
            local_w = jnp.full((ncells,), -1, jnp.int32).at[safe].max(upd)
            local_c = jnp.where(
                local_w >= 0,
                jnp.take(colors, jnp.clip(local_w - base_l, 0,
                                          pad_local - 1)),
                0)
            wmax = jax.lax.pmax(local_w, axis)
            sel = (local_w == wmax) & (wmax >= 0)
            cmax = jax.lax.psum(jnp.where(sel, local_c, 0), axis)
            return wmax, cmax

        wmax, cmax = jax.shard_map(
            shard_fn, mesh=mesh,
            in_specs=(P(None, axis),),
            out_specs=(P(), P()),
        )(ops)
        winner_new = jnp.maximum(winner, wmax)
        cell_color = jnp.where(winner_new > winner, cmax, cell_color)
        return winner_new, cell_color

    return paint


def sharded_reloc_score(mesh: Mesh, axis: str = "dp"):
    """Return a node-sharded scoring kernel for global relocalization
    (signature of relocalization._score_nodes: (pool, base_i, base_j,
    rmask, ai, oi, oj, live, leaf=, chunk=) -> (n,) scores).

    Relocalization's cost is the node scoring — every candidate (yaw,
    translation-block) is independent (models/relocalization.py), so each
    device scores its n/D node block against the replicated pyramid level
    and scan cells, and the gathered (n,) vector feeds the replicated
    top-k beam. Per-node row sums are computed identically to the
    single-device kernel, so the whole search (pose, score, certificate)
    is BIT-IDENTICAL — pinned by tests/test_parallel.py on the 8-device
    CPU mesh. Nodes are padded (live=False) to a multiple of the axis
    size here; pass the result as `score_fn` to relocalization.relocalize.
    """
    from ..models.relocalization import _score_nodes

    D = int(mesh.shape[axis])
    rep = NamedSharding(mesh, P())

    def score(pool, base_i, base_j, rmask, ai, oi, oj, live, leaf, chunk):
        n = ai.shape[0]
        pad = (-n) % D
        ai_p = jnp.pad(ai, (0, pad))
        oi_p = jnp.pad(oi, (0, pad))
        oj_p = jnp.pad(oj, (0, pad))
        live_p = jnp.pad(live, (0, pad))
        shard_chunk = min(chunk, max(1, (n + pad) // D))

        def shard_fn(pool_r, bi_r, bj_r, rm_r, ai_l, oi_l, oj_l, live_l):
            return _score_nodes(pool_r, bi_r, bj_r, rm_r,
                                ai_l, oi_l, oj_l, live_l,
                                leaf=leaf, chunk=shard_chunk)

        out = jax.shard_map(
            shard_fn, mesh=mesh,
            in_specs=(P(), P(), P(), P(), P(axis), P(axis), P(axis), P(axis)),
            out_specs=P(axis),
        )(pool, base_i, base_j, rmask, ai_p, oi_p, oj_p, live_p)
        # replicate: the top-k beam runs the same full-(n,) program on
        # every device, exactly as single-chip
        return jax.lax.with_sharding_constraint(out, rep)[:n]

    return score


def sharded_pf_score(mesh: Mesh, map_cfg: MapConfig, axis: str = "dp"):
    """Return a particle-sharded scoring kernel for the particle-filter
    models (signature of particle_filter._score_particles minus map_cfg:
    (particles (P, 3), pts (R, 2), mask (R,), im (W, H)) -> (P,) scores).

    The (P, R) map-correlation scoring is the filter's only super-O(P)
    work (models/particle_filter.py), so the multi-chip strategy shards
    exactly that: each device scores its P/D particle block against the
    replicated scan and map (scores are per-particle row sums — no
    cross-particle math), and one all_gather replicates the (P,) result.
    Every other per-step op (weights, logsumexp, estimate, resample) is
    O(P) scalar work that stays replicated, which makes the sharded filter
    BIT-IDENTICAL to the single-device one — pinned by
    tests/test_parallel.py on the 8-device CPU mesh.

    P must be a multiple of the axis size. Pass the result as `score_fn`
    to pf_step / localize_particle_filter / pf_slam_step /
    slam_particle_filter.
    """
    from ..models.particle_filter import _score_particles

    rep = NamedSharding(mesh, P())

    def score(particles, pts, mask, im):
        def shard_fn(particles_l, pts_r, mask_r, im_r):
            return _score_particles(particles_l, pts_r, mask_r, im_r,
                                    map_cfg)

        out = jax.shard_map(
            shard_fn, mesh=mesh,
            in_specs=(P(axis), P(), P(), P()),
            out_specs=P(axis),
        )(particles, pts, mask, im)
        # replicate: downstream weight/estimate/resample math runs the
        # same full-(P,) program on every device, exactly as single-chip
        return jax.lax.with_sharding_constraint(out, rep)

    return score


def sharded_optimize_trajectory(mesh: Mesh, cfg=None, axis: str = "dp"):
    """Return a jitted pose-graph optimizer sharding the FACTOR axis.

    Signature matches models/pose_graph.optimize_trajectory:
    (poses0 (N, 3), relative_poses (N-1, 3, 3), loop_i, loop_j, loop_meas,
    loop_mask) -> LMResult. Poses replicate across the mesh; each device
    linearizes its contiguous shard of between + loop factors and the
    assembled banded Hessian + gradient combine with one fused psum per
    LM iteration (models/pose_graph.optimize_sharded has the design and
    exactness notes). BANDED fixed-interval graphs only — the pipeline's
    graph shape (reference: main.py:158-161).
    """
    import numpy as np

    from ..config import PoseGraphConfig
    from ..models import pose_graph as pg

    if cfg is None:
        cfg = PoseGraphConfig()

    @jax.jit
    def _run_jit(poses0, relative_poses, loop_i, loop_j, loop_meas,
                 loop_mask):
        graph = pg.make_graph(relative_poses, cfg, loop_i=loop_i,
                              loop_j=loop_j, loop_meas=loop_meas,
                              loop_mask=loop_mask)
        return pg.optimize_sharded(
            poses0, graph, mesh, axis=axis, max_iters=cfg.max_lm_iters,
            lambda_init=cfg.lambda_init, lambda_up=cfg.lambda_up,
            lambda_down=cfg.lambda_down, cost_rtol=cfg.cost_rtol,
            band=cfg.fixed_interval,
            robust=getattr(cfg, "robust_loss", "none"),
            robust_delta=getattr(cfg, "robust_delta", 1.0))

    def run(poses0, relative_poses, loop_i, loop_j, loop_meas, loop_mask):
        # the banded-only span guard must run HERE, on concrete values:
        # inside the jit the indices are tracers and optimize_sharded's
        # own guard is skipped, so without this check wide/reversed arcs
        # would silently drop their Hessian coupling blocks
        band = cfg.fixed_interval
        live = np.asarray(loop_mask).astype(bool)
        if live.any():
            span = (np.asarray(loop_j) - np.asarray(loop_i))[live]
            if int(span.max()) > band or int(span.min()) < 0:
                raise ValueError(
                    f"sharded_optimize_trajectory is banded-only: loop "
                    f"spans must lie in [0, band={band}], got "
                    f"[{int(span.min())}, {int(span.max())}] — use the "
                    "single-device solver='direct' path for wide or "
                    "reversed arcs")
        return _run_jit(poses0, relative_poses, loop_i, loop_j, loop_meas,
                        loop_mask)

    return run


def pad_batch(x: jnp.ndarray, multiple: int, axis: int = 0,
              pad_value=0) -> Tuple[jnp.ndarray, int]:
    """Pad `axis` up to a multiple; returns (padded, pad_count)."""
    n = x.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return x, 0
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x, widths, constant_values=pad_value), pad
