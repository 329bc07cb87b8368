"""The fused multi-device SLAM step: the framework's 'training step' analog.

One step consumes a window of scans and produces refined poses + an updated
map — the full compute pattern of the pipeline (batched ICP + pose-graph
Gauss-Newton + log-odds map update) jitted over a 2-D device mesh:

  - axis "dp": scan pairs (ICP batch parallel)
  - axis "rp": rays within each scan (map update parallel, psum-combined)

This is what `__graft_entry__.dryrun_multichip` compiles and executes.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import IcpConfig, MapConfig, PoseGraphConfig
from ..models import pose_graph
from ..models.occupancy import _compact_scan_update as _scan_update
from ..ops.icp import run_icp_batch
from ..utils import se2


class SuperStepOut(NamedTuple):
    poses: jnp.ndarray
    logodds: jnp.ndarray
    icp_errors: jnp.ndarray
    graph_cost: jnp.ndarray


def make_slam_step(mesh: Mesh, map_cfg: MapConfig, K: int,
                   icp_cfg: IcpConfig = IcpConfig(),
                   pg_cfg: PoseGraphConfig = PoseGraphConfig()):
    """Build the jitted multi-device SLAM step.

    Inputs of the returned fn:
      points (N, R, 3): scan window, rays sharded over "rp"
      masks (N, R)
      odom_poses (N, 3): odometry seeds (replicated)
      logodds (W, H): current map (replicated)
    Output: SuperStepOut with refined poses and the updated map. The map
    update is the single-chip pipeline's compacted scatter, run per ray
    shard.
    """
    dp = NamedSharding(mesh, P("dp"))
    rep = NamedSharding(mesh, P())

    def step(points, masks, odom_poses, logodds):
        # ---- batched ICP over consecutive pairs (dp-parallel) ----
        seeds2 = se2.get_relative_pose(odom_poses[:-1], odom_poses[1:])
        seeds3 = se2.TSE3_from_TSE2(seeds2)
        src = jax.lax.with_sharding_constraint(points[1:], dp)
        tgt = jax.lax.with_sharding_constraint(points[:-1], dp)
        res = run_icp_batch(src, tgt, masks[1:], masks[:-1], seeds3,
                            epsilon=icp_cfg.epsilon,
                            max_iters=icp_cfg.max_iters,
                            stopping_thresh=icp_cfg.stopping_thresh,
                            planar=True)
        rel2 = se2.TSE2_from_TSE3(res.T)
        chain = se2.compose_chain(rel2, se2.T_from_pose(odom_poses[0]))
        poses = se2.pose_from_T(chain)

        # ---- pose-graph refinement (replicated; one LM solve) ----
        graph = pose_graph.make_graph(rel2, pg_cfg, prior_pose=odom_poses[0])
        opt = pose_graph.optimize(poses, graph, max_iters=pg_cfg.max_lm_iters,
                                  cg_iters=pg_cfg.cg_iters,
                                  lambda_init=pg_cfg.lambda_init,
                                  lambda_up=pg_cfg.lambda_up,
                                  lambda_down=pg_cfg.lambda_down,
                                  solver=getattr(pg_cfg, "solver", "direct"))
        poses = opt.poses

        # ---- map update (rp-parallel rays, psum-combined, per-scan clip) ----
        def map_shard(poses_l, points_l, masks_l, grid0):
            def scan_step(grid, inp):
                pose, pts, m = inp
                zeros = jax.lax.pcast(jnp.zeros_like(grid), "rp",
                                      to="varying")
                delta = _scan_update(zeros, pose, pts[..., :2], m,
                                     map_cfg, K)
                delta = jax.lax.psum(delta, "rp")
                return jnp.clip(grid + delta, -map_cfg.logodds_clip,
                                map_cfg.logodds_clip), None

            grid, _ = jax.lax.scan(scan_step, grid0,
                                   (poses_l, points_l, masks_l))
            return grid

        grid = jax.shard_map(
            map_shard, mesh=mesh,
            in_specs=(P(), P(None, "rp", None), P(None, "rp"), P()),
            out_specs=P(),
        )(poses, points, masks, logodds)

        return SuperStepOut(poses=poses, logodds=grid,
                            icp_errors=res.error, graph_cost=opt.cost)

    # points/masks enter replicated; the ICP view constrains to "dp" (pair
    # batch) and the map shard_map slices the "rp" (ray) view. Feeding a
    # single non-trivially-sharded input to both consumers would force the
    # SPMD partitioner into an involuntary full rematerialization.
    in_sh = (rep, rep, rep, rep)
    return jax.jit(step, in_shardings=in_sh)
