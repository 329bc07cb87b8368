"""Measured multi-device scaling of the sharded map builders.

Times sharded_build_logodds (ray-sharded, psum per scan) AND
sharded_build_logodds_scans (scan-parallel, clamp-affine composition) on
1/2/4/8 virtual CPU devices.

CAVEAT on interpretation: the virtual devices timeshare ONE physical CPU
core, so wall-clock here measures the sharding overhead (collectives,
partitioned program), not real-chip speedup. The quantities that transfer
to real chips are reported per row: per-device work (scattered slots for
the ray split; SCANS WALKED for the scan split — the scan's cost unit)
and the collective budget (the ray split moves one full grid per scan
across devices; the scan split gathers 3 grids once).

    python tools/multichip_scaling.py [n_steps]
"""

import os
import sys
import time

import numpy as np

# must run before the backend initializes
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lidar_slam.config import MapConfig  # noqa: E402
from lidar_slam.models import occupancy  # noqa: E402
from lidar_slam.parallel import mesh as mesh_lib  # noqa: E402
from lidar_slam.parallel import sharding  # noqa: E402


def log(m):
    print(m, file=sys.stderr, flush=True)


def main():
    n_steps = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    n_rays = 1080  # divisible by 8
    cfg = MapConfig()
    rng = np.random.default_rng(0)
    ang = rng.uniform(-2.36, 2.36, (n_steps, n_rays))
    r = rng.uniform(0.3, 20.0, (n_steps, n_rays))
    pts = jnp.asarray(np.stack([r * np.cos(ang), r * np.sin(ang)], -1),
                      jnp.float32)
    masks = jnp.asarray(rng.random((n_steps, n_rays)) > 0.02)
    poses = jnp.asarray(
        np.cumsum(rng.normal(0, 0.02, (n_steps, 3)), 0), jnp.float32)
    K = occupancy.adaptive_ray_cells(pts, masks, cfg, 30.0)
    from lidar_slam.utils.runtime import report_devices, use_compile_cache
    use_compile_cache()
    log(f"devices={len(report_devices())} steps={n_steps} rays={n_rays} K={K}")

    ref = None
    same = True
    for n_dev in (1, 2, 4, 8):
        m = mesh_lib.make_mesh(n_dev)
        build = sharding.sharded_build_logodds(m, cfg, K)
        g_check = build(poses, pts, masks)  # identical input every mesh size
        g_check.block_until_ready()
        if ref is None:
            ref = np.asarray(g_check)
        else:
            same &= bool((np.abs(np.asarray(g_check) - ref) < 1e-4).all())
        t0 = time.time()
        g = build(poses + 1e-6 * float(n_dev), pts, masks)
        g.block_until_ready()
        dt = time.time() - t0
        slots_per_dev = n_rays // n_dev * K
        log(f"n_dev={n_dev}: {dt:6.2f}s wall (virtual mesh, 1 core) | "
            f"per-device slots/scan = {slots_per_dev:,} "
            f"({n_rays // n_dev} rays x {K})")
    log(f"ray-sharded maps across mesh sizes agree (atol 1e-4): {same}")

    grid_mb = cfg.width * cfg.height * 4 / 1e6
    log("--- scan-parallel (clamp-affine composition) ---")
    same = True
    for n_dev in (1, 2, 4, 8):
        m = mesh_lib.make_mesh(n_dev)
        build = sharding.sharded_build_logodds_scans(m, cfg, K)
        g_check = build(poses, pts, masks)
        g_check.block_until_ready()
        same &= bool((np.abs(np.asarray(g_check) - ref) < 1e-4).all())
        t0 = time.time()
        g = build(poses + 1e-6 * float(n_dev), pts, masks)
        g.block_until_ready()
        dt = time.time() - t0
        log(f"n_dev={n_dev}: {dt:6.2f}s wall (virtual mesh, 1 core) | "
            f"per-device scans walked = {n_steps // n_dev} (of {n_steps}) | "
            f"interconnect: 1 gather of {3 * n_dev * grid_mb:.0f} MB total "
            f"(ray split: {n_steps} psums = {n_steps * grid_mb:,.0f} MB)")
    log(f"scan-parallel maps match the ray-sharded reference "
        f"(atol 1e-4): {same}")

    # --- factor-sharded pose-graph LM (pose_graph.optimize_sharded) ---
    # Same caveat as above: wall-clock on the timeshared mesh measures the
    # sharding OVERHEAD trend (one fused psum of ~(n_sup, 30, 30) x 2 +
    # (n, 3) per LM iteration), not speedup. The column that transfers is
    # per-device factors linearized.
    from lidar_slam.models import pose_graph as pg
    from lidar_slam.utils import se2

    log("--- factor-sharded pose-graph LM ---")
    T_abs = se2.T_from_pose(poses)
    rel = jnp.einsum("nij,njk->nik", se2.inverse_T(T_abs[:-1]), T_abs[1:])
    li = jnp.arange(0, n_steps - 10, 10, dtype=jnp.int32)
    lj = li + 10
    lmeas = jnp.einsum("nij,njk->nik", se2.inverse_T(T_abs[li]), T_abs[lj])
    lmask = jnp.ones(li.shape, bool)
    x0 = poses + 0.05 * jnp.asarray(
        rng.normal(0, 1, poses.shape), jnp.float32)
    kw = dict(band=10, max_iters=15, cost_rtol=1e-9)
    ref_pg = pg.optimize(x0, pg.make_graph(rel, loop_i=li, loop_j=lj,
                                           loop_meas=lmeas, loop_mask=lmask),
                         solver="banded", **kw)
    same = True
    n_fact = int(rel.shape[0]) + int(li.shape[0])
    for n_dev in (1, 2, 4, 8):
        m = mesh_lib.make_mesh(n_dev)
        graph = pg.make_graph(rel, loop_i=li, loop_j=lj, loop_meas=lmeas,
                              loop_mask=lmask)
        run = jax.jit(lambda x, g=graph, mm=m: pg.optimize_sharded(
            x, g, mm, **kw))
        got = run(x0)  # compile + equality check on identical input
        got.poses.block_until_ready()
        same &= bool(jnp.abs(got.poses - ref_pg.poses).max() < 1e-4)
        t0 = time.time()
        got = run(x0 + 1e-6 * float(n_dev))
        got.poses.block_until_ready()
        dt = time.time() - t0
        log(f"n_dev={n_dev}: {dt:6.2f}s wall (virtual mesh, 1 core) | "
            f"per-device factors linearized/iter ~ {n_fact // n_dev:,} "
            f"(of {n_fact:,}) | {int(got.iterations)} LM iters")
    log(f"factor-sharded poses match the single-device banded solver "
        f"(atol 1e-4): {same}")


if __name__ == "__main__":
    main()
