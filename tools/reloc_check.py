"""Validation + timing harness for global relocalization.

Builds a dataset-scale synthetic world map, "kidnaps" the robot at a set
of steps (no prior: search center = map origin, full 2-pi yaw span), and
reports per-step grid/refined pose error, certificate status, and wall
time for the search and the ICP polish.

Usage: python tools/reloc_check.py [--full] [n_steps] [n_kidnaps]
Runs on the default device. The default is a small search (0.1 m map,
72 headings); --full runs the dataset-scale window (0.05 m map, 360
headings).
"""
import sys
import time

import numpy as np
import jax.numpy as jnp

sys.path.insert(0, ".")
from lidar_slam.config import LidarConfig, MapConfig
from lidar_slam.models import occupancy, relocalization as rl
from lidar_slam.ops import scan as scan_ops
from lidar_slam.utils import io


def main():
    full = "--full" in sys.argv
    if full:
        sys.argv.remove("--full")
    from lidar_slam.utils.runtime import report_devices, use_compile_cache
    use_compile_cache()
    report_devices()
    n_steps = int(sys.argv[1]) if len(sys.argv) > 1 else 600
    n_kid = int(sys.argv[2]) if len(sys.argv) > 2 else 4

    ds = io.synthetic_dataset(n_steps=n_steps, n_rays=1081, seed=11)
    gt = np.asarray(ds["ground_truth"])
    pts, mask = scan_ops.scans_to_points(
        jnp.asarray(ds["lidar"]["ranges"]), 0.1, 30.0, LidarConfig())
    half = max(16.0, float(np.abs(gt[:, :2]).max()) + 12.0)
    mcfg = MapConfig(world_max_x=half, world_min_x=-half,
                     world_max_y=half, world_min_y=-half,
                     resolution=0.05 if full else 0.1)
    K = occupancy.max_ray_cells(mcfg, 30.0)
    t0 = time.time()
    lo = occupancy.build_logodds(jnp.asarray(gt), pts, mask, mcfg, K)
    np.asarray(lo)
    print(f"map {mcfg.width}x{mcfg.height} built from {n_steps} scans "
          f"in {time.time() - t0:.2f}s")

    # Kidnapped: full-map window, any heading.
    cfg = rl.RelocConfig(
        n_angles=360 if full else 72,
        search_radius=half - 10.0,
        n_levels=6 if full else 4,
        beam=2048 if full else 512,
        max_rays=256 if full else 128)
    ks = np.linspace(n_steps // 8, n_steps - 1, n_kid).astype(int)
    errs = []
    for rep, k in enumerate(ks):
        t0 = time.time()
        grid_res, refined, icp_err = rl.relocalize_refined(
            lo, mcfg, pts[k], mask[k], cfg, center=(0.0, 0.0))
        r = np.asarray(refined)
        dt = time.time() - t0
        d_xy = float(np.hypot(r[0] - gt[k, 0], r[1] - gt[k, 1]))
        d_th = float(abs((r[2] - gt[k, 2] + np.pi) % (2 * np.pi) - np.pi))
        errs.append((d_xy, d_th))
        g = np.asarray(grid_res.pose)
        gd = float(np.hypot(g[0] - gt[k, 0], g[1] - gt[k, 1]))
        tag = "warm" if rep else "cold"
        print(f"k={k:5d} grid d_xy={gd:.3f}m certified={bool(grid_res.certified)} "
              f"margin={float(grid_res.pruned_margin):.1f} | refined "
              f"d_xy={d_xy * 100:.1f}cm d_th={np.degrees(d_th):.2f}deg "
              f"icp_err={float(icp_err):.2e} | {dt:.2f}s ({tag})")
    e = np.asarray(errs)
    print(f"mean refined error: {e[:, 0].mean() * 100:.1f} cm, "
          f"{np.degrees(e[:, 1].mean()):.2f} deg over {len(ks)} kidnaps")


if __name__ == "__main__":
    main()
