"""Measure the REFERENCE texture stage on this machine (BASELINE.md row).

Runs the reference's actual generate_texture_map
(reference: modules/texture_mapping.py:7-99 — per-frame host loop of
2x cv2.imread + the numpy unproject/registration/paint chain) over a
fabricated dataRGBD tree of dataset-geometry 480x640 PNGs, and prints
ms/frame plus the dataset-20 extrapolation (2,407 RGB frames — the
length of the Kinect rgb stamp track the loader advertises,
reference: modules/utils.py:95-100).

No JAX involved: this is the 1-CPU-core baseline the repo's device texture
path (models/texture.py, tools/texture_bench.py) is compared against.

Usage: python tools/texture_reference_bench.py [--frames 24]
"""

import argparse
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = "/root/reference"
DATASET20_RGB_FRAMES = 2407


def fabricate_tree(root, n_frames, rng):
    """dataRGBD/{Disparity20,RGB20} PNG trees in the reference's naming
    (reference: modules/texture_mapping.py:54-62)."""
    sys.path.insert(0, REPO)
    from lidar_slam.utils.png import write_png

    ddir = os.path.join(root, "dataRGBD", "Disparity20")
    rdir = os.path.join(root, "dataRGBD", "RGB20")
    os.makedirs(ddir)
    os.makedirs(rdir)
    for k in range(n_frames + 1):
        disp = rng.integers(300, 900, (480, 640)).astype(np.uint16)
        write_png(os.path.join(ddir, f"disparity20_{k}.png"), disp)
    for i in range(1, n_frames + 1):
        rgb = rng.integers(0, 255, (480, 640, 3)).astype(np.uint8)
        write_png(os.path.join(rdir, f"rgb20_{i}.png"), rgb)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=24)
    args = ap.parse_args()

    sys.path.insert(0, REF)
    import modules.ogm as rogm
    import modules.sensors as rsensors
    import modules.texture_mapping as rtm

    n = args.frames
    rng = np.random.default_rng(0)

    # sensor stamp tracks: rgb/disp pairs map 1:1, poses map frame->index
    stamps = 1e9 + np.arange(n) * 0.1
    kinect = rsensors.Kinect({"disp_stamps": stamps + 0.01,
                              "rgb_stamps": stamps})
    encoder = rsensors.Encoder.__new__(rsensors.Encoder)
    encoder.stamps = stamps  # only .stamps is read by the texture stage
    poses = rng.normal(0, 0.5, (n, 3))

    # the reference's exact map geometry (main.py:27-29,198-205)
    ogm = rogm.OccupancyGridMap(
        resolution=0.05, world_map_max_x=30, world_map_max_y=30,
        world_map_min_x=-30, world_map_min_y=-30)

    # camera constants exactly as the driver builds them (main.py:217-232)
    pitch = np.radians(18)
    T_rc = np.eye(4)
    T_rc[:3, :3] = np.array([[np.cos(pitch), 0, np.sin(pitch)],
                             [0, 1, 0],
                             [-np.sin(pitch), 0, np.cos(pitch)]])
    T_rc[:3, 3] = [0.16766, 0.0, 0.38001]
    K = np.array([[585.05, 0, 242.94], [0, 585.05, 315.84], [0, 0, 1.0]])

    with tempfile.TemporaryDirectory() as root:
        fabricate_tree(root, n, rng)
        cwd = os.getcwd()
        os.chdir(root)  # the reference hardcodes relative dataRGBD/ paths
        try:
            t0 = time.time()
            rtm.generate_texture_map(20, poses, kinect, encoder, ogm,
                                     T_rc, K)
            dt = time.time() - t0
        finally:
            os.chdir(cwd)
    per_frame = dt / n
    print(f"reference texture stage: {n} frames in {dt:.2f}s "
          f"({per_frame * 1e3:.1f} ms/frame)")
    print(f"extrapolated dataset-20 ({DATASET20_RGB_FRAMES} frames): "
          f"{per_frame * DATASET20_RGB_FRAMES:.1f}s")


if __name__ == "__main__":
    main()
