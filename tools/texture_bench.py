"""Texture-stage benchmark: per-frame cost of the RGB-D pipeline.

Times two components at dataset-20 frame geometry (480 x 640):
  compute   the fused unproject+paint path (synthetic in-memory frames)
  decode    the native C++ batch PNG loader on a fabricated on-disk tree

Reference counterpart: modules/texture_mapping.py:49-96 (per-frame host
loop: 2x cv2.imread + numpy chain). Dataset 20 has ~2,407 RGB frames.

Usage: python tools/texture_bench.py [--frames 64] [--decode-frames 32]
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--decode-frames", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--float32-disp", action="store_true",
                    help="measure the legacy float32-upload path")
    args = ap.parse_args()

    from lidar_slam.utils.runtime import report_devices, use_compile_cache
    use_compile_cache()
    report_devices()
    import numpy as np

    from lidar_slam.config import SlamConfig
    from lidar_slam.models import texture

    cfg = SlamConfig()
    H, W = 480, 640
    rng = np.random.default_rng(0)

    def synth_frames(seed, n, disp_dtype=np.uint16):
        r = np.random.default_rng(seed)
        disp = r.uniform(300, 900, (n, H, W)).astype(disp_dtype)
        rgb = r.integers(0, 255, (n, H, W, 3), dtype=np.uint8)
        return disp, rgb

    # --- compute path (loader injected, frames pre-generated) ---
    # uint16 disparity = the production disk-loader contract (raw sensor
    # upload, device-side conversion); --float32-disp measures the old path
    F = args.frames
    disp_dtype = np.float32 if args.float32_disp else np.uint16
    poses = rng.normal(0, 0.5, (F, 3)).astype(np.float32)
    grid_map = np.zeros((cfg.map.width, cfg.map.height), np.uint8)
    timed = []
    for seed, label in ((1, "warm-up"), (2, "timed"), (4, "timed2")):
        disp, rgb = synth_frames(seed, F, disp_dtype)
        loader = lambda ids: (disp[ids], rgb[ids])
        t0 = time.time()
        tex = texture.generate_texture_map(
            poses, np.arange(F), np.arange(F), grid_map, loader,
            cfg.map, cfg.camera, batch_size=args.batch)
        dt = time.time() - t0
        if label != "warm-up":
            timed.append(dt)
        print(f"compute {label} [{np.dtype(disp_dtype).name} disp, "
              f"batch {args.batch}]: {F} frames in {dt:.2f}s "
              f"({dt / F * 1e3:.1f} ms/frame)", file=sys.stderr)
    # best-of timed reps
    per_frame = min(timed) / F
    print(f"extrapolated dataset-20 compute (2,407 frames): "
          f"{per_frame * 2407:.1f}s", file=sys.stderr)

    # --- native paint-op projector (the thin-link production engine) ---
    from lidar_slam.utils import native as native_lib
    if native_lib.available() and not args.float32_disp:
        timed_n = []
        for seed, label in ((5, "warm-up"), (6, "timed"), (7, "timed2")):
            disp, rgb = synth_frames(seed, F)
            loader = lambda ids: (disp[ids], rgb[ids])
            t0 = time.time()
            texture.generate_texture_map(
                poses, np.arange(F), np.arange(F), grid_map, loader,
                cfg.map, cfg.camera, batch_size=args.batch,
                projector="native")
            dt = time.time() - t0
            if label != "warm-up":
                timed_n.append(dt)
            print(f"paint-op {label} [native projector, batch "
                  f"{args.batch}]: {F} frames in {dt:.2f}s "
                  f"({dt / F * 1e3:.1f} ms/frame)", file=sys.stderr)
        print(f"extrapolated dataset-20 paint-op engine (2,407 frames): "
              f"{min(timed_n) / F * 2407:.1f}s", file=sys.stderr)

    # --- native decode path (fabricated on-disk tree) ---
    from lidar_slam.utils import native
    from lidar_slam.utils.png import write_png
    D = args.decode_frames
    with tempfile.TemporaryDirectory() as root:
        disp, rgb = synth_frames(3, D)
        dpaths, rpaths = [], []
        for i in range(D):
            dp = os.path.join(root, f"d{i}.png")
            rp = os.path.join(root, f"r{i}.png")
            write_png(dp, disp[i].astype(np.uint16))
            write_png(rp, rgb[i])
            dpaths.append(dp)
            rpaths.append(rp)
        if native.available():
            t0 = time.time()
            native.read_png_batch(dpaths, (H, W), np.uint16)
            native.read_png_batch(rpaths, (H, W, 3), np.uint8)
            dt = time.time() - t0
            print(f"native decode: {D} frame pairs in {dt:.2f}s "
                  f"({dt / D * 1e3:.1f} ms/frame) -> dataset-20 "
                  f"~{dt / D * 2407:.0f}s", file=sys.stderr)
        else:
            print("native decoder unavailable; skipping decode bench",
                  file=sys.stderr)


if __name__ == "__main__":
    main()
