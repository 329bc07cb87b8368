"""Minimal PNG IO.

The reference leans on cv2.imread (C++) for reading Kinect PNGs
(reference: modules/texture_mapping.py:118-132) and matplotlib for writing
map images (modules/ogm.py:66-100). This module provides a dependency-free
encoder (zlib) and delegates to the native C++ decoder in native/ when built
(see lidar_slam.utils.native); cv2/PIL are used as fallbacks only if
present.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def write_png(path: str, image: np.ndarray) -> None:
    """Write (H, W) gray (uint8/uint16) or (H, W, 3) RGB uint8 as PNG."""
    image = np.asarray(image)
    depth = 8
    if image.dtype == np.uint16:
        if image.ndim != 2:
            raise ValueError("16-bit write supports grayscale only")
        depth = 16
    elif image.dtype != np.uint8:
        raise ValueError(f"write_png expects uint8/uint16, got {image.dtype}")
    if image.ndim == 2:
        color_type = 0  # grayscale
        h, w = image.shape
        raw = image[:, :, None]
    elif image.ndim == 3 and image.shape[2] == 3:
        color_type = 2  # RGB
        h, w, _ = image.shape
        raw = image
    else:
        raise ValueError(f"write_png expects (H,W) or (H,W,3), got {image.shape}")

    if depth == 16:
        raw = raw.astype(">u2")  # PNG 16-bit samples are big-endian

    # Filter type 0 (None) per scanline.
    scanlines = b"".join(
        b"\x00" + raw[y].tobytes() for y in range(h)
    )
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, 0)
    data = (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(scanlines, 6))
        + _chunk(b"IEND", b"")
    )
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def read_png(path: str) -> np.ndarray:
    """Read a PNG into a numpy array.

    Prefers the native C++ decoder (native/libslamio.so); falls back to a
    pure-Python decoder supporting 8-bit gray/RGB/RGBA and 16-bit gray —
    which covers the Kinect disparity (16-bit gray) and RGB (8-bit) images
    the reference reads with cv2 (modules/texture_mapping.py:129-132).
    """
    from . import native

    if native.available():
        return native.read_png(path)
    return _read_png_python(path)


def _paeth(a, b, c):
    p = a.astype(np.int32) + b.astype(np.int32) - c.astype(np.int32)
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    out = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return out.astype(np.uint16)


def _read_png_python(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path} is not a PNG")
    pos = 8
    idat = []
    w = h = depth = ctype = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB", payload)
            if interlace:
                raise ValueError("interlaced PNG unsupported")
        elif tag == b"IDAT":
            idat.append(payload)
        elif tag == b"IEND":
            break
        pos += 12 + length
    channels = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    bpp_bytes = depth // 8
    stride = w * channels * bpp_bytes
    raw = zlib.decompress(b"".join(idat))

    # Undo per-scanline filters (sequential in rows, vectorized in columns).
    img = np.zeros((h, stride), dtype=np.uint16)
    fb = channels * bpp_bytes  # filter unit in bytes
    prev = np.zeros(stride, dtype=np.uint16)
    arr = np.frombuffer(raw, dtype=np.uint8)
    for y in range(h):
        ftype = arr[y * (stride + 1)]
        line = arr[y * (stride + 1) + 1 : (y + 1) * (stride + 1)].astype(np.uint16)
        if ftype == 0:
            cur = line
        elif ftype == 2:  # Up
            cur = (line + prev) & 0xFF
        else:  # Sub(1), Average(3), Paeth(4) need a left-to-right pass
            cur = line.copy()
            for x in range(stride):
                a = cur[x - fb] if x >= fb else 0
                b = prev[x]
                c = prev[x - fb] if x >= fb else 0
                if ftype == 1:
                    cur[x] = (cur[x] + a) & 0xFF
                elif ftype == 3:
                    cur[x] = (cur[x] + ((int(a) + int(b)) >> 1)) & 0xFF
                elif ftype == 4:
                    cur[x] = (cur[x] + _paeth(np.uint16(a), np.uint16(b), np.uint16(c))) & 0xFF
                else:
                    raise ValueError(f"bad filter {ftype}")
        img[y] = cur
        prev = cur

    bytes_img = img.astype(np.uint8).reshape(h, -1)
    if depth == 8:
        out = bytes_img.reshape(h, w, channels)
    elif depth == 16:
        out = (bytes_img.reshape(h, w, channels, 2)[..., 0].astype(np.uint16) << 8) | \
            bytes_img.reshape(h, w, channels, 2)[..., 1]
    else:
        raise ValueError(f"bit depth {depth} unsupported")
    return out.squeeze()
