"""Lidar scan preprocessing: polar -> Cartesian with validity masks.

The reference returns a ragged list of per-scan (n_i, 2) arrays
(reference: modules/localization.py:252-307). Ragged shapes defeat XLA, so the
fixed-shape representation is the single most important design decision of this
framework: every scan stays a FIXED (n_rays, 2) array plus a boolean validity
mask. Range filtering (reference: localization.py:288) and the DBSCAN /
statistical filters (localization.py:201-250) become mask updates, never shape
changes — so the whole pipeline vmaps/scans over a dense (N, n_rays, ...)
batch.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from ..config import LidarConfig


def scan_angles(cfg: LidarConfig, n_rays: int | None = None) -> jnp.ndarray:
    """Ray angles, identical linspace to reference modules/localization.py:278.

    The reference derives the ray count from the data
    (localization.py:275-279), not from a constant — pass n_rays to match
    datasets that are not 1081-ray."""
    return jnp.linspace(cfg.angle_min, cfg.angle_max,
                        cfg.n_rays if n_rays is None else n_rays)


def scans_to_points(
    ranges: jnp.ndarray,
    range_min: float,
    range_max: float,
    cfg: LidarConfig = LidarConfig(),
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Convert (N, n_rays) ranges to robot-frame points (N, n_rays, 2) + mask.

    Matches reference modules/localization.py:283-305: validity is
    range_min <= r <= range_max; points are polar->Cartesian in the lidar
    frame then offset by the lidar->robot translation p_rl (R = I). Invalid
    rays keep a well-defined (masked) value of the lidar origin offset.
    """
    # ray count comes from the data, like the reference's
    # n_measurements = lidar_ranges.shape (localization.py:275-279)
    angles = scan_angles(cfg, n_rays=ranges.shape[-1])
    mask = (ranges >= range_min) & (ranges <= range_max)
    safe = jnp.where(mask, ranges, 0.0)
    x = safe * jnp.cos(angles)[None, :] + cfg.p_rl[0]
    y = safe * jnp.sin(angles)[None, :] + cfg.p_rl[1]
    return jnp.stack([x, y], axis=-1), mask


def transform_scans_to_world(poses: jnp.ndarray, points: jnp.ndarray) -> jnp.ndarray:
    """Robot-frame scan points -> world frame, batched over scans.

    poses (N, 3), points (N, P, 2) -> (N, P, 2). Replaces the reference's
    per-scan Python loop (reference: modules/localization.py:309-317) with
    one batched transform; masks are unchanged by rigid transforms.
    """
    from ..utils import se2

    return se2.transform_points(points, se2.T_from_pose(poses))
