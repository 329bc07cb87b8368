"""Log-odds occupancy grid mapping on XLA.

Capability parity with the reference OGM (reference: modules/ogm.py:5-231),
redesigned for XLA: the per-scan Python loop over ~1081 rays with per-ray
variable-length Bresenham and in-place array writes becomes

  - one vmapped closed-form Bresenham over all rays (ops/bresenham.py),
  - a scatter-add of +/- log4 contributions into the grid, compacted to
    live (ray, slot) tiles by sorting rays by their in-bounds extent
    (scatter cost scales with total slots; out-of-bounds cells are dropped
    by the scatter itself), and
  - a lax.scan over time steps carrying the grid, clipping to +/-20 after
    each scan exactly like the reference (modules/ogm.py:188 — the clip is
    sequential, so the time axis is a scan; rays within a scan are the
    parallel axis and are additionally shardable across devices).

Replicated reference quirks (see SURVEY.md section 2 #12):
  - world2grid is ceil((x - min)/res) - 1 (modules/ogm.py:117-123);
  - the ray ORIGIN is robot xy + the UNROTATED lidar offset p_rl[:2]
    (modules/ogm.py:164-166), while endpoints use the rotated scan points;
  - if a ray's endpoint leaves the map, the LAST in-bounds cell on the ray
    receives the occupied (+log4) update (modules/ogm.py:181-185 filters
    in-bounds first, then treats the final remaining cell as the endpoint);
  - finalize: pmf = sigmoid(-logodds); the uint8 grid_map is 1 exactly where
    pmf > 0.5, i.e. value 1 marks FREE cells (modules/ogm.py:61-64 — the
    reference's 0.5 assignment truncates to 0 in uint8; we replicate the
    semantics).
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import LidarConfig, MapConfig
from ..ops.bresenham import bresenham_fixed


def world2grid(x: jnp.ndarray, y: jnp.ndarray, cfg: MapConfig) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """World meters -> integer cell indices (reference: modules/ogm.py:102-124)."""
    i = jnp.ceil((x - cfg.world_min_x) / cfg.resolution).astype(jnp.int32) - 1
    j = jnp.ceil((y - cfg.world_min_y) / cfg.resolution).astype(jnp.int32) - 1
    return i, j


def grid2world(i: jnp.ndarray, j: jnp.ndarray, cfg: MapConfig) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Cell indices -> world meters (reference: modules/ogm.py:126-147)."""
    return i * cfg.resolution + cfg.world_min_x, j * cfg.resolution + cfg.world_min_y


def max_ray_cells(cfg: MapConfig, range_max: float) -> int:
    """Static bound on cells per ray: a ray of physical length range_max spans
    at most ceil(range_max/res) cells along the major axis (+ slack for the
    start offset)."""
    return int(math.ceil(range_max / cfg.resolution)) + 8


def adaptive_ray_cells(points, masks, cfg: MapConfig,
                       range_max: float = 30.0) -> int:
    """Data-adaptive static slot count: the longest VALID ray in the data,
    not the sensor's range_max.

    Scatter cost scales with total slots (PERF.md), and indoor logs rarely
    contain rays near range_max — on dataset-20-shaped data this cuts slots
    >2x with zero semantic change. Host-side (numpy) computation before
    tracing; the bound is conservative: ray cell count <=
    ceil((|p| + |p_rl|)/res) + 1 for robot-frame point p (the ray origin is
    offset by the unrotated p_rl while the endpoint carries the rotated one,
    reference: modules/ogm.py:160-166). Rounded up to a multiple of 64 to
    bound jit recompiles across datasets.
    """
    pts = np.asarray(points)
    m = np.asarray(masks)
    if not m.any():
        return 64
    max_norm = float(np.sqrt((pts[..., 0] ** 2 + pts[..., 1] ** 2)[m].max()))
    k = int(math.ceil((max_norm + 0.28) / cfg.resolution)) + 8
    k64 = int(-(-k // 64) * 64)
    return min(k64, max_ray_cells(cfg, range_max))


def scan_logodds_cells(
    pose: jnp.ndarray,
    points: jnp.ndarray,
    mask: jnp.ndarray,
    cfg: MapConfig,
    K: int,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Per-scan ray contributions in dense (R, K) layout + per-ray lengths.

    pose (3,), points (R, 2) robot-frame scan points (already including the
    lidar offset, like reference z_ts), mask (R,) ray validity. Returns
    (xs, ys, values, lengths) with masked slots routed to xs = -1.
    """
    x, y, yaw = pose[0], pose[1], pose[2]
    c, s = jnp.cos(yaw), jnp.sin(yaw)
    # endpoints: rotate robot-frame points to world and translate
    # (reference: modules/ogm.py:160-162)
    wx = points[..., 0] * c - points[..., 1] * s + x
    wy = points[..., 0] * s + points[..., 1] * c + y
    # ray origin: robot xy + unrotated lidar offset (reference: ogm.py:164-166)
    ox = x + LidarConfig().p_rl[0]
    oy = y + LidarConfig().p_rl[1]

    sx, sy = world2grid(ox, oy, cfg)
    ex, ey = world2grid(wx, wy, cfg)
    sx = jnp.broadcast_to(sx, ex.shape)
    sy = jnp.broadcast_to(sy, ey.shape)

    xs, ys, in_ray = bresenham_fixed(sx, sy, ex, ey, K)  # (R, K)

    in_bounds = (xs >= 0) & (xs < cfg.width) & (ys >= 0) & (ys < cfg.height)
    valid = in_ray & in_bounds & mask[..., None]

    k = jnp.arange(K, dtype=jnp.int32)
    # last in-bounds cell gets +log4 (occupied); earlier cells -log4 (free)
    last_valid = jnp.max(jnp.where(valid, k, -1), axis=-1, keepdims=True)
    L = cfg.logodds_ratio
    values = jnp.where(valid, jnp.where(k == last_valid, L, -L), 0.0)

    # route masked-out slots to an out-of-bounds index so scatter drops them
    xs = jnp.where(valid, xs, -1)
    # live extent per ray = last in-bounds slot + 1 (tighter than the
    # geometric ray length for rays that exit the map; slots beyond it are
    # all invalid, so bounding by it is exact)
    lengths = last_valid[..., 0] + 1
    return xs, ys, values.astype(jnp.float32), lengths.astype(jnp.int32)


def scan_logodds_delta(
    pose: jnp.ndarray,
    points: jnp.ndarray,
    mask: jnp.ndarray,
    cfg: MapConfig,
    K: int,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Flattened (R*K,) variant of scan_logodds_cells (dense scatter path)."""
    xs, ys, values, _ = scan_logodds_cells(pose, points, mask, cfg, K)
    return xs.reshape(-1), ys.reshape(-1), values.reshape(-1)


def _compact_scan_update(grid, pose, pts, m, cfg: MapConfig, K: int,
                         ray_chunk: int = 128, slot_chunk: int = 64):
    """One scan's scatter, restricted to live (ray-chunk x slot-chunk) tiles.

    Scatter cost scales with total slots including dropped ones (PERF.md),
    so sorting rays by length and skipping slot tiles beyond each chunk's
    longest ray cuts scattered slots from R*K to ~sum(L_r): every valid
    slot of every ray in a chunk lies below the chunk's max length, so the
    visited-cell set (and the map) is bit-identical to the dense path.
    """
    xs, ys, values, lengths = scan_logodds_cells(pose, pts, m, cfg, K)
    R = xs.shape[0]
    order = jnp.argsort(-lengths)
    xs, ys, values = xs[order], ys[order], values[order]
    L_sorted = lengths[order]

    n_rc = -(-R // ray_chunk)
    pad_r = n_rc * ray_chunk - R
    # pad the slot axis to whole tiles too, so dynamic_slice never clamps
    # (a clamped start would re-read earlier slots and double-count)
    pad_k = (-K) % slot_chunk
    if pad_r or pad_k:
        xs = jnp.pad(xs, ((0, pad_r), (0, pad_k)), constant_values=-1)
        ys = jnp.pad(ys, ((0, pad_r), (0, pad_k)))
        values = jnp.pad(values, ((0, pad_r), (0, pad_k)))

    for c in range(n_rc):
        lmax = jnp.minimum(L_sorted[c * ray_chunk], K)
        n_tiles = -(-lmax // slot_chunk)

        def body(j, g, c=c):
            j0 = j * slot_chunk
            r0 = jnp.asarray(c * ray_chunk, j0.dtype)
            tx = jax.lax.dynamic_slice(xs, (r0, j0), (ray_chunk, slot_chunk))
            ty = jax.lax.dynamic_slice(ys, (r0, j0), (ray_chunk, slot_chunk))
            tv = jax.lax.dynamic_slice(values, (r0, j0),
                                       (ray_chunk, slot_chunk))
            return g.at[tx.reshape(-1), ty.reshape(-1)].add(
                tv.reshape(-1), mode="drop")

        grid = jax.lax.fori_loop(0, n_tiles, body, grid)
    return grid


@partial(jax.jit, static_argnames=("cfg", "K"))
def update_map(
    logodds: jnp.ndarray,
    pose: jnp.ndarray,
    points: jnp.ndarray,
    mask: jnp.ndarray,
    cfg: MapConfig,
    K: int,
) -> jnp.ndarray:
    """One scan's map update: scatter-add all ray contributions, then clip
    (reference: modules/ogm.py:149-188)."""
    new = _compact_scan_update(logodds, pose, points, mask, cfg, K)
    return jnp.clip(new, -cfg.logodds_clip, cfg.logodds_clip)


@partial(jax.jit, static_argnames=("cfg", "K", "compact"))
def build_logodds(
    poses: jnp.ndarray,
    points: jnp.ndarray,
    masks: jnp.ndarray,
    cfg: MapConfig,
    K: int,
    init: jnp.ndarray | None = None,
    compact: bool = True,
) -> jnp.ndarray:
    """Build the full log-odds grid with a lax.scan over scans
    (reference: modules/ogm.py:45-59). poses (N,3), points (N,R,2), masks (N,R).

    Each scan is one XLA scatter-add: compact=True scatters only live
    (ray, slot) tiles after sorting rays by length (identical map, a
    ~sum(L)/(R*K) share of the slots — see _compact_scan_update),
    compact=False is the plain dense scatter.
    """
    if init is None:
        init = jnp.zeros((cfg.width, cfg.height), dtype=jnp.float32)

    def step(grid, inp):
        pose, pts, m = inp
        if compact:
            grid = _compact_scan_update(grid, pose, pts, m, cfg, K)
        else:
            xs, ys, values = scan_logodds_delta(pose, pts, m, cfg, K)
            grid = grid.at[xs, ys].add(values, mode="drop")
        return jnp.clip(grid, -cfg.logodds_clip, cfg.logodds_clip), None

    grid, _ = jax.lax.scan(step, init, (poses, points, masks))
    return grid


def finalize_grid(logodds: jnp.ndarray) -> jnp.ndarray:
    """Threshold log-odds into the uint8 grid_map (reference: modules/ogm.py:61-64;
    value 1 marks FREE cells — see module docstring)."""
    pmf = 1.0 / (1.0 + jnp.exp(logodds))
    return (pmf > 0.5).astype(jnp.uint8)


def render_logodds(logodds: jnp.ndarray) -> np.ndarray:
    """Min-max normalize + sqrt gamma -> uint8 grayscale image
    (reference rendering semantics: modules/ogm.py:66-85)."""
    lo = np.asarray(logodds, dtype=np.float64)
    den = lo.max() - lo.min()
    norm = (lo - lo.min()) / (den if den > 0 else 1.0)
    return (np.sqrt(norm) * 255.0).astype(np.uint8)


@dataclasses.dataclass
class OccupancyGridMap:
    """Stateful convenience wrapper mirroring the reference class surface
    (reference: modules/ogm.py:5-64) over the functional core above."""

    cfg: MapConfig
    range_max: float = 30.0

    def __post_init__(self):
        self.grid_map_width = self.cfg.width
        self.grid_map_height = self.cfg.height
        self.res = self.cfg.resolution
        self.logodds_ratio = self.cfg.logodds_ratio
        self.K = max_ray_cells(self.cfg, self.range_max)
        self.grid_map_log_odds = jnp.zeros((self.cfg.width, self.cfg.height), jnp.float32)
        self.grid_map = np.zeros((self.cfg.width, self.cfg.height), np.uint8)

    @classmethod
    def create(cls, resolution, world_map_max_x, world_map_max_y,
               world_map_min_x, world_map_min_y, buffer=1.0, range_max=30.0):
        cfg = MapConfig(resolution=resolution, world_max_x=world_map_max_x,
                        world_max_y=world_map_max_y, world_min_x=world_map_min_x,
                        world_min_y=world_map_min_y, buffer=buffer)
        return cls(cfg=cfg, range_max=range_max)

    def world2grid(self, x, y):
        i, j = world2grid(jnp.asarray(x), jnp.asarray(y), self.cfg)
        return np.stack([np.asarray(i).reshape(-1), np.asarray(j).reshape(-1)], axis=-1).squeeze()

    def grid2world(self, i, j):
        x, y = grid2world(jnp.asarray(i), jnp.asarray(j), self.cfg)
        return np.stack([np.asarray(x).reshape(-1), np.asarray(y).reshape(-1)], axis=-1).squeeze()

    def update_map(self, x_t, z_t, mask=None):
        z_t = jnp.asarray(z_t)
        if mask is None:
            mask = jnp.ones(z_t.shape[0], dtype=bool)
        self.grid_map_log_odds = update_map(
            self.grid_map_log_odds, jnp.asarray(x_t), z_t, mask, self.cfg, self.K)

    def build_map(self, states, meas, masks=None):
        states = jnp.asarray(states)
        meas = jnp.asarray(meas)
        if masks is None:
            masks = jnp.ones(meas.shape[:2], dtype=bool)
        self.grid_map_log_odds = build_logodds(
            states, meas, jnp.asarray(masks), self.cfg, self.K,
            init=self.grid_map_log_odds)
        self.grid_map = np.asarray(finalize_grid(self.grid_map_log_odds))

    def plot_log_odds_map(self, fname):
        from ..utils.png import write_png
        write_png(fname, render_logodds(self.grid_map_log_odds))

    def plot_map(self, fname):
        from ..utils.png import write_png
        write_png(fname, (np.asarray(self.grid_map) * 255).astype(np.uint8))
