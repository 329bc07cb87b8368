"""Dataset-SCALE multi-chip equality: the scan-parallel map builder at the
full dataset-20 problem size (4,956 scans x 1,081 rays, 1201x1201 grid,
K=608) on the 8-virtual-device mesh vs the sequential single-device build.

Round-3 review item 6: every other sharding equality test runs at toy
shapes; this one pins the clamp-affine scan-parallel composition
(ops/clamp_affine.py, parallel/sharding.sharded_build_logodds_scans) at
the real workload, where thousands of scans revisit the same cells and
the +/-20 log-odds rails saturate for real.

Budget: ONE build pair, shared module-scoped (~8-10 min on the 1-core CPU
runner — the bulk of the suite's heavy tail, as budgeted by the review).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lidar_slam.config import SlamConfig
from lidar_slam.models import occupancy
from lidar_slam.ops import scan as scan_ops
from lidar_slam.parallel import mesh as mesh_lib
from lidar_slam.parallel import sharding
from lidar_slam.utils import io

pytestmark = [
    pytest.mark.slow,
    pytest.mark.skipif(len(jax.devices()) < 8,
                       reason="needs 8 virtual devices"),
]

N_STEPS = 4956
N_RAYS = 1081


@pytest.fixture(scope="module")
def built_pair():
    cfg = SlamConfig()
    data = io.synthetic_dataset(n_steps=N_STEPS, n_rays=N_RAYS, seed=20)
    ranges = jnp.asarray(data["lidar"]["ranges"], jnp.float32)
    points, masks = scan_ops.scans_to_points(ranges, 0.1, 30.0, cfg.lidar)
    poses = jnp.asarray(data["ground_truth"], jnp.float32)
    K = occupancy.adaptive_ray_cells(points, masks, cfg.map, 30.0)
    assert cfg.map.width == 1201 and cfg.map.height == 1201

    # pad to a multiple of 8 with mask=False scans (identity updates)
    pad = (-N_STEPS) % 8
    poses_p = jnp.concatenate([poses, jnp.zeros((pad, 3), jnp.float32)])
    points_p = jnp.concatenate(
        [points, jnp.zeros((pad,) + points.shape[1:], points.dtype)])
    masks_p = jnp.concatenate(
        [masks, jnp.zeros((pad,) + masks.shape[1:], bool)])

    ref = np.asarray(occupancy.build_logodds(poses, points, masks,
                                             cfg.map, K))
    m = mesh_lib.make_mesh(8)
    build = sharding.sharded_build_logodds_scans(m, cfg.map, K)
    got = np.asarray(build(poses_p, points_p, masks_p))
    return ref, got, cfg


def test_scan_parallel_logodds_equality_at_dataset_scale(built_pair):
    """Composed 8-block result vs sequential, full dataset-20 size.

    Bit-identical wherever the running cell value never saturates; at
    saturated cells the clip-composition analysis bounds the deviation to
    ULP scale (ops/clamp_affine.py) — in practice the difference has
    measured exactly 0 at this scale."""
    ref, got, cfg = built_pair
    max_diff = float(np.abs(got - ref).max())
    assert max_diff <= 1e-4, max_diff
    # the saturation rails are genuinely exercised at this scale
    clip = cfg.map.logodds_clip
    assert (ref >= clip).sum() > 1000 and (ref <= -clip).sum() > 1000


def test_scan_parallel_finalized_map_equality_at_dataset_scale(built_pair):
    """The shipped artifact — the finalized uint8 grid (reference
    modules/ogm.py:61-64 quirks included) — is exactly equal."""
    ref, got, _ = built_pair
    np.testing.assert_array_equal(
        np.asarray(occupancy.finalize_grid(jnp.asarray(got))),
        np.asarray(occupancy.finalize_grid(jnp.asarray(ref))))
