"""Edge-case robustness: degenerate masks, boundary angles, empty factors."""

import numpy as np
import jax.numpy as jnp

from lidar_slam.ops import icp as icp_ops
from lidar_slam.utils import se2


def test_icp_all_source_points_masked():
    """A pair with zero valid source points must terminate finitely
    (the chunk-padding path relies on this)."""
    rng = np.random.default_rng(0)
    src = jnp.asarray(rng.normal(size=(50, 3)))
    tgt = jnp.asarray(rng.normal(size=(50, 3)))
    res = icp_ops.run_icp(src, tgt, epsilon=1e-3,
                          pc1_mask=jnp.zeros(50, bool),
                          pc2_mask=jnp.ones(50, bool))
    assert np.isfinite(np.asarray(res.T)).all()
    assert float(res.error) == 0.0  # no valid points -> zero error < eps
    assert int(res.iters) == 1


def test_se2_log_near_pi():
    """Rotation magnitudes near pi must stay finite and invert correctly."""
    for w in (np.pi - 1e-4, -np.pi + 1e-4, 3.0, -3.0):
        xi = jnp.asarray([0.5, -0.2, w])
        T = se2.exp_se2(xi)
        back = np.asarray(se2.log_se2(T))
        np.testing.assert_allclose(back, np.asarray(xi), atol=1e-8)


def test_se2_log_zero_rotation():
    T = se2.T_from_pose(jnp.asarray([1.0, 2.0, 0.0]))
    xi = np.asarray(se2.log_se2(T))
    np.testing.assert_allclose(xi, [1.0, 2.0, 0.0], atol=1e-12)


def test_pose_graph_without_loops():
    from lidar_slam.models import pose_graph
    rng = np.random.default_rng(1)
    rel = se2.T_from_pose(jnp.asarray(rng.normal(0, 0.05, (10, 3))))
    g = pose_graph.make_graph(rel)
    res = pose_graph.optimize(jnp.asarray(np.zeros((11, 3))), g,
                              max_iters=10, cg_iters=40)
    assert np.isfinite(np.asarray(res.poses)).all()
    # chain with no loops: optimum is the integrated measurements
    chain = se2.compose_chain(rel)
    want = np.asarray(se2.pose_from_T(chain))
    np.testing.assert_allclose(np.asarray(res.poses)[:, :2], want[:, :2],
                               atol=1e-3)


def test_occupancy_single_scan_single_ray():
    from lidar_slam.config import MapConfig
    from lidar_slam.models import occupancy
    cfg = MapConfig(resolution=0.5, world_max_x=3, world_min_x=-3,
                    world_max_y=3, world_min_y=-3)
    K = occupancy.max_ray_cells(cfg, 4.0)
    grid = occupancy.build_logodds(
        jnp.zeros((1, 3)), jnp.asarray([[[1.0, 0.0]]]),
        jnp.ones((1, 1), bool), cfg, K)
    g = np.asarray(grid)
    assert np.isclose(g.max(), np.log(4.0))  # endpoint
    assert np.isclose(g.min(), -np.log(4.0))  # free cells
    assert np.isfinite(g).all()


def test_bresenham_extreme_coordinates():
    from lidar_slam.ops.bresenham import bresenham_cells
    # the documented int32 domain: rays up to 46340 cells along the major
    # axis (k*dy stays below 2^31)
    cells = np.asarray(bresenham_cells(-20000, -20000, 20000, 19999))
    assert cells.shape[0] == 40001
    assert (np.abs(np.diff(cells[:, 0])) == 1).all()
    diffs = np.diff(cells[:, 1])
    assert set(np.unique(diffs)) <= {0, 1}
