"""Robust m-estimators on loop factors (models/pose_graph.py).

The reference protects its pose graph from bad loop closures with hard
distance/yaw gates only (reference main.py:163-172); production factor-graph
stacks (GTSAM's noiseModel.mEstimator) additionally downweight residual
outliers inside the solve. These tests pin the IRLS implementation: exact
no-op in the quadratic zone, and genuine outlier rejection where a gross
loop measurement conflicts with correct anchors.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from lidar_slam.config import PoseGraphConfig
from lidar_slam.models import pose_graph as pg
from lidar_slam.utils import se2


@pytest.fixture(scope="module")
def outlier_world():
    """Arc trajectory with drifty odometry, global anchors 0->j for
    j in {10..70}, plus ONE conflicting outlier anchor 0->40 claiming a
    2.5 m displaced pose. A non-robust solve must split the difference at
    pose 40; a robust solve must side with the correct constraint."""
    rng = np.random.default_rng(0)
    N = 80
    th = np.cumsum(np.full(N, 0.05))
    th[0] = 0
    gt = np.stack([np.cumsum(0.3 * np.cos(th)),
                   np.cumsum(0.3 * np.sin(th)), th], -1).astype(np.float32)
    gt = jnp.asarray(gt)
    rel = se2.get_relative_pose(gt[:-1], gt[1:])
    noise = rng.normal(0, 0.02, (N - 1, 3)).astype(np.float32)
    rel_noisy = se2.T_from_pose(se2.pose_from_T(rel) + jnp.asarray(noise))
    poses0 = se2.pose_from_T(
        se2.compose_chain(rel_noisy, se2.T_from_pose(gt[0])))

    li = np.array([0] * 8, np.int32)
    lj = np.array([10, 20, 30, 40, 50, 60, 70, 40], np.int32)
    lmeas = np.array(se2.get_relative_pose(gt[li[:7]], gt[lj[:7]]),
                     copy=True)
    bad = se2.T_from_pose(
        se2.pose_from_T(se2.get_relative_pose(gt[0], gt[40])[None])[0]
        + jnp.asarray([2.5, -1.5, 0.6], jnp.float32))
    lmeas = np.concatenate([lmeas, np.asarray(bad)[None]],
                           0).astype(np.float32)

    graph = pg.make_graph(rel_noisy, PoseGraphConfig(), prior_pose=gt[0],
                          loop_i=jnp.asarray(li), loop_j=jnp.asarray(lj),
                          loop_meas=jnp.asarray(lmeas),
                          loop_mask=jnp.ones(8, bool))
    return gt, poses0, graph


def _err(poses, gt):
    return np.linalg.norm(np.asarray(poses)[:, :2] - np.asarray(gt)[:, :2],
                          axis=1)


def test_huber_huge_delta_is_exact_noop(outlier_world):
    """With delta above every whitened residual, Huber's weight is exactly
    1 and its rho exactly e^2/2 — the solve must be bitwise the plain
    one."""
    gt, poses0, graph = outlier_world
    r_none = pg.optimize(poses0, graph, max_iters=30)
    r_big = pg.optimize(poses0, graph, max_iters=30, robust="huber",
                        robust_delta=1e6)
    np.testing.assert_array_equal(np.asarray(r_none.poses),
                                  np.asarray(r_big.poses))


def test_robust_rejects_conflicting_outlier(outlier_world):
    """Measured: none leaves pose 40 at 1.35 m (dragged toward the false
    anchor); huber recovers to 0.26 m, cauchy to 0.03 m."""
    gt, poses0, graph = outlier_world
    r_none = pg.optimize(poses0, graph, max_iters=80, cost_rtol=1e-9)
    e_none = _err(r_none.poses, gt)
    assert e_none[40] > 1.0  # the outlier really does corrupt the solve

    r_hub = pg.optimize(poses0, graph, max_iters=80, cost_rtol=1e-9,
                        robust="huber", robust_delta=1.0)
    e_hub = _err(r_hub.poses, gt)
    assert e_hub[40] < 0.5 and e_hub.mean() < 0.15

    r_cau = pg.optimize(poses0, graph, max_iters=80, cost_rtol=1e-9,
                        robust="cauchy", robust_delta=1.0)
    e_cau = _err(r_cau.poses, gt)
    assert e_cau[40] < 0.15 and e_cau.mean() < 0.10

    assert e_hub.mean() < e_none.mean() / 3
    assert e_cau.mean() < e_none.mean() / 3


def test_robust_via_config(outlier_world):
    """optimize_with_config wires cfg.robust_loss/robust_delta through."""
    gt, poses0, graph = outlier_world
    cfg = PoseGraphConfig(robust_loss="cauchy", robust_delta=1.0,
                          max_lm_iters=80, cost_rtol=1e-9)
    res = pg.optimize_with_config(poses0, graph, cfg)
    assert _err(res.poses, gt)[40] < 0.15


def test_unknown_kernel_raises(outlier_world):
    gt, poses0, graph = outlier_world
    with pytest.raises(ValueError, match="unknown robust kernel"):
        pg.optimize(poses0, graph, max_iters=2, robust="tukey")


def test_robust_weight_and_cost_values():
    """Spot-check the kernels against their closed forms."""
    e2 = jnp.asarray([0.0, 0.25, 4.0, 100.0], jnp.float32)
    w, rho = pg._robust_w_rho(e2, "huber", 1.0)
    np.testing.assert_allclose(np.asarray(w), [1, 1, 0.5, 0.1], atol=1e-6)
    np.testing.assert_allclose(np.asarray(rho), [0, 0.125, 1.5, 9.5],
                               atol=1e-6)
    w, rho = pg._robust_w_rho(e2, "cauchy", 1.0)
    np.testing.assert_allclose(np.asarray(w), [1, 0.8, 0.2, 1 / 101],
                               atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(rho), 0.5 * np.log1p(np.asarray(e2)), atol=1e-6)
