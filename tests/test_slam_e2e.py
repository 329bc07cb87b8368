import numpy as np
import jax.numpy as jnp
import pytest

from lidar_slam.config import (IcpConfig, LidarConfig, MapConfig,
                               PoseGraphConfig, SlamConfig)
from lidar_slam.models import slam
from lidar_slam.utils import io


@pytest.fixture(scope="module")
def small_dataset():
    return io.synthetic_dataset(n_steps=80, n_rays=541, seed=42)


def _cfg():
    return SlamConfig(
        lidar=LidarConfig(n_rays=541),
        map=MapConfig(resolution=0.1, world_max_x=15, world_min_x=-15,
                      world_max_y=15, world_min_y=-15),
        icp=IcpConfig(epsilon=0.001),
        pose_graph=PoseGraphConfig(max_lm_iters=20, cg_iters=100),
    )


def test_mode_odom(small_dataset):
    d = small_dataset
    res = slam.run_slam(d["encoder"]["counts"], d["imu"]["angular_velocity"],
                        d["lidar"]["ranges"], 0.1, 30.0, mode="odom",
                        cfg=_cfg(), chunk_size=16)
    assert res.poses.shape == (80, 3)
    assert res.relative_poses_odom.shape == (79, 3, 3)
    assert res.logodds is not None and res.grid_map is not None
    assert res.grid_map.dtype == np.uint8
    assert np.isfinite(res.poses).all()
    # the map saw real structure
    assert (res.logodds < -1).sum() > 100
    assert (res.logodds > 1).sum() > 10
    gt = d["ground_truth"]
    err = np.linalg.norm(res.poses[:, :2] - gt[:, :2], axis=1).mean()
    assert err < 0.1


def test_mode_scan_matching(small_dataset):
    d = small_dataset
    res = slam.run_slam(d["encoder"]["counts"], d["imu"]["angular_velocity"],
                        d["lidar"]["ranges"], 0.1, 30.0, mode="scan_matching",
                        cfg=_cfg(), build_map=False, chunk_size=16)
    assert res.poses_scan_matching is not None
    assert res.relative_poses_scan_matching.shape == (79, 3, 3)
    assert np.isfinite(res.poses).all()
    np.testing.assert_array_equal(res.poses, res.poses_scan_matching)


def test_mode_gtsam(small_dataset):
    d = small_dataset
    res = slam.run_slam(d["encoder"]["counts"], d["imu"]["angular_velocity"],
                        d["lidar"]["ranges"], 0.1, 30.0, mode="gtsam",
                        fixed_interval=10, cfg=_cfg(), build_map=True,
                        chunk_size=16)
    assert res.poses_optimized is not None
    assert np.isfinite(res.poses_optimized).all()
    np.testing.assert_array_equal(res.poses, res.poses_optimized)
    # candidates at 0,10,...,60 -> 7; gating keeps a subset
    assert 0 <= res.n_loop_closures <= 7
    assert res.grid_map is not None


def test_mode_gtsam_with_filters(small_dataset):
    d = small_dataset
    res = slam.run_slam(d["encoder"]["counts"], d["imu"]["angular_velocity"],
                        d["lidar"]["ranges"], 0.1, 30.0, mode="gtsam",
                        filter_lidar=True, cfg=_cfg(), build_map=False,
                        chunk_size=16)
    assert np.isfinite(res.poses).all()


def test_loop_closure_gating_semantics():
    """The reference gates on the SIGNED angle (not abs), and strict <
    (reference: main.py:163-172)."""
    from lidar_slam.models.slam import compute_loop_closures
    rng = np.random.default_rng(0)
    # identical scans at every step: closure transform ~ identity, accepted
    base = rng.uniform(-3, 3, (60, 2))
    pts = np.tile(base[None], (21, 1, 1))
    pts3 = jnp.concatenate([jnp.asarray(pts),
                            jnp.zeros((21, 60, 1))], axis=-1)
    masks = jnp.ones((21, 60), bool)
    cand = np.arange(0, 11, 10)
    T2, accept, errors, iters = compute_loop_closures(
        pts3, masks, cand, 10, max_distance=0.1, max_yaw_deg=1.0)
    assert np.asarray(accept).all()
    np.testing.assert_allclose(np.asarray(T2), np.tile(np.eye(3), (2, 1, 1)),
                               atol=1e-6)
