"""Particle-filter SLAM (models/pf_slam.py).

The reference localizes by ICP + GTSAM and maps afterwards
(main.py:107-205); pf_slam closes the loop the course starter's
mapCorrelation was designed for (code/pr2_utils.py:12-43): score motion
hypotheses against the map built so far, extend that map with the
filtered estimate. These tests pin the degenerate equivalences, the exact
causal-map semantics, and the headline capability — bounding the drift of
a deliberately biased odometry with NO prior map.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from lidar_slam.config import LidarConfig, MapConfig
from lidar_slam.models import occupancy, odometry, pf_slam
from lidar_slam.models.particle_filter import PFConfig
from lidar_slam.ops import scan as scan_ops
from lidar_slam.utils import io


@pytest.fixture(scope="module")
def world():
    cfg_map = MapConfig(resolution=0.1, world_max_x=15, world_min_x=-15,
                        world_max_y=15, world_min_y=-15)
    data = io.synthetic_dataset(n_steps=240, n_rays=181, seed=5)
    gt = jnp.asarray(data["ground_truth"], jnp.float32)
    counts = jnp.asarray(data["encoder"]["counts"], jnp.float32)
    gyro = jnp.asarray(data["imu"]["angular_velocity"], jnp.float32)
    ranges = jnp.asarray(data["lidar"]["ranges"], jnp.float32)
    points, masks = scan_ops.scans_to_points(ranges, 0.1, 30.0,
                                             LidarConfig())
    K = int(occupancy.adaptive_ray_cells(points, masks, cfg_map, 30.0))
    return cfg_map, gt, counts, gyro, points[..., :2], masks, K


def _pos_err(poses, gt):
    return np.linalg.norm(np.asarray(poses)[:, :2] - np.asarray(gt)[:, :2],
                          axis=1)


def test_zero_noise_equals_dead_reckoning(world):
    """sigma=0, temperature=0: every particle IS the dead-reckoned pose, so
    the SLAM estimate must equal poses_from_odometry (pins the step
    alignment against the odometry stage, like the PF-localization
    analog)."""
    cfg_map, gt, counts, gyro, pts, masks, K = world
    cfg = PFConfig(n_particles=8, sigma_v=0.0, sigma_w=0.0, temperature=0.0)
    poses, _, aux = pf_slam.slam_particle_filter(
        counts, gyro, pts, masks, cfg_map, cfg, x0=gt[0], K=K)
    odo = odometry.poses_from_odometry(counts, gyro, x_0=gt[0])
    np.testing.assert_allclose(np.asarray(poses), np.asarray(odo), atol=1e-5)
    assert not bool(np.asarray(aux["resampled"]).any())


def test_causal_map_matches_build_over_returned_track(world):
    """The returned map must BITWISE equal build_logodds over the returned
    pose track: pf_slam's per-step map extension is exactly the reference
    per-scan update (modules/ogm.py:149-188) applied at the filtered
    estimates, nothing more."""
    cfg_map, gt, counts, gyro, pts, masks, K = world
    n = 64  # enough steps to exercise resampling; keeps the test cheap
    cfg = PFConfig(n_particles=64)
    poses, logodds, _ = pf_slam.slam_particle_filter(
        counts[:n], gyro[:n], pts[:n], masks[:n], cfg_map, cfg,
        x0=gt[0], K=K)
    rebuilt = occupancy.build_logodds(poses, pts[:n], masks[:n], cfg_map, K)
    np.testing.assert_array_equal(np.asarray(logodds), np.asarray(rebuilt))


def test_streaming_matches_batch(world):
    """slam_particle_filter is exactly lax.scan over pf_slam_step: feeding
    the same log step-by-step must reproduce the batch track and map."""
    cfg_map, gt, counts, gyro, pts, masks, K = world
    n = 40
    cfg = PFConfig(n_particles=32)
    poses_b, lo_b, aux_b = pf_slam.slam_particle_filter(
        counts[:n], gyro[:n], pts[:n], masks[:n], cfg_map, cfg,
        x0=gt[0], K=K)

    state = pf_slam.init_pf_slam(pts[0], masks[0], cfg_map, cfg,
                                 x0=gt[0], K=K)
    ests = [np.asarray(gt[0])]
    for i in range(1, n):
        state, (est, neff, rs) = pf_slam.pf_slam_step(
            state, counts[i], gyro[i], pts[i], masks[i], cfg_map, cfg, K)
        ests.append(np.asarray(est))
    np.testing.assert_allclose(np.stack(ests), np.asarray(poses_b),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(state.logodds), np.asarray(lo_b),
                               atol=1e-5)
    assert int(state.step) == n


def test_bounds_biased_odometry_drift(world):
    """15% encoder-scale bias, NO prior map: dead reckoning drifts ~0.30 m
    by the end; scoring against the self-built causal map halves the drift
    (measured mean 0.073 vs 0.140, final 0.141 vs 0.295)."""
    cfg_map, gt, counts, gyro, pts, masks, K = world
    biased = counts * 1.15
    odo = odometry.poses_from_odometry(biased, gyro, x_0=gt[0])
    err_odo = _pos_err(odo, gt)
    assert err_odo[-1] > 0.25  # the bias really does break dead reckoning

    cfg = PFConfig(n_particles=128)
    poses, logodds, aux = pf_slam.slam_particle_filter(
        biased, gyro, pts, masks, cfg_map, cfg, x0=gt[0], K=K)
    err = _pos_err(poses, gt)
    assert err.mean() < 0.10          # measured 0.073
    assert err[-1] < 0.20             # measured 0.141
    assert err.mean() < 0.75 * err_odo.mean()
    assert bool(np.asarray(aux["resampled"]).any())  # the filter worked
    assert int((np.asarray(logodds) > 0).sum()) > 100  # and really mapped
