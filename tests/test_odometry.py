import numpy as np
import jax.numpy as jnp

from lidar_slam.models import odometry
from lidar_slam.utils import io


def _np_motion_model(pose, v, w, dt):
    """Independent numpy re-derivation of the reference motion model
    (reference semantics: modules/localization.py:15-36)."""
    dtheta = w[-1] * dt
    x, y, theta = pose
    sinc = np.sin(dtheta / 2) / (dtheta / 2) if dtheta != 0 else 1.0
    x = x + v * dt * sinc * np.cos(theta + dtheta / 2)
    y = y + v * dt * sinc * np.sin(theta + dtheta / 2)
    return np.array([x, y, theta + dtheta])


def _np_v_from_encoder(counts):
    dr = (counts[0] + counts[2]) / 2 * 0.0022
    dl = (counts[1] + counts[3]) / 2 * 0.0022
    return (dr + dl) / 2 * 40


def test_v_from_encoder():
    rng = np.random.default_rng(0)
    counts = rng.normal(size=(50, 4)) * 10
    got = np.asarray(odometry.v_from_encoder(jnp.asarray(counts)))
    want = np.array([_np_v_from_encoder(c) for c in counts])
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_motion_model_single_step():
    pose = np.array([1.0, -0.5, 0.3])
    v = 0.4
    w = np.array([0.0, 0.0, 0.2])
    got = np.asarray(odometry.diff_drive_motion_model(
        jnp.asarray(pose), jnp.asarray(v), jnp.asarray(w), 0.025))
    want = _np_motion_model(pose, v, w, 0.025)
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_poses_from_odometry_matches_sequential_numpy():
    rng = np.random.default_rng(1)
    n = 200
    counts = rng.normal(size=(n, 4)) * 5 + 10
    gyro = rng.normal(size=(n, 3)) * 0.1 + 0.01
    dt = 1.0 / 40.0

    got, got_rel = odometry.poses_from_odometry(
        jnp.asarray(counts), jnp.asarray(gyro), return_relative_poses=True)
    got = np.asarray(got)

    # sequential numpy reference
    poses = [np.zeros(3)]
    for i in range(1, n):
        v = _np_v_from_encoder(counts[i])
        poses.append(_np_motion_model(poses[-1], v, gyro[i], dt))
    want = np.stack(poses)
    np.testing.assert_allclose(got, want, atol=1e-9)

    # relative poses satisfy T_i @ rel_i == T_{i+1}
    got_rel = np.asarray(got_rel)
    assert got_rel.shape == (n - 1, 3, 3)
    for i in range(0, n - 1, 37):
        Ti = np.array([
            [np.cos(want[i, 2]), -np.sin(want[i, 2]), want[i, 0]],
            [np.sin(want[i, 2]), np.cos(want[i, 2]), want[i, 1]],
            [0, 0, 1],
        ])
        Tn = Ti @ got_rel[i]
        np.testing.assert_allclose(Tn[0, 2], want[i + 1, 0], atol=1e-9)
        np.testing.assert_allclose(Tn[1, 2], want[i + 1, 1], atol=1e-9)


def test_zero_gyro_is_finite():
    counts = np.ones((10, 4))
    gyro = np.zeros((10, 3))
    poses = np.asarray(odometry.poses_from_odometry(jnp.asarray(counts), jnp.asarray(gyro)))
    assert np.all(np.isfinite(poses))
    # pure translation along x
    np.testing.assert_allclose(poses[:, 1], 0.0, atol=1e-12)
    np.testing.assert_allclose(poses[:, 2], 0.0, atol=1e-12)


def test_odometry_tracks_synthetic_ground_truth():
    data = io.synthetic_dataset(n_steps=800, seed=3)
    poses = np.asarray(odometry.poses_from_odometry(
        jnp.asarray(data["encoder"]["counts"]), jnp.asarray(data["imu"]["angular_velocity"])))
    gt = data["ground_truth"]
    err = np.linalg.norm(poses[:, :2] - gt[:, :2], axis=1)
    assert err.mean() < 0.5  # noisy encoders, but should roughly track


def test_gates():
    rng = np.random.default_rng(2)
    counts = rng.normal(size=(100, 4))
    gyro = rng.normal(size=(100, 3))
    md, my = odometry.max_step_gates(jnp.asarray(counts), jnp.asarray(gyro))
    want_md = np.max((counts[:, 0] * 0.0022 + counts[:, 1] * 0.0022) / 2)
    want_my = np.rad2deg(np.max(np.abs(gyro), axis=0)[2] / 40.0)
    np.testing.assert_allclose(float(md), want_md, atol=1e-12)
    np.testing.assert_allclose(float(my), want_my, atol=1e-12)
