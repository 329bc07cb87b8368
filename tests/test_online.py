"""Online (streaming) SLAM parity with the offline batch pipeline.

The online step replicates the offline stages' math exactly (the ICP seed
comes from consecutive odometry poses and the refined pose composes onto
the refined chain — models/online.py docstring), so feeding the same log
step-by-step must reproduce poses_from_scan_matching, and the causal map
must equal build_logodds over the same (causal) trajectory.
"""

import numpy as np
import jax.numpy as jnp

from lidar_slam.config import SlamConfig
from lidar_slam.models import occupancy, odometry, online, scan_matching
from lidar_slam.ops import scan as scan_ops
from lidar_slam.utils import io

CFG = SlamConfig()
N, R, K = 30, 120, 200


def _log(seed):
    data = io.synthetic_dataset(n_steps=N, n_rays=R, seed=seed)
    counts = jnp.asarray(data["encoder"]["counts"], jnp.float32)
    gyro = jnp.asarray(data["imu"]["angular_velocity"], jnp.float32)
    ranges = jnp.asarray(data["lidar"]["ranges"], jnp.float32)
    points, masks = scan_ops.scans_to_points(ranges, 0.1, 30.0, CFG.lidar)
    return counts, gyro, points, masks


def _run_online(counts, gyro, points, masks):
    st = online.init_state(points[0], masks[0], CFG, n_max=64, K=K)
    for t in range(1, N):
        st = online.online_step(st, counts[t], gyro[t], points[t],
                                masks[t], CFG, K=K)
    return st


def test_online_pose_track_matches_offline_scan_matching():
    counts, gyro, points, masks = _log(0)
    st = _run_online(counts, gyro, points, masks)

    poses_odom = odometry.poses_from_odometry(counts, gyro)
    sm = scan_matching.poses_from_scan_matching(poses_odom, points, masks,
                                                CFG.icp, chunk_size=8)
    track = np.asarray(st.poses_hist[:N])
    np.testing.assert_allclose(track, np.asarray(sm.poses), atol=2e-4)
    np.testing.assert_allclose(np.asarray(st.pose),
                               np.asarray(sm.poses[-1]), atol=2e-4)
    # relative-pose history matches too (ring layout: step s's incoming
    # relative transform lives at slot s)
    np.testing.assert_allclose(np.asarray(st.rel_hist[1:N]),
                               np.asarray(sm.relative_poses), atol=2e-4)


def test_online_causal_map_matches_batch_over_same_track():
    counts, gyro, points, masks = _log(1)
    st = _run_online(counts, gyro, points, masks)
    # the causal trajectory is frozen as each pose is estimated, so the
    # batch rasterizer over that same trajectory must agree
    track = st.poses_hist[:N]
    want = occupancy.build_logodds(track, points[..., :2], masks, CFG.map,
                                   K)
    np.testing.assert_allclose(np.asarray(st.logodds), np.asarray(want),
                               atol=1e-4)
    assert (np.asarray(st.logodds) != 0).sum() > 200


def test_online_refine_smooths_trajectory():
    counts, gyro, points, masks = _log(2)
    st = _run_online(counts, gyro, points, masks)
    refined = online.refine(st, CFG)
    assert refined.shape == (N, 3)
    assert np.isfinite(refined).all()
    # between-factors-only refinement stays near the measured chain
    track = np.asarray(st.poses_hist[:N])
    assert np.abs(refined - track).max() < 0.5


def test_online_sliding_window_past_capacity():
    """Past n_max steps the ring buffers retain the most recent n_max
    steps; refine() reconstructs the chronological window, anchors its
    head at the online posterior (the marginalized prior), and returns a
    smoothed copy covering [window_start, step] (round-3: replaces the
    round-2 stale-prefix behavior)."""
    counts, gyro, points, masks = _log(3)
    n_max = 8
    st = online.init_state(points[0], masks[0], CFG, n_max=n_max, K=K)
    all_poses = [np.asarray(st.pose)]
    for t in range(1, 20):
        st = online.online_step(st, counts[t], gyro[t], points[t],
                                masks[t], CFG, K=K)
        all_poses.append(np.asarray(st.pose))
    assert int(st.step) == 19
    assert online.window_start(st) == 12  # steps 12..19 retained

    # the stored ring holds exactly the LAST n_max online poses
    order = (12 + np.arange(n_max)) % n_max
    window = np.asarray(st.poses_hist)[order]
    np.testing.assert_allclose(window, np.stack(all_poses[12:]), atol=1e-6)

    refined = online.refine(st, CFG)
    assert refined.shape == (n_max, 3)
    assert np.isfinite(refined).all()
    # head anchored at its posterior estimate (the marginalized prior);
    # a consistent chain means the window barely moves
    np.testing.assert_allclose(refined[0], all_poses[12], atol=0.05)
    assert np.abs(refined - window).max() < 0.5

    # refine with the window's scans (chronological, extra leading entries
    # ignored) exercises the loop-closure path past capacity
    CFG_SHORT = CFG  # fixed_interval=10 > window; between factors only
    refined2 = online.refine(st, CFG_SHORT, scans=points[:20],
                             scan_masks=masks[:20])
    assert refined2.shape == (n_max, 3)


def test_online_refine_loops_past_capacity():
    """A window larger than the loop interval, past capacity: refine()
    adds window-relative fixed-interval loop closures from the caller's
    (windowed) scans and stays consistent with the stored track."""
    counts, gyro, points, masks = _log(6)
    n_max = 24  # > fixed_interval + 1, < N
    st = online.init_state(points[0], masks[0], CFG, n_max=n_max, K=K)
    for t in range(1, N):
        st = online.online_step(st, counts[t], gyro[t], points[t],
                                masks[t], CFG, K=K)
    start = online.window_start(st)
    assert start == N - n_max
    refined = online.refine(st, CFG, scans=points[start:],
                            scan_masks=masks[start:])
    assert refined.shape == (n_max, 3)
    order = (start + np.arange(n_max)) % n_max
    window = np.asarray(st.poses_hist)[order]
    assert np.abs(refined - window).max() < 0.5


def test_online_refine_with_loops_and_x0():
    """refine() with the caller's scan history adds gated fixed-interval
    loop closures, and a non-zero start pose anchors the prior at the
    trajectory START (round-2 review: it was snapped to the origin)."""
    counts, gyro, points, masks = _log(4)
    x0 = jnp.asarray([5.0, -2.0, 0.3])
    st = online.init_state(points[0], masks[0], CFG, n_max=64, K=K, x0=x0)
    for t in range(1, N):
        st = online.online_step(st, counts[t], gyro[t], points[t],
                                masks[t], CFG, K=K)
    refined = online.refine(st, CFG, scans=points, scan_masks=masks)
    track = np.asarray(st.poses_hist[:N])
    assert refined.shape == (N, 3)
    # anchored at the start pose, not the origin
    np.testing.assert_allclose(refined[0], np.asarray(x0), atol=0.05)
    assert np.abs(refined - track).max() < 0.5


def test_online_refine_validates_scan_inputs():
    """refine() with scans must reject a missing/short scan_masks with a
    clear error instead of an opaque downstream failure (round-3 review)."""
    import pytest

    counts, gyro, points, masks = _log(7)
    st = online.init_state(points[0], masks[0], CFG, n_max=64, K=K)
    for t in range(1, N):
        st = online.online_step(st, counts[t], gyro[t], points[t],
                                masks[t], CFG, K=K)
    with pytest.raises(ValueError, match="scan_masks"):
        online.refine(st, CFG, scans=points)
    with pytest.raises(ValueError, match="scans"):
        online.refine(st, CFG, scans=points[:5], scan_masks=masks[:5])
    with pytest.raises(ValueError, match="masks"):
        online.refine(st, CFG, scans=points, scan_masks=masks[:5])


def test_online_checkpoint_resume(tmp_path):
    """A restored checkpoint continues the stream with results identical
    to the uninterrupted run (serving-mode elastic recovery)."""
    counts, gyro, points, masks = _log(5)
    st = online.init_state(points[0], masks[0], CFG, n_max=64, K=K)
    for t in range(1, 15):
        st = online.online_step(st, counts[t], gyro[t], points[t],
                                masks[t], CFG, K=K)
    p = tmp_path / "ckpt.npz"
    online.save_state(str(p), st)
    st_resumed = online.load_state(str(p))
    for t in range(15, N):
        st = online.online_step(st, counts[t], gyro[t], points[t],
                                masks[t], CFG, K=K)
        st_resumed = online.online_step(st_resumed, counts[t], gyro[t],
                                        points[t], masks[t], CFG, K=K)
    np.testing.assert_array_equal(np.asarray(st.pose),
                                  np.asarray(st_resumed.pose))
    np.testing.assert_array_equal(np.asarray(st.logodds),
                                  np.asarray(st_resumed.logodds))
    np.testing.assert_array_equal(np.asarray(st.poses_hist),
                                  np.asarray(st_resumed.poses_hist))


def _se2_T(pose):
    c, s = np.cos(pose[2]), np.sin(pose[2])
    return np.array([[c, -s, pose[0]], [s, c, pose[1]], [0, 0, 1.0]])


def _se2_pose(T):
    return np.array([T[0, 2], T[1, 2], np.arctan2(T[1, 0], T[0, 0])])


def _kidnap_log(n=400, t_kidnap=300, t_target=70, n_rays=541, seed=0):
    """A stream whose robot is TELEPORTED at step t_kidnap back to its
    step-t_target location (already mapped), while encoders/gyro keep
    reporting the continuous motion — the kidnapped-robot scenario.
    Scans before/after the jump are raycast against the SAME room (one
    _raycast_room call over both trajectories fixes the walls/pillars)."""
    rng = np.random.default_rng(seed)
    freq = 40.0
    dt = 1.0 / freq
    t = np.arange(n) * dt
    v = np.full(n, 0.8)
    w = np.full(n, 0.25)  # steady arc: large heading change over the run
    theta = np.cumsum(w * dt)
    gt = np.stack([np.cumsum(v * dt * np.cos(theta)),
                   np.cumsum(v * dt * np.sin(theta)), theta], axis=1)
    # rigid remap of the tail: pose t_kidnap lands exactly on pose t_target
    T_off = _se2_T(gt[t_target]) @ np.linalg.inv(_se2_T(gt[t_kidnap]))
    gt2 = gt.copy()
    for i in range(t_kidnap, n):
        gt2[i] = _se2_pose(T_off @ _se2_T(gt[i]))
    angles = np.linspace(np.radians(-135.0), np.radians(135.0), n_rays)
    ranges_all = io._raycast_room(np.concatenate([gt, gt2]), angles, 30.0,
                                  rng)
    ranges = np.where(np.arange(n)[:, None] < t_kidnap,
                      ranges_all[:n], ranges_all[n:])
    counts = np.stack([v / (0.0022 * freq)] * 4, axis=1)
    counts += rng.normal(0, 0.05, counts.shape)
    gyro = np.zeros((n, 3))
    gyro[:, 2] = w + rng.normal(0, 2e-3, n)
    return counts, gyro, ranges, gt2


def test_online_kidnapped_robot_recovers():
    """Mid-stream kidnap: the loss gate fires (coast, no map paint),
    relocalize_and_reseed recovers the pose to <5 cm against the causal
    map, and the stream continues tracking the post-kidnap trajectory
    (round-3 review item 3: relocalization wired into serving).

    Tracking uses PLICP: the scenario drives a constant arc, where
    point-to-point ICP's nearest-sample bias accumulates meters of drift
    over 300 steps (measured: 2.6 m / 0.7 rad) and the causal map frame
    then diverges from ground truth before the kidnap even happens;
    point_to_line tracks the same log to ~2 cm. The candidate polish is
    what makes the recovery itself robust: this room's correlative hit
    counts alias (the score-best grid node sits 7 m from the true pose),
    and the error-ranked batched ICP over the top-8 NMS'd candidates
    separates true (err ~3e-6) from alias (~1e-3) by 2.5 orders."""
    import dataclasses

    from lidar_slam.config import MapConfig, OnlineConfig

    n, t_kidnap = 400, 300
    counts, gyro, ranges, gt2 = _kidnap_log(n=n, t_kidnap=t_kidnap)
    cfg = dataclasses.replace(
        CFG,
        map=MapConfig(resolution=0.1, world_min_x=-15.0, world_max_x=15.0,
                      world_min_y=-15.0, world_max_y=15.0),
        icp=dataclasses.replace(CFG.icp, metric="point_to_line"),
        online=OnlineConfig(loss_rms_thresh=0.3))
    counts = jnp.asarray(counts, jnp.float32)
    gyro = jnp.asarray(gyro, jnp.float32)
    points, masks = scan_ops.scans_to_points(
        jnp.asarray(ranges, jnp.float32), 0.1, 30.0, cfg.lidar)
    k = online.default_ray_cells(cfg, 30.0)

    st = online.init_state(points[0], masks[0], cfg, n_max=512, K=k)
    recovered_at = None
    for t in range(1, n):
        st = online.online_step(st, counts[t], gyro[t], points[t],
                                masks[t], cfg, K=k)
        rms = float(st.match_rms)
        if rms > cfg.online.loss_rms_thresh:
            assert t == t_kidnap, (
                f"loss gate fired at step {t} (rms {rms:.3f}), expected "
                f"only at the kidnap step {t_kidnap}")
            pose_before = np.asarray(st.pose)
            st, grid_res, icp_err = online.relocalize_and_reseed(
                st, cfg, K=k)
            recovered_at = t
            # the coasted pose was far off; recovery must land <5 cm
            # from the true post-kidnap pose
            err_pos = np.hypot(*(np.asarray(st.pose)[:2] - gt2[t, :2]))
            err_yaw = abs((float(st.pose[2]) - gt2[t, 2] + np.pi)
                          % (2 * np.pi) - np.pi)
            assert err_pos < 0.05, (err_pos, np.asarray(st.pose), gt2[t])
            assert err_yaw < 0.03
            # it really was a kidnap: the pre-recovery estimate was far out
            assert np.hypot(*(pose_before[:2] - gt2[t, :2])) > 0.5
    assert recovered_at == t_kidnap, "loss gate never fired"
    # the stream continued and still tracks the post-kidnap trajectory
    final_err = np.hypot(*(np.asarray(st.pose)[:2] - gt2[-1, :2]))
    assert final_err < 0.15, final_err
    # history stays refinable across the jump (the reseed writes the
    # estimated teleport as the slot's between factor)
    refined = online.refine(st, cfg)
    assert np.all(np.isfinite(refined))
