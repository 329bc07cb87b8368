import numpy as np
import jax.numpy as jnp

from lidar_slam.utils import se2


def _np_T_from_pose(pose):
    x, y, th = pose
    return np.array([
        [np.cos(th), -np.sin(th), x],
        [np.sin(th), np.cos(th), y],
        [0, 0, 1.0],
    ])


def test_T_from_pose_matches_numpy():
    rng = np.random.default_rng(0)
    poses = rng.normal(size=(16, 3))
    got = np.asarray(se2.T_from_pose(jnp.asarray(poses)))
    want = np.stack([_np_T_from_pose(p) for p in poses])
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_pose_from_T_roundtrip():
    rng = np.random.default_rng(1)
    poses = rng.normal(size=(32, 3))
    poses[:, 2] = rng.uniform(-np.pi + 1e-6, np.pi - 1e-6, 32)
    rt = np.asarray(se2.pose_from_T(se2.T_from_pose(jnp.asarray(poses))))
    np.testing.assert_allclose(rt, poses, atol=1e-10)


def test_se2_se3_roundtrip():
    rng = np.random.default_rng(2)
    poses = rng.normal(size=(8, 3))
    T2 = se2.T_from_pose(jnp.asarray(poses))
    T3 = se2.TSE3_from_TSE2(T2)
    back = se2.TSE2_from_TSE3(T3)
    np.testing.assert_allclose(np.asarray(back), np.asarray(T2), atol=1e-12)
    # SE(3) lift has zero z and identity lower-right block
    T3 = np.asarray(T3)
    np.testing.assert_allclose(T3[:, 2, :], np.tile([0, 0, 1, 0], (8, 1)), atol=0)
    np.testing.assert_allclose(T3[:, 3, :], np.tile([0, 0, 0, 1], (8, 1)), atol=0)


def test_inverse_T():
    rng = np.random.default_rng(3)
    poses = rng.normal(size=(8, 3))
    T = se2.T_from_pose(jnp.asarray(poses))
    I = np.asarray(T @ se2.inverse_T(T))
    np.testing.assert_allclose(I, np.tile(np.eye(3), (8, 1, 1)), atol=1e-12)


def test_get_relative_pose_matches_numpy():
    rng = np.random.default_rng(4)
    p1 = rng.normal(size=(8, 3))
    p2 = rng.normal(size=(8, 3))
    got = np.asarray(se2.get_relative_pose(jnp.asarray(p1), jnp.asarray(p2)))
    for i in range(8):
        want = np.linalg.inv(_np_T_from_pose(p1[i])) @ _np_T_from_pose(p2[i])
        np.testing.assert_allclose(got[i], want, atol=1e-10)


def test_transform_points_2d_3d():
    rng = np.random.default_rng(5)
    pts2 = rng.normal(size=(10, 2))
    pose = np.array([0.3, -0.2, 0.7])
    T = se2.T_from_pose(jnp.asarray(pose))
    got = np.asarray(se2.transform_points(jnp.asarray(pts2), T))
    Tn = _np_T_from_pose(pose)
    hom = np.hstack([pts2, np.ones((10, 1))])
    want = (Tn @ hom.T).T[:, :2]
    np.testing.assert_allclose(got, want, atol=1e-12)

    # 3-D through an SE(3) lift
    pts3 = rng.normal(size=(10, 3))
    T3 = se2.TSE3_from_TSE2(T)
    got3 = np.asarray(se2.transform_points(jnp.asarray(pts3), T3))
    T3n = np.asarray(T3)
    hom3 = np.hstack([pts3, np.ones((10, 1))])
    want3 = (T3n @ hom3.T).T[:, :3]
    np.testing.assert_allclose(got3, want3, atol=1e-12)


def test_compose_chain_matches_sequential():
    rng = np.random.default_rng(6)
    rel_poses = rng.normal(size=(20, 3)) * 0.1
    rel_T = se2.T_from_pose(jnp.asarray(rel_poses))
    got = np.asarray(se2.compose_chain(rel_T))
    acc = np.eye(3)
    seq = [acc]
    for i in range(20):
        acc = acc @ np.asarray(rel_T)[i]
        seq.append(acc)
    np.testing.assert_allclose(got, np.stack(seq), atol=1e-10)
