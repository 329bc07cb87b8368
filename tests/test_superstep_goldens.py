import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

REF_OUT = "/root/reference/outputs"


def test_superstep_on_cpu_mesh():
    """The fused multi-device SLAM step runs and produces finite outputs on
    the virtual 8-device mesh (the same path dryrun_multichip exercises)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from lidar_slam.config import IcpConfig, MapConfig, PoseGraphConfig
    from lidar_slam.models.occupancy import max_ray_cells
    from lidar_slam.parallel.mesh import make_mesh
    from lidar_slam.parallel.superstep import make_slam_step

    mesh = make_mesh(8, axes=("dp", "rp"))
    map_cfg = MapConfig(resolution=0.2, world_max_x=6, world_min_x=-6,
                        world_max_y=6, world_min_y=-6)
    K = max_ray_cells(map_cfg, 6.0)
    step = make_slam_step(mesh, map_cfg, K, IcpConfig(),
                          PoseGraphConfig(max_lm_iters=2, cg_iters=20))

    rng = np.random.default_rng(0)
    N, R = 8, 16 * int(mesh.shape["rp"])
    ang = rng.uniform(-np.pi, np.pi, (N, R))
    r = rng.uniform(0.3, 5.0, (N, R))
    points = jnp.asarray(np.stack([r * np.cos(ang), r * np.sin(ang),
                                   np.zeros_like(r)], axis=-1), jnp.float64)
    masks = jnp.ones((N, R), bool)
    odom = jnp.asarray(np.cumsum(rng.normal(0, 0.02, (N, 3)), axis=0))
    logodds = jnp.zeros((map_cfg.width, map_cfg.height), jnp.float32)

    out = step(points, masks, odom, logodds)
    assert out.poses.shape == (N, 3)
    assert np.isfinite(np.asarray(out.poses)).all()
    assert np.isfinite(np.asarray(out.logodds)).all()
    assert float(jnp.abs(out.logodds).sum()) > 0


def test_superstep_map_matches_single_device_build():
    """The step's ray-sharded map (psum of per-shard scatter deltas on the
    'rp' axis) equals the single-device build at the step's own poses."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from lidar_slam.config import IcpConfig, MapConfig, PoseGraphConfig
    from lidar_slam.models.occupancy import build_logodds, max_ray_cells
    from lidar_slam.parallel.mesh import make_mesh
    from lidar_slam.parallel.superstep import make_slam_step

    mesh = make_mesh(8, axes=("dp", "rp"))
    map_cfg = MapConfig(resolution=0.2, world_max_x=6, world_min_x=-6,
                        world_max_y=6, world_min_y=-6)
    K = max_ray_cells(map_cfg, 6.0)
    pg = PoseGraphConfig(max_lm_iters=2, cg_iters=20)

    rng = np.random.default_rng(3)
    N, R = 8, 16 * int(mesh.shape["rp"])
    ang = rng.uniform(-np.pi, np.pi, (N, R))
    r = rng.uniform(0.3, 5.0, (N, R))
    points = jnp.asarray(np.stack([r * np.cos(ang), r * np.sin(ang),
                                   np.zeros_like(r)], axis=-1), jnp.float32)
    masks = jnp.ones((N, R), bool)
    odom = jnp.asarray(np.cumsum(rng.normal(0, 0.02, (N, 3)), axis=0),
                       jnp.float32)
    logodds = jnp.zeros((map_cfg.width, map_cfg.height), jnp.float32)

    out = make_slam_step(mesh, map_cfg, K, IcpConfig(), pg)(
        points, masks, odom, logodds)
    ref = build_logodds(out.poses, points[..., :2], masks, map_cfg, K,
                        init=logodds)
    np.testing.assert_allclose(np.asarray(out.logodds), np.asarray(ref),
                               atol=1e-5)
    assert float(jnp.abs(ref).sum()) > 0


def test_transform_scans_to_world():
    from lidar_slam.ops.scan import transform_scans_to_world
    rng = np.random.default_rng(1)
    poses = rng.normal(size=(4, 3))
    pts = rng.normal(size=(4, 10, 2))
    got = np.asarray(transform_scans_to_world(jnp.asarray(poses), jnp.asarray(pts)))
    for i in range(4):
        c, s = np.cos(poses[i, 2]), np.sin(poses[i, 2])
        want = pts[i] @ np.array([[c, -s], [s, c]]).T + poses[i, :2]
        np.testing.assert_allclose(got[i], want, atol=1e-10)


@pytest.mark.skipif(not os.path.exists(REF_OUT), reason="reference goldens unavailable")
def test_reference_golden_artifacts_are_loadable():
    """The committed dataset-20 artifacts are the accuracy goldens
    (SURVEY.md section 6); verify our persistence layer reads them and our
    pipeline types accept their shapes."""
    from lidar_slam.utils import io, se2

    poses = io.load_numpy(os.path.join(REF_OUT, "poses_odom_20.npy"))
    assert poses.shape == (4956, 3)
    rel = io.load_numpy(os.path.join(REF_OUT, "relative_poses_odom_20.npy"))
    assert rel.shape == (4955, 3, 3)
    opt = io.load_numpy(os.path.join(REF_OUT, "poses_optimized_20.npy"))
    assert opt.shape == (4956, 3)

    # relative poses compose consistently with the absolute trajectory
    T = np.asarray(se2.T_from_pose(jnp.asarray(poses)))
    recomposed = T[:-1] @ rel
    np.testing.assert_allclose(recomposed[:, :2, 2], poses[1:, :2], atol=1e-6)

    # our pose-graph layer accepts the golden relative poses directly
    from lidar_slam.models import pose_graph
    g = pose_graph.make_graph(jnp.asarray(rel[:100]))
    cost = float(pose_graph.graph_cost(jnp.asarray(poses[:101]), g))
    assert np.isfinite(cost)


def test_superstep_matches_unsharded_pipeline():
    """Parity: the fused multi-device step equals the SAME math composed
    unsharded at identical iteration caps (poses near-exact; the map's
    psum groups ray contributions by shard, so log-odds agree to float
    tolerance and the thresholded uint8 maps exactly)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from lidar_slam.config import IcpConfig, MapConfig, PoseGraphConfig
    from lidar_slam.models import occupancy, pose_graph
    from lidar_slam.models.occupancy import max_ray_cells
    from lidar_slam.ops.icp import run_icp_batch
    from lidar_slam.parallel.mesh import make_mesh
    from lidar_slam.parallel.superstep import make_slam_step
    from lidar_slam.utils import se2

    mesh = make_mesh(8, axes=("dp", "rp"))
    map_cfg = MapConfig(resolution=0.2, world_max_x=6, world_min_x=-6,
                        world_max_y=6, world_min_y=-6)
    K = max_ray_cells(map_cfg, 6.0)
    icp_cfg = IcpConfig(max_iters=64)
    pg_cfg = PoseGraphConfig(max_lm_iters=3, cg_iters=25)
    step = make_slam_step(mesh, map_cfg, K, icp_cfg, pg_cfg)

    rng = np.random.default_rng(3)
    N, R = 8, 16 * int(mesh.shape["rp"])
    ang = rng.uniform(-np.pi, np.pi, (N, R))
    r = rng.uniform(0.3, 5.0, (N, R))
    points = jnp.asarray(np.stack([r * np.cos(ang), r * np.sin(ang),
                                   np.zeros_like(r)], axis=-1), jnp.float32)
    masks = jnp.asarray(rng.random((N, R)) > 0.05)
    odom = jnp.asarray(np.cumsum(rng.normal(0, 0.02, (N, 3)), axis=0),
                       jnp.float32)
    logodds = jnp.zeros((map_cfg.width, map_cfg.height), jnp.float32)

    out = step(points, masks, odom, logodds)

    # unsharded composition of the same stages at the same caps
    seeds3 = se2.TSE3_from_TSE2(se2.get_relative_pose(odom[:-1], odom[1:]))
    res = run_icp_batch(points[1:], points[:-1], masks[1:], masks[:-1],
                        seeds3, epsilon=icp_cfg.epsilon,
                        max_iters=icp_cfg.max_iters,
                        stopping_thresh=icp_cfg.stopping_thresh, planar=True)
    rel2 = se2.TSE2_from_TSE3(res.T)
    poses0 = se2.pose_from_T(se2.compose_chain(rel2, se2.T_from_pose(odom[0])))
    graph = pose_graph.make_graph(rel2, pg_cfg, prior_pose=odom[0])
    opt = pose_graph.optimize(poses0, graph, max_iters=pg_cfg.max_lm_iters,
                              cg_iters=pg_cfg.cg_iters,
                              lambda_init=pg_cfg.lambda_init,
                              lambda_up=pg_cfg.lambda_up,
                              lambda_down=pg_cfg.lambda_down)
    grid = occupancy.build_logodds(opt.poses, points[..., :2], masks,
                                   map_cfg, K, init=logodds)

    np.testing.assert_allclose(np.asarray(out.poses), np.asarray(opt.poses),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.icp_errors),
                               np.asarray(res.error), atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.logodds), np.asarray(grid),
                               atol=1e-4)
    np.testing.assert_array_equal(
        np.asarray(occupancy.finalize_grid(out.logodds)),
        np.asarray(occupancy.finalize_grid(grid)))
