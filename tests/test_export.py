"""Interop exports: ROS map_server PGM/YAML and TUM trajectories.

Round-trip and orientation tests for lidar_slam/utils/export.py, plus
one CLI pass exercising --export_ros_map / --export_tum end to end.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from lidar_slam.config import MapConfig
from lidar_slam.models import occupancy
from lidar_slam.utils import export

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def small_cfg():
    return MapConfig(resolution=0.5, world_max_x=2.0, world_max_y=3.0,
                     world_min_x=-2.0, world_min_y=-3.0)


def test_ros_image_trinary_and_orientation():
    cfg = small_cfg()
    lo = np.zeros((cfg.width, cfg.height), np.float32)
    # occupied at grid (1, 2), free at grid (3, 0); everything else unknown
    lo[1, 2] = 4.0   # p_occ = sigmoid(4) = 0.982 > 0.65
    lo[3, 0] = -4.0  # p_occ = 0.018 < 0.196
    img = export.map_to_ros_image(lo)
    H = cfg.height
    assert img.shape == (cfg.height, cfg.width)
    # image[row, col] = grid[col, H-1-row]  =>  row = H-1-j, col = i
    assert img[H - 1 - 2, 1] == 0       # occupied -> black
    assert img[H - 1 - 0, 3] == 254     # free -> near-white
    assert img[0, 0] == 205             # unobserved -> unknown gray
    # a weak hit between the thresholds stays unknown
    lo2 = lo.copy()
    lo2[2, 2] = 0.3  # p_occ = 0.574, between 0.196 and 0.65
    assert export.map_to_ros_image(lo2)[H - 1 - 2, 2] == 205


def test_ros_map_roundtrip(tmp_path):
    cfg = small_cfg()
    rng = np.random.default_rng(0)
    lo = rng.normal(0, 5, (cfg.width, cfg.height)).astype(np.float32)
    stem = str(tmp_path / "map")
    pgm, yml = export.save_map_ros(lo, cfg, stem)
    img, meta = export.load_map_ros(yml)
    assert meta["resolution"] == cfg.resolution
    assert meta["origin"][:2] == [cfg.world_min_x, cfg.world_min_y]
    assert meta["negate"] == 0
    np.testing.assert_array_equal(img, export.map_to_ros_image(lo))
    # orientation inverse recovers the grid layout
    np.testing.assert_array_equal(export.ros_image_to_grid(img),
                                  export.map_to_ros_image(lo)[::-1].T)


def test_ros_origin_is_world_min_corner():
    # world2grid(world_min + eps) = cell 0: the YAML origin (lower-left
    # pixel pose) must be the world-min corner for nav stacks to place
    # the map where the SLAM poses are
    cfg = small_cfg()
    i, j = occupancy.world2grid(np.float32(cfg.world_min_x + 1e-3),
                                np.float32(cfg.world_min_y + 1e-3), cfg)
    assert int(i) == 0 and int(j) == 0


def test_tum_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    n = 37
    poses = np.stack([rng.normal(0, 5, n), rng.normal(0, 5, n),
                      rng.uniform(-np.pi + 1e-3, np.pi - 1e-3, n)], -1)
    stamps = np.cumsum(rng.uniform(0.01, 0.05, n)) + 1e9
    path = str(tmp_path / "traj.tum")
    export.save_trajectory_tum(path, poses, stamps)
    s2, p2 = export.load_trajectory_tum(path)
    np.testing.assert_allclose(s2, stamps, rtol=0, atol=5e-7)
    np.testing.assert_allclose(p2[:, :2], poses[:, :2], atol=1e-8)
    dyaw = np.angle(np.exp(1j * (p2[:, 2] - poses[:, 2])))
    np.testing.assert_allclose(dyaw, 0, atol=1e-8)


def test_tum_default_stamps(tmp_path):
    poses = np.zeros((5, 3))
    path = str(tmp_path / "t.tum")
    export.save_trajectory_tum(path, poses)
    s, p = export.load_trajectory_tum(path)
    np.testing.assert_array_equal(s, np.arange(5.0))
    assert p.shape == (5, 3)


def test_quaternion_matches_yaw():
    yaws = np.linspace(-np.pi, np.pi, 17)
    q = export.yaw_to_quaternion(yaws)
    np.testing.assert_allclose(np.linalg.norm(q, axis=-1), 1.0, atol=1e-12)
    # rotate +x by the quaternion, compare against the 2-D rotation
    x = 1.0 - 2.0 * (q[:, 1] ** 2 + q[:, 2] ** 2)
    y = 2.0 * (q[:, 0] * q[:, 1] + q[:, 2] * q[:, 3])
    np.testing.assert_allclose(x, np.cos(yaws), atol=1e-12)
    np.testing.assert_allclose(y, np.sin(yaws), atol=1e-12)


@pytest.mark.slow
def test_cli_export_flags(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    args = ["--mode", "scan_matching", "--synthetic", "30", "--res", "0.2",
            "--width", "30", "--height", "30",
            "--output_dir", str(tmp_path / "outputs"),
            "--export_ros_map", str(tmp_path / "rosmap"),
            "--export_tum", str(tmp_path / "traj.tum")]
    code = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "import sys; sys.argv = ['main.py'] + %r;"
        "exec(open(%r).read())" % (args, os.path.join(REPO, "main.py"))
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    img, meta = export.load_map_ros(str(tmp_path / "rosmap.yaml"))
    assert img.shape[0] > 0 and meta["resolution"] == 0.2
    # the map must contain real free/occupied structure, not all-unknown
    assert (img == 0).sum() > 0 and (img == 254).sum() > 0
    stamps, poses = export.load_trajectory_tum(str(tmp_path / "traj.tum"))
    assert poses.shape == (30, 3)
    ref = np.load(tmp_path / "outputs" / "poses_scan_matching_20.npy")
    np.testing.assert_allclose(poses[:, :2], ref[:, :2], atol=1e-6)


@pytest.mark.slow
def test_online_cli_export_ros_map(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    args = ["--synthetic", "30", "--res", "0.2", "--width", "16",
            "--height", "16", "--window", "20",
            "--map_path", str(tmp_path / "m.png"),
            "--export_ros_map", str(tmp_path / "serve")]
    code = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "import sys; sys.argv = ['online_slam.py'] + %r;"
        "exec(open(%r).read())" % (args, os.path.join(REPO, "online_slam.py"))
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    img, meta = export.load_map_ros(str(tmp_path / "serve.yaml"))
    assert meta["resolution"] == 0.2
    assert (img == 0).sum() > 0  # occupied structure present
