import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd, script="main.py"):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    # the CLI tier runs on the CPU whatever the host (see conftest)
    code = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "import sys; sys.argv = [%r] + %r;"
        "exec(open(%r).read())" % (script, args, os.path.join(REPO, script))
    )
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, env=env,
                          timeout=600)


@pytest.mark.slow
def test_cli_odom_synthetic(tmp_path):
    r = _run(["--mode", "odom", "--synthetic", "50", "--res", "0.1",
              "--width", "30", "--height", "30", "--generate_texture_map",
              "--output_dir", str(tmp_path / "outputs")], cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    poses = np.load(tmp_path / "outputs" / "poses_odom_20.npy")
    assert poses.shape == (50, 3)
    rel = np.load(tmp_path / "outputs" / "relative_poses_odom_20.npy")
    assert rel.shape == (49, 3, 3)
    assert (tmp_path / "images" / "logodds_map_odom_20.png").exists()
    assert "skipping texture" in r.stdout


@pytest.mark.slow
def test_cli_gtsam_filtered_synthetic(tmp_path):
    r = _run(["--mode", "gtsam", "--filter_lidar", "--synthetic", "40",
              "--res", "0.2", "--width", "30", "--height", "30",
              "--output_dir", str(tmp_path / "outputs")], cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    for name in ["poses_odom_20", "poses_scan_matching_20", "poses_optimized_20",
                 "relative_poses_scan_matching_20"]:
        assert (tmp_path / "outputs" / f"{name}.npy").exists(), name
    assert "loop closures" in r.stdout


@pytest.mark.slow
def test_cli_gtsam_dataset_21(tmp_path):
    """Full gtsam e2e at --dataset 21 on a fabricated on-disk 21-shaped
    dataset (different step count, wider trajectory, range_max=60):
    loader validation, K-slot adaptation, grid sizing, and the _21 output
    naming all hold (round-3 review: every test/bench used 20 shapes)."""
    from test_driver_oracle import _write_dataset

    data_dir = str(tmp_path / "data")
    n_rgb = 3
    _write_dataset(data_dir, n_steps=36, n_rays=241, dataset_num=21,
                   n_rgb=n_rgb)
    # the on-disk dataRGBD tree the texture stage reads
    # (reference: texture_mapping.py:54-62 layout; 21-suffixed here)
    from lidar_slam.utils.png import write_png
    rng = np.random.default_rng(5)
    os.makedirs(tmp_path / "dataRGBD" / "Disparity21", exist_ok=True)
    os.makedirs(tmp_path / "dataRGBD" / "RGB21", exist_ok=True)
    for k in range(int(n_rgb * 1.2) + 1):
        disp = rng.integers(400, 900, (480, 640)).astype(np.uint16)
        write_png(str(tmp_path / "dataRGBD" / "Disparity21"
                      / f"disparity21_{k}.png"), disp)
    for i in range(1, n_rgb + 1):
        rgb = rng.integers(0, 255, (480, 640, 3)).astype(np.uint8)
        write_png(str(tmp_path / "dataRGBD" / "RGB21"
                      / f"rgb21_{i}.png"), rgb)
    r = _run(["--mode", "gtsam", "--dataset", "21",
              "--dataset_path", data_dir, "--res", "0.2",
              "--width", "40", "--height", "40", "--generate_texture_map",
              "--output_dir", str(tmp_path / "outputs")], cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    for name in ["poses_odom_21", "poses_scan_matching_21",
                 "poses_optimized_21", "relative_poses_odom_21",
                 "relative_poses_scan_matching_21"]:
        assert (tmp_path / "outputs" / f"{name}.npy").exists(), name
    poses = np.load(tmp_path / "outputs" / "poses_optimized_21.npy")
    assert poses.shape == (36, 3)
    assert (tmp_path / "images" / "logodds_map_gtsam_21.png").exists()
    assert (tmp_path / "images" / "texture_map_gtsam_21.png").exists()


@pytest.mark.slow
def test_cli_synthetic_dataset_21_routing(tmp_path):
    """--synthetic with --dataset 21 routes through the 21-shaped
    generator and labels artifacts _21."""
    r = _run(["--mode", "odom", "--synthetic", "30", "--dataset", "21",
              "--res", "0.2", "--width", "40", "--height", "40",
              "--output_dir", str(tmp_path / "outputs")], cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "21-shaped" in r.stdout
    poses = np.load(tmp_path / "outputs" / "poses_odom_21.npy")
    assert poses.shape == (30, 3)


def test_cli_invalid_dataset_number(tmp_path):
    """The reference validates dataset in {20,21}
    (reference: modules/utils.py:48-53); the rebuilt loader must too."""
    os.makedirs(tmp_path / "data", exist_ok=True)
    r = _run(["--dataset", "22", "--dataset_path",
              str(tmp_path / "data")], cwd=str(tmp_path))
    assert r.returncode != 0
    assert "Must be 20 or 21" in (r.stderr + r.stdout)


def test_cli_missing_dataset_errors(tmp_path):
    r = _run(["--dataset_path", "/nonexistent/"], cwd=str(tmp_path))
    assert r.returncode != 0
    assert "Data folder does not exist" in (r.stderr + r.stdout)


@pytest.mark.slow
def test_online_cli_synthetic_checkpoint_resume(tmp_path):
    """online_slam.py streams, checkpoints, and resumes; track covers
    step 0 (round-3 review)."""
    ck = str(tmp_path / "ck.npz")
    r = _run(["--synthetic", "40", "--res", "0.2", "--width", "16",
              "--height", "16", "--window", "24", "--checkpoint", ck,
              "--map_path", str(tmp_path / "m.png"),
              "--poses_path", str(tmp_path / "p.npy")],
             cwd=str(tmp_path), script="online_slam.py")
    assert r.returncode == 0, r.stderr[-2000:]
    track = np.load(tmp_path / "p.npy")
    assert track.shape == (40, 3)  # includes step 0
    assert (tmp_path / "m.png").exists()
    r2 = _run(["--synthetic", "40", "--res", "0.2", "--width", "16",
               "--height", "16", "--window", "24", "--checkpoint", ck,
               "--resume", "--map_path", str(tmp_path / "m2.png")],
              cwd=str(tmp_path), script="online_slam.py")
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "resumed from" in r2.stderr


@pytest.mark.slow
def test_online_cli_dataset_mode(tmp_path):
    """The real-data branch of online_slam.py loads a fabricated on-disk
    dataset (round-3 review: load_data was called with the path in the
    dataset_names slot and crashed)."""
    from test_driver_oracle import _write_dataset

    data_dir = str(tmp_path / "data")
    _write_dataset(data_dir, n_steps=30, n_rays=181)
    r = _run(["--dataset", "20", "--dataset_path", data_dir,
              "--res", "0.2", "--width", "16", "--height", "16",
              "--map_path", str(tmp_path / "m.png")],
             cwd=str(tmp_path), script="online_slam.py")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "streamed" in r.stderr
    assert (tmp_path / "m.png").exists()


@pytest.mark.slow
def test_online_cli_icp_metric_plicp(tmp_path):
    """--icp_metric point_to_line is plumbed through online_slam.py
    (round-3 review: only main.py exposed it) and the PLICP streaming
    run completes with a refinement pass."""
    r = _run(["--synthetic", "40", "--res", "0.2", "--width", "16",
              "--height", "16", "--window", "24",
              "--icp_metric", "point_to_line", "--refine_every", "20",
              "--map_path", str(tmp_path / "m.png"),
              "--poses_path", str(tmp_path / "p.npy")],
             cwd=str(tmp_path), script="online_slam.py")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "refined window" in r.stderr
    track = np.load(tmp_path / "p.npy")
    assert track.shape == (40, 3)
    assert np.all(np.isfinite(track))


@pytest.mark.slow
def test_online_cli_relocalize_on_loss_flag(tmp_path):
    """--relocalize_on_loss plumbs the loss gate through the driver; a
    healthy stream never trips it (the kidnap recovery itself is covered
    by tests/test_online.py::test_online_kidnapped_robot_recovers)."""
    r = _run(["--synthetic", "30", "--res", "0.2", "--width", "16",
              "--height", "16", "--window", "24",
              "--relocalize_on_loss", "--loss_rms", "0.3",
              "--map_path", str(tmp_path / "m.png"),
              "--poses_path", str(tmp_path / "p.npy")],
             cwd=str(tmp_path), script="online_slam.py")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "tracking LOST" not in r.stderr
    track = np.load(tmp_path / "p.npy")
    assert track.shape == (30, 3)


def test_online_cli_resume_refuses_missing_checkpoint(tmp_path):
    """--resume with a missing checkpoint must hard-error instead of
    silently starting fresh and overwriting the path at the end
    (round-3 review)."""
    r = _run(["--synthetic", "10", "--resume",
              "--checkpoint", str(tmp_path / "nope.npz")],
             cwd=str(tmp_path), script="online_slam.py")
    assert r.returncode != 0
    assert "does not exist" in r.stderr
    assert not (tmp_path / "nope.npz").exists()
    r2 = _run(["--synthetic", "10", "--resume"],
              cwd=str(tmp_path), script="online_slam.py")
    assert r2.returncode != 0
    assert "requires --checkpoint" in r2.stderr


@pytest.mark.slow
def test_online_cli_localize_roundtrip(tmp_path):
    """Map-then-localize serving round trip (round-3 review: PF
    localization was demo-ware, unreachable from any driver): main.py
    --save_logodds exports the grid, online_slam.py --localize streams
    the particle filter against it and tracks the mapping trajectory."""
    m = str(tmp_path / "map.npy")
    r = _run(["--mode", "odom", "--synthetic", "60", "--res", "0.1",
              "--width", "30", "--height", "30", "--save_logodds", m,
              "--output_dir", str(tmp_path / "outputs")], cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "log-odds grid saved" in r.stdout
    gt = np.load(tmp_path / "outputs" / "poses_odom_20.npy")

    r2 = _run(["--synthetic", "60", "--res", "0.1", "--width", "30",
               "--height", "30", "--localize", m, "--particles", "128",
               "--poses_path", str(tmp_path / "p.npy")],
              cwd=str(tmp_path), script="online_slam.py")
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "localized 59 steps" in r2.stderr
    track = np.load(tmp_path / "p.npy")
    assert track.shape == (60, 3)
    err = np.linalg.norm(track[:, :2] - gt[:, :2], axis=1)
    assert float(err.mean()) < 0.3, err.mean()


def test_online_cli_localize_flag_validation(tmp_path):
    """--localize refuses SLAM-stream flags and mismatched map shapes
    instead of silently ignoring them."""
    m = str(tmp_path / "map.npy")
    np.save(m, np.zeros((10, 10), np.float32))
    r = _run(["--synthetic", "10", "--localize", m, "--refine_every", "5"],
             cwd=str(tmp_path), script="online_slam.py")
    assert r.returncode != 0
    assert "localization-only" in r.stderr
    # shape mismatch: default --res/--width/--height imply (1200, 1200)
    r2 = _run(["--synthetic", "10", "--localize", m],
              cwd=str(tmp_path), script="online_slam.py")
    assert r2.returncode != 0
    assert "pass the flags the map was built with" in r2.stderr
    r3 = _run(["--synthetic", "10",
               "--localize", str(tmp_path / "missing.npy")],
              cwd=str(tmp_path), script="online_slam.py")
    assert r3.returncode != 0
    assert "does not exist" in r3.stderr


@pytest.mark.slow
def test_online_cli_localize_global_init(tmp_path):
    """--global_init fixes scan 0's pose by certified global relocalization
    (no --x0 given) and the filter then TRACKS the mapping trajectory — a
    blind uniform particle spread provably cannot at serving counts."""
    m = str(tmp_path / "map.npy")
    r = _run(["--mode", "odom", "--synthetic", "40", "--res", "0.1",
              "--width", "30", "--height", "30", "--save_logodds", m,
              "--output_dir", str(tmp_path / "outputs")], cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    gt = np.load(tmp_path / "outputs" / "poses_odom_20.npy")
    r2 = _run(["--synthetic", "40", "--res", "0.1", "--width", "30",
               "--height", "30", "--localize", m, "--particles", "64",
               "--global_init",
               "--poses_path", str(tmp_path / "p.npy")],
              cwd=str(tmp_path), script="online_slam.py")
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "global init: relocalized scan 0" in r2.stderr
    track = np.load(tmp_path / "p.npy")
    assert track.shape == (40, 3)
    err = np.linalg.norm(track[:, :2] - gt[:, :2], axis=1)
    assert float(err.mean()) < 0.3, err.mean()
