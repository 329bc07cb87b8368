import numpy as np
import pytest

from lidar_slam.utils import metrics


def test_ate_zero_for_identical():
    rng = np.random.default_rng(0)
    p = np.cumsum(rng.normal(0, 0.1, (50, 3)), axis=0)
    r = metrics.ate_translation(p, p)
    assert r["rmse"] < 1e-12 and r["max"] < 1e-12


def test_ate_alignment_removes_rigid_offset():
    rng = np.random.default_rng(1)
    ref = np.cumsum(rng.normal(0, 0.1, (80, 3)), axis=0)
    th = 0.7
    c, s = np.cos(th), np.sin(th)
    est = ref.copy()
    est[:, :2] = ref[:, :2] @ np.array([[c, -s], [s, c]]).T + [3.0, -2.0]
    est[:, 2] += th
    aligned = metrics.ate_translation(est, ref, align=True)
    raw = metrics.ate_translation(est, ref, align=False)
    assert aligned["rmse"] < 1e-9
    assert raw["rmse"] > 1.0


def test_rpe_detects_drift():
    rng = np.random.default_rng(2)
    ref = np.cumsum(rng.normal(0, 0.1, (60, 3)), axis=0)
    est = ref + np.cumsum(rng.normal(0, 0.01, ref.shape), axis=0)
    r = metrics.relative_pose_error(est, ref)
    assert 0 < r["trans_rmse"] < 0.2
    same = metrics.relative_pose_error(ref, ref)
    assert same["trans_rmse"] < 1e-12


def test_map_agreement():
    rng = np.random.default_rng(3)
    a = rng.normal(0, 5, (64, 64))
    r = metrics.map_agreement(a, a)
    assert r["accuracy"] == 1.0 and r["iou_occupied"] == 1.0
    b = a.copy()
    b[:32] = -b[:32]
    r2 = metrics.map_agreement(a, b)
    assert r2["accuracy"] < 1.0
    with pytest.raises(ValueError):
        metrics.map_agreement(a, a[:10])


def test_plot_trajectories_writes_files(tmp_path):
    from lidar_slam.utils import plotting
    rng = np.random.default_rng(4)
    poses = [np.cumsum(rng.normal(0, 0.1, (40, 3)), axis=0) for _ in range(2)]
    out = tmp_path / "sub" / "traj.png"
    plotting.plot_trajectories(poses, str(out), labels=["a", "b"])
    assert out.exists() and out.stat().st_size > 100
    # dependency-free raster fallback path
    out2 = tmp_path / "raster.png"
    plotting._raster_trajectories(poses, str(out2))
    from lidar_slam.utils.png import _read_png_python
    img = _read_png_python(str(out2))
    assert img.shape == (800, 800, 3)
    assert (img < 250).any()  # something was drawn


def test_compare_runs_cli(tmp_path):
    """tools/compare_runs.py (README's accuracy tooling) emits a JSON
    report with ATE/RPE and map-agreement blocks."""
    import json
    import subprocess
    import sys

    rng = np.random.default_rng(0)
    ref = np.cumsum(rng.normal(0, 0.05, (50, 3)), axis=0)
    est = ref + rng.normal(0, 0.01, ref.shape)
    a = str(tmp_path / "est.npy"); b = str(tmp_path / "ref.npy")
    np.save(a, est); np.save(b, ref)
    m1 = rng.normal(0, 2, (40, 40)); m2 = m1 + rng.normal(0, 0.1, m1.shape)
    ma = str(tmp_path / "ma.npy"); mb = str(tmp_path / "mb.npy")
    np.save(ma, m1); np.save(mb, m2)
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, os.path.join(repo, "tools", "compare_runs.py"),
         "--est", a, "--ref", b, "--est-map", ma, "--ref-map", mb],
        capture_output=True, text=True, cwd=repo, timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]
    rep = json.loads(r.stdout)
    assert rep["ate"]["rmse"] < 0.05
    assert rep["rpe_1"]["trans_rmse"] < 0.1
    assert 0.0 <= rep["map"]["accuracy"] <= 1.0
