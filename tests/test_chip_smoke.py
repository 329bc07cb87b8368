"""chip_smoke.py's contract, checked on the CPU: it refuses anything but a
GPU, --four runs only the four-card phase, a failed check withholds the
`ok` line, and the last line is built from JAX's own device report. Its
comparison phases run here with the CPU standing in for the GPU."""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run_script(cwd, script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _no_ok_line(stdout):
    return not any(line.startswith('{"ok"') for line in stdout.splitlines())


def test_refuses_a_non_gpu_platform():
    res = _run_script(REPO, "chip_smoke.py")
    assert res.returncode != 0
    assert _no_ok_line(res.stdout)
    assert "not a GPU" in res.stderr


def test_fails_without_the_rest_of_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    res = _run_script(str(tmp_path), "chip_smoke.py")
    assert res.returncode != 0
    assert _no_ok_line(res.stdout)


def _fake_devices(n):
    return [types.SimpleNamespace(platform="gpu", device_kind="NVIDIA H100",
                                  id=i) for i in range(n)]


@pytest.mark.parametrize("argv,runner", [([], "run_one_card"),
                                         (["--four"], "run_four_cards")])
def test_phase_selection(monkeypatch, capsys, argv, runner):
    calls = []
    monkeypatch.setattr(chip_smoke, "phase_device",
                        lambda n: _fake_devices(max(n, 1)))
    for name in ("run_one_card", "run_four_cards"):
        monkeypatch.setattr(chip_smoke, name,
                            lambda d, c, _n=name: calls.append((_n, d)) or [])
    assert chip_smoke.main(argv) == 0
    assert [c[0] for c in calls] == [runner]
    n = 4 if argv else 1
    dev = calls[0][1]
    assert (len(dev) if isinstance(dev, list) else 1) == n
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last)["ok"] is True


def test_failed_check_withholds_the_ok_line(monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "phase_device", lambda n: _fake_devices(1))
    monkeypatch.setattr(chip_smoke, "run_one_card", lambda d, c: ["map"])
    assert chip_smoke.main([]) == 1
    assert _no_ok_line(capsys.readouterr().out)


def test_ok_line_contract():
    line = chip_smoke.ok_line(_fake_devices(4))
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100", "count": 4}}')


@pytest.mark.parametrize("dut", ["cpu", pytest.param("gpu",
                                                     marks=pytest.mark.gpu)])
def test_comparison_phases_pass(dut, request):
    """Phase 2's comparisons at small sizes, the device under test against
    the CPU backend (the CPU stands in for the GPU here): every check must
    pass and print its observed value and tolerance."""
    import jax

    cpu = jax.devices("cpu")[0]
    dev = request.getfixturevalue("gpu_device") if dut == "gpu" else cpu
    sizes = chip_smoke.Sizes(scans=24, pairs=4, map_scans=6, filter_scans=6,
                             frames=4, online_steps=3)
    log_ = chip_smoke.load_log(3, sizes.scans, cpu)
    checks = chip_smoke.Checks()
    with chip_smoke.default_device(dev):
        times, inter = chip_smoke.staged_run(log_)
    assert set(times) == {"filter", "odometry", "scan_matching",
                          "loop_closures", "pose_graph", "map_build"}
    seeds = chip_smoke.compare_nn(checks, log_, dev, cpu, sizes)
    chip_smoke.compare_icp(checks, log_, dev, cpu, sizes, seeds)
    chip_smoke.compare_map(checks, log_, log_["gt"].astype("float32"), dev,
                           cpu, sizes)
    chip_smoke.compare_pose_graph(checks, inter, dev, cpu)
    chip_smoke.compare_filters(checks, log_, dev, cpu, sizes)
    chip_smoke.compare_online(checks, log_, dev, cpu, sizes)
    assert checks.failed == []
