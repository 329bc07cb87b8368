import io as std_io

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lidar_slam.utils.logging import StageLogger
from lidar_slam.utils import profiling


def test_stage_logger_collects_metrics():
    buf = std_io.StringIO()
    log = StageLogger(stream=buf)
    log.start("Estimating poses")
    log.metric("n_poses", 100)
    dt = log.end()
    assert dt >= 0
    summary = log.summary()
    assert summary["Estimating poses.n_poses"] == 100
    assert "Estimating poses.seconds" in summary
    out = buf.getvalue()
    assert "Estimating poses..." in out and "=" * 52 in out


def test_stage_logger_json_lines():
    buf = std_io.StringIO()
    log = StageLogger(stream=buf, json_lines=True)
    log.start("s")
    log.metric("x", 1.5)
    log.end()
    log.summary()
    assert '"metric": "s.x"' in buf.getvalue()


def test_device_timer_counters():
    counters = {}
    with profiling.device_timer("op", counters, items=10, verbose=False):
        profiling.block(jnp.arange(8).sum())
    assert counters["op"] > 0
    assert counters["op_per_s"] > 0


def test_debug_mode_raises_on_nan():
    with profiling.debug_mode():
        with pytest.raises(FloatingPointError):
            jax.jit(lambda x: jnp.log(x))(jnp.asarray(-1.0)).block_until_ready()
    # restored afterwards: no raise
    _ = jax.jit(lambda x: jnp.log(x))(jnp.asarray(-1.0)).block_until_ready()


def test_tic_toc(capsys):
    t = profiling.tic()
    dt = profiling.toc(t, "X")
    assert dt >= 0
    assert "X took" in capsys.readouterr().out


def test_devices_or_die_returns_devices(capsys):
    """Entry points print the device report (utils/runtime.report_devices)
    and get jax.devices() back."""
    from lidar_slam.utils.runtime import report_devices

    devs = report_devices()
    assert len(devs) >= 1
    err = capsys.readouterr().err
    assert f"jax {jax.__version__}" in err and devs[0].platform in err


def _cache_dir_in_child(env_value):
    """jax_compilation_cache_dir after use_compile_cache() in a fresh
    interpreter, with JAX_COMPILATION_CACHE_DIR set to env_value (or unset)."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    code = ("import sys; sys.path.insert(0, %r); import jax;"
            "from lidar_slam.utils.runtime import use_compile_cache;"
            "d = use_compile_cache();"
            "print(d); print(jax.config.jax_compilation_cache_dir)") % repo
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=repo)
    assert res.returncode == 0, res.stderr
    return res.stdout.split()


def test_compile_cache_follows_env_var(tmp_path):
    d = str(tmp_path / "cache")
    assert _cache_dir_in_child(d) == [d, d]


def test_compile_cache_defaults_to_checkout():
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    assert _cache_dir_in_child(None) == [want, want]


@pytest.mark.parametrize("entry", ["main.py", "online_slam.py", "bench.py",
                                   "chip_smoke.py"])
def test_entry_points_use_the_cache_helper(entry):
    """Each entry point sets its cache through use_compile_cache, and no
    entry point sets a cache directory of its own."""
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, entry)) as f:
        src = f.read()
    assert "use_compile_cache()" in src
    assert "jax_compilation_cache_dir" not in src
