"""Process set-up shared by the entry points: compile cache and device report.

Every entry point (main.py, online_slam.py, bench.py, chip_smoke.py and the
tools) calls `use_compile_cache()` before its first compile and prints
`report_devices()` once, so a run's log always names the device it ran on.
"""

from __future__ import annotations

import os
import subprocess
import sys

import jax

# <checkout>/.jax_cache (listed in .gitignore)
DEFAULT_CACHE_DIR = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", ".jax_cache"))


def use_compile_cache(min_compile_time_s: float = 0.5) -> str:
    """Enable JAX's persistent compilation cache and return its directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and this
    sets no other directory; otherwise the cache goes to <checkout>/.jax_cache.
    """
    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = DEFAULT_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_time_s)
    return cache_dir


def gpu_name_and_power_limit() -> str | None:
    """`nvidia-smi`'s name and power limit of each card, one line per card
    (None where there is no nvidia-smi)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip() or None


def report_devices(stream=sys.stderr):
    """Print the JAX version and the devices JAX sees; return jax.devices()."""
    devs = jax.devices()
    kinds = sorted({d.device_kind for d in devs})
    print(f"jax {jax.__version__}: {len(devs)} x {devs[0].platform} "
          f"({', '.join(kinds)})", file=stream, flush=True)
    return devs
