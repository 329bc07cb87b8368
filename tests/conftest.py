"""Test harness configuration.

Tests run on a virtual 8-device CPU mesh so multi-chip sharding paths are
exercised without accelerators. Must set flags before JAX initializes.

Tests that only a GPU can run carry the `gpu` marker; the `gpu_device`
fixture skips them where JAX finds no GPU (decided when the test runs, never
at import, so every worker collects the same tests). chip_smoke.py runs the
same paths on the card.
"""

import os

# The CPU tier unless the caller names platforms: the `gpu` tier runs as
# JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu
PLATFORMS = os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "1")
# Per-op/per-jit compiles cost ~0.5s each on this box; the persistent cache
# makes re-runs of the suite fast.
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(__file__), "..", ".jax_cache"),
)
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.1")

import jax  # noqa: E402
import pytest  # noqa: E402

# If jax was imported before this file ran, env vars alone are too late —
# the config update is what actually selects the platform.
jax.config.update("jax_platforms", PLATFORMS)
jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Release each module's compiled executables when the module finishes.

    The full suite compiles hundreds of distinct programs in ONE process;
    keeping every loaded executable alive eventually segfaults XLA's CPU
    backend deep into the run (observed 2026-08-18 at >200 cumulative
    compiles: two runs crashed inside backend_compile_and_load at
    DIFFERENT late tests — test_scan_matching once, test_reference_outputs
    once — each of which passes standalone; cumulative JIT state, not a
    test bug). Executables shared across modules reload from the
    persistent .jax_cache, so the cost is load time, not recompilation.
    """
    yield
    jax.clear_caches()


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip where JAX finds none (tests marked `gpu`)."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py covers this path "
                    "on the card")
    return devs[0]
