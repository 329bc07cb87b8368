"""Tracing / profiling utilities.

The reference's only timing tools are tic/toc wall-clock helpers and tqdm
bars (reference: code/pr2_utils.py:6-9; SURVEY.md section 5). This module
provides the same surface plus device-aware timing (block_until_ready
fences), per-stage throughput counters, and an optional jax.profiler trace
context for device timelines.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import jax


def tic() -> float:
    """(reference: code/pr2_utils.py:6-7)"""
    return time.time()


def toc(tstart: float, name: str = "Operation") -> float:
    """(reference: code/pr2_utils.py:8-9); also returns the elapsed time."""
    dt = time.time() - tstart
    print(f"{name} took: {dt} sec.\n")
    return dt


def block(tree):
    """Block until every array in a pytree is ready; returns the tree."""
    for leaf in jax.tree_util.tree_leaves(tree):
        if hasattr(leaf, "block_until_ready"):
            leaf.block_until_ready()
    return tree


@contextlib.contextmanager
def device_timer(name: str, counters: Optional[Dict[str, float]] = None,
                 items: Optional[int] = None, verbose: bool = True):
    """Fenced wall-clock timing of a device computation.

    Use as: `with device_timer("icp", items=n_pairs) as t: block(fn(...))`.
    Records seconds (and items/sec when `items` given) into `counters`.
    """
    t0 = time.time()
    yield
    dt = time.time() - t0
    if counters is not None:
        counters[name] = dt
        if items:
            counters[f"{name}_per_s"] = items / dt
    if verbose:
        rate = f" ({items / dt:.1f}/s)" if items else ""
        print(f"[timing] {name}: {dt:.3f}s{rate}")


@contextlib.contextmanager
def debug_mode(nan_checks: bool = True):
    """Development mode: raise on NaNs produced by any jitted computation
    (the race-detection/sanitizer analog for this framework —
    SURVEY.md section 5; single-address-space SPMD has no data races, NaNs
    are the corruption that actually happens)."""
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", nan_checks)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/jax_trace"):
    """jax.profiler trace context (view with TensorBoard / xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
