"""Profiling and debugging aids (SURVEY §5 'Tracing / profiling',
'Race detection / sanitizers' analogs).

- ``trace(dir)``: jax.profiler trace capture around a solver run; open the
  result in Perfetto/XProf to attribute time to the named update regions.
- ``named_scope``: re-export for annotating custom step functions.
- ``determinism_check``: same-seed bitwise reproducibility (the JAX analog
  of a race detector for our purposes — any nondeterministic reduction or
  layout flake shows up as a bit mismatch).
- ``debug_nans``: context manager enabling jax_debug_nans locally.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import jax
import numpy as np

named_scope = jax.named_scope


def enable_compilation_cache() -> str:
    """Enable JAX's persistent compilation cache; returns its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already keeps its
    cache there and no other directory is set.  Otherwise the cache is
    ``.jax_cache/`` at the checkout root: a fixed path (the path is part
    of the cache key, so a directory that moves never hits), listed in
    ``.gitignore``.
    """
    import os

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))), ".jax_cache")
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return cache_dir


def gpu_label() -> str:
    """The first GPU's name and power limit as ``nvidia-smi`` reports them
    (``"NVIDIA H100 80GB HBM3, 700.00 W"``), read by a child process that
    stays off JAX.  A card may be set below its maximum power limit and
    then runs slower under load, so every measurement carries this."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a profiler trace of the enclosed computation."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    old = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", enable)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", old)


def determinism_check(fn: Callable[[], object], runs: int = 2) -> bool:
    """Run ``fn`` repeatedly and verify bitwise-identical outputs.

    Returns True when deterministic; raises AssertionError with the first
    mismatching leaf otherwise.
    """
    ref = jax.tree_util.tree_map(np.asarray, fn())
    for r in range(1, runs):
        out = jax.tree_util.tree_map(np.asarray, fn())
        leaves_a = jax.tree_util.tree_leaves(ref)
        leaves_b = jax.tree_util.tree_leaves(out)
        for i, (a, b) in enumerate(zip(leaves_a, leaves_b)):
            if not np.array_equal(a, b, equal_nan=True):
                raise AssertionError(
                    f"run {r} leaf {i} differs: max abs diff "
                    f"{np.max(np.abs(a.astype(np.float64) - b.astype(np.float64)))}"
                )
    return True
