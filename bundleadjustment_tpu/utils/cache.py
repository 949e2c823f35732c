"""Persistent XLA compile cache.

The tracking/mapping pipeline jits a family of shape buckets (frontend,
motion-only BA, neighbor-search batches, BA snapshots); the persistent
cache lets a rerun skip their compiles.  The cache directory is part of the
cache key, so it stays at one fixed place: `JAX_COMPILATION_CACHE_DIR` when
the environment sets it (JAX then reads it itself), else `.jax_cache` at the
root of the checkout.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory the compile cache lives in."""
    return os.environ.get(ENV_VAR) or REPO_CACHE_DIR


def enable_persistent_cache() -> str | None:
    """Point JAX's compilation cache at `cache_dir()`; returns the directory,
    or None where the cache stays off.

    Reads configuration only — it never initializes a backend.  With
    `JAX_COMPILATION_CACHE_DIR` set nothing is changed.  A process pinned to
    the CPU platform (the test suite) keeps the cache off: XLA:CPU reloads
    warn of possible SIGILL on every hit, concurrent cache writes have
    crashed its compiler, and CPU compiles take seconds anyway."""
    import jax

    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    if (jax.config.jax_platforms or "").strip().lower() == "cpu":
        return None
    os.makedirs(REPO_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return REPO_CACHE_DIR
