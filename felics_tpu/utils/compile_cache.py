"""Persistent XLA compilation cache.

A CLI invocation (one process per image) or a benchmark run would otherwise
recompile every program in every process. ``enable()`` points JAX's
persistent compilation cache at a durable directory so a later process
reuses earlier compiles:

  * when ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    this module sets no other directory;
  * otherwise the cache is ``<checkout>/.jax_cache`` (git-ignored): a fixed
    path, since the path is part of what a later run must find again.

Called by the CLI entry points, bench.py and chip_smoke.py. Library users
embedding felics_tpu in a long-lived process don't need it (in-process
caching suffices) but may call it too — it is idempotent.
"""

from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")
ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def cache_dir() -> str:
    """The directory ``enable`` caches compiled programs in."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable() -> str:
    """Turn on the persistent cache; returns its directory."""
    d = cache_dir()
    if not os.environ.get(ENV_VAR):
        os.makedirs(d, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", d)
    return d
