"""Persistent XLA compilation cache.

Compiling the fused evidence programs takes tens of seconds per shape;
with the persistent cache a resumed or repeated run skips straight to
execution.  Every entry point (the pipeline, ``bench.py``,
``chip_smoke.py``) enables it through :func:`enable_compilation_cache`.
"""

from __future__ import annotations

import os
from pathlib import Path

__all__ = ["enable_compilation_cache", "CHECKOUT_CACHE_DIR"]

# <checkout>/.jax_cache — a fixed path, since the path is part of the
# cache key and a directory that moves never hits
CHECKOUT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing else is configured.  Otherwise the cache lives in
    :data:`CHECKOUT_CACHE_DIR`.  Safe to call repeatedly.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    CHECKOUT_CACHE_DIR.mkdir(exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE_DIR))
    return str(CHECKOUT_CACHE_DIR)
