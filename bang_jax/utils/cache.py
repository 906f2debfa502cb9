"""Persistent XLA compilation cache.

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX keeps its cache there and this
module sets no directory. Otherwise the cache lives at `bench_data/jax_cache`
inside the checkout: a fixed path, so later processes on the same checkout
find what earlier ones compiled.
"""

from __future__ import annotations

import os

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "bench_data",
    "jax_cache",
)


def enable_persistent_cache() -> str:
    """Turn the persistent cache on; returns its directory."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_CACHE_DIR
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
