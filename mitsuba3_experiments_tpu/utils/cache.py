"""JAX persistent compilation cache: one place that decides its directory.

When JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing here
sets another directory.  Otherwise the cache lives at a fixed path inside
the checkout, `<checkout>/.jax_cache` (git-ignored), so every entry point
of one checkout shares it.
"""
from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache(min_compile_secs: float = 1.0) -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return path
