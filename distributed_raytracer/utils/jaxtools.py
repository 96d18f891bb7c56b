"""Small JAX runtime helpers."""

from __future__ import annotations

import os

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compilation_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else `<checkout>/.jax_cache`, a
    fixed path that every run from one checkout shares."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_CHECKOUT, ".jax_cache"))


def enable_compilation_cache() -> str:
    """Enable JAX's persistent compilation cache; returns its directory."""
    import jax

    cache_dir = compilation_cache_dir()
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return cache_dir
