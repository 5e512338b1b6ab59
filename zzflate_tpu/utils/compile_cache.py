"""Where every entry point keeps JAX's persistent compilation cache.

`JAX_COMPILATION_CACHE_DIR`, when set, is the cache and nothing else is
configured. Otherwise the cache is `.jax_cache/` beside the package (the
repository root in a checkout): a fixed path, because the path is part
of what makes a later process find the entries again.
"""
from __future__ import annotations

import os

_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def cache_dir() -> str:
    """The cache directory this process should use."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _ROOT, ".jax_cache"
    )


def enable(min_compile_secs: float = 1.0) -> str:
    """Point JAX's persistent cache at cache_dir() and return the path.

    Graphs that compile faster than min_compile_secs are not stored."""
    import jax

    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", min_compile_secs
    )
    return path
