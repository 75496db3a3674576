"""Persistent XLA compilation cache for the repository's entry scripts.

Called by chip_smoke.py, bench.py and the bench/ harnesses, never at
package import.
"""

from __future__ import annotations

import os

_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
ENV = "JAX_COMPILATION_CACHE_DIR"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing else is set. Otherwise the cache lives at the fixed path
    ``<checkout>/.jax_cache`` (listed in .gitignore): the path is part of
    the cache key, so it must not move between runs."""
    env = os.environ.get(ENV)
    if env:
        return env
    import jax

    path = os.path.join(_CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
