"""Process-wide JAX runtime settings shared by every entry point.

``enable_compile_cache()`` turns on JAX's persistent compilation cache.
When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
here overrides it.  Otherwise the cache lives at the fixed
``<checkout>/.cache/jax``: the directory is part of the cache key, so a path
that changed between runs (a temporary name, a process id, the time) would
never hit.
"""

from __future__ import annotations

import os

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(_REPO, ".cache", "jax")
ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def compile_cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    return os.environ.get(ENV_VAR) or DEFAULT_CACHE_DIR


def enable_compile_cache() -> str:
    """Enable the persistent compilation cache; returns its directory."""
    import jax

    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return compile_cache_dir()
