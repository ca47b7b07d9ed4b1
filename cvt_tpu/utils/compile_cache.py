"""One place that decides where JAX keeps its persistent compile cache.

Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing
is set here. Otherwise the cache lives at the fixed `<repo>/.jax_cache`
(listed in .gitignore): a fixed path, because the path is part of what
makes a later process find an earlier compilation.
"""

from __future__ import annotations

import os

REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent compile cache on; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE)
    return REPO_CACHE
