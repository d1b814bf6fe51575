"""Persistent compile cache placement for the repo's entry scripts.

Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it and nothing here
overrides it.  Otherwise the cache goes to a fixed `.jax_cache/` at the
checkout root: the path is part of what makes later runs hit the cache.
"""
from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"


def compile_cache_dir(root: str) -> str:
    """The cache directory a run from checkout `root` uses."""
    return os.environ.get(ENV) or os.path.join(os.path.abspath(root),
                                               ".jax_cache")


def configure_compile_cache(root: str) -> str:
    """Point JAX's persistent compile cache at compile_cache_dir(root)."""
    import jax

    path = compile_cache_dir(root)
    if not os.environ.get(ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
