"""Where JAX keeps its persistent compilation cache.

`JAX_COMPILATION_CACHE_DIR`, when set, is used as it is. Otherwise the
cache lives in `.jax_cache` at the root of this checkout (listed in
`.gitignore`), a path fixed by this file's location, so every process
run from the same checkout finds the programs compiled before it.
"""
from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compilation_cache_dir() -> str:
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT, ".jax_cache"))


def enable_compilation_cache() -> str:
    """Point JAX's persistent compilation cache at
    `compilation_cache_dir()`; returns the directory."""
    import jax

    path = compilation_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
