"""Persistent XLA compilation cache at a fixed path.

JAX keys its persistent cache by directory, so a directory that moves
between runs never hits. `enable_compile_cache` keeps the cache in
`<checkout>/.jax_cache` unless `JAX_COMPILATION_CACHE_DIR` is set, in
which case JAX reads that variable itself and nothing is configured here.
"""
from __future__ import annotations

import os

CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
CACHE_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Enable the persistent compilation cache; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
