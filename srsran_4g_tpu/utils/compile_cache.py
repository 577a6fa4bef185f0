"""Persistent XLA compilation cache for the entry points.

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it on its own and this
module sets nothing.  Otherwise the cache goes to `<checkout>/.jax_cache`:
a fixed path, because the path is part of the cache key, so a cache that
moves never hits.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable() -> str:
    """Point JAX's persistent compilation cache at its directory.

    Call before the first compilation.  Returns the directory in use.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
