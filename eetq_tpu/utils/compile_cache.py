"""Where JAX keeps its persistent compilation cache.

`JAX_COMPILATION_CACHE_DIR`, when set, is JAX's own setting and is left
alone. Otherwise the cache goes to `<checkout>/.jax_cache` — a fixed path,
because the path is part of what a later process must find again
(`.gitignore` lists it).
"""

from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)
)))


def enable_compile_cache(checkout: str = CHECKOUT) -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    path = os.path.join(checkout, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
