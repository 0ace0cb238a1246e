"""Persistent XLA compile cache for the repo's scripts.

``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's own setting and is used
as it is. Otherwise the cache lives at a fixed path inside the checkout
(``<repo>/.jax_cache``, git-ignored), so a later run of any script from
the same checkout finds what an earlier one compiled.
"""

from __future__ import annotations

import os

import jax

_REPO = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; returns it."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = os.path.join(_REPO, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    return path
