"""The one rule for JAX's persistent compilation cache.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it by itself and no
directory is set in code. Otherwise the cache lives in ``.jax_cache/``
at the root of the checkout (listed in ``.gitignore``): a fixed path, so
later runs from the same checkout hit it.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def enable_compile_cache() -> str:
    """Apply the rule above before the first compile; returns the
    directory the cache uses."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
