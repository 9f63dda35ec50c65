"""Persistent XLA compile cache for the entry points (CLI, chip_smoke.py,
bench.py).

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
nothing is set here.  Otherwise the cache lives at one fixed path inside
the checkout (``<checkout>/.jax_cache``, listed in ``.gitignore``): the
path is part of what makes a later process find an earlier compile, so
it is never derived from a temp name, a PID or the time.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def configure_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory and return
    that directory."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE))
    return str(CHECKOUT_CACHE)
