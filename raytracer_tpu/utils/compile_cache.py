"""Where JAX's persistent compilation cache lives, decided in one place.

The entry points (the CLI, bench.py, chip_smoke.py) call
`enable_compile_cache()` once at start-up; library code and the test suite
never do.
"""

from __future__ import annotations

import os

import jax

# A fixed path inside the checkout: the cache directory is part of the
# cache's key, so a directory that moves between runs never hits.
DEFAULT_CACHE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".jax_cache")
)


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory.

    If JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and nothing is
    set here. Otherwise the cache goes to DEFAULT_CACHE_DIR."""
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
