"""Where JAX keeps its persistent compilation cache: one rule for every
entry point (`chip_smoke.py`, `bench.py`, the pipeline CLI)."""
from __future__ import annotations

import os

# <checkout>/.jax_cache — listed in .gitignore.
_DEFAULT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable() -> str:
    """Turn on the persistent compilation cache and return its directory.

    If JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and nothing is
    set here. Otherwise the cache goes to a fixed `.jax_cache/` in the
    checkout: the path is part of the cache key, so it must not move
    between runs."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", _DEFAULT)
    return _DEFAULT
