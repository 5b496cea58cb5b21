"""JAX's persistent compilation cache, in one place for every entry point.

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and nothing
here changes any setting.  Otherwise the cache goes to `.jax_cache` at the
root of the checkout (listed in .gitignore), a fixed path, so that one
program's compilations are found again by the next run from that checkout.
"""
from __future__ import annotations

import os
from pathlib import Path

CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache(environ=os.environ) -> str:
    """Turn the persistent compilation cache on; returns its directory."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return environ["JAX_COMPILATION_CACHE_DIR"]
    import jax
    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return str(CHECKOUT_CACHE)
