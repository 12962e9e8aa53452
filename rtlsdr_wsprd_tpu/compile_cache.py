"""Persistent JAX compilation cache, placed from outside.

``JAX_COMPILATION_CACHE_DIR`` names the directory when it is set, and
no other directory is set in code. Otherwise the cache lives in the
checkout's ``.jax_cache`` (gitignored), resolved from this package's
location, so every entry point of one checkout shares one fixed path
(the path is part of the cache key: a moving directory never hits).
The reference's analog is its FFTW wisdom file (wsprd/wsprd.c:503-507).
"""

from __future__ import annotations

import os
from pathlib import Path

DEFAULT_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def cache_dir() -> str:
    """The directory the cache uses: the environment's, else the
    checkout's ``.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_DIR)


def enable() -> str:
    """Point JAX's persistent compilation cache at ``cache_dir()`` and
    return that directory. Sets configuration only; initializes no
    backend."""
    import jax

    d = cache_dir()
    jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return d


__all__ = ["DEFAULT_DIR", "cache_dir", "enable"]
