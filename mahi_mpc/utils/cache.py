"""Where JAX keeps compiled programs between processes.

``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it itself and
nothing is set here.  Otherwise the cache goes to ``<checkout>/.jax_cache``
(git-ignored), a fixed path so that the cache keys stay stable.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache(default_dir: str | Path = DEFAULT_DIR,
                         min_compile_time_s: float = 1.0) -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(default_dir))
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_time_s)
    return str(default_dir)
