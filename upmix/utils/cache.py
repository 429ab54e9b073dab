"""Persistent compilation cache.

Each CLI invocation is a fresh process, so without a persistent cache the
pipeline recompiles every run; with JAX's compilation cache a warm start
loads the compiled programs from disk instead.  Where the cache lives:

  1. ``JAX_COMPILATION_CACHE_DIR``, when set — always, even over an
     explicit argument, so a deployment's cache location is the one
     place every entry point (CLI, bench, tuner) agrees on;
  2. else the explicit ``cache_dir`` argument;
  3. else ``.jax_cache`` at the root of the source checkout — a fixed
     path (the cache key includes it), inside the tree, and listed in
     .gitignore.
"""

from __future__ import annotations

import os

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def compilation_cache_dir(cache_dir: str | None = None) -> str:
    """The directory the rules above select (nothing is created)."""
    return (
        os.environ.get("JAX_COMPILATION_CACHE_DIR")
        or cache_dir
        or DEFAULT_CACHE_DIR
    )


def enable_compilation_cache(cache_dir: str | None = None) -> str:
    """Point JAX at the persistent on-disk compilation cache.

    Returns the directory in effect, or "" when it cannot be created
    (cache disabled — e.g. a read-only checkout).
    """
    import jax

    cache_dir = compilation_cache_dir(cache_dir)
    try:
        os.makedirs(cache_dir, exist_ok=True)
    except OSError:
        return ""
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return cache_dir
