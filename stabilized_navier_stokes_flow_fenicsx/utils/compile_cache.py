"""One place that decides where JAX's persistent compilation cache lives.

Fine-mesh Newton programs take minutes to compile, so every entry point
(apps, ``bench.py``, ``chip_smoke.py``, the test suite) turns the cache
on through ``enable_compile_cache``.  ``JAX_COMPILATION_CACHE_DIR``, when
set, wins and nothing else is configured; otherwise the cache sits at a
fixed path inside the checkout, ``<repo>/.jax_cache`` (listed in
``.gitignore``).  The path is part of the cache key, so it must not move
between runs.
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir() -> str:
    """The cache directory the program uses."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(REPO_ROOT, ".jax_cache"))


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at ``compile_cache_dir()`` and cache
    every program that takes at least a second to compile.  Call before
    the first compilation; returns the directory."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    if "JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES" not in os.environ:
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    if "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS" not in os.environ:
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
