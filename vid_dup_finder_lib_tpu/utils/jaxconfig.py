"""JAX runtime configuration helpers."""

from __future__ import annotations

import os

# Fixed cache location inside the checkout (listed in .gitignore): the
# path is part of the cache key, so it never depends on $HOME, a
# temporary name, a pid or the time.
_REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str | None:
    """The persistent compile-cache directory this package configures:
    None when ``JAX_COMPILATION_CACHE_DIR`` is set (JAX reads it itself),
    else ``<checkout>/.jax_cache``."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return _REPO_CACHE_DIR


def enable_compilation_cache() -> None:
    """Persist compiled executables across processes.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX already uses that
    directory and this sets none of its own; otherwise the cache goes to
    ``<checkout>/.jax_cache``.
    """
    import jax

    path = cache_dir()
    if path is not None:
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    # cache every program, however small or quick to compile
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
