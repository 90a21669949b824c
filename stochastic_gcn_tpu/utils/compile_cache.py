"""Persistent XLA compilation cache at one fixed place.

Every entry point (the train and infer CLIs, ``bench.py``,
``chip_smoke.py``) compiles the same static shapes on every launch.  JAX
keys its persistent cache on the cache directory's path, so the directory
must not move with the working directory.

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself and the cache
  lives there and nowhere else; this module changes nothing.
* unset: ``<checkout>/tmp/jax_cache``, resolved from this package's
  location (``tmp/`` is git-ignored).
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "tmp", "jax_cache")


def compile_cache_dir(environ=None) -> tuple[str, bool]:
    """(directory, whether it came from ``JAX_COMPILATION_CACHE_DIR``)."""
    environ = os.environ if environ is None else environ
    path = environ.get(ENV_VAR, "")
    if path:
        return path, True
    return DEFAULT_DIR, False


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at :func:`compile_cache_dir`
    and return the directory."""
    path, from_env = compile_cache_dir()
    if not from_env:
        import jax
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    return path
