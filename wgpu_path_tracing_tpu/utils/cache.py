"""Persistent XLA compile cache location.

One rule for every entry point (``Renderer``, the CLI, ``bench.py``,
``chip_smoke.py``): if ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already
reads it and nothing is changed here; otherwise the cache lives in a fixed
``.jax_cache/`` directory at the checkout root (listed in .gitignore). A
fixed path matters: it is part of the cache key, so a directory that moves
never hits.
"""

from __future__ import annotations

import os

import jax

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def compile_cache_dir() -> str:
    """The directory the compile cache uses under the rule above."""
    return os.environ.get(CACHE_ENV) or DEFAULT_CACHE_DIR


def enable_compile_cache() -> str:
    """Apply the rule; returns the cache directory in effect."""
    if not os.environ.get(CACHE_ENV):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return compile_cache_dir()
