"""Persistent XLA compilation cache for the entry points.

Entry points (``python -m cpuperformanceraytracer_tpu.app.cli``,
bench.py, chip_smoke.py) call :func:`setup_compile_cache` once at
start-up; importing the package, or calling ``cli.main`` from a test,
sets nothing. Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it
itself and nothing is set in code. Otherwise the cache lives at one
fixed directory inside the checkout: the path is part of what makes a
later run find its entries, so it never depends on a pid, a time or a
temporary directory.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
# <checkout>/.jax_cache (listed in .gitignore)
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def compile_cache_dir(environ=None) -> str:
    """The directory the cache uses: the environment's, else the fixed
    in-checkout default."""
    environ = os.environ if environ is None else environ
    return environ.get(ENV_VAR) or DEFAULT_DIR


def setup_compile_cache(environ=None) -> str:
    """Point JAX's persistent compilation cache at
    :func:`compile_cache_dir` and return that directory."""
    import jax

    environ = os.environ if environ is None else environ
    path = compile_cache_dir(environ)
    if not environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
