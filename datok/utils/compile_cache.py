"""One place that decides where JAX keeps its persistent compile cache.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
nothing is changed here.  Otherwise the cache goes to a fixed
``.jax_cache/`` directory inside the checkout (listed in
``.gitignore``): the path is part of the cache key, so it must not move
between runs.  The CLI, ``chip_smoke.py`` and ``bench.py`` call
:func:`enable_compile_cache` before their first compilation.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; returns
    the directory in use."""
    env = os.environ.get(ENV)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
