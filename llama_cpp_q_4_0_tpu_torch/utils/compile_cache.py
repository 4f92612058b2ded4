"""The build cache of the compiled code: the port's counterpart of XLA's
persistent compile cache.

The CUDA kernels (``kernels/build.py``, one nvcc per source) and the native
host library (``native/``, g++) are compiled once into one directory and
rebuilt only when a source is newer than its library.  ``enable`` names
that directory (default: the package's ``build/``) and returns it; call it
before the first build."""

from __future__ import annotations

import os


def enable(cache_dir: str | None = None) -> str:
    from ..kernels import build

    cache_dir = os.path.abspath(cache_dir or build.DEFAULT_BUILD_DIR)
    os.makedirs(cache_dir, exist_ok=True)
    build.BUILD_DIR = cache_dir
    return cache_dir
