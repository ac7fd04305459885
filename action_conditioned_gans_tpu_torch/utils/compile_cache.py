"""Where the port's compiled code is kept (port of the JAX package's
``utils/compile_cache.py``).

The JAX package caches XLA executables across processes when
``ACGAN_COMPILE_CACHE_DIR`` is set. The port compiles two things, both on
first use and both kept on disk keyed on their sources' hash: the Hopper
kernels (``nvcc``, ``ops/kernels/build.py``, default ``build/kernels``) and
the TFRecord library (``g++``, ``data/native_tfrecord.py``, default
``build/native``). ``ACGAN_COMPILE_CACHE_DIR`` moves both under one
directory, ``<dir>/kernels`` and ``<dir>/native``, so that checkouts or
containers can share the builds.

``ACGAN_COMPILE_CACHE_MIN_SECS`` has no meaning here: the JAX package skips
programs that compile faster than it, but every build of the port is a
library that a later process loads instead of compiling again, so every one
is kept whatever its time.
"""

from __future__ import annotations

import os
from typing import Optional

_ENV_DIR = "ACGAN_COMPILE_CACHE_DIR"


def maybe_enable_compile_cache(path: Optional[str] = None) -> Optional[str]:
    """Point the kernel and native builds at ``path`` (else
    ``$ACGAN_COMPILE_CACHE_DIR``); returns the directory, or None, changing
    nothing, when neither is set. Call it before the first build."""
    path = path or os.environ.get(_ENV_DIR)
    if not path:
        return None
    from action_conditioned_gans_tpu_torch.data import native_tfrecord
    from action_conditioned_gans_tpu_torch.ops.kernels import build

    path = os.path.abspath(path)
    build.BUILD_DIR = os.path.join(path, "kernels")
    native_tfrecord.BUILD_DIR = os.path.join(path, "native")
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    os.makedirs(native_tfrecord.BUILD_DIR, exist_ok=True)
    return path
