"""The kernel build cache.

Counterpart of ``bevfusion_multimodal_3d_object_detection_tpu/utils/cache.py``.
What the JAX package compiles at run time is XLA programs, which it keeps in
a persistent compilation cache. What the port compiles at run time is its
CUDA kernel libraries (``ops/_build.py``: one ``nvcc`` per source into
``build/kernels/`` by default, rebuilt only when the source is newer), so
`enable_compilation_cache` points that build at `cache_dir` when one is
given and, on a CUDA host, builds every library at once, so that no request
or step waits on ``nvcc``. The CLIs call it where the JAX CLIs do.

The JAX version's environment variables have no counterpart here:
``BMOD_PLATFORM`` pins a JAX backend, while the port's device is an explicit
argument; ``BMOD_JAX_CACHE`` moves or turns off XLA's persistent cache,
while the port persists nothing beyond the libraries.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import torch

from ..ops import _build


def enable_compilation_cache(cache_dir: Optional[str] = None) -> Path:
    """Build the kernel libraries into `cache_dir` (default
    ``build/kernels``), now when a CUDA device is present; returns the
    build directory."""
    if cache_dir is not None:
        _build.BUILD_DIR = Path(cache_dir)
    if torch.cuda.is_available():
        _build.build()
    return _build.BUILD_DIR
