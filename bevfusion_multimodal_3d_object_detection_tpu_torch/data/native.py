"""ctypes binding of the native point prep (``csrc/pointprep.cc``).

The port's own copy of
``bevfusion_multimodal_3d_object_detection_tpu/data/native.py:24-146`` and
of its C++ source. The library is compiled with ``g++`` into
``build/native/`` at first use (again when the source is newer).

Unlike the JAX package, which falls back to numpy when the library is
missing, this binding raises: the native path subsamples with xorshift128+
and the numpy path with ``RandomState.choice``, so a silent switch would give
other points. A caller who wants numpy asks for it
(``NuScenesDataset(use_native=False)``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "pointprep.cc"
LIBRARY = Path(__file__).resolve().parents[2] / "build" / "native" / "libpointprep.so"

_lib = None
_lock = threading.Lock()


def build() -> Path:
    """Compile the library unless it is newer than its source; raises with
    the compiler's output when ``g++`` fails."""
    if LIBRARY.exists() and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime:
        return LIBRARY
    LIBRARY.parent.mkdir(parents=True, exist_ok=True)
    # a private name, then an atomic rename: processes building at once
    # never load a half-written file
    tmp = LIBRARY.with_name(f"{LIBRARY.name}.{os.getpid()}.{threading.get_ident()}")
    proc = subprocess.run(
        ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(SOURCE), "-o", str(tmp)],
        capture_output=True, text=True, timeout=300,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE} ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    tmp.replace(LIBRARY)
    return LIBRARY


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.pointprep_load_lidar.restype = ctypes.c_int
            lib.pointprep_load_lidar.argtypes = [
                ctypes.c_char_p, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.c_uint64,
            ]
            _lib = lib
        return _lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def load_lidar_native(path: str, record_floats: int, max_points: int, out_channels: int,
                      pc_range: Tuple[float, ...], seed: int) -> np.ndarray:
    """.bin read + strict range filter + zero pad or xorshift subsample ->
    (max_points, out_channels) float32; raises when the file cannot be read."""
    out = np.empty((max_points, out_channels), np.float32)
    r6 = np.asarray(pc_range, np.float32)
    n = get_lib().pointprep_load_lidar(
        str(path).encode(), record_floats, _fptr(out), max_points, out_channels,
        _fptr(r6), seed & 0xFFFFFFFFFFFFFFFF,
    )
    if n < 0:
        raise OSError(f"native point prep could not read {path}")
    return out

