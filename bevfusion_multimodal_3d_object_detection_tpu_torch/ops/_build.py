"""Build and load the port's CUDA kernel libraries.

Each source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface under ``build/kernels/`` (skipped while the
library is newer than its source) and loaded through ``ctypes``. `build`
starts one ``nvcc`` per stale source, all at once, and waits for them.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = {"pointnet_fused": "pointnet_fused.cu", "bev_pool": "bev_pool.cu"}

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(cuda_home) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def build(*names: str) -> Dict[str, Path]:
    """Compile the named libraries (all of them when none is named) and
    return their paths; raises with nvcc's output if any build fails."""
    names = names or tuple(SOURCES)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src, lib = CSRC / SOURCES[name], library_path(name)
        if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
            continue
        cmd = [
            _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(lib), str(src),
        ]
        procs[name] = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
    failures = []
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {SOURCES[name]} ({proc.returncode}):\n{out}")
    if failures:
        raise RuntimeError("\n".join(failures))
    return {name: library_path(name) for name in names}


def load(name: str, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed; `declare` sets its
    functions' argument and result types once."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)[name]))
            declare(lib)
            _loaded[name] = lib
        return lib
