"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface (no PyTorch headers, so a
build takes seconds). Libraries land in ``build/kernels/`` at the root of
the checkout, named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one is reused. Nothing here runs at
import time: the CPU tests import every module on a machine without
``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
#: every kernel source of the port, built by :func:`build_all`
KERNELS = ("flash_fwd", "flash_bwd", "paged_decode")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built at first use and need the CUDA toolkit")
    return path


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, nvcc: str):
    """Start one nvcc build; returns (process, tmp path, final path, log)."""
    out = _library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = out.with_suffix(".log")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, log


def build_all(names: Iterable[str] = KERNELS) -> List[Path]:
    """Build every named kernel library that is not built yet, one nvcc per
    source, all started together. Raises ``RuntimeError`` naming each
    source that failed, with the compiler's output."""
    todo = [n for n in names if not _library_path(n).exists()]
    jobs = []
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = [(n, *_start(n, nvcc)) for n in todo]
    failed = []
    for name, proc, tmp, out, log in jobs:
        text, _ = proc.communicate()
        log.write_text(text)
        if proc.returncode != 0 or not tmp.exists():
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{text}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return [_library_path(n) for n in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = build_all([name])[0]
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and shared-memory report) of the last
    build of ``name``."""
    log = _library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
