"""C++ host ops — port of ``paddle_tpu/utils/cpp_extension.py``.

:func:`load` compiles the user's C++ sources with ``g++`` into a shared
library (cached by the sources' hash under the temporary directory) and
exposes each op it lists. An op runs on the host through ctypes: its
input goes to the host as float32, the C function runs, the result comes
back to the input's device, one round trip a call (the JAX package's
``pure_callback``). A card-speed user kernel belongs in a ``custom_op``
instead. C interface:

    extern "C" const char* pt_op_list();       // "relu6,scale2"
    extern "C" void <name>(const float* x, float* y, int64_t n);
    extern "C" void <name>_grad(const float* x, const float* gy,
                                float* gx, int64_t n);   // optional

elementwise over float32; ``<name>_grad``, when exported, is the op's
backward.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.op_registry import apply_fn

__all__ = ["load", "CppExtensionModule"]

_CACHE_DIR = os.path.join(tempfile.gettempdir(),
                          "paddle_tpu_torch_extensions")


def _build(name: str, sources: Sequence[str], extra_cflags=()) -> str:
    os.makedirs(_CACHE_DIR, exist_ok=True)
    blobs = []
    for s in sources:
        with open(s, "rb") as f:
            blobs.append(f.read())
    tag = hashlib.sha256(b"\0".join(blobs)
                         + repr(extra_cflags).encode()).hexdigest()[:16]
    so_path = os.path.join(_CACHE_DIR, f"{name}_{tag}.so")
    if os.path.exists(so_path):
        return so_path
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-o", so_path,
           *extra_cflags, *sources]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cpp_extension build failed:\n{proc.stderr}")
    return so_path


class _HostOp:
    """One C symbol wrapped as an op: a host round trip a call."""

    def __init__(self, lib, name: str, grad_name: Optional[str]):
        self._fn = getattr(lib, name)
        self._fn.argtypes = [ctypes.POINTER(ctypes.c_float),
                             ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
        self._fn.restype = None
        self.name = name
        self._grad = None
        if grad_name is not None:
            g = getattr(lib, grad_name)
            g.argtypes = [ctypes.POINTER(ctypes.c_float),
                          ctypes.POINTER(ctypes.c_float),
                          ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
            g.restype = None
            self._grad = g

    def _host_fwd(self, x: np.ndarray) -> np.ndarray:
        x = np.ascontiguousarray(x, np.float32)
        y = np.empty_like(x)
        self._fn(x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                 y.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), x.size)
        return y

    def _host_bwd(self, x: np.ndarray, gy: np.ndarray) -> np.ndarray:
        x = np.ascontiguousarray(x, np.float32)
        gy = np.ascontiguousarray(gy, np.float32)
        gx = np.empty_like(x)
        self._grad(x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                   gy.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                   gx.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), x.size)
        return gx

    def kernel(self):
        """The op's function of a tensor (built once): the tensor to the
        host as float32, the C symbol, the result back to its device; with
        ``<name>_grad`` exported, the same round trip as its backward."""
        cached = getattr(self, "_kernel", None)
        if cached is not None:
            return cached
        host_fwd, host_bwd = self._host_fwd, self._host_bwd

        def round_trip(f, *ts):
            arrs = [t.detach().float().cpu().numpy() for t in ts]
            return torch.from_numpy(f(*arrs)).to(ts[0].device)

        if self._grad is None:
            self._kernel = lambda a: round_trip(host_fwd, a)
            return self._kernel

        class _Op(torch.autograd.Function):
            @staticmethod
            def forward(ctx, a):
                ctx.save_for_backward(a)
                return round_trip(host_fwd, a)

            @staticmethod
            def backward(ctx, gy):
                (a,) = ctx.saved_tensors
                return round_trip(host_bwd, a, gy).to(a.dtype)

        self._kernel = _Op.apply
        return self._kernel

    def __call__(self, x):
        return apply_fn(f"custom_cpp_{self.name}", self.kernel(), x)


class CppExtensionModule:
    def __init__(self, so_path: str):
        self._lib = ctypes.CDLL(so_path)
        self.so_path = so_path
        self._lib.pt_op_list.restype = ctypes.c_char_p
        names = self._lib.pt_op_list().decode().split(",")
        self.op_names: List[str] = [n.strip() for n in names if n.strip()]
        for n in self.op_names:
            grad = f"{n}_grad"
            setattr(self, n, _HostOp(self._lib, n, grad if hasattr(
                self._lib, grad) else None))


def load(name: str, sources: Sequence[str], extra_cflags=(),
         verbose: bool = False) -> CppExtensionModule:
    """JIT-compile C++ sources and expose their ops
    (reference: cpp_extension.load)."""
    so = _build(name, sources, tuple(extra_cflags))
    return CppExtensionModule(so)
