"""paddle_tpu_torch — the PyTorch and CUDA port of ``paddle_tpu``.

The JAX package ``paddle_tpu`` stays the reference; this package mirrors its
module paths and names, runs PyTorch on an NVIDIA H100, and replaces each
Pallas TPU kernel with a kernel written by hand for Hopper (CUDA C++ built
from ``ops/csrc`` at first use). It imports ``torch`` and never ``jax`` or
``paddle_tpu``.

Entry points (model construction, ``_init_paged_caches`` and the serving
engine) run on the CUDA device unless the caller passes ``device="cpu"``,
which runs every kernel's plain PyTorch version instead; the training
``distributed.Engine`` and ``hapi.Model`` run where their model lives.
Importing the package touches no card.
"""

from __future__ import annotations

from ._later import later_slice
from . import io, metric, regularizer  # noqa: F401
from .device import resolve_device, resolve_dtype  # noqa: F401
from .framework import load, save  # noqa: F401

__all__ = ["io", "load", "metric", "regularizer", "resolve_device",
           "resolve_dtype", "save"]

# what the JAX package's top level has and a later slice brings
_LATER = {
    "amp": "paddle_tpu_torch.amp (auto_cast, decorate, GradScaler, the op "
           "lists, debugging: its casts hang off the JAX op registry)",
    "flops": "paddle_tpu_torch.flops (XLA's cost model: torch has no "
             "counterpart that counts the same ops)",
    "ParamAttr": "ParamAttr (per-parameter regularizers and learning "
                 "rates)",
    "core": "paddle_tpu_torch.core", "tensor": "paddle_tpu_torch.tensor",
    "static": "paddle_tpu_torch.static", "jit": "paddle_tpu_torch.jit",
}


def __getattr__(name):
    if name in _LATER:
        raise later_slice(_LATER[name], "Paddle API surface", "8")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
