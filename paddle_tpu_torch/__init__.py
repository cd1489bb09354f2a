"""paddle_tpu_torch — the PyTorch and CUDA port of ``paddle_tpu``.

The JAX package ``paddle_tpu`` stays the reference; this package mirrors its
module paths and names, runs PyTorch on an NVIDIA H100, and replaces each
Pallas TPU kernel with a kernel written by hand for Hopper (CUDA C++ built
from ``ops/csrc`` at first use). It imports ``torch`` and never ``jax`` or
``paddle_tpu``.

The top level is the eager Paddle API, as the JAX package's ``__init__``
(:11-35) exports it: the dtypes, ``Tensor`` / ``Parameter`` (subclasses of
``torch.Tensor``), the ``paddle.*`` tensor functions (``to_tensor``,
``matmul``, ``reshape`` ...), ``grad`` / ``no_grad``, ``ParamAttr``,
``seed`` and the RNG state, the flags, ``set_device`` / ``get_device``, the
``amp``, ``autograd``, ``nn`` and ``tensor`` packages and ``linalg`` (the
module ``tensor/linalg.py``, as in the JAX package).

Entry points (creation functions, layers, model construction,
``_init_paged_caches`` and the serving engine) run on the current place:
the CUDA device unless ``set_device("cpu")`` or ``device="cpu"`` asks for
the CPU, which runs every kernel's plain PyTorch version instead; without a
card the CUDA place raises. The training ``distributed.Engine`` and
``hapi.Model`` run where their model lives. Importing the package touches
no card.
"""

from __future__ import annotations

from ._later import later_slice
from . import io, metric, regularizer  # noqa: F401
from .core.autograd_engine import (enable_grad, grad, no_grad,  # noqa: F401
                                   set_grad_enabled)
from .core.dtype import (bfloat16, bool_ as bool, complex64,  # noqa: F401
                         complex128, float16, float32, float64,
                         get_default_dtype, int8, int16, int32, int64,
                         set_default_dtype, uint8)
from .core.tensor import Parameter, Tensor  # noqa: F401
from .device import (get_device, resolve_device, resolve_dtype,  # noqa: F401
                     set_device)
from .flags import get_flags, set_flags  # noqa: F401
from .framework import ParamAttr, load, save  # noqa: F401
from .framework.random import get_rng_state, seed, set_rng_state  # noqa
from .tensor import *  # noqa: F401,F403
from .tensor import einsum, linalg  # noqa: F401
from . import amp, autograd, core, nn, optimizer, tensor  # noqa: F401,E402

# what the JAX package's top level has and a later slice brings
_LATER = {
    "flops": "paddle_tpu_torch.flops (XLA's cost model: torch has no "
             "counterpart that counts the same ops)",
    "static": "paddle_tpu_torch.static", "jit": "paddle_tpu_torch.jit",
    "enable_static": "the static graph (enable_static: the op "
                     "dispatcher's static-graph interception)",
    "profiler": "paddle_tpu_torch.profiler",
}


def in_dynamic_mode() -> bool:
    return True


def is_compiled_with_cuda() -> bool:
    return True


def __getattr__(name):
    if name in _LATER:
        raise later_slice(_LATER[name], "Paddle API surface", "8")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
