"""paddle_tpu_torch — the PyTorch and CUDA port of ``paddle_tpu``.

The JAX package ``paddle_tpu`` stays the reference; this package mirrors its
module paths and names, runs PyTorch on an NVIDIA H100, and replaces each
Pallas TPU kernel with a kernel written by hand for Hopper (CUDA C++ built
from ``ops/csrc`` at first use). It imports ``torch`` and never ``jax`` or
``paddle_tpu``.

The top level is the eager Paddle API, as the JAX package's ``__init__``
exports it: the dtypes, ``Tensor`` / ``Parameter`` (subclasses of
``torch.Tensor``), the ``paddle.*`` tensor functions (``to_tensor``,
``matmul``, ``reshape``, the long tail of ``tensor/extras.py`` and
``toplevel_extras.py``, the in-place family ``abs_`` ... ``where_``),
``grad`` / ``no_grad``, ``ParamAttr``, ``seed`` and the RNG state, the
flags, ``set_device`` / ``get_device`` and the places, ``Model``,
``summary``, ``create_parameter``, the packages (``amp``, ``audio``,
``fft``, ``signal``, ``profiler``, ``nn``, ``vision``, ``hapi`` ...) and
``linalg``; ``jit`` (``to_static`` on ``torch.compile``, ``save``/``load``
on ``torch.export``), ``static`` (``enable_static`` / ``disable_static``,
``Program``, ``Executor``) and ``onnx``; ``flops`` (XLA's cost model's
rules over one forward's aten ops) and the packages ``sparse``, ``text``,
``distribution``, ``geometric``, ``quantization``, ``hub``, ``utils``,
``dataset`` and ``version``; ``DataParallel`` (``distributed``'s, which
averages gradients over its group).

Entry points (creation functions, layers, model construction,
``_init_paged_caches`` and the serving engine) run on the current place:
the CUDA device unless ``set_device("cpu")`` or ``device="cpu"`` asks for
the CPU, which runs every kernel's plain PyTorch version instead; without a
card the CUDA place raises. The training ``distributed.Engine`` and
``hapi.Model`` run where their model lives. Importing the package touches
no card.
"""

from __future__ import annotations

import torch as _torch

from ._later import later_slice
from . import io, metric, regularizer  # noqa: F401
from .core.autograd_engine import (enable_grad, grad, no_grad,  # noqa: F401
                                   set_grad_enabled)
from .core.dtype import (bfloat16, bool_ as bool, complex64,  # noqa: F401
                         complex128, float16, float32, float64,
                         get_default_dtype, int8, int16, int32, int64,
                         set_default_dtype, uint8)
from .core.tensor import Parameter, Tensor  # noqa: F401
from .device import (CPUPlace, CUDAPinnedPlace, CUDAPlace,  # noqa: F401
                     TPUPlace, get_device, resolve_device, resolve_dtype,
                     set_device)
from .flags import get_flags, set_flags  # noqa: F401
from .framework import ParamAttr, load, save  # noqa: F401
from .framework.random import get_rng_state, seed, set_rng_state  # noqa
from .tensor import *  # noqa: F401,F403
from .tensor import einsum, linalg  # noqa: F401
from . import amp, autograd, core, nn, optimizer, tensor  # noqa: F401,E402
from . import audio, fft, profiler, signal  # noqa: F401,E402
from . import (distributed, hapi, incubate, inference,  # noqa: F401,E402
               observability, vision)
from . import jit, onnx, static  # noqa: F401,E402
from . import (dataset, distribution, geometric, hub,  # noqa: F401,E402
               quantization, sparse, text, utils, version)
from .hapi.model import Model  # noqa: F401,E402
from .jit.api import to_static  # noqa: F401,E402

from .distributed import DataParallel  # noqa: F401,E402

# what the JAX package's top level has and a later slice brings:
# name -> (what, slice, ROADMAP Queue 1 item)
_LATER = {}


def create_parameter(shape, dtype="float32", name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """A standalone trainable parameter on the current place (reference:
    python/paddle/tensor/creation.py create_parameter): zeros for a bias,
    Xavier-uniform otherwise, unless an initializer is given."""
    from .nn import initializer as I

    init = default_initializer or (I.Constant(0.0) if is_bias
                                   else I.XavierUniform())
    return Parameter(init(shape, dtype), dtype=dtype, name=name)


def create_tensor(dtype="float32", name=None, persistable=False):
    """A 0-dim zero tensor of ``dtype`` on the current place."""
    from .core.dtype import convert_dtype

    return _torch.zeros((), dtype=convert_dtype(dtype),
                        device=resolve_device()).as_subclass(Tensor)


def in_dynamic_mode() -> bool:
    from .core import static_graph

    return not static_graph.static_mode_enabled()


def in_static_mode() -> bool:
    from .core import static_graph

    return static_graph.static_mode_enabled()


def enable_static():
    from .core import static_graph

    static_graph.enable_static_mode()


def disable_static(place=None):
    from .core import static_graph

    static_graph.disable_static_mode()


def is_compiled_with_cuda() -> bool:
    return True


def is_compiled_with_rocm() -> bool:
    return False


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_cinn() -> bool:
    return False


def is_compiled_with_distribute() -> bool:
    return True


def device_count() -> int:
    """The cards torch sees (``torch.cuda.device_count()``)."""
    return _torch.cuda.device_count()


def set_printoptions(**kwargs):
    """numpy's and torch's print options (precision, threshold,
    edgeitems, linewidth)."""
    import numpy as _np

    opts = {k: v for k, v in kwargs.items()
            if k in ("precision", "threshold", "edgeitems", "linewidth")}
    _np.set_printoptions(**opts)
    _torch.set_printoptions(**opts)


def flops(net, input_size, custom_ops=None, print_detail=False):
    """FLOPs of one forward at ``input_size``, counted by XLA's cost
    model's rules (:mod:`paddle_tpu_torch.hapi.flops`)."""
    from .hapi.flops import flops as _flops

    return _flops(net, input_size, custom_ops, print_detail)


def summary(net, input_size=None, dtypes=None, input=None):
    from .hapi.summary import summary as _summary

    return _summary(net, input_size, dtypes, input)


def __getattr__(name):
    if name in _LATER:
        raise later_slice(*_LATER[name])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
