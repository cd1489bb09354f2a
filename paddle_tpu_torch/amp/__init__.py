"""paddle_tpu_torch.amp — automatic mixed precision, port of
``paddle_tpu/amp/__init__.py`` (reference: python/paddle/amp).

``auto_cast`` installs an AMP state that the port's op dispatcher consults
(``core/op_registry.apply_fn``) exactly where the JAX package's does. Its
casts are the JAX package's, not ``torch.autocast``'s: only the seven ops
whose ``OpDef`` carries a category are ever cast (white ``linear``,
``conv``, ``matmul``; black ``softmax``, ``cross_entropy``,
``logsumexp``), so ``layer_norm``, ``exp``, ``sum`` and
``scaled_dot_product_attention`` run in the dtypes they are given, and
``custom_white_list=["exp"]`` changes nothing (``exp`` is neutral). Level
O2 makes every non-black registered op white. The default dtype is
bfloat16, as in the JAX package; ``dtype="float16"`` with ``GradScaler``'s
dynamic loss scaling is the fp16 recipe. Torch code outside the
dispatcher (the port's models call torch directly) is never cast, as the
JAX package never casts its models' raw ``jnp`` calls.

``decorate(level="O2")`` casts the floating parameters of every sublayer
to the AMP dtype in place (each ``Parameter`` keeps its identity, so an
optimizer built before it holds the same objects), except the norm layers
and ``excluded_layers``. ``master_weight``, ``save_dtype`` and
``master_grad`` are accepted and ignored, as in the JAX package.
``amp.debugging`` holds the nan/inf checker, op statistics and the
tensor-stats dumps (``dump_tensor_stats`` / ``compare_accuracy``).
"""

from __future__ import annotations

import contextlib

import torch

from ..core import op_registry
from ..core.dtype import convert_dtype, dtype_name
from . import debugging  # noqa: F401
from .amp_lists import BLACK_LIST, WHITE_LIST
from .grad_scaler import AmpScaler, GradScaler  # noqa: F401


class _AmpState:
    def __init__(self, enabled, dtype, level, custom_white, custom_black):
        self.enabled = enabled
        self.dtype = dtype
        self.level = level
        self.white = set(WHITE_LIST) | set(custom_white or ())
        self.black = set(BLACK_LIST) | set(custom_black or ())
        self.low_precision_ops = {}

    def classify(self, op_name, default_cat):
        if op_name in self.black:
            return op_registry.AMP_BLACK
        if op_name in self.white:
            return op_registry.AMP_WHITE
        if self.level == "O2":
            # pure low precision: every registered op but black runs low
            return (op_registry.AMP_WHITE
                    if default_cat != op_registry.AMP_BLACK
                    else op_registry.AMP_BLACK)
        return default_cat

    def record_op(self, name):
        self.low_precision_ops[name] = self.low_precision_ops.get(name, 0) + 1


def _amp_dtype(dtype):
    return convert_dtype("float16" if dtype == "float16" else "bfloat16")


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """Reference: amp/auto_cast.py:1014. Default dtype bfloat16."""
    prev = op_registry.amp_state
    op_registry.amp_state = _AmpState(enable, _amp_dtype(dtype), level,
                                      custom_white_list, custom_black_list)
    try:
        yield
    finally:
        op_registry.amp_state = prev


amp_guard = auto_cast


def is_auto_cast_enabled():
    st = op_registry.amp_state
    return bool(st and st.enabled)


def get_amp_dtype():
    st = op_registry.amp_state
    return dtype_name(st.dtype) if st else "float32"


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None, master_grad=False,
             excluded_layers=None):
    """Reference: amp/auto_cast.py decorate — O2 casts the models'
    parameters to the AMP dtype (see the module docstring); O1 changes
    nothing."""
    from ..nn.layer.norm import BatchNorm2D, LayerNorm

    single_model = not isinstance(models, (list, tuple))
    model_list = [models] if single_model else list(models)
    if level == "O2":
        dt = _amp_dtype(dtype)
        excl = excluded_layers if isinstance(excluded_layers,
                                             (list, tuple)) \
            else ([excluded_layers] if excluded_layers is not None else [])
        excl_types = tuple(e for e in excl if isinstance(e, type))
        for m in model_list:
            for layer in m.modules():
                if isinstance(layer, (BatchNorm2D, LayerNorm) + excl_types) \
                        or any(layer is e for e in excl):
                    continue
                for p in layer._parameters.values():
                    if p is not None and p.is_floating_point():
                        p.data = p.data.to(dt)
            m._casted_by_pure_fp16 = True
    if optimizers is None:
        return models if single_model else model_list
    return (models if single_model else model_list), optimizers


def is_float16_supported(device=None):
    """fp16 compute: the card's tensor cores (the flash kernels take fp16)."""
    return torch.cuda.is_available()


def is_bfloat16_supported(device=None):
    """bf16 compute: the card, and torch on the CPU."""
    return True

