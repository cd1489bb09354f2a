"""Op registry and eager dispatcher — port of ``paddle_tpu/core/
op_registry.py``.

Each op is a plain function over ``torch.Tensor``s plus metadata (its AMP
category). Every Paddle function of the port calls :func:`apply_fn` (or
:func:`apply` for a registered op), which runs, in the JAX dispatcher's
order (:110-243):

  AMP autocast -> the function -> nan/inf check -> outputs.

There is no tape: torch's autograd records the function's ops as they run.
The function gets plain ``torch.Tensor`` views of the Paddle tensors among
its positional arguments. Its tensor outputs come back as Paddle
``Tensor``s unless a plain ``torch.Tensor`` was among them and no Paddle
tensor other than a ``Parameter``: a caller holding plain tensors (the
port's models, a layer's parameters aside) keeps them, and a creation op
(no tensor argument) returns a Paddle tensor.

AMP follows JAX's ``apply_fn`` exactly (:118-136): an op is classified only
when its ``OpDef`` carries a category other than neutral. Seven do in the
JAX package (white: ``linear``, ``conv``, ``matmul`` in ``tensor/math.py``
and in ``tensor/linalg.py``, ``column_parallel_linear``; black:
``softmax``, ``cross_entropy``, ``logsumexp``). For a white op the
positional tensors whose dtype is exactly float32 are cast to the AMP
dtype; for a black op the bf16/fp16 positional tensors are cast to
float32. Keyword arguments and integer tensors are never cast. Every other
op, whatever the op lists name, runs in the dtypes it is given.

The nan/inf check (``FLAGS_check_nan_inf``) reads every floating output
to the host, so it is off by default; ``check_nan_inf_level`` 0 raises
``FloatingPointError``, 1 or more warns; either way the counts land in the
numeric health word. The JAX dispatcher's static-graph interception
(:138-147) has no port: ``enable_static`` raises ``later_slice`` (item
8.5).

The tensor-stats hook ``stats_recorder`` (JAX :67, read at :230-231 and
:239-240), which ``amp.debugging.dump_tensor_stats`` sets, is called with
the op's name and its tensor outputs after the nan/inf check; with no
recorder set an op pays one ``is None`` test. ``profile_scope`` is
declared, as in JAX, and read by nothing.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, Optional

import torch

from .. import flags
from .tensor import Tensor, unwrap

# AMP categories (reference: python/paddle/amp/amp_lists.py)
AMP_WHITE = "white"  # run in low precision (matmul/conv class)
AMP_BLACK = "black"  # keep fp32 (softmax/norm/exp class)
AMP_NEUTRAL = "neutral"  # follow inputs


class OpDef:
    __slots__ = ("name", "fn", "amp", "doc")

    def __init__(self, name, fn, amp=AMP_NEUTRAL, doc=""):
        self.name = name
        self.fn = fn
        self.amp = amp
        self.doc = doc


OPS: Dict[str, OpDef] = {}


def register_op(name: str, amp: str = AMP_NEUTRAL):
    """Decorator: register a plain torch function as a framework op."""

    def deco(fn):
        OPS[name] = OpDef(name, fn, amp=amp, doc=fn.__doc__ or "")
        return fn

    return deco


def get_op(name: str) -> OpDef:
    return OPS[name]


# ---- AMP hook (set by paddle_tpu_torch.amp) ----
amp_state = None  # type: Optional[Any]

# ---- profiler hook (declared as in the JAX package; nothing reads it) ----
profile_scope = None  # type: Optional[Callable]

# ---- tensor-stats dump hook (set by paddle_tpu_torch.amp.debugging) ----
stats_recorder = None  # type: Optional[Any]

#: ops dispatched since the last reset (a plain counter; callers reset it)
dispatched = 0

_LOW = (torch.bfloat16, torch.float16)


def _check_nan_inf(name, outs):
    num_nan = num_inf = 0
    for a in outs:
        if a.is_floating_point():
            bad = ~torch.isfinite(a)
            if bool(bad.any()):
                num_nan += int(torch.isnan(a).sum())
                num_inf += int(torch.isinf(a).sum())
    if num_nan or num_inf:
        from ..framework import numeric_guard

        numeric_guard.report_nan_inf(num_nan, num_inf, source=f"op:{name}")
        msg = (f"Operator {name} output contains {num_nan} nan / "
               f"{num_inf} inf values")
        if flags.get_flag("check_nan_inf_level") == 0:
            raise FloatingPointError(msg)
        warnings.warn(msg)


def _amp_cast(args, op):
    """The positional arguments after AMP's casts for ``op`` (JAX :118-136)."""
    cat = amp_state.classify(op.name, op.amp)
    if cat == AMP_WHITE:
        tgt, cast = amp_state.dtype, torch.float32
        if flags.get_flag("low_precision_op_list"):
            amp_state.record_op(op.name)
    elif cat == AMP_BLACK:
        tgt, cast = torch.float32, _LOW
    else:
        return args
    return tuple(_cast(a, tgt) if isinstance(a, torch.Tensor)
                 and (a.dtype == cast if cast is torch.float32
                      else a.dtype in cast) else a for a in args)


def _cast(a, dtype):
    """``a`` in ``dtype``, a Paddle tensor staying one (the cast itself on
    the plain view: no Python dispatch of the subclass)."""
    if isinstance(a, Tensor):
        return unwrap(a).to(dtype).as_subclass(Tensor)
    return a.to(dtype)


def _outputs(out, paddle):
    """Tensor outputs as Paddle ``Tensor``s (when ``paddle``), the
    floating ones listed for the checks."""
    if isinstance(out, (tuple, list)):
        return type(out)(_outputs(o, paddle) for o in out)
    if paddle and isinstance(out, torch.Tensor) and not isinstance(out,
                                                                   Tensor):
        return out.as_subclass(Tensor)
    return out


def _flat_tensors(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat_tensors(o)]
    return [out] if isinstance(out, torch.Tensor) else []


def apply(name: str, *args, **kwargs):
    """Dispatch a registered op over tensor args."""
    op = OPS[name]
    return apply_fn(name, op.fn, *args, _opdef=op, **kwargs)


def apply_fn(name: str, fn: Callable, *args, _opdef: Optional[OpDef] = None,
             **kwargs):
    """Dispatch a function as an op named ``name`` (see the module
    docstring). Positional args may be tensors (Paddle or plain) or static
    values; kwargs are static and never cast."""
    global dispatched
    dispatched += 1
    if (_opdef is not None and _opdef.amp != AMP_NEUTRAL
            and amp_state is not None and amp_state.enabled):
        args = _amp_cast(args, _opdef)
    paddle = torch_plain = False
    plain = []
    for a in args:
        if isinstance(a, Tensor):
            paddle = paddle or not a.is_parameter
            a = unwrap(a)
        elif isinstance(a, torch.Tensor):
            torch_plain = True
        plain.append(a)
    out = fn(*plain, **kwargs)
    if flags._FLAGS["check_nan_inf"]:   # read once an op: no name check
        _check_nan_inf(name, _flat_tensors(out))
    if stats_recorder is not None:
        stats_recorder.record(name, _flat_tensors(out))
    return _outputs(out, paddle or not torch_plain)
