"""User ops — port of ``paddle_tpu/utils/custom_op.py``.

:func:`custom_op` registers a function of torch tensors in the port's op
registry, so it dispatches like every built-in op (AMP, the nan/inf check,
static recording). Its body may launch the user's own Triton or CUDA
kernel. A ``vjp`` wires its backward through a ``torch.autograd.Function``
(the analogue of ``PD_BUILD_GRAD_OP``); without one, autograd
differentiates through the body.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core import op_registry
from ..core.op_registry import AMP_NEUTRAL, OpDef, apply_fn


def custom_op(name: str, vjp: Optional[Callable] = None,
              amp: str = AMP_NEUTRAL):
    """Decorator: register ``fn`` as the op ``name``.

    ``vjp(*primals, cotangent) -> gradient or tuple of gradients`` (one per
    positional input) gives the backward.

    >>> @custom_op("my_gelu")
    ... def my_gelu(x):
    ...     return 0.5 * x * (1 + torch.tanh(0.7978845608 * (x + 0.044715
    ...                                                    * x ** 3)))
    """

    def deco(fn):
        kernel = fn
        if vjp is not None:
            class _Op(torch.autograd.Function):
                @staticmethod
                def forward(ctx, *args):
                    ctx.save_for_backward(*args)
                    return fn(*args)

                @staticmethod
                def backward(ctx, cot):
                    grads = vjp(*ctx.saved_tensors, cot)
                    return grads if isinstance(grads, tuple) else (grads,)

            _Op.__name__ = f"CustomOp_{name}"

            def kernel(*args):
                return _Op.apply(*args)

        op_registry.OPS[name] = OpDef(name, kernel, amp=amp,
                                      doc=fn.__doc__ or "")

        def call(*args, **kwargs):
            return apply_fn(name, kernel, *args, **kwargs)

        call.__name__ = name
        call.__doc__ = fn.__doc__
        call._kernel = kernel
        return call

    return deco
