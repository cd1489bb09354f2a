"""The eager autograd API — port of ``paddle_tpu/core/autograd_engine.py``
(:24-64, :281-314) on ``torch.autograd``.

The JAX package keeps its own tape (``GradNode``, ``run_backward``); the
port's tape is torch's, so only the API is ported: ``no_grad`` /
``enable_grad`` / ``set_grad_enabled`` / ``grad_enabled`` switch torch's
grad mode, and :func:`grad` is ``torch.autograd.grad`` under Paddle's
arguments.
"""

from __future__ import annotations

import functools

import torch

from .tensor import Tensor


def grad_enabled() -> bool:
    return torch.is_grad_enabled()


def set_grad_enabled(mode: bool) -> bool:
    """Set grad mode; returns the previous mode (the JAX package's form:
    a plain call, not torch's context manager)."""
    prev = torch.is_grad_enabled()
    torch._C._set_grad_enabled(bool(mode))
    return prev


class no_grad:
    """Context manager / decorator disabling gradient recording
    (paddle.no_grad)."""

    def __enter__(self):
        self._prev = set_grad_enabled(False)
        return self

    def __exit__(self, *exc):
        set_grad_enabled(self._prev)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with no_grad():
                return fn(*args, **kwargs)

        return wrapper


class enable_grad:
    def __enter__(self):
        self._prev = set_grad_enabled(True)
        return self

    def __exit__(self, *exc):
        set_grad_enabled(self._prev)
        return False


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """``paddle.grad``: gradients of ``outputs`` with respect to ``inputs``
    (leaves or intermediate tensors) without touching any tensor's
    ``.grad``. ``retain_graph`` defaults to True, as in the JAX package (a
    later ``backward`` may still use the graph). An input the outputs do
    not depend on raises ``RuntimeError`` unless ``allow_unused``, which
    gives None.
    ``no_grad_vars`` (tensors whose gradient paths are cut) is not
    ported: a non-empty one raises."""
    if no_grad_vars:
        from .._later import later_slice

        raise later_slice("paddle.grad(no_grad_vars=...)",
                          "Paddle API surface", "8")
    outputs, inputs = _as_list(outputs), _as_list(inputs)
    if grad_outputs is not None:
        grad_outputs = _as_list(grad_outputs)
    retain = True if retain_graph is None else retain_graph
    grads = torch.autograd.grad(outputs, inputs, grad_outputs,
                                retain_graph=retain, create_graph=create_graph,
                                allow_unused=allow_unused)
    return [g if g is None or isinstance(g, Tensor) else g.as_subclass(Tensor)
            for g in grads]
