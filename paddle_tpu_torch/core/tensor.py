"""The framework Tensor — port of ``paddle_tpu/core/tensor.py``.

``Tensor`` is a subclass of ``torch.Tensor`` (the JAX package's is a handle
over an immutable ``jax.Array``). torch's default ``__torch_function__``
keeps the subclass on every op's output, so a Paddle tensor stays one
through torch ops and ``layer(paddle.to_tensor(x))`` returns a ``Tensor``
with Paddle's methods, while every port module that takes a
``torch.Tensor`` takes it unchanged. The methods ``tensor._install`` maps
(operators, ``reshape``, ``astype`` ...) live on this class only; nothing is
installed on ``torch.Tensor``.

Autograd is torch's: ``stop_gradient`` is the inverse of ``requires_grad``
(True by default, as ``to_tensor`` makes it), ``backward``,
``register_hook``, ``detach`` and ``clone`` are torch's, ``grad`` is the
gradient torch accumulated. ``Parameter`` is also a ``torch.nn.Parameter``,
so ``Module``s register it; ops on it return ``Tensor``.

Departures from the JAX package's class, where torch's own meaning is kept
because torch's code relies on it: ``shape`` is a ``torch.Size`` (a tuple;
JAX's is a list: compare with ``list(t.shape)``), ``size`` is torch's
method (Paddle's property is ``numel()``), ``dtype`` a torch dtype, and
``place`` the ``torch.device``. ``cuda``/``cpu``/``to`` move the data (the
JAX package has one device and returns the tensor).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.overrides import get_default_nowrap_functions

from . import dtype as dtype_mod


class Tensor(torch.Tensor):
    """A Paddle tensor (see the module docstring). Build one with
    ``paddle_tpu_torch.to_tensor`` or :func:`wrap`."""

    persistable = False
    is_parameter = False

    # ---- autograd flag ----
    @property
    def stop_gradient(self) -> bool:
        if not (self.is_floating_point() or self.is_complex()):
            return self.__dict__.get("_int_stop_gradient", True)
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value: bool) -> None:
        if not (self.is_floating_point() or self.is_complex()):
            # torch keeps no gradient of an integer tensor: the flag only
            self.__dict__["_int_stop_gradient"] = bool(value)
        elif value and not self.is_leaf:
            # torch cannot cut the graph at an op's output in place (it is
            # a view of the op's result); JAX's flag stops recording there
            raise RuntimeError("stop_gradient = True on an op's output: "
                               "torch cannot cut its graph in place; use "
                               "y = y.detach()")
        else:
            self.requires_grad_(not value)

    # ---- properties ----
    @property
    def place(self) -> torch.device:
        return self.device

    # ---- conversion ----
    def numpy(self) -> np.ndarray:
        """A host copy as numpy (bf16 as float32: numpy has no bf16)."""
        t = self.detach().cpu().as_subclass(torch.Tensor)
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    # ---- autograd ----
    def clear_grad(self):
        self.grad = None

    clear_gradient = clear_grad

    # ---- mutation ----
    def set_value(self, value):
        """Copy ``value`` (a tensor, array or number) into this tensor in
        place, cast to its dtype; the shapes must agree."""
        src = value if isinstance(value, torch.Tensor) else torch.as_tensor(
            np.asarray(value))
        if tuple(src.shape) != tuple(self.shape):
            raise ValueError(f"set_value shape mismatch: {tuple(src.shape)} "
                             f"vs {tuple(self.shape)}")
        with torch.no_grad():
            self.copy_(src.to(self.dtype))
        return self

    def pin_memory(self, *args, **kwargs):
        """torch's pinned copy where a card can use it; the tensor itself
        otherwise (the JAX package's, which has no pinned memory)."""
        if torch.cuda.is_available() and self.device.type == "cpu":
            return super().pin_memory(*args, **kwargs)
        return self

    def value(self):
        return self

    def __deepcopy__(self, memo):
        """A detached copy (same dtype, device, ``stop_gradient`` and
        attributes): torch's own protocol cannot build this subclass."""
        if id(self) in memo:
            return memo[id(self)]
        out = self.detach().as_subclass(torch.Tensor).clone().as_subclass(
            type(self))
        if self.requires_grad:
            out.requires_grad_(True)
        out.__dict__.update(self.__dict__)
        memo[id(self)] = out
        return out

    def get_tensor(self):
        return self

    def __repr__(self, *, tensor_contents=None):
        grad = "" if self.stop_gradient else ", stop_gradient=False"
        data = torch.Tensor.__repr__(self.detach().as_subclass(torch.Tensor))
        return (f"Tensor(shape={list(self.shape)}, "
                f"dtype={dtype_mod.dtype_name(self.dtype)}, "
                f"place={self.device}{grad},\n       {data})")

    def __format__(self, spec):
        if self.dim() == 0:
            return self.item().__format__(spec)
        return object.__format__(self, spec)


_NOWRAP = get_default_nowrap_functions()


def _to_tensor_type(ret):
    """Outputs of a torch function on a Parameter as ``Tensor``s (never as
    Parameters, which are made only on purpose)."""
    if isinstance(ret, (tuple, list)):
        return type(ret)(_to_tensor_type(r) for r in ret)
    if isinstance(ret, torch.Tensor) and not isinstance(ret, Tensor):
        return ret.as_subclass(Tensor)
    return ret


class Parameter(Tensor, torch.nn.Parameter):
    """Trainable tensor (reference: python/paddle/base/framework.py
    EagerParamBase): a ``torch.nn.Parameter`` (``Module``s register it)
    with Paddle's ``trainable`` (= not ``stop_gradient``), ``optimize_attr``,
    ``regularizer``, ``need_clip`` and ``persistable``."""

    persistable = True
    is_parameter = True

    def __new__(cls, data, dtype=None, name=None, trainable=True):
        data = data if isinstance(data, torch.Tensor) else torch.as_tensor(
            np.asarray(data))
        if dtype is not None:
            data = data.to(dtype_mod.convert_dtype(dtype))
        p = torch.Tensor._make_subclass(
            cls, data.detach().as_subclass(torch.Tensor), bool(trainable))
        p.optimize_attr = {"learning_rate": 1.0}
        p.regularizer = None
        p.need_clip = True
        p.initialized = True
        if name is not None:
            p.param_name = name
        return p

    @property
    def trainable(self) -> bool:
        return self.requires_grad

    @trainable.setter
    def trainable(self, value: bool) -> None:
        self.requires_grad_(bool(value))

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        with torch._C.DisableTorchFunctionSubclass():
            ret = func(*args, **(kwargs or {}))
        return ret if func in _NOWRAP else _to_tensor_type(ret)

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        out = Parameter(self.detach().clone(), trainable=self.requires_grad)
        out.__dict__.update(
            {k: (dict(v) if isinstance(v, dict) else v)
             for k, v in self.__dict__.items()})
        memo[id(self)] = out
        return out

    def __reduce_ex__(self, proto):
        return (Parameter, (self.detach().as_subclass(torch.Tensor), None,
                            None, self.requires_grad))

    def __repr__(self, *, tensor_contents=None):
        return "Parameter containing:\n" + super().__repr__()


def unwrap(x):
    """A Paddle ``Tensor`` as a plain ``torch.Tensor`` view (same storage,
    same autograd graph); anything else unchanged."""
    return x.as_subclass(torch.Tensor) if isinstance(x, Tensor) else x


def wrap(x, stop_gradient=True) -> Tensor:
    """``x`` as a Paddle ``Tensor``: a ``Tensor`` unchanged, another torch
    tensor as a view (same storage and graph), anything else through
    ``to_tensor`` on the current place."""
    if isinstance(x, Tensor):
        return x
    if isinstance(x, torch.Tensor):
        return x.as_subclass(Tensor)
    from ..tensor.creation import to_tensor

    return to_tensor(x, stop_gradient=stop_gradient)
