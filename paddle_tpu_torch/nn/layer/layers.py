"""nn.Layer — port of ``paddle_tpu/nn/layer/layers.py`` as a
``torch.nn.Module`` with Paddle's API.

Parameters, buffers and sublayers live in torch's registries, so torch's
machinery (autograd, ``Module.to``, optimizers, ``state_dict`` under a torch
parent) works on a ``Layer`` unchanged; Paddle's names sit on top:
``create_parameter`` (a ``core.tensor.Parameter`` on the current place,
drawn from that device's global generator unless ``generator=`` names
another), ``add_sublayer``, ``add_parameter``, ``register_buffer(...,
persistable)``, ``sublayers`` / ``named_sublayers`` (self first, then each
sublayer's subtree in order), ``parameters()`` as a list,
``register_forward_pre_hook`` / ``register_forward_post_hook``,
``state_dict`` / ``set_state_dict`` under the JAX package's names and
``apply`` in its pre-order.

``state_dict()`` called the Paddle way returns the live parameters and the
persistable buffers (parameters first, then buffers, as the JAX package
orders them); called the torch way (``prefix=`` or ``keep_vars=``, as a
torch parent or ``weights.load_jax_state`` calls it) it is torch's.
``create_parameter(attr=ParamAttr(...))`` sets the parameter's
initializer, name, trainability, learning-rate factor, regularizer and
``need_clip`` (JAX ``layers.py`` :120-149, which leaves ``need_clip``
out).
"""

from __future__ import annotations

import collections
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from ...core import dtype as dtype_mod
from ...core.tensor import Parameter, Tensor
from ...device import resolve_device
from ...framework import ParamAttr
from ...framework.random import generator as global_generator

_layer_counter = collections.defaultdict(int)


def check_attr(attr, what):
    """``attr`` as ``create_parameter`` takes it: None, False (no
    parameter), a ``ParamAttr`` or a name (Paddle's ``ParamAttr(name=)``
    shorthand); returns it as None, False or a ``ParamAttr``."""
    if attr is None or attr is False or isinstance(attr, ParamAttr):
        return attr
    if isinstance(attr, str):
        return ParamAttr(name=attr)
    raise TypeError(f"{what}: a parameter attribute is None, False, a "
                    f"ParamAttr or a name, not {type(attr).__name__}")


class Layer(nn.Module):
    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = dtype_mod.convert_dtype(dtype)
        cls = self.__class__.__name__.lower()
        _layer_counter[cls] += 1
        self._full_name = (name_scope or cls) + f"_{_layer_counter[cls] - 1}"
        self._casted_by_pure_fp16 = False

    # ---- naming ----
    def full_name(self):
        return self._full_name

    def __setattr__(self, name, value):
        params = self.__dict__.get("_parameters")
        if params is not None and name in params and params[name] is not None \
                and isinstance(value, torch.Tensor) \
                and not isinstance(value, nn.Parameter):
            params[name].set_value(value)   # Paddle: assign into the param
            return
        super().__setattr__(name, value)

    # ---- registration API ----
    def add_parameter(self, name: str, parameter: Optional[Parameter]):
        if parameter is not None and not isinstance(parameter, nn.Parameter):
            raise TypeError("add_parameter expects a Parameter")
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name: str, sublayer: nn.Module):
        self.add_module(name, sublayer)
        return sublayer

    def register_buffer(self, name: str, tensor: Optional[torch.Tensor],
                        persistable: bool = True, *, persistent=None):
        super().register_buffer(
            name, tensor, persistable if persistent is None else persistent)
        return tensor

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, *, device=None,
                         generator=None) -> Parameter:
        """A ``Parameter`` of ``shape`` drawn by ``attr.initializer``, else
        ``default_initializer`` (default: zeros for a bias, Xavier-normal
        otherwise), in ``dtype`` (default: the layer's) on ``device``
        (default: the current place) from ``generator`` (default: that
        device's global generator). A ``ParamAttr`` also sets the
        parameter's name, ``trainable``, ``optimize_attr["learning_rate"]``,
        ``regularizer`` and ``need_clip``."""
        from .. import initializer as I

        attr = check_attr(attr, "create_parameter") or None
        dt = dtype_mod.convert_dtype(dtype) or self._dtype
        dev = resolve_device(device)
        init = (attr.initializer if attr is not None else None) \
            or default_initializer
        if init is None:
            init = I.Constant(0.0) if is_bias else I.XavierNormal()
        gen = generator if generator is not None else global_generator(dev)
        if attr is None:
            return Parameter(init(list(shape), dt, dev, gen))
        p = Parameter(init(list(shape), dt, dev, gen), name=attr.name,
                      trainable=attr.trainable)
        p.attr_named = attr.name is not None
        p.optimize_attr["learning_rate"] = attr.learning_rate
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
        return p

    def create_tensor(self, name=None, dtype=None, persistable=False):
        t = torch.zeros((), dtype=dtype_mod.convert_dtype(dtype)
                        or self._dtype, device=resolve_device()).as_subclass(
                            Tensor)
        t.persistable = persistable
        return t

    # ---- traversal ----
    def parameters(self, include_sublayers: bool = True) -> List[Parameter]:
        return list(super().parameters(include_sublayers))

    def sublayers(self, include_self: bool = False) -> List[nn.Module]:
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix="", include_self=False, layers_set=None):
        for name, m in self.named_modules(memo=layers_set, prefix=prefix):
            if m is self and not include_self:
                continue
            yield name, m

    def apply(self, fn):
        for layer in self.sublayers(include_self=True):
            fn(layer)
        return self

    # ---- hooks ----
    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, outputs)``; a non-None return replaces the
        outputs."""
        return self.register_forward_hook(hook)

    # ---- state dict ----
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True, **torch_kw):
        if torch_kw:   # torch's call (a torch parent, keep_vars=...)
            return super().state_dict(destination=destination, **torch_kw)
        dest = destination if destination is not None \
            else collections.OrderedDict()
        live = super().state_dict(keep_vars=True)
        params = {id(p) for p in self.parameters()}
        for key in [k for k, v in live.items() if id(v) in params] + \
                [k for k, v in live.items() if id(v) not in params]:
            dest[structured_name_prefix + key] = live[key]
        return dest

    to_static_state_dict = state_dict

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy each entry of ``state_dict`` (tensors or arrays) into the
        parameter or buffer of its name, cast to its dtype; returns
        (missing, unexpected) names. A shape mismatch raises."""
        own = self.state_dict()
        missing, unexpected = [], []
        for k, v in state_dict.items():
            if k not in own:
                unexpected.append(k)
                continue
            tgt = own[k]
            if not isinstance(v, torch.Tensor):
                v = np.array(v)   # a private, writable copy
                # ml_dtypes' bf16 (a JAX state) has no torch counterpart
                v = torch.from_numpy(v.astype(np.float32)
                                     if v.dtype.name == "bfloat16" else v)
            src = v
            if tuple(src.shape) != tuple(tgt.shape):
                raise ValueError(f"shape mismatch for {k}: "
                                 f"{tuple(src.shape)} vs {tuple(tgt.shape)}")
            with torch.no_grad():
                tgt.copy_(src.to(device=tgt.device, dtype=tgt.dtype))
        missing = [k for k in own if k not in state_dict]
        return missing, unexpected

    set_dict = set_state_dict
    load_dict = set_state_dict

    # ---- dtype / device ----
    def to(self, device=None, dtype=None, blocking=None, **kwargs):
        """Paddle's ``to(device, dtype)``; torch's positional forms
        (``to(torch.bfloat16)``, ``to("cuda")``) too."""
        if isinstance(device, torch.dtype):
            device, dtype = None, device
        if device is not None or kwargs:
            super().to(device, **kwargs)
        if dtype is not None:
            self._cast_all(dtype_mod.convert_dtype(dtype))
        return self

    def astype(self, dtype):
        self._cast_all(dtype_mod.convert_dtype(dtype))
        return self

    def _cast_all(self, dtype):
        """Cast the floating parameters and buffers in place (each
        ``Parameter`` keeps its identity)."""
        self._apply(lambda t: t.to(dtype) if t.is_floating_point() else t)
        for layer in self.sublayers(include_self=True):
            if isinstance(layer, Layer):
                layer._dtype = dtype

    def float(self):
        self._cast_all(torch.float32)
        return self

    def bfloat16(self):
        self._cast_all(torch.bfloat16)
        return self

    def half(self):
        self._cast_all(torch.float16)
        return self

    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None


class LayerList(nn.ModuleList, Layer):
    """Sublayers named "0", "1", ... (torch's ``ModuleList`` with
    ``Layer``'s API)."""


class Sequential(nn.Sequential, Layer):
    """Sublayers run in order: given as layers (named "0", "1", ...), as
    (name, layer) pairs or as one ``OrderedDict``."""

    def __init__(self, *layers):
        if layers and all(isinstance(l, tuple) for l in layers):
            layers = (collections.OrderedDict(layers),)
        super().__init__(*layers)


class ParameterList(nn.ParameterList, Layer):
    """Parameters named "0", "1", ... (torch's ``ParameterList`` with
    ``Layer``'s API)."""
