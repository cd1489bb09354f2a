"""Carry weights from the JAX package into the port.

Both packages name parameters alike (``model.layers.0.self_attn.
q_proj_weight``, ``gpt.layers.0.attn.qkv_weight``, ``bert.embeddings.
word_embeddings_weight``, ``layer1.0.conv1.weight`` ...) and store
projections as ``[in, out]`` and conv kernels as ``[out, in, kh, kw]``, so
a JAX state dict loads as it is: no renames, no transposes. A JAX
``Layer.state_dict()`` also holds the persistent buffers (BatchNorm's
``_mean`` and ``_variance``), which the port registers under the same
names. A tied embedding (GPT's ``gpt.wte``, BERT's MLM head) is one
parameter in both. The JAX training engine keys its AdamW moments (and a
pluggable optimizer's accumulators) by the same names, so its optimizer
state crosses over by name too (:func:`engine_state_from_jax`); an
optimizer's own ``state_dict`` keys them by position in both packages
(:func:`state_from_jax_optimizer`).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def load_jax_state(model: torch.nn.Module,
                   state: Mapping[str, np.ndarray]) -> None:
    """Copy ``state`` (name -> array) into ``model``'s parameters and
    persistent buffers (``model.state_dict()``'s names), cast to each
    tensor's dtype and device. Names and shapes must match exactly: a
    missing, unexpected or misshapen entry raises before anything is
    copied."""
    own = model.state_dict(keep_vars=True)
    missing = sorted(set(own) - set(state))
    unexpected = sorted(set(state) - set(own))
    if missing or unexpected:
        raise KeyError(f"state does not match the model: missing {missing}, "
                       f"unexpected {unexpected}")
    arrays = {}
    for name, t in own.items():
        arr = np.array(state[name])   # a private, writable copy
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch for {name}: {arr.shape} vs "
                             f"{tuple(t.shape)}")
        arrays[name] = _torch_wrappable(arr)
    with torch.no_grad():
        for name, t in own.items():
            t.copy_(torch.from_numpy(arrays[name]))


def _torch_wrappable(arr: np.ndarray) -> np.ndarray:
    if arr.dtype.name == "bfloat16":   # ml_dtypes: torch cannot wrap it
        return arr.astype(np.float32)
    return arr


def _host(x) -> np.ndarray:
    """A JAX array, a ``paddle_tpu`` Tensor or a torch tensor as a numpy
    array torch can wrap."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.is_floating_point() else x).numpy()
    return _torch_wrappable(np.array(getattr(x, "_data", x)))


def state_from_jax_layer(jax_model) -> Dict[str, np.ndarray]:
    """A ``paddle_tpu`` layer's parameters as host arrays (name -> array),
    the input :func:`load_jax_state` takes. Test-side helper: it reads the
    layer's ``state_dict()`` without importing the JAX package."""
    return {name: np.asarray(getattr(p, "_data", p))
            for name, p in jax_model.state_dict().items()}


def _host_tree(x):
    """Arrays (JAX, ``paddle_tpu`` Tensor, torch) in nested dicts, lists and
    tuples as numpy arrays; other leaves (ints, floats, strings) as they
    are."""
    if isinstance(x, dict):
        return {k: _host_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host_tree(v) for v in x)
    if isinstance(x, (torch.Tensor, np.ndarray)) or hasattr(x, "_data") \
            or hasattr(x, "__array__"):
        return _host(x)
    return x


def state_from_jax_optimizer(jax_opt) -> Dict[str, object]:
    """A ``paddle_tpu`` optimizer's ``state_dict()`` (``{"step_count",
    "accumulators": {name: {position: array}}, "LR_Scheduler"}``), or that
    dict itself, or a JAX Engine's ``state_dict()["opt"]`` ({acc: {param
    name: array}}), with every array on the host as numpy: the input of the
    port's ``Optimizer.set_state_dict`` and of the ``"opt"`` entry of
    ``Engine.set_state_dict``. Test-side helper: it imports nothing of the
    JAX package."""
    sd = jax_opt.state_dict() if hasattr(jax_opt, "state_dict") else jax_opt
    return _host_tree(sd)


def engine_state_from_jax(jax_engine) -> Dict[str, object]:
    """A JAX ``Engine.state_dict()`` as host arrays: ``{"model": {name:
    array}, "step": int}`` with the built-in AdamW's ``"m"`` and ``"v"``
    ({name: array}) or a pluggable optimizer's ``"opt"`` ({acc: {name:
    array}}). Names are the parameter names of both packages, so the
    result feeds the port's ``Engine.set_state_dict`` and compares with its
    ``state_dict()`` by name (:func:`engine_state_to_host`). Test-side
    helper: it imports nothing of the JAX package."""
    return _engine_host(jax_engine.state_dict())


def engine_state_to_host(engine) -> Dict[str, object]:
    """The port's ``Engine.state_dict()`` in the same host form as
    :func:`engine_state_from_jax` (fp32 numpy arrays by name, int step)."""
    return _engine_host(engine.state_dict())


def _engine_host(sd) -> Dict[str, object]:
    out = {k: _host_tree(sd[k]) for k in ("model", "m", "v", "opt")
           if k in sd}
    out["step"] = int(_host(sd["step"]))
    return out
