"""Carry weights from the JAX package into the port.

Both packages name parameters alike (``model.layers.0.self_attn.
q_proj_weight`` ...) and store projections as ``[in, out]``, so a JAX
state dict loads as it is: no renames, no transposes. The JAX training
engine keys its AdamW moments by the same names, so its optimizer state
crosses over by name too (:func:`engine_state_from_jax`).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def load_jax_state(model: torch.nn.Module,
                   state: Mapping[str, np.ndarray]) -> None:
    """Copy ``state`` (name -> array) into ``model``'s parameters, cast to
    each parameter's dtype and device. Names and shapes must match exactly:
    a missing, unexpected or misshapen entry raises before anything is
    copied."""
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(state))
    unexpected = sorted(set(state) - set(own))
    if missing or unexpected:
        raise KeyError(f"state does not match the model: missing {missing}, "
                       f"unexpected {unexpected}")
    arrays = {}
    for name, p in own.items():
        arr = np.array(state[name])   # a private, writable copy
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"shape mismatch for {name}: {arr.shape} vs "
                             f"{tuple(p.shape)}")
        arrays[name] = _torch_wrappable(arr)
    with torch.no_grad():
        for name, p in own.items():
            p.copy_(torch.from_numpy(arrays[name]))


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


def engine_state_from_jax(jax_engine) -> Dict[str, object]:
    """A JAX ``Engine.state_dict()`` (built-in AdamW path) as host arrays:
    ``{"model": {name: array}, "m": {name: array}, "v": {name: array},
    "step": int}``. Names are the parameter names of both packages, so the
    result feeds the port's ``Engine.set_state_dict`` and compares with its
    ``state_dict()`` by name (:func:`engine_state_to_host`). Test-side
    helper: it imports nothing of the JAX package."""
    sd = jax_engine.state_dict()
    return {"model": {n: _host(a) for n, a in sd["model"].items()},
            "m": {n: _host(a) for n, a in sd["m"].items()},
            "v": {n: _host(a) for n, a in sd["v"].items()},
            "step": int(_host(sd["step"]))}


def engine_state_to_host(engine) -> Dict[str, object]:
    """The port's ``Engine.state_dict()`` in the same host form as
    :func:`engine_state_from_jax` (fp32 numpy arrays by name, int step)."""
    sd = engine.state_dict()
    return {"model": {n: _host(a) for n, a in sd["model"].items()},
            "m": {n: _host(a) for n, a in sd["m"].items()},
            "v": {n: _host(a) for n, a in sd["v"].items()},
            "step": int(sd["step"].item())}
