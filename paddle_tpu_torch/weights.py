"""Carry weights from the JAX package into the port.

Both packages name parameters alike (``model.layers.0.self_attn.
q_proj_weight`` ...) and store projections as ``[in, out]``, so a JAX
state dict loads as it is: no renames, no transposes.
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
        if arr.dtype.name == "bfloat16":   # ml_dtypes: torch cannot wrap it
            arr = arr.astype(np.float32)
        arrays[name] = arr
    with torch.no_grad():
        for name, p in own.items():
            p.copy_(torch.from_numpy(arrays[name]))


def state_from_jax_layer(jax_model) -> Dict[str, np.ndarray]:
    """A ``paddle_tpu`` layer's parameters as host arrays (name -> array),
    the input :func:`load_jax_state` takes. Test-side helper: it reads the
    layer's ``state_dict()`` without importing the JAX package."""
    return {name: np.asarray(getattr(p, "_data", p))
            for name, p in jax_model.state_dict().items()}
