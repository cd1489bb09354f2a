"""``paddle.save`` / ``paddle.load`` — port of
``paddle_tpu/framework/io.py``.

The file is the JAX package's: a pickle (protocol 4) of the object in
which every tensor is a ``_TensorPayload(array, dtype_str)`` holding a
numpy array. The payload class pickles under the JAX package's path
(``paddle_tpu.framework.io._TensorPayload``) without importing it, so for
the same values the two packages write byte-equal files and each loads
the other's. ``load`` gives CPU torch tensors (numpy arrays with
``return_numpy=True``).

bfloat16 payloads are numpy arrays of ``ml_dtypes.bfloat16``, the dtype
the JAX package's arrays carry. Without ``ml_dtypes`` a bf16 tensor can be
neither saved nor loaded: :class:`DtypeUnavailableError` says so, and no
value is ever read as another dtype.
"""

from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np
import torch

#: where the JAX package defines the payload class; the pickle names it
JAX_PAYLOAD = ("paddle_tpu.framework.io", "_TensorPayload")


class DtypeUnavailableError(RuntimeError):
    """A payload's dtype needs a package this installation lacks."""


class _TensorPayload:
    def __init__(self, array, dtype):
        self.array = array
        self.dtype = dtype


def _ml_dtypes(what: str):
    try:
        import ml_dtypes
    except ImportError:
        raise DtypeUnavailableError(
            f"cannot {what}: bfloat16 payloads are ml_dtypes arrays and "
            "ml_dtypes is not installed") from None
    return ml_dtypes


def _host_array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        bf16 = _ml_dtypes("save a bfloat16 tensor").bfloat16
        return t.view(torch.int16).numpy().view(bf16)
    return t.numpy()


def _to_saveable(obj: Any):
    if isinstance(obj, torch.Tensor):
        arr = _host_array(obj)
        return _TensorPayload(arr, str(arr.dtype))
    if isinstance(obj, dict):
        return {k: _to_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = type(obj)
        return t(_to_saveable(v) for v in obj)
    return obj


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    arr = np.array(arr)   # a private, writable copy
    if dtype == "bfloat16":
        if arr.dtype.itemsize != 2:
            raise ValueError(f"a bfloat16 payload holds {arr.dtype} data")
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _from_saveable(obj: Any, return_numpy=False):
    if isinstance(obj, _TensorPayload):
        if return_numpy:
            return obj.array
        return _tensor(obj.array, obj.dtype)
    if isinstance(obj, dict):
        return {k: _from_saveable(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = type(obj)
        return t(_from_saveable(v, return_numpy) for v in obj)
    return obj


class _Pickler(pickle._Pickler):
    """The standard pickler (byte-equal to the C one), except that the
    payload class is written under the JAX package's path."""

    def save_global(self, obj, name=None):
        if obj is not _TensorPayload:
            return super().save_global(obj, name)
        self.save(JAX_PAYLOAD[0])
        self.save(JAX_PAYLOAD[1])
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == JAX_PAYLOAD:
            return _TensorPayload
        if module == "ml_dtypes":
            return getattr(_ml_dtypes(f"load a {name} payload"), name)
        return super().find_class(module, name)


def save(obj, path, protocol=4, **configs):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        _Pickler(f, protocol).dump(_to_saveable(obj))


def load(path, return_numpy=False, **configs):
    with open(path, "rb") as f:
        obj = _Unpickler(f).load()
    return _from_saveable(obj, return_numpy)
