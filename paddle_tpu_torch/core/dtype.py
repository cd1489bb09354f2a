"""Dtype system — port of ``paddle_tpu/core/dtype.py`` on torch dtypes.

The names (``paddle.float32`` ...), ``convert_dtype``, ``dtype_name`` and the
default dtype are the JAX package's; the values are torch dtypes. A dtype
may be given as a string ("float32", "bf16", ...), a torch dtype or a numpy
dtype. ``complex128`` and ``float64`` exist as names; the port runs float64
only where torch does on the device (JAX needs x64 for it).
"""

from __future__ import annotations

import numpy as np
import torch

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_STR2DTYPE = {
    "bool": bool_,
    "uint8": uint8,
    "int8": int8,
    "int16": int16,
    "int32": int32,
    "int64": int64,
    "float16": float16,
    "bfloat16": bfloat16,
    "float32": float32,
    "float64": float64,
    "complex64": complex64,
    "complex128": complex128,
    "fp16": float16,
    "bf16": bfloat16,
    "fp32": float32,
    "fp64": float64,
}
_DTYPE2STR = {v: k for k, v in list(_STR2DTYPE.items())[:12]}


def convert_dtype(dtype):
    """Normalize a user-supplied dtype (str / numpy / torch) to a torch
    dtype; None stays None."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        if dtype not in _STR2DTYPE:
            raise ValueError(f"Unknown dtype string: {dtype!r}")
        return _STR2DTYPE[dtype]
    name = np.dtype(dtype).name
    if name not in _STR2DTYPE:
        raise ValueError(f"Unsupported dtype: {dtype!r}")
    return _STR2DTYPE[name]


def dtype_name(dtype) -> str:
    """"float32", "bfloat16", ... (numpy's names, as the JAX package
    prints them)."""
    return _DTYPE2STR[convert_dtype(dtype)]


def is_floating_point(dtype) -> bool:
    return convert_dtype(dtype).is_floating_point


def is_integer(dtype) -> bool:
    dt = convert_dtype(dtype)
    return not (dt.is_floating_point or dt.is_complex or dt == bool_)


def is_complex(dtype) -> bool:
    return convert_dtype(dtype).is_complex


# default dtype management (paddle.set_default_dtype)
_default_dtype = float32


def set_default_dtype(dtype) -> None:
    global _default_dtype
    dtype = convert_dtype(dtype)
    if not is_floating_point(dtype):
        raise TypeError("default dtype must be floating point")
    _default_dtype = dtype


def get_default_dtype():
    return _default_dtype
