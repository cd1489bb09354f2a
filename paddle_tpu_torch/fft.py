"""paddle_tpu_torch.fft — port of ``paddle_tpu/fft.py`` (reference:
python/paddle/fft.py) on ``torch.fft`` (cuFFT on the card).

The same functions, ``norm`` ("backward" by default) and axis defaults as
the JAX module, each dispatched through ``core/op_registry.apply_fn``.
torch's FFTs take no bf16 (and fp16 only on the card at power-of-two
sizes) where JAX's complex transforms cast bf16 and fp16 to float32: every
transform here casts a bf16 or fp16 input to float32 first, so the results
are complex64 (or float32) as JAX's are. JAX refuses a bf16 input to its
real transforms (``rfft``, ``rfft2``, ``rfftn``, ``ihfft``); the port casts
it as for the others. ``fftfreq`` / ``rfftfreq`` are float32 unless
``dtype`` says otherwise, on the current place.
"""

from __future__ import annotations

import torch

from .core import dtype as dtype_mod
from .core.op_registry import apply_fn
from .core.tensor import Tensor
from .device import resolve_place

__all__ = [
    "fft", "ifft", "rfft", "irfft", "hfft", "ihfft",
    "fft2", "ifft2", "rfft2", "irfft2",
    "fftn", "ifftn", "rfftn", "irfftn",
    "fftfreq", "rfftfreq", "fftshift", "ifftshift",
]

_HALF = (torch.bfloat16, torch.float16)


def _in(a):
    """``a`` as torch's FFTs take it (half types in float32)."""
    if a.dtype in _HALF:
        return a.float()
    if not (a.is_floating_point() or a.is_complex()):
        return a.to(dtype_mod.get_default_dtype())
    return a


def _axes(axes):
    return None if axes is None else tuple(axes)


def _wrap1(op_name, fn):
    def f(x, n=None, axis=-1, norm="backward", name=None):
        # ifft / ihfft of a real input come back as conjugate views
        return apply_fn(op_name, lambda a: fn(_in(a), n=n, dim=axis,
                                              norm=norm).resolve_conj(), x)

    f.__name__ = op_name
    return f


def _wrapn(op_name, fn, default_axes):
    def f(x, s=None, axes=default_axes, norm="backward", name=None):
        return apply_fn(op_name, lambda a: fn(
            _in(a), s=None if s is None else tuple(s), dim=_axes(axes),
            norm=norm), x)

    f.__name__ = op_name
    return f


fft = _wrap1("fft", torch.fft.fft)
ifft = _wrap1("ifft", torch.fft.ifft)
rfft = _wrap1("rfft", torch.fft.rfft)
irfft = _wrap1("irfft", torch.fft.irfft)
hfft = _wrap1("hfft", torch.fft.hfft)
ihfft = _wrap1("ihfft", torch.fft.ihfft)
fft2 = _wrapn("fft2", torch.fft.fftn, (-2, -1))
ifft2 = _wrapn("ifft2", torch.fft.ifftn, (-2, -1))
rfft2 = _wrapn("rfft2", torch.fft.rfftn, (-2, -1))
irfft2 = _wrapn("irfft2", torch.fft.irfftn, (-2, -1))
fftn = _wrapn("fftn", torch.fft.fftn, None)
ifftn = _wrapn("ifftn", torch.fft.ifftn, None)
rfftn = _wrapn("rfftn", torch.fft.rfftn, None)
irfftn = _wrapn("irfftn", torch.fft.irfftn, None)


def _freq(fn, n, d, dtype):
    dt = dtype_mod.convert_dtype(dtype) or torch.float32
    return fn(int(n), d=float(d), dtype=torch.float32,
              device=resolve_place()).to(dt).as_subclass(Tensor)


def fftfreq(n, d=1.0, dtype=None, name=None):
    return _freq(torch.fft.fftfreq, n, d, dtype)


def rfftfreq(n, d=1.0, dtype=None, name=None):
    return _freq(torch.fft.rfftfreq, n, d, dtype)


def fftshift(x, axes=None, name=None):
    return apply_fn("fftshift", lambda a: torch.fft.fftshift(
        a, dim=_axes(axes)), x)


def ifftshift(x, axes=None, name=None):
    return apply_fn("ifftshift", lambda a: torch.fft.ifftshift(
        a, dim=_axes(axes)), x)
