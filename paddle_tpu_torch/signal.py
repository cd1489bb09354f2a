"""paddle_tpu_torch.signal — port of ``paddle_tpu/signal.py``
(reference: python/paddle/signal.py): ``frame``, ``overlap_add``, ``stft``
and ``istft``.

The layouts are JAX's: ``frame`` gives [..., frame_length, frames] (axis
-1) or [frames, frame_length, ...] (axis 0), ``stft`` [..., freq, frames].
``window=None`` is a window of ones; ``normalized`` divides by sqrt(n_fft);
a window shorter than ``n_fft`` is zero-padded on both sides, the left
(n_fft - win_length) // 2 (JAX's ``_pad_window``). ``stft`` runs
``torch.stft`` (cuFFT) over the input flattened to [batch, samples], which
pads (``center``, ``pad_mode``) and centres the window exactly so; bf16 and
fp16 inputs are cast to float32 (complex64 out).

``overlap_add`` and ``istft``'s overlap-add are one ``fold`` over all
frames (JAX loops over the frames in Python: two launches a frame on the
card). ``istft`` divides by JAX's envelope floor, max(sum of squared
windows, 1e-11), so it never calls ``torch.istft``, which raises where a
window fails NOLA and JAX divides by the floor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .core.op_registry import apply_fn
from .core.tensor import unwrap

__all__ = ["stft", "istft", "frame", "overlap_add"]


def frame(x, frame_length, hop_length, axis=-1, name=None):
    """Overlapping frames. axis=-1: [..., n] -> [..., frame_length, num];
    axis=0: [n, ...] -> [num, frame_length, ...]."""
    if axis not in (-1, 0):
        raise ValueError("frame supports axis in (-1, 0)")

    def fn(a):
        if axis == 0:
            a = torch.movedim(a, 0, -1)
        out = a.unfold(-1, frame_length, hop_length)   # [..., num, fl]
        if axis == 0:
            return torch.movedim(out, (-2, -1), (0, 1))
        return out.transpose(-1, -2)

    return apply_fn("frame", fn, x)


def _fold(fr, hop):
    """Overlap-add of frames [..., fl, num] at ``hop``: [..., n]."""
    fl, num = fr.shape[-2], fr.shape[-1]
    n = fl + hop * (num - 1)
    lead = fr.shape[:-2]
    out = F.fold(fr.reshape(-1, fl, num), (1, n), (1, fl), stride=(1, hop))
    return out.reshape(lead + (n,))


def overlap_add(x, hop_length, axis=-1, name=None):
    """Inverse of frame. axis=-1: [..., frame_length, num] -> [..., n];
    axis=0: [num, frame_length, ...] -> [n, ...]."""
    if axis not in (-1, 0):
        raise ValueError("overlap_add supports axis in (-1, 0)")

    def fn(a):
        if axis == 0:
            a = torch.movedim(a, (0, 1), (-1, -2))
        out = _fold(a, hop_length)
        return torch.movedim(out, -1, 0) if axis == 0 else out

    return apply_fn("overlap_add", fn, x)


def _pad_window(w, n_fft, win_length):
    lo = (n_fft - win_length) // 2
    return F.pad(w, (lo, n_fft - win_length - lo)) if win_length < n_fft \
        else w


def _window(window, win_length, like):
    w = unwrap(window)
    if w is None:
        return torch.ones(win_length, device=like.device)
    return w if isinstance(w, torch.Tensor) else torch.as_tensor(
        w, device=like.device)


def stft(x, n_fft, hop_length=None, win_length=None, window=None,
         center=True, pad_mode="reflect", normalized=False, onesided=True,
         name=None):
    """Short-time Fourier transform: [..., n_fft // 2 + 1 (or n_fft),
    frames]."""
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft

    def fn(a, *w):
        if not a.is_floating_point() or a.dtype in (torch.bfloat16,
                                                    torch.float16):
            a = a.float()
        win = w[0].to(a.dtype) if w else torch.ones(win_length,
                                                    dtype=a.dtype,
                                                    device=a.device)
        lead = a.shape[:-1]
        spec = torch.stft(a.reshape(-1, a.shape[-1]), n_fft, hop_length,
                          win_length, win, center=center, pad_mode=pad_mode,
                          normalized=normalized, onesided=onesided,
                          return_complex=True)
        return spec.reshape(lead + spec.shape[-2:])

    if window is None:
        return apply_fn("stft", fn, x)
    return apply_fn("stft", fn, x, _window(window, win_length, unwrap(x)))


def istft(x, n_fft, hop_length=None, win_length=None, window=None,
          center=True, normalized=False, onesided=True, length=None,
          return_complex=False, name=None):
    """Inverse STFT with the window-envelope normalization (JAX's floor
    1e-11 where the envelope vanishes)."""
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft

    def fn(spec, w):
        w_p = _pad_window(w.to(spec.real.dtype), n_fft, win_length)
        if normalized:
            spec = spec * n_fft ** 0.5
        fr = (torch.fft.irfft(spec, n=n_fft, dim=-2) if onesided
              else torch.fft.ifft(spec, dim=-2).real)
        fr = fr * w_p[:, None]
        num = fr.shape[-1]
        out = _fold(fr, hop_length)
        env = _fold((w_p * w_p)[:, None].expand(n_fft, num).contiguous(),
                    hop_length)
        out = out / torch.clamp(env, min=1e-11)
        n = out.shape[-1]
        if center:
            out = out[..., n_fft // 2: n - n_fft // 2]
        if length is not None:
            out = out[..., :length]
        return out

    return apply_fn("istft", fn, x, _window(window, win_length, unwrap(x)))
