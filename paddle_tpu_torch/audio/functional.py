"""Audio functional ops — port of ``paddle_tpu/audio/functional.py``
(reference: python/paddle/audio/functional/functional.py + window.py,
librosa's mel / fbank / DCT / window math).

Windows, filterbanks and DCT bases are built on the host in numpy (float64,
rounded to the asked dtype once), as the JAX package builds them on the
host, then moved to the current place in one copy. ``hz_to_mel`` /
``mel_to_hz`` take a number (and return a float) or a tensor (computed on
its device); ``power_to_db`` runs on its input's device. None of them goes
through the dispatcher (nor do they in the JAX package).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core.tensor import Tensor, unwrap
from ..device import resolve_place

__all__ = ["hz_to_mel", "mel_to_hz", "mel_frequencies", "fft_frequencies",
           "compute_fbank_matrix", "power_to_db", "create_dct", "get_window"]

_F_SP = 200.0 / 3
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = math.log(6.4) / 27.0


def _place(arr, dtype):
    """A host array as a Paddle tensor of ``dtype`` on the current
    place."""
    t = torch.from_numpy(np.ascontiguousarray(arr, np.float64))
    return t.to(device=resolve_place(), dtype=dtype_mod.convert_dtype(
        dtype)).as_subclass(Tensor)


def _hz_to_mel_np(f, htk):
    f = np.asarray(f, np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    return np.where(f >= _MIN_LOG_HZ, _MIN_LOG_MEL + np.log(
        np.maximum(f, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP, f / _F_SP)


def _mel_to_hz_np(m, htk):
    m = np.asarray(m, np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    return np.where(m >= _MIN_LOG_MEL, _MIN_LOG_HZ * np.exp(
        _LOGSTEP * (m - _MIN_LOG_MEL)), _F_SP * m)


def hz_to_mel(freq, htk: bool = False):
    """Hz -> mel (reference: functional.py:29; the slaney scale by
    default)."""
    if not isinstance(freq, torch.Tensor):
        return float(_hz_to_mel_np(freq, htk))

    f = unwrap(freq).float()
    if htk:
        out = 2595.0 * torch.log10(1.0 + f / 700.0)
    else:
        out = torch.where(f >= _MIN_LOG_HZ, _MIN_LOG_MEL + torch.log(
            torch.clamp(f, min=1e-10) / _MIN_LOG_HZ) / _LOGSTEP, f / _F_SP)
    return out.as_subclass(Tensor)


def mel_to_hz(mel, htk: bool = False):
    if not isinstance(mel, torch.Tensor):
        return float(_mel_to_hz_np(mel, htk))

    m = unwrap(mel).float()
    if htk:
        out = 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    else:
        out = torch.where(m >= _MIN_LOG_MEL, _MIN_LOG_HZ * torch.exp(
            _LOGSTEP * (m - _MIN_LOG_MEL)), _F_SP * m)
    return out.as_subclass(Tensor)


def _mel_frequencies_np(n_mels, f_min, f_max, htk):
    mels = np.linspace(_hz_to_mel_np(f_min, htk), _hz_to_mel_np(f_max, htk),
                       n_mels)
    return _mel_to_hz_np(mels, htk)


def mel_frequencies(n_mels: int = 64, f_min: float = 0.0,
                    f_max: float = 11025.0, htk: bool = False,
                    dtype: str = "float32"):
    return _place(_mel_frequencies_np(n_mels, f_min, f_max, htk), dtype)


def fft_frequencies(sr: int, n_fft: int, dtype: str = "float32"):
    return _place(np.linspace(0, sr / 2, 1 + n_fft // 2), dtype)


def compute_fbank_matrix(sr: int, n_fft: int, n_mels: int = 64,
                         f_min: float = 0.0, f_max=None, htk: bool = False,
                         norm="slaney", dtype: str = "float32"):
    """Triangular mel filterbank [n_mels, 1 + n_fft // 2] (reference:
    functional.py:189; librosa.filters.mel)."""
    f_max = f_max or sr / 2.0
    fft_f = np.linspace(0, sr / 2, 1 + n_fft // 2)
    mel_f = _mel_frequencies_np(n_mels + 2, f_min, f_max, htk)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_f[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (mel_f[2: n_mels + 2] - mel_f[:n_mels])
        weights = weights * enorm[:, None]
    return _place(weights, dtype)


def power_to_db(spect, ref_value: float = 1.0, amin: float = 1e-10,
                top_db: float = 80.0):
    """Power spectrogram -> dB (reference: functional.py:262); ``top_db``
    clips below the largest value of the whole input."""
    s = unwrap(spect)
    log_spec = 10.0 * torch.log10(torch.clamp(s, min=amin))
    log_spec = log_spec - 10.0 * math.log10(max(amin, ref_value))
    if top_db is not None:
        log_spec = torch.maximum(log_spec, log_spec.max() - top_db)
    return log_spec.as_subclass(Tensor)


def create_dct(n_mfcc: int, n_mels: int, norm="ortho",
               dtype: str = "float32"):
    """DCT-II basis [n_mels, n_mfcc] (reference: functional.py:306)."""
    n = np.arange(n_mels, dtype=np.float64)
    k = np.arange(n_mfcc, dtype=np.float64)[None, :]
    dct = np.cos(math.pi / n_mels * (n[:, None] + 0.5) * k)
    if norm == "ortho":
        dct = dct * math.sqrt(2.0 / n_mels)
        dct[:, 0] *= 1.0 / math.sqrt(2.0)
    else:
        dct = dct * 2.0
    return _place(dct, dtype)


def _bohman(n):
    x = np.abs(np.linspace(-1, 1, n + 2)[1:-1])
    return (1 - x) * np.cos(math.pi * x) + np.sin(math.pi * x) / math.pi


_WINDOWS = {
    "hann": lambda n: 0.5 - 0.5 * np.cos(2 * math.pi * np.arange(n) / n),
    "hamming": lambda n: 0.54 - 0.46 * np.cos(2 * math.pi * np.arange(n)
                                              / n),
    "blackman": lambda n: (0.42 - 0.5 * np.cos(2 * math.pi * np.arange(n)
                                               / n)
                           + 0.08 * np.cos(4 * math.pi * np.arange(n) / n)),
    "bohman": _bohman,
    "triang": lambda n: 1 - np.abs(2 * np.arange(n) - (n - 1)) / n,
    "bartlett": lambda n: 1 - np.abs(2 * np.arange(n) - (n - 1)) / (n - 1),
    "rect": lambda n: np.ones(n),
    "cosine": lambda n: np.sin(math.pi / n * (np.arange(n) + 0.5)),
}


def get_window(window, win_length: int, fftbins: bool = True,
               dtype: str = "float32"):
    """Window function by name (reference: window.py get_window);
    ``('kaiser', beta)`` / ``('gaussian', std)`` / ``('exponential', None,
    tau)`` tuples as scipy takes them."""
    if isinstance(window, (tuple, list)):
        name, *params = window
        if name == "kaiser":
            # periodic (fftbins): the first N points of the N + 1 window
            w = np.kaiser(win_length + (1 if fftbins else 0),
                          params[0])[:win_length]
        elif name == "gaussian":
            x = np.arange(win_length) - (win_length - 1) / 2
            w = np.exp(-0.5 * (x / params[0]) ** 2)
        elif name == "exponential":
            x = np.abs(np.arange(win_length) - (win_length - 1) / 2)
            w = np.exp(-x / params[-1])
        else:
            raise ValueError(f"unknown window {name}")
        return _place(w, dtype)
    if window not in _WINDOWS:
        raise ValueError(f"unknown window {window}; options: "
                         f"{sorted(_WINDOWS)}")
    if fftbins:
        w = _WINDOWS[window](win_length)   # periodic: denominators use N
    else:
        # symmetric: evaluate with N - 1 denominators, close the window
        w = _WINDOWS[window](win_length - 1)
        w = np.concatenate([w, w[:1]])
    return _place(np.asarray(w, np.float64)[:win_length], dtype)


