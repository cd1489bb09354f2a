"""Audio feature layers — port of ``paddle_tpu/audio/features.py``
(reference: python/paddle/audio/features/layers.py: Spectrogram:45,
MelSpectrogram:130, LogMelSpectrogram:237, MFCC:344).

The buffers keep the JAX package's names (``fft_window``,
``fbank_matrix``, ``dct_matrix``), built on the host and moved to the
current place once, at construction. ``Spectrogram`` is |stft(x)| ** power
over [..., samples] -> [..., 1 + n_fft // 2, frames]; the others stack the
mel product, the dB conversion and the DCT on it, as in JAX. As in JAX only
``stft`` goes through the dispatcher (a stats dump sees the same ops);
unlike the JAX layers, which rewrap their results and so cut the tape, the
port's are differentiable.
"""

from __future__ import annotations

import torch

from ..core.tensor import Tensor, unwrap
from ..nn.layer.layers import Layer
from . import functional as AF

__all__ = ["Spectrogram", "MelSpectrogram", "LogMelSpectrogram", "MFCC"]


def _like(out, x):
    """``out`` a Paddle tensor where ``x`` is one."""
    return out.as_subclass(Tensor) if isinstance(x, Tensor) else out


class Spectrogram(Layer):
    def __init__(self, n_fft: int = 512, hop_length=None, win_length=None,
                 window: str = "hann", power: float = 2.0,
                 center: bool = True, pad_mode: str = "reflect",
                 dtype: str = "float32"):
        super().__init__()
        self.n_fft = n_fft
        self.hop_length = hop_length or n_fft // 4
        self.win_length = win_length or n_fft
        self.power = power
        self.center = center
        self.pad_mode = pad_mode
        self.register_buffer(
            "fft_window", AF.get_window(window, self.win_length, dtype=dtype))

    def forward(self, x):
        from .. import signal

        spec = signal.stft(x, self.n_fft, self.hop_length, self.win_length,
                           window=self.fft_window, center=self.center,
                           pad_mode=self.pad_mode)
        return _like(unwrap(spec).abs() ** self.power, spec)


class MelSpectrogram(Layer):
    def __init__(self, sr: int = 22050, n_fft: int = 2048, hop_length=None,
                 win_length=None, window: str = "hann", power: float = 2.0,
                 center: bool = True, pad_mode: str = "reflect",
                 n_mels: int = 64, f_min: float = 50.0, f_max=None,
                 htk: bool = False, norm="slaney", dtype: str = "float32"):
        super().__init__()
        self._spectrogram = Spectrogram(n_fft, hop_length, win_length, window,
                                        power, center, pad_mode, dtype)
        self.register_buffer("fbank_matrix", AF.compute_fbank_matrix(
            sr, n_fft, n_mels, f_min, f_max, htk, norm, dtype))

    def forward(self, x):
        spec = self._spectrogram(x)     # [..., freq, time]
        return _like(torch.einsum("mf,...ft->...mt",
                                  unwrap(self.fbank_matrix), unwrap(spec)),
                     spec)


class LogMelSpectrogram(Layer):
    def __init__(self, sr: int = 22050, n_fft: int = 2048, hop_length=None,
                 win_length=None, window: str = "hann", power: float = 2.0,
                 center: bool = True, pad_mode: str = "reflect",
                 n_mels: int = 64, f_min: float = 50.0, f_max=None,
                 htk: bool = False, norm="slaney", ref_value: float = 1.0,
                 amin: float = 1e-10, top_db=None, dtype: str = "float32"):
        super().__init__()
        self._melspectrogram = MelSpectrogram(
            sr, n_fft, hop_length, win_length, window, power, center,
            pad_mode, n_mels, f_min, f_max, htk, norm, dtype)
        self.ref_value, self.amin, self.top_db = ref_value, amin, top_db

    def forward(self, x):
        return AF.power_to_db(self._melspectrogram(x), self.ref_value,
                              self.amin, self.top_db)


class MFCC(Layer):
    def __init__(self, sr: int = 22050, n_mfcc: int = 40, n_fft: int = 2048,
                 hop_length=None, win_length=None, window: str = "hann",
                 power: float = 2.0, center: bool = True,
                 pad_mode: str = "reflect", n_mels: int = 64,
                 f_min: float = 50.0, f_max=None, htk: bool = False,
                 norm="slaney", ref_value: float = 1.0, amin: float = 1e-10,
                 top_db=None, dtype: str = "float32"):
        super().__init__()
        self._log_melspectrogram = LogMelSpectrogram(
            sr, n_fft, hop_length, win_length, window, power, center,
            pad_mode, n_mels, f_min, f_max, htk, norm, ref_value, amin,
            top_db, dtype)
        self.register_buffer("dct_matrix", AF.create_dct(n_mfcc, n_mels,
                                                         dtype=dtype))

    def forward(self, x):
        logmel = self._log_melspectrogram(x)    # [..., n_mels, time]
        return _like(torch.einsum("mk,...mt->...kt",
                                  unwrap(self.dct_matrix), unwrap(logmel)),
                     logmel)
