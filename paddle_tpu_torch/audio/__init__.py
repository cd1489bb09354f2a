"""paddle_tpu_torch.audio — port of ``paddle_tpu/audio`` (reference:
python/paddle/audio: functional/, features/, datasets/): windows, the mel
filterbank, ``power_to_db``, the DCT basis, and the feature layers
``Spectrogram``, ``MelSpectrogram``, ``LogMelSpectrogram`` and ``MFCC`` over
``signal.stft``."""

from . import datasets, features, functional  # noqa: F401
from .functional import (  # noqa: F401
    compute_fbank_matrix,
    create_dct,
    fft_frequencies,
    get_window,
    hz_to_mel,
    mel_frequencies,
    mel_to_hz,
    power_to_db,
)

__all__ = ["functional", "features", "datasets"]
