"""Audio datasets — port of ``paddle_tpu/audio/datasets.py`` (reference:
python/paddle/audio/datasets — ESC50/TESS).

Nothing is downloaded: the waveforms are synthesized from a seed with the
documented shapes and labels, byte-equal to the JAX package's (numpy
only), as ``vision.datasets`` does."""

from __future__ import annotations

import numpy as np

from ..io.dataset import Dataset

__all__ = ["ESC50", "TESS"]


class _SyntheticAudio(Dataset):
    sample_rate = 16000
    n_classes = 2
    duration = 1.0

    def __init__(self, mode: str = "train", feat_type: str = "raw", size=200,
                 **kwargs):
        self.mode = mode
        self.feat_type = feat_type
        self.size = size
        self._rng = np.random.default_rng(0 if mode == "train" else 1)
        self._labels = self._rng.integers(0, self.n_classes, size)

    def __len__(self):
        return self.size

    def __getitem__(self, idx):
        n = int(self.sample_rate * self.duration)
        rng = np.random.default_rng((0 if self.mode == "train" else 1, idx))
        label = int(self._labels[idx])
        freq = 200.0 + 50.0 * label
        t = np.arange(n) / self.sample_rate
        wave = (np.sin(2 * np.pi * freq * t)
                + 0.1 * rng.standard_normal(n)).astype(np.float32)
        return wave, label


class ESC50(_SyntheticAudio):
    """ESC-50 environmental sounds (50 classes, 5s @ 44.1k in the reference)."""

    sample_rate = 44100
    n_classes = 50
    duration = 5.0


class TESS(_SyntheticAudio):
    """TESS emotional speech (7 classes in the reference)."""

    sample_rate = 24414
    n_classes = 7
    duration = 2.0
