"""mnist reader creators — port of ``paddle_tpu/dataset/mnist.py``
(reference: python/paddle/dataset/mnist.py): yields
(image [784] f32 in [-1, 1], label int) over the synthetic vision dataset."""

from __future__ import annotations

import numpy as np

__all__ = ["train", "test"]


def _reader(mode, n):
    from ..vision.datasets import MNIST

    ds = MNIST(mode=mode, size=n)

    def reader():
        for i in range(len(ds)):
            img, label = ds[i]
            flat = np.asarray(img, np.float32).reshape(-1) / 127.5 - 1.0
            yield flat, int(np.asarray(label).reshape(-1)[0])

    return reader


def train(n: int = 512):
    return _reader("train", n)


def test(n: int = 128):
    return _reader("test", n)
