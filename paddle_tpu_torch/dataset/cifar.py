"""cifar reader creators — port of ``paddle_tpu/dataset/cifar.py``
(reference: python/paddle/dataset/cifar.py): yields
(flattened CHW f32 in [0, 1], label int) over the synthetic vision datasets."""

from __future__ import annotations

import numpy as np

__all__ = ["train10", "test10", "train100", "test100"]


def _reader(cls_name, mode, n):
    from ..vision import datasets as D

    ds = getattr(D, cls_name)(mode=mode, size=n)

    def reader():
        for i in range(len(ds)):
            img, label = ds[i]
            a = np.asarray(img, np.float32)
            if a.ndim == 3:          # HWC -> CHW like the reference
                a = a.transpose(2, 0, 1)
            yield (a / 255.0).reshape(-1), int(np.asarray(label).reshape(-1)[0])

    return reader


def train10(n: int = 512):
    return _reader("Cifar10", "train", n)


def test10(n: int = 128):
    return _reader("Cifar10", "test", n)


def train100(n: int = 512):
    return _reader("Cifar100", "train", n)


def test100(n: int = 128):
    return _reader("Cifar100", "test", n)
