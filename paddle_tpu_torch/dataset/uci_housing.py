"""uci_housing reader creators — port of
``paddle_tpu/dataset/uci_housing.py`` (reference:
python/paddle/dataset/uci_housing.py).

Deterministic synthetic 13-feature regression table with the reference's
feature names and normalization contract (features standardized, target in
its own column) — the same shapes/types the reference's readers yield.
"""

from __future__ import annotations

import numpy as np

__all__ = ["feature_names", "train", "test"]

feature_names = [
    "CRIM", "ZN", "INDUS", "CHAS", "NOX", "RM", "AGE",
    "DIS", "RAD", "TAX", "PTRATIO", "B", "LSTAT",
]

_N_TRAIN, _N_TEST = 404, 102


def _table(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((_N_TRAIN + _N_TEST, 13)).astype(np.float32)
    w = rng.standard_normal(13).astype(np.float32)
    y = (x @ w + 0.1 * rng.standard_normal(len(x))).astype(np.float32)
    return x, y[:, None]


def train():
    """Reader creator: yields (features [13] f32, target [1] f32)."""

    def reader():
        x, y = _table(0)
        for i in range(_N_TRAIN):
            yield x[i], y[i]

    return reader


def test():
    def reader():
        x, y = _table(0)
        for i in range(_N_TRAIN, _N_TRAIN + _N_TEST):
            yield x[i], y[i]

    return reader
