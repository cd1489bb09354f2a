"""The legacy reader-creator dataset API — port of ``paddle_tpu/dataset``
(the same readers over the port's synthetic datasets, byte-equal).

Parity anchor: python/paddle/dataset (uci_housing.py, mnist.py, cifar.py,
common.py) — the pre-2.0 API whose surface is *reader creators*: zero-arg
functions returning generators of per-sample tuples, composed with
``paddle.batch``-style combinators. The reference marks the whole package
deprecated and it downloads from URLs; this runtime has no egress, so the
readers here serve the SAME API shape over the in-repo synthetic datasets
(vision/datasets) and a deterministic synthetic housing table — real
iterables, not stubs.
"""

from __future__ import annotations

import numpy as np

from . import common  # noqa: F401
from . import uci_housing  # noqa: F401
from . import mnist  # noqa: F401
from . import cifar  # noqa: F401

__all__ = ["common", "uci_housing", "mnist", "cifar"]
