"""Batch normalisation — port of ``batch_norm`` (``paddle_tpu/nn/
functional/norm.py`` :55-101), channels at axis 1.

The JAX package normalises with XLA ops (no Pallas kernel); the port calls
torch's batch norm (cuDNN on the card). In training it normalises by the
batch's statistics (population variance) and updates the running ones in
place: ``momentum * running + (1 - momentum) * batch``, with the unbiased
variance ``var * n / (n - 1)``. Paddle's ``momentum`` (0.9) is the weight
of the old value; torch's is that of the new one, so torch gets
``1 - momentum``. Outside training, or with ``use_global_stats``, it
normalises by the running statistics and updates nothing.
"""

from __future__ import annotations

import torch.nn.functional as F

from ..._later import later_slice


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    if not data_format.startswith("NC"):
        raise later_slice(f"batch_norm with data_format={data_format!r}",
                          "Paddle API surface", "8")
    use_batch_stats = bool(training and not use_global_stats)
    return F.batch_norm(x, running_mean, running_var, weight, bias,
                        use_batch_stats, 1.0 - momentum, epsilon)
