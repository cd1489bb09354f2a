"""Normalisation functionals — port of ``layer_norm`` and ``batch_norm``
(``paddle_tpu/nn/functional/norm.py`` :14-101), neutral ops of the
dispatcher.

``layer_norm`` computes as the JAX package does: statistics in fp32 (the
population variance), the normalised values cast back to the input's
dtype, then times ``weight`` and plus ``bias`` in the types the operands
promote to (a bf16 input with fp32 weights gives fp32, as in JAX).

``batch_norm`` calls torch's batch norm (cuDNN on the card). In training
it normalises by the batch's statistics (population variance) and updates
the running ones in place: ``momentum * running + (1 - momentum) *
batch``, with the unbiased variance ``var * n / (n - 1)``. Paddle's
``momentum`` (0.9) is the weight of the old value; torch's is that of the
new one, so torch gets ``1 - momentum``. Outside training, or with
``use_global_stats``, it normalises by the running statistics and updates
nothing.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..._later import later_slice
from ...core.op_registry import apply_fn


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    nd = len(tuple(normalized_shape))

    def fn(a, *wb):
        dims = tuple(range(a.ndim - nd, a.ndim))
        af = a.float()
        var, mean = torch.var_mean(af, dims, correction=0, keepdim=True)
        out = ((af - mean) / torch.sqrt(var + epsilon)).to(a.dtype)
        i = 0
        if weight is not None:
            out = out * wb[i]
            i += 1
        if bias is not None:
            out = out + wb[i]
        return out

    args = [x] + [w for w in (weight, bias) if w is not None]
    return apply_fn("layer_norm", fn, *args)


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    if not data_format.startswith("NC"):
        raise later_slice(f"batch_norm with data_format={data_format!r}",
                          "Paddle API surface", "8")
    use_batch_stats = bool(training and not use_global_stats)
    return apply_fn("batch_norm", lambda a, rm, rv, w, b: F.batch_norm(
        a, rm, rv, w, b, use_batch_stats, 1.0 - momentum, epsilon),
        x, running_mean, running_var, weight, bias)
