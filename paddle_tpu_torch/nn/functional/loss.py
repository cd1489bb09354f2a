"""Cross entropy — port of ``cross_entropy`` (``paddle_tpu/nn/functional/
loss.py:22``) for hard labels over the last axis, through the op
dispatcher under the JAX package's black ``OpDef("cross_entropy")``
(bf16/fp16 logits run in fp32 under AMP)."""

from __future__ import annotations

import torch

from ..._later import later_slice
from ...core.op_registry import AMP_BLACK, OpDef, apply_fn

_XENT = OpDef("cross_entropy", None, amp=AMP_BLACK)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross entropy of ``input`` ``[N, C]`` against integer labels
    ``[N]`` or ``[N, 1]``, in fp32 (:22-57): labels equal to
    ``ignore_index`` count zero; ``weight`` ``[C]`` scales each label's
    loss. ``"mean"`` divides the sum by the number of kept labels (with
    ``weight``: by their summed weights), ``"sum"`` sums and ``"none"``
    returns ``[N]``."""
    if soft_label or label_smoothing or not use_softmax \
            or axis not in (-1, input.dim() - 1):
        raise later_slice("cross_entropy with soft labels, label smoothing, "
                          "use_softmax=False or a class axis other than the "
                          "last", "Paddle API surface", "8")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"unknown reduction {reduction!r}")
    if weight is None:
        return apply_fn("cross_entropy", lambda a, b: _xent(
            a, b, None, ignore_index, reduction), input, label,
            _opdef=_XENT)
    return apply_fn("cross_entropy", lambda a, b, w: _xent(
        a, b, w, ignore_index, reduction), input, label, weight,
        _opdef=_XENT)


def _xent(input, label, weight, ignore_index, reduction):
    logp = torch.log_softmax(input.float(), dim=-1)
    lbl = label.long()
    if lbl.dim() == logp.dim():
        lbl = lbl.squeeze(-1)
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, 0)
    loss = torch.where(valid, -logp.gather(-1, safe[..., None])[..., 0], 0.0)
    if weight is not None:
        wt = weight.float()[safe]
        loss = loss * wt
        if reduction == "mean":
            return loss.sum() / (wt * valid).sum().clamp_min(1e-12)
    if reduction == "mean":
        return loss.sum() / valid.sum().clamp_min(1)
    return loss.sum() if reduction == "sum" else loss
