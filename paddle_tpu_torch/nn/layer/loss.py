"""``CrossEntropyLoss`` — port of ``paddle_tpu/nn/layer/loss.py`` (:9-24)."""

from __future__ import annotations

from .. import functional as F
from .layers import Layer


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        self.weight, self.ignore_index = weight, ignore_index
        self.reduction, self.soft_label, self.axis = (reduction, soft_label,
                                                      axis)
        self.use_softmax, self.label_smoothing = (use_softmax,
                                                  label_smoothing)

    def forward(self, input, label):
        return F.cross_entropy(input, label, self.weight, self.ignore_index,
                               self.reduction, self.soft_label, self.axis,
                               self.use_softmax, self.label_smoothing)
