"""``Linear``, ``Embedding`` and ``Dropout`` — port of ``paddle_tpu/nn/
layer/common.py`` (:19-68), on :class:`Layer`."""

from __future__ import annotations

from ...device import resolve_device
from .. import functional as F
from .. import initializer as I
from .layers import Layer, check_attr


class Linear(Layer):
    """``y = x @ weight + bias`` with ``weight`` ``[in, out]`` (Paddle's
    layout, unlike ``torch.nn.Linear``): weight Xavier-normal, bias zero
    (``bias_attr=False``: none), drawn from ``generator`` (default: the
    device's global generator) on ``device`` (default: the current place;
    the CUDA device raises without a card)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, generator=None):
        super().__init__()
        check_attr(weight_attr, "Linear")
        check_attr(bias_attr, "Linear")
        dev = resolve_device(device)
        self.in_features, self.out_features = in_features, out_features
        self.weight = self.create_parameter(
            [in_features, out_features], default_initializer=I.XavierNormal(),
            device=dev, generator=generator)
        self.bias = (None if bias_attr is False else self.create_parameter(
            [out_features], is_bias=True, device=dev))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self.in_features}, out_features={self.out_features}"


class Embedding(Layer):
    """A ``[num_embeddings, embedding_dim]`` table, Xavier-normal, with row
    ``padding_idx`` (if given) zeroed; ids at a non-negative ``padding_idx``
    look up zeros (:func:`..functional.embedding`)."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *, device=None,
                 generator=None):
        super().__init__()
        check_attr(weight_attr, "Embedding")
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = padding_idx
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim],
            default_initializer=I.XavierNormal(), device=device,
            generator=generator)
        if padding_idx is not None:
            self.weight.detach()[padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Dropout(Layer):
    """Dropout in training mode, the identity (or the downscale) in eval
    mode; the keep masks come from ``generator`` (the owning model's) or
    the device's global generator."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None,
                 *, generator=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, self.p, self.axis, self.training, self.mode,
                         generator=self.generator)
