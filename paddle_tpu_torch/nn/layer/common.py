"""Common layers — port of ``paddle_tpu/nn/layer/common.py``, on
:class:`Layer`. Layers with parameters take ``weight_attr`` /
``bias_attr`` (None, False for none, or a ``ParamAttr``), ``device``
(default: the current place; the CUDA device raises without a card) and
``generator`` (default: the device's global generator)."""

from __future__ import annotations

from ...device import resolve_device
from .. import functional as F
from .. import initializer as I
from .layers import Layer, check_attr


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Linear(Layer):
    """``y = x @ weight + bias`` with ``weight`` ``[in, out]`` (Paddle's
    layout, unlike ``torch.nn.Linear``): weight Xavier-normal, bias
    zero."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, generator=None):
        super().__init__()
        bias_attr = check_attr(bias_attr, "Linear")
        dev = resolve_device(device)
        self.in_features, self.out_features = in_features, out_features
        self.weight = self.create_parameter(
            [in_features, out_features], attr=check_attr(weight_attr,
                                                         "Linear"),
            default_initializer=I.XavierNormal(), device=dev,
            generator=generator)
        self.bias = (None if bias_attr is False else self.create_parameter(
            [out_features], attr=bias_attr, is_bias=True, device=dev,
            generator=generator))

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
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = padding_idx
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim],
            attr=check_attr(weight_attr, "Embedding"),
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


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None, *,
                 generator=None):
        super().__init__()
        self.p, self.data_format, self.generator = p, data_format, generator

    def forward(self, x):
        return F.dropout2d(x, self.p, self.training, self.data_format,
                           generator=self.generator)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None, *,
                 generator=None):
        super().__init__()
        self.p, self.data_format, self.generator = p, data_format, generator

    def forward(self, x):
        return F.dropout3d(x, self.p, self.training, self.data_format,
                           generator=self.generator)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None, *, generator=None):
        super().__init__()
        self.p, self.generator = p, generator

    def forward(self, x):
        return F.alpha_dropout(x, self.p, self.training,
                               generator=self.generator)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return F.flatten(x, self.start_axis, self.stop_axis)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size, self.scale_factor, self.mode = size, scale_factor, mode
        self.align_corners, self.align_mode = align_corners, align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingBilinear2D(Upsample):
    """Bilinear with ``align_corners=True`` (Paddle's class; the JAX
    package's interpolate ignores the flag)."""

    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True,
                         data_format=data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False,
                         data_format=data_format)


class Pad1D(Layer):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL", name=None):
        super().__init__()
        self.padding, self.mode, self.value = padding, mode, value
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value,
                     self.data_format)


class Pad2D(Pad1D):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad3D(Pad1D):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(Pad1D):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class Bilinear(Layer):
    """``weight`` [out, in1, in2] Xavier-normal, ``bias`` [1, out] zero."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None, *, device=None,
                 generator=None):
        super().__init__()
        bias_attr = check_attr(bias_attr, "Bilinear")
        dev = resolve_device(device)
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features],
            attr=check_attr(weight_attr, "Bilinear"), device=dev,
            generator=generator)
        self.bias = (None if bias_attr is False else self.create_parameter(
            [1, out_features], attr=bias_attr, is_bias=True, device=dev,
            generator=generator))

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.factor, self.data_format = upscale_factor, data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.factor, self.data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.factor, self.data_format = downscale_factor, data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.factor, self.data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups, self.data_format = groups, data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.output_sizes = output_sizes
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.fold(x, self.output_sizes, *self.args)
