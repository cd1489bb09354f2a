"""paddle.static.nn — port of ``paddle_tpu/static/nn.py`` (reference:
python/paddle/static/nn/common.py fc/conv2d/batch_norm/embedding).

Each helper builds the dygraph layer (eager parameters: the "startup
program" is eager initialization) and applies it to the symbolic Variable,
so the recording flows through the one op dispatcher.
"""

from __future__ import annotations

__all__ = ["fc", "embedding", "conv2d", "batch_norm", "dropout"]


def fc(x, size, num_flatten_dims=1, weight_attr=None, bias_attr=None,
       activation=None, name=None):
    from .. import nn

    in_features = 1
    for s in x.shape[num_flatten_dims:]:
        if s is None or int(s) < 0:
            raise ValueError(
                f"static.nn.fc: feature dims of '{getattr(x, 'name', 'x')}' "
                f"must be static, got shape {x.shape} (only the leading "
                f"{num_flatten_dims} batch dim(s) may be dynamic)")
        in_features *= int(s)
    layer = nn.Linear(in_features, size)
    if x.ndim > num_flatten_dims + 1:
        from .. import tensor as T

        x = T.reshape(x, list(x.shape[:num_flatten_dims]) + [in_features])
    out = layer(x)
    if activation:
        out = getattr(nn.functional, activation)(out)
    return out


def embedding(input, size, is_sparse=False, padding_idx=None,
              param_attr=None, dtype="float32"):
    from .. import nn

    layer = nn.Embedding(size[0], size[1], padding_idx=padding_idx)
    return layer(input)


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, data_format="NCHW"):
    from .. import nn

    in_ch = int(input.shape[1 if data_format == "NCHW" else -1])
    layer = nn.Conv2D(in_ch, num_filters, filter_size, stride=stride,
                      padding=padding, dilation=dilation, groups=groups,
                      data_format=data_format)
    return layer(input)


def batch_norm(input, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW"):
    from .. import nn

    ch = int(input.shape[1 if data_layout == "NCHW" else -1])
    layer = nn.BatchNorm2D(ch, momentum=momentum, epsilon=epsilon,
                           data_format=data_layout)
    if is_test:
        layer.eval()
    return layer(input)


def dropout(x, dropout_prob=0.5, is_test=False):
    from ..nn import functional as F

    return F.dropout(x, p=dropout_prob, training=not is_test)
