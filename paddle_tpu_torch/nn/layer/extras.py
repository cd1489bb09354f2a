"""The long tail of ``nn`` layers — port of ``paddle_tpu/nn/layer/
extras.py``: ``PairwiseDistance``, ``Softmax2D``, ``Unflatten``,
``FeatureAlphaDropout``, ``ZeroPad1D`` / ``3D``, ``LayerDict``, the
unpools, ``LPPool1D`` / ``2D`` and the fractional pools, the long-tail
losses with CTC, RNN-T, hierarchical sigmoid and the adaptive softmax,
``SpectralNorm``, ``RNNCellBase``, ``BiRNN``, ``BeamSearchDecoder`` and
``dynamic_decode``. Each layer holds its functional's settings
(:mod:`..functional.extras`) and the JAX layer's parameters and buffers
under their names, shapes and default initializers.

Beam search departs from the JAX package, whose ``dynamic_decode`` stacks
each step's tokens and never follows the beam indices back (:608-622), so
its ``ids[b, k]`` mixes hypotheses: the port's decoder returns each step's
parent beams too and ``dynamic_decode`` backtracks through them with
``gather_tree``, as Paddle's does.
"""

from __future__ import annotations

import math

import torch

from ...core.op_registry import apply_fn
from ...core.tensor import Tensor, unwrap
from ...device import resolve_device
from ...framework.random import generator as global_generator
from .. import initializer as I
from ..functional import extras as FX
from .layers import Layer, check_attr
from .rnn import RNN, nest_map

__all__ = [
    "PairwiseDistance", "Softmax2D", "Unflatten", "FeatureAlphaDropout",
    "ZeroPad1D", "ZeroPad3D", "LayerDict",
    "MaxUnPool1D", "MaxUnPool2D", "MaxUnPool3D",
    "LPPool1D", "LPPool2D", "FractionalMaxPool2D", "FractionalMaxPool3D",
    "SoftMarginLoss", "MultiLabelSoftMarginLoss", "MultiMarginLoss",
    "PoissonNLLLoss", "GaussianNLLLoss", "TripletMarginWithDistanceLoss",
    "CTCLoss", "RNNTLoss", "HSigmoidLoss", "AdaptiveLogSoftmaxWithLoss",
    "SpectralNorm", "RNNCellBase", "BiRNN", "BeamSearchDecoder",
    "dynamic_decode",
]


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return FX.pairwise_distance(x, y, self.p, self.epsilon, self.keepdim)


class Softmax2D(Layer):
    def forward(self, x):
        return FX.softmax_2d(x)


class Unflatten(Layer):
    """``axis`` split into ``shape``."""

    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis, self.shape_ = axis, [int(unwrap(s)) for s in shape]

    def forward(self, x):
        return apply_fn("unflatten", lambda a: a.unflatten(
            self.axis % a.ndim, self.shape_), x)


class FeatureAlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return FX.feature_alpha_dropout(x, self.p, self.training)


class ZeroPad1D(Layer):
    def __init__(self, padding, data_format="NCL", name=None):
        super().__init__()
        self.padding, self.data_format = padding, data_format

    def forward(self, x):
        from ..functional import pad

        return pad(x, self.padding, mode="constant", value=0.0,
                   data_format=self.data_format)


class ZeroPad3D(ZeroPad1D):
    def __init__(self, padding, data_format="NCDHW", name=None):
        super().__init__(padding, data_format, name)


class LayerDict(Layer):
    """An ordered dict of sublayers (reference: nn/layer/container.py)."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers:
            self.update(sublayers)

    def __getitem__(self, key):
        return self._modules[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

    def __delitem__(self, key):
        del self._modules[key]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules)

    def __contains__(self, key):
        return key in self._modules

    def keys(self):
        return self._modules.keys()

    def values(self):
        return self._modules.values()

    def items(self):
        return self._modules.items()

    def update(self, sublayers):
        for k, v in (sublayers.items() if isinstance(sublayers, dict)
                     else sublayers):
            self[k] = v

    def pop(self, key):
        layer = self._modules[key]
        del self._modules[key]
        return layer

    def clear(self):
        self._modules.clear()


class MaxUnPool1D(Layer):
    _n, _format = 1, "NCL"

    def __init__(self, kernel_size, stride=None, padding=0, data_format=None,
                 output_size=None, name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding)
        self.data_format = data_format or self._format
        self.output_size = output_size

    def forward(self, x, indices):
        k, s, p = self.args
        return getattr(FX, f"max_unpool{self._n}d")(
            x, indices, k, s, p, self.output_size, self.data_format)


class MaxUnPool2D(MaxUnPool1D):
    _n, _format = 2, "NCHW"


class MaxUnPool3D(MaxUnPool1D):
    _n, _format = 3, "NCDHW"


class LPPool1D(Layer):
    _fn, _format = "lp_pool1d", "NCL"

    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format=None, name=None):
        super().__init__()
        self.a = (norm_type, kernel_size, stride, padding, ceil_mode,
                  data_format or self._format)

    def forward(self, x):
        from ..functional import pooling

        return getattr(pooling, self._fn)(x, *self.a)


class LPPool2D(LPPool1D):
    _fn, _format = "lp_pool2d", "NCHW"


class FractionalMaxPool2D(Layer):
    """Fractional max pooling over JAX's pseudo-random intervals
    (:func:`..functional.extras.fractional_max_pool2d`), drawn anew each
    call unless ``random_u`` is fixed."""

    _n = 2

    def __init__(self, output_size, kernel_size=None, random_u=None,
                 return_mask=False, name=None):
        super().__init__()
        self.output_size, self.kernel_size = output_size, kernel_size
        self.random_u, self.return_mask = random_u, return_mask

    def forward(self, x):
        return getattr(FX, f"fractional_max_pool{self._n}d")(
            x, self.output_size, self.kernel_size, self.random_u,
            self.return_mask)


class FractionalMaxPool3D(FractionalMaxPool2D):
    _n = 3


class _LossBase(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction


class SoftMarginLoss(_LossBase):
    def __init__(self, reduction="mean", name=None):
        super().__init__(reduction)

    def forward(self, input, label):
        return FX.soft_margin_loss(input, label, self.reduction)


class MultiLabelSoftMarginLoss(_LossBase):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__(reduction)
        self.weight = weight

    def forward(self, input, label):
        return FX.multi_label_soft_margin_loss(input, label, self.weight,
                                               self.reduction)


class MultiMarginLoss(_LossBase):
    def __init__(self, p=1, margin=1.0, weight=None, reduction="mean",
                 name=None):
        super().__init__(reduction)
        self.p, self.margin, self.weight = p, margin, weight

    def forward(self, input, label):
        return FX.multi_margin_loss(input, label, self.p, self.margin,
                                    self.weight, self.reduction)


class PoissonNLLLoss(_LossBase):
    def __init__(self, log_input=True, full=False, epsilon=1e-8,
                 reduction="mean", name=None):
        super().__init__(reduction)
        self.log_input, self.full, self.epsilon = log_input, full, epsilon

    def forward(self, input, label):
        return FX.poisson_nll_loss(input, label, self.log_input, self.full,
                                   self.epsilon, self.reduction)


class GaussianNLLLoss(_LossBase):
    def __init__(self, full=False, epsilon=1e-6, reduction="mean", name=None):
        super().__init__(reduction)
        self.full, self.epsilon = full, epsilon

    def forward(self, input, label, variance):
        return FX.gaussian_nll_loss(input, label, variance, self.full,
                                    self.epsilon, self.reduction)


class TripletMarginWithDistanceLoss(_LossBase):
    def __init__(self, distance_function=None, margin=1.0, swap=False,
                 reduction="mean", name=None):
        super().__init__(reduction)
        self.distance_function = distance_function
        self.margin, self.swap = margin, swap

    def forward(self, input, positive, negative):
        return FX.triplet_margin_with_distance_loss(
            input, positive, negative, self.distance_function, self.margin,
            self.swap, self.reduction)


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank, self.reduction = blank, reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return FX.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                           self.blank, self.reduction, norm_by_times)


class RNNTLoss(Layer):
    def __init__(self, blank=0, fastemit_lambda=0.0, reduction="mean",
                 name=None):
        super().__init__()
        self.blank, self.reduction = blank, reduction
        self.fastemit_lambda = fastemit_lambda

    def forward(self, logits, labels, input_lengths, label_lengths):
        return FX.rnnt_loss(logits, labels, input_lengths, label_lengths,
                            self.blank, self.fastemit_lambda, self.reduction)


class HSigmoidLoss(Layer):
    """``weight`` [classes - 1, feature] Normal(0, 1 / sqrt(feature)),
    ``bias`` [classes - 1] zero (none with ``bias_attr=False``);
    ``is_custom`` trees take ``path_table`` / ``path_code`` in forward."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False, name=None,
                 *, device=None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        bias_attr = check_attr(bias_attr, "HSigmoidLoss")
        self.num_classes, self.is_sparse = num_classes, is_sparse
        self.weight = self.create_parameter(
            [num_classes - 1, feature_size],
            attr=check_attr(weight_attr, "HSigmoidLoss"),
            default_initializer=I.Normal(std=1.0 / math.sqrt(feature_size)),
            device=dev, generator=generator)
        self.bias = (None if bias_attr is False else self.create_parameter(
            [num_classes - 1], attr=bias_attr, is_bias=True,
            default_initializer=I.Constant(0.0), device=dev,
            generator=generator))

    def forward(self, input, label, path_table=None, path_code=None):
        return FX.hsigmoid_loss(input, label, self.num_classes, self.weight,
                                self.bias, path_table, path_code,
                                self.is_sparse)


class AdaptiveLogSoftmaxWithLoss(Layer):
    """The cluster-factored softmax: ``head_weight`` [in, shortlist +
    clusters] (``head_bias`` with ``head_bias=True``) and a (``tail_{i}_
    proj`` [in, in / div_value^(i+1)], ``tail_{i}_out``) pair a cluster,
    Xavier-uniform. ``forward`` returns ``(per-row log-probability,
    loss)``."""

    def __init__(self, in_features, n_classes, cutoffs, div_value=4.0,
                 head_bias=False, name=None, *, device=None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.cutoffs = list(cutoffs) + [n_classes]
        self.n_clusters = len(self.cutoffs) - 1
        self.head_size = self.cutoffs[0] + self.n_clusters
        self.in_features, self.n_classes = in_features, n_classes

        def param(shape, init):
            return self.create_parameter(shape, default_initializer=init,
                                         device=dev, generator=generator)

        self.head_weight = param([in_features, self.head_size],
                                 I.XavierUniform())
        self.head_bias = param([self.head_size], I.Constant(0.0)) \
            if head_bias else None
        self.tail_weights = []
        for i in range(self.n_clusters):
            hsz = max(1, int(in_features // (div_value ** (i + 1))))
            osz = self.cutoffs[i + 1] - self.cutoffs[i]
            w1 = param([in_features, hsz], I.XavierUniform())
            w2 = param([hsz, osz], I.XavierUniform())
            setattr(self, f"tail_{i}_proj", w1)
            setattr(self, f"tail_{i}_out", w2)
            self.tail_weights.append((w1, w2))

    def forward(self, input, label):
        return FX.adaptive_log_softmax_with_loss(
            input, label, self.head_weight, self.tail_weights, self.cutoffs,
            self.head_bias)

    def log_prob(self, input):
        """[rows, n_classes] log-probabilities."""
        has_b, n = self.head_bias is not None, self.n_clusters
        flat = [w for pair in self.tail_weights for w in pair]

        def fn(x, hw, *rest):
            hb = rest[0] if has_b else None
            rest = rest[1:] if has_b else rest
            x = x.float()
            logits = x @ hw.float()
            if hb is not None:
                logits = logits + hb.float()
            head = torch.log_softmax(logits, -1)
            c0 = self.cutoffs[0]
            parts = [head[:, :c0]]
            for i in range(n):
                tail = torch.log_softmax(
                    (x @ rest[2 * i].float()) @ rest[2 * i + 1].float(), -1)
                parts.append(head[:, c0 + i:c0 + i + 1] + tail)
            return torch.cat(parts, -1)

        return apply_fn("adaptive_log_softmax_log_prob", fn, input,
                        self.head_weight,
                        *([self.head_bias] if has_b else []), *flat)

    def predict(self, input):
        return apply_fn("argmax", lambda a: a.argmax(-1),
                        self.log_prob(input))


class SpectralNorm(Layer):
    """``weight / sigma``, sigma the largest singular value of ``weight``
    (``axis`` first, the rest flattened) by ``power_iters`` power
    iterations (at least one) from the buffers ``weight_u`` [h] and
    ``weight_v`` [w], which each call writes back (detached) so the
    estimate converges across calls. As in JAX the iterations are
    differentiated. The start vectors are standard normal draws from the
    port's generator of the layer's device."""

    def __init__(self, weight_shape, axis=0, power_iters=1, epsilon=1e-12,
                 name=None, dtype="float32", *, device=None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else global_generator(dev)
        self.axis, self.power_iters, self.epsilon = axis, power_iters, epsilon
        h = int(weight_shape[axis])
        w = math.prod(int(s) for s in weight_shape) // h
        self.register_buffer("weight_u", torch.randn(h, device=dev,
                                                     generator=gen))
        self.register_buffer("weight_v", torch.randn(w, device=dev,
                                                     generator=gen))

    def forward(self, weight):
        axis, iters, eps = self.axis, self.power_iters, self.epsilon

        def fn(wt, u, v):
            mat = wt.movedim(axis, 0).reshape(wt.shape[axis], -1)
            for _ in range(max(iters, 1)):
                v = mat.T @ u
                v = v / (torch.linalg.vector_norm(v) + eps)
                u = mat @ v
                u = u / (torch.linalg.vector_norm(u) + eps)
            return wt / (u @ mat @ v), u.detach(), v.detach()

        out, u, v = apply_fn("spectral_norm", fn, weight, self.weight_u,
                             self.weight_v)
        # new buffers (the old ones stay saved for the backward)
        self.weight_u, self.weight_v = unwrap(u), unwrap(v)
        return out


class RNNCellBase(Layer):
    """Base of user cells: ``get_initial_states`` from ``state_shape``."""

    def get_initial_states(self, batch_ref, shape=None, dtype="float32",
                           init_value=0.0, batch_dim_idx=0):
        """[batch, h] states of ``init_value``, h each size of ``shape``
        (default ``[self.state_shape]``): one tensor for one size, a tuple
        for several; in ``dtype`` (which JAX ignores, keeping fp32) on
        ``batch_ref``'s device."""
        from ...core import dtype as dtype_mod

        ref = unwrap(batch_ref)
        b = ref.shape[batch_dim_idx]
        hidden = shape or [self.state_shape]
        if isinstance(hidden, int):
            hidden = [hidden]
        dt = dtype_mod.convert_dtype(dtype) or torch.float32

        def mk(h):
            return torch.full((b, int(h)), float(init_value), dtype=dt,
                              device=ref.device).as_subclass(Tensor)

        if len(hidden) == 1:
            return mk(hidden[0])
        return tuple(mk(h) for h in hidden)


class BiRNN(Layer):
    """Two cells over time, one forward and one reversed, their outputs
    concatenated; ``sequence_length`` freezes each direction's state past
    a row's length (see :class:`.rnn.RNN`)."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        st_fw, st_bw = (initial_states if initial_states is not None
                        else (None, None))
        out_fw, s_fw = self.rnn_fw(inputs, st_fw, sequence_length)
        out_bw, s_bw = self.rnn_bw(inputs, st_bw, sequence_length)
        out = apply_fn("concat", lambda a, b: torch.cat([a, b], -1), out_fw,
                       out_bw)
        return out, (s_fw, s_bw)


class BeamSearchDecoder:
    """Beam search over ``cell`` (embedding -> cell -> ``output_fn``), the
    JAX package's step (:576-605): each beam's log-softmax (finished beams
    extend only with ``end_token`` at zero cost) added to its score, the
    best ``beam_size`` of beams x vocabulary kept, the cell states gathered
    by beam. ``step`` returns ``((tokens, scores, finished), states,
    (tokens, parent beams), finished)``: unlike JAX's, its outputs carry
    the parents, which :func:`dynamic_decode` backtracks."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token, self.end_token = int(start_token), int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn, self.output_fn = embedding_fn, output_fn

    def initialize(self, initial_cell_states):
        first = unwrap(initial_cell_states[0] if isinstance(
            initial_cell_states, (tuple, list)) else initial_cell_states)
        b, k, dev = first.shape[0], self.beam_size, first.device
        tokens = torch.full((b, k), self.start_token, dtype=torch.int64,
                            device=dev)
        log_probs = torch.tensor([[0.0] + [-1e9] * (k - 1)],
                                 device=dev).repeat(b, 1)
        finished = torch.zeros((b, k), dtype=torch.bool, device=dev)
        states = nest_map(lambda s: unwrap(s).repeat_interleave(k, 0)
                          .as_subclass(Tensor), initial_cell_states)
        return (tokens, log_probs, finished), states

    def step(self, time, inputs, states):
        tokens, log_probs, finished = (unwrap(t) for t in inputs)
        b, k = tokens.shape
        flat_tok = tokens.reshape(-1).as_subclass(Tensor)
        emb = self.embedding_fn(flat_tok) if self.embedding_fn else flat_tok
        out, new_states = self.cell(emb, states)
        logits = self.output_fn(out) if self.output_fn else out
        logp = torch.log_softmax(unwrap(logits).float(), -1)
        V = logp.shape[-1]
        logp = logp.reshape(b, k, V)
        pad = torch.full((V,), -1e9, device=logp.device)
        pad[self.end_token] = 0.0
        logp = torch.where(finished[..., None], pad, logp)
        total = log_probs[..., None] + logp
        top_lp, top_idx = torch.topk(total.reshape(b, k * V), k)
        beam_idx = top_idx // V
        tok = top_idx % V
        fin = finished.gather(1, beam_idx) | (tok == self.end_token)

        def pick(s):
            a = unwrap(s)
            a = a.reshape((b, k) + tuple(a.shape[1:]))
            idx = beam_idx.reshape((b, k) + (1,) * (a.ndim - 2)).expand(
                (b, k) + tuple(a.shape[2:]))
            return a.gather(1, idx).reshape(
                (b * k,) + tuple(a.shape[2:])).as_subclass(Tensor)

        new_states = nest_map(pick, new_states)
        return (tok, top_lp, fin), new_states, (tok, beam_idx), fin


def dynamic_decode(decoder, inits=None, max_step_num=100,
                   output_time_major=False, impute_finished=False,
                   is_test=False, return_length=False, **kwargs):
    """Run ``decoder`` until every beam finishes or ``max_step_num`` steps:
    returns ``(ids [batch, beam, time], final scores)`` (``[time, batch,
    beam]`` when ``output_time_major``; with ``return_length`` also each
    hypothesis' length up to and including its first end token). The ids
    are the backtracked hypotheses (``gather_tree`` over the steps'
    parents), Paddle's result, where JAX stacks the raw step tokens.
    ``impute_finished`` and ``is_test`` change neither the ids nor the
    scores; any other keyword raises ``TypeError``."""
    if kwargs:
        raise TypeError(f"dynamic_decode got unexpected arguments "
                        f"{sorted(kwargs)}")
    inputs, states = decoder.initialize(inits)
    toks, parents = [], []
    for t in range(int(max_step_num)):
        inputs, states, (tok, parent), fin = decoder.step(t, inputs, states)
        toks.append(tok)
        parents.append(parent)
        if bool(fin.all()):
            break
    ids = unwrap(FX.gather_tree(torch.stack(toks, 0),
                                torch.stack(parents, 0))).permute(1, 2, 0)
    scores = inputs[1].as_subclass(Tensor)
    lengths = None
    if return_length:
        T = ids.shape[-1]
        is_end = ids == decoder.end_token
        first = torch.where(is_end.any(-1), is_end.int().argmax(-1) + 1, T)
        lengths = first.as_subclass(Tensor)
    if output_time_major:
        ids = ids.permute(2, 0, 1)
    ids = ids.contiguous().as_subclass(Tensor)
    return (ids, scores, lengths) if return_length else (ids, scores)
