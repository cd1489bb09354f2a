"""Every ``paddle_tpu_torch.nn.functional`` function of the JAX package's
activation, loss, norm, common, pooling and conv modules against the JAX
package's (CPU, fp32, numpy inputs from a seed), one case a call
(tests/torch_nn_parity.py runs both).

Tolerances, relative to max(1, max |jax|):
- forward 1e-5; gradients of sum(out * cotangent) 1e-5 (1e-4 where a
  case says so: cubic and antialiased resize weights, p-norms, spectral
  norm's power iteration and ``lp_pool``'s powers round differently);
- under ``auto_cast(level="O1", dtype="bfloat16")`` every output's dtype
  equals JAX's (white convs give bf16, black cross entropy fp32, neutral
  ops their input's dtype);
- where the JAX package ignores an argument and the port gives Paddle's
  meaning (``divisor_override``, ``return_mask`` of adaptive pools and
  with ``ceil_mode``, ``align_corners=True``, ``output_size``, NHWC
  pixel shuffles, conv ``padding_mode``), the reference is torch's own call
  or a numpy loop, exactly or to 1e-6;
- random functionals (dropout2d/3d, alpha_dropout, gumbel_softmax, rrelu
  in training) cannot draw ``jax.random``'s bits: their outside-training
  forms equal JAX's, and their masks are held to their rates (binomial,
  over 2^15 or more draws, within 6 standard deviations); hard
  gumbel_softmax is the one-hot within 1e-6 (the straight-through sum
  ``onehot + y - stop_gradient(y)`` rounds, in JAX too).
"""

import json
import os

import jax  # noqa: F401  (JAX on the CPU, as tests/conftest.py sets it)
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as PF
from paddle_tpu_torch import device as pt_device
from torch_nn_parity import (F, INT, POS, PROB, SIGN, amp_dtypes, check,
                             compare)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def cpu_place():
    prev = pt_device._PLACE
    pt.set_device("cpu")
    yield
    pt_device._PLACE = prev


CASES = []


def case(name, fn, inputs, grad=(0,), tol=1e-5, gtol=1e-5):
    CASES.append(pytest.param(fn, inputs, grad, tol, gtol, id=name))


def nf(P):
    return P.nn.functional


X = F(4, 34, scale=3.0)

# ---- activations ----
for _name, _kw in [
        ("relu", {}), ("relu6", {}), ("leaky_relu", dict(negative_slope=0.1)),
        ("elu", dict(alpha=0.7)), ("selu", {}), ("celu", dict(alpha=0.8)),
        ("gelu", {}), ("gelu", dict(approximate=True)), ("silu", {}),
        ("swish", {}), ("mish", {}), ("hardswish", {}), ("hardsigmoid", {}),
        ("hardsigmoid", dict(slope=0.2, offset=0.4)),
        ("hardtanh", dict(min=-0.5, max=0.7)), ("hardshrink", {}),
        ("hardshrink", dict(threshold=0.3)), ("softshrink", {}),
        ("softshrink", dict(threshold=0.4)), ("tanhshrink", {}),
        ("thresholded_relu", {}),
        ("thresholded_relu", dict(threshold=0.5, value=0.1)),
        ("softplus", {}), ("softplus", dict(beta=2.0, threshold=5.0)),
        ("softsign", {}), ("sigmoid", {}), ("logsigmoid", {}),
        ("log_sigmoid", {}), ("tanh", {}), ("softmax", {}),
        ("softmax", dict(axis=0)), ("log_softmax", {}),
        ("log_softmax", dict(axis=0)), ("rrelu", {}),
        ("rrelu", dict(lower=0.2, upper=0.4)), ("glu", {}),
        ("glu", dict(axis=0))]:
    case(f"{_name}{'-' + '-'.join(map(str, _kw.values())) if _kw else ''}",
         lambda P, x, n=_name, kw=_kw: getattr(nf(P), n)(x, **kw), [X])
case("prelu-channel", lambda P, x, w: nf(P).prelu(x, w),
     [F(2, 3, 4, 5), F(3)], (0, 1))
case("prelu-one", lambda P, x, w: nf(P).prelu(x, w), [F(2, 3, 4), F(1)],
     (0, 1))
case("prelu-nhwc", lambda P, x, w: nf(P).prelu(x, w, data_format="NHWC"),
     [F(2, 4, 5, 3), F(3)], (0, 1))
case("maxout", lambda P, x: nf(P).maxout(x, 2), [F(2, 6, 3, 3)])
case("maxout-last", lambda P, x: nf(P).maxout(x, 3, axis=-1), [F(2, 3, 6)])

# ---- losses ----
LOGITS, LABELS = F(6, 5), INT(6)
LABELS_IGN = np.array([0, 4, -100, 2, 1, -100])
for _red in ("mean", "sum", "none"):
    case(f"cross_entropy-{_red}", lambda P, x, y, r=_red:
         nf(P).cross_entropy(x, y, reduction=r), [LOGITS, LABELS_IGN])
    case(f"cross_entropy-weight-{_red}", lambda P, x, y, w, r=_red:
         nf(P).cross_entropy(x, y, w, reduction=r),
         [LOGITS, LABELS_IGN, POS(5)], (0, 2))
case("cross_entropy-smoothing", lambda P, x, y: nf(P).cross_entropy(
    x, y, label_smoothing=0.1), [LOGITS, LABELS_IGN])
case("cross_entropy-smoothing-weight", lambda P, x, y, w:
     nf(P).cross_entropy(x, y, w, label_smoothing=0.2), [LOGITS, LABELS,
                                                          POS(5)])
case("cross_entropy-soft", lambda P, x, y: nf(P).cross_entropy(
    x, y, soft_label=True), [LOGITS, PROB(6, 5)], (0, 1))
case("cross_entropy-soft-smoothing", lambda P, x, y: nf(P).cross_entropy(
    x, y, soft_label=True, label_smoothing=0.1, reduction="sum"),
    [LOGITS, PROB(6, 5)])
case("cross_entropy-probs", lambda P, x, y: nf(P).cross_entropy(
    x, y, use_softmax=False), [PROB(6, 5), LABELS])
case("cross_entropy-axis1", lambda P, x, y: nf(P).cross_entropy(
    x, y, axis=1), [F(3, 5, 4), INT(3, 4)])
case("cross_entropy-label-n1", lambda P, x, y: nf(P).cross_entropy(x, y),
     [LOGITS, INT(6, 1)])
case("softmax_with_cross_entropy", lambda P, x, y:
     nf(P).softmax_with_cross_entropy(x, y, return_softmax=True),
     [LOGITS, INT(6, 1)])
for _red in ("mean", "sum", "none"):
    case(f"nll_loss-{_red}", lambda P, x, y, r=_red: nf(P).nll_loss(
        x, y, reduction=r), [F(6, 5), LABELS_IGN])
case("nll_loss-weight", lambda P, x, y, w: nf(P).nll_loss(x, y, w),
     [F(6, 5), LABELS_IGN, POS(5)], (0, 2))
A, B = F(5, 7), F(5, 7)
for _red in ("mean", "sum", "none"):
    case(f"mse_loss-{_red}", lambda P, a, b, r=_red: nf(P).mse_loss(
        a, b, r), [A, B], (0, 1))
    case(f"l1_loss-{_red}", lambda P, a, b, r=_red: nf(P).l1_loss(a, b, r),
         [A, B], (0, 1))
case("smooth_l1_loss", lambda P, a, b: nf(P).smooth_l1_loss(
    a, b, delta=0.5), [A, B], (0, 1))
case("huber_loss", lambda P, a, b: nf(P).huber_loss(a, b, delta=0.7),
     [A, B], (0, 1))
case("binary_cross_entropy", lambda P, p, y: nf(P).binary_cross_entropy(
    p, y), [PROB(5, 7), PROB(5, 7)], (0, 1))
case("binary_cross_entropy-weight", lambda P, p, y, w:
     nf(P).binary_cross_entropy(p, y, w, reduction="sum"),
     [PROB(5, 7), PROB(5, 7), POS(7)])
case("bce_with_logits", lambda P, z, y:
     nf(P).binary_cross_entropy_with_logits(z, y), [A, PROB(5, 7)], (0, 1))
case("bce_with_logits-weights", lambda P, z, y, w, pw:
     nf(P).binary_cross_entropy_with_logits(z, y, w, "none", pw),
     [A, PROB(5, 7), POS(7), POS(7)], (0, 2, 3))
for _red in ("mean", "sum", "none", "batchmean"):
    case(f"kl_div-{_red}", lambda P, lp, t, r=_red: nf(P).kl_div(lp, t, r),
         [F(4, 6), PROB(4, 6)], (0, 1))
case("kl_div-log_target", lambda P, lp, t: nf(P).kl_div(
    lp, t, log_target=True), [F(4, 6), F(4, 6)], (0, 1))
case("margin_ranking_loss", lambda P, a, b, y: nf(P).margin_ranking_loss(
    a, b, y, margin=0.3), [F(8), F(8), SIGN(8)], (0, 1))
case("hinge_embedding_loss", lambda P, a, y: nf(P).hinge_embedding_loss(
    a, y, margin=0.8), [F(4, 6), SIGN(4, 6)])
case("cosine_embedding_loss", lambda P, a, b, y:
     nf(P).cosine_embedding_loss(a, b, y, margin=0.1),
     [F(6, 5), F(6, 5), SIGN(6)], (0, 1))
case("triplet_margin_loss", lambda P, a, p, n: nf(P).triplet_margin_loss(
    a, p, n), [F(6, 5), F(6, 5), F(6, 5)], (0, 1, 2), gtol=1e-4)
case("triplet_margin_loss-p1-swap", lambda P, a, p, n:
     nf(P).triplet_margin_loss(a, p, n, margin=2.0, p=1.0, swap=True,
                               reduction="none"),
     [F(6, 5), F(6, 5), F(6, 5)], (0, 1, 2), gtol=1e-4)
case("sigmoid_focal_loss", lambda P, z, y: nf(P).sigmoid_focal_loss(z, y),
     [A, PROB(5, 7)], (0, 1))
case("sigmoid_focal_loss-normalizer", lambda P, z, y, n:
     nf(P).sigmoid_focal_loss(z, y, n, alpha=-1, gamma=1.5,
                              reduction="mean"),
     [A, PROB(5, 7), POS(1)], (0, 2))
case("log_loss", lambda P, p, y: nf(P).log_loss(p, y),
     [PROB(6, 1), PROB(6, 1)], (0, 1))
case("square_error_cost", lambda P, a, b: nf(P).square_error_cost(a, b),
     [A, B], (0, 1))
case("dice_loss", lambda P, p, y: nf(P).dice_loss(p, y),
     [PROB(3, 4, 5), INT(3, 4, 1)])

# ---- norms ----
IMG = F(2, 6, 5, 4)
case("layer_norm", lambda P, x, w, b: nf(P).layer_norm(x, [5, 4], w, b),
     [IMG, F(5, 4), F(5, 4)], (0, 1, 2))
case("rms_norm", lambda P, x, w: nf(P).rms_norm(x, w), [F(3, 4, 8), F(8)],
     (0, 1))
case("rms_norm-no-weight", lambda P, x: nf(P).rms_norm(x, epsilon=1e-5),
     [F(3, 8)])
case("instance_norm", lambda P, x, w, b: nf(P).instance_norm(
    x, weight=w, bias=b), [IMG, POS(6), F(6)], (0, 1, 2))
case("instance_norm-plain", lambda P, x: nf(P).instance_norm(x, eps=1e-3),
     [F(2, 3, 7)])
case("group_norm", lambda P, x, w, b: nf(P).group_norm(x, 3, 1e-5, w, b),
     [IMG, POS(6), F(6)], (0, 1, 2))
case("group_norm-nhwc", lambda P, x, w, b: nf(P).group_norm(
    x, 2, 1e-5, w, b, data_format="NHWC"), [F(2, 5, 4, 6), POS(6), F(6)],
    (0, 1, 2))
case("group_norm-plain", lambda P, x: nf(P).group_norm(x, 2), [F(2, 4, 9)])
case("local_response_norm", lambda P, x: nf(P).local_response_norm(
    x, 3, alpha=0.1, beta=0.6, k=1.5), [IMG])
case("local_response_norm-even", lambda P, x: nf(P).local_response_norm(
    x, 4), [F(2, 7, 3)])
case("spectral_norm", lambda P, w, u, v: nf(P).spectral_norm(
    w, u, v, power_iters=3), [F(6, 4, 2), F(6), F(8)], (0,), gtol=1e-4)
case("spectral_norm-dim1", lambda P, w, u, v: nf(P).spectral_norm(
    w, u, v, dim=1), [F(5, 4), F(4), F(5)], (0,), gtol=1e-4)

# ---- common ----
case("dropout-eval", lambda P, x: nf(P).dropout(x, 0.3, training=False),
     [X])
case("dropout-downscale-eval", lambda P, x: nf(P).dropout(
    x, 0.3, training=False, mode="downscale_in_infer"), [X])
case("dropout2d-eval", lambda P, x: nf(P).dropout2d(x, 0.3,
                                                     training=False), [IMG])
case("dropout3d-eval", lambda P, x: nf(P).dropout3d(x, 0.3,
                                                     training=False),
     [F(2, 3, 2, 3, 4)])
case("alpha_dropout-eval", lambda P, x: nf(P).alpha_dropout(
    x, 0.3, training=False), [X])
case("one_hot", lambda P, y: nf(P).one_hot(y, 6), [INT(3, 4)], ())
case("label_smooth", lambda P, y: nf(P).label_smooth(y), [PROB(4, 5)])
case("label_smooth-prior", lambda P, y, p: nf(P).label_smooth(
    y, p, epsilon=0.2), [PROB(4, 5), PROB(1, 5)], (0, 1))
case("cosine_similarity", lambda P, a, b: nf(P).cosine_similarity(a, b),
     [F(4, 6, 3), F(4, 6, 3)], (0, 1))
case("cosine_similarity-axis", lambda P, a, b: nf(P).cosine_similarity(
    a, b, axis=-1, eps=1e-6), [F(4, 6), F(4, 6)], (0, 1))
case("normalize", lambda P, x: nf(P).normalize(x), [F(3, 5, 2)])
case("normalize-p1", lambda P, x: nf(P).normalize(x, p=1, axis=-1),
     [F(3, 5)], gtol=1e-4)
case("pad-constant", lambda P, x: nf(P).pad(x, [1, 2, 0, 3], value=0.5),
     [IMG])
case("pad-reflect", lambda P, x: nf(P).pad(x, [1, 2, 2, 1],
                                           mode="reflect"), [IMG])
case("pad-replicate", lambda P, x: nf(P).pad(x, [2, 1], mode="replicate",
                                             data_format="NCL"),
     [F(2, 3, 5)])
case("pad-circular", lambda P, x: nf(P).pad(x, [1, 1, 2, 0],
                                            mode="circular"), [IMG])
for _mode, _shape, _tgt in [
        ("nearest", (2, 3, 5, 4), (9, 7)), ("nearest", (2, 3, 9, 7), (4, 3)),
        ("bilinear", (2, 3, 5, 4), (9, 7)), ("bilinear", (2, 3, 9, 8), (4, 3)),
        ("bicubic", (2, 3, 5, 4), (9, 7)), ("bicubic", (2, 3, 9, 8), (4, 3)),
        ("area", (2, 3, 8, 8), (4, 4)), ("linear", (2, 3, 5), (11,)),
        ("linear", (2, 3, 11), (4,)), ("nearest", (2, 3, 5), (8,)),
        ("trilinear", (1, 2, 3, 4, 5), (5, 3, 7)),
        ("nearest", (1, 2, 3, 4, 5), (6, 2, 5))]:
    _dir = "up" if np.prod(_tgt) > np.prod(_shape[2:]) else "down"
    case(f"interpolate-{_mode}-{len(_tgt)}d-{_dir}", lambda P, x, t=_tgt, m=_mode:
         nf(P).interpolate(x, size=list(t), mode=m,
                           data_format="NC" + "DHW"[-len(t):]),
         [F(*_shape)], gtol=1e-4)
case("interpolate-scale", lambda P, x: nf(P).interpolate(
    x, scale_factor=2, mode="bilinear"), [IMG], gtol=1e-4)
case("interpolate-nhwc", lambda P, x: nf(P).interpolate(
    x, size=[7, 3], mode="bicubic", data_format="NHWC"), [F(2, 5, 4, 3)],
    gtol=1e-4)
case("upsample", lambda P, x: nf(P).upsample(x, scale_factor=[2, 3]),
     [IMG])
case("unfold", lambda P, x: nf(P).unfold(x, [2, 3], strides=[1, 2],
                                         paddings=1, dilations=[2, 1]),
     [F(2, 3, 7, 8)])
case("unfold-plain", lambda P, x: nf(P).unfold(x, 3), [F(1, 2, 5, 5)])
case("fold", lambda P, x: nf(P).fold(x, [6, 7], [2, 3], strides=[1, 2],
                                     paddings=1),
     [F(2, 3 * 2 * 3, 7 * 4)])
case("bilinear", lambda P, a, b, w, bb: nf(P).bilinear(a, b, w, bb),
     [F(4, 3), F(4, 5), F(6, 3, 5), F(1, 6)], (0, 1, 2, 3))
case("bilinear-no-bias", lambda P, a, b, w: nf(P).bilinear(a, b, w),
     [F(4, 3), F(4, 5), F(6, 3, 5)], (0, 1, 2))
case("pixel_shuffle", lambda P, x: nf(P).pixel_shuffle(x, 2),
     [F(2, 8, 3, 4)])
case("pixel_unshuffle", lambda P, x: nf(P).pixel_unshuffle(x, 2),
     [F(2, 3, 4, 6)])
case("channel_shuffle", lambda P, x: nf(P).channel_shuffle(x, 3),
     [F(2, 6, 3, 2)])
case("channel_shuffle-nhwc", lambda P, x: nf(P).channel_shuffle(
    x, 2, data_format="NHWC"), [F(2, 3, 2, 6)])

# ---- pooling ----
for _n, _shape in ((1, (2, 3, 11)), (2, (2, 3, 9, 8)), (3, (1, 2, 7, 6, 5))):
    for _k, _s, _p in ((3, 2, 1), (2, None, 0)):
        case(f"max_pool{_n}d-k{_k}", lambda P, x, n=_n, k=_k, s=_s, p=_p:
             getattr(nf(P), f"max_pool{n}d")(x, k, s, p), [F(*_shape)])
        for _ex in (True, False):
            case(f"avg_pool{_n}d-k{_k}-{'ex' if _ex else 'in'}",
                 lambda P, x, n=_n, k=_k, s=_s, p=_p, ex=_ex:
                 getattr(nf(P), f"avg_pool{n}d")(x, k, s, p, exclusive=ex),
                 [F(*_shape)])
    case(f"adaptive_avg_pool{_n}d", lambda P, x, n=_n: getattr(
        nf(P), f"adaptive_avg_pool{n}d")(x, [3, 2, 4][:n]), [F(*_shape)])
    case(f"adaptive_max_pool{_n}d", lambda P, x, n=_n: getattr(
        nf(P), f"adaptive_max_pool{n}d")(x, [4, 3, 2][:n]), [F(*_shape)])
    if _n < 3:
        case(f"max_pool{_n}d-mask", lambda P, x, n=_n: getattr(
            nf(P), f"max_pool{n}d")(x, 3, 2, 1, return_mask=True),
            [F(*_shape)])
case("max_pool2d-nhwc", lambda P, x: nf(P).max_pool2d(
    x, 3, 2, 1, data_format="NHWC"), [F(2, 9, 8, 3)])
case("avg_pool2d-nhwc", lambda P, x: nf(P).avg_pool2d(
    x, 3, 2, 1, data_format="NHWC"), [F(2, 9, 8, 3)])
case("avg_pool1d-nlc", lambda P, x: nf(P).avg_pool1d(
    x, 2, data_format="NLC"), [F(2, 8, 3)])
case("adaptive_avg_pool2d-nhwc", lambda P, x: nf(P).adaptive_avg_pool2d(
    x, [3, 2], data_format="NHWC"), [F(2, 7, 5, 3)])
case("adaptive_avg_pool2d-up", lambda P, x: nf(P).adaptive_avg_pool2d(
    x, 5), [F(1, 2, 2, 3)])
for _n, _shape in ((1, (2, 3, 11)), (2, (2, 3, 9, 8))):
    for _pn in (2, 3):
        case(f"lp_pool{_n}d-p{_pn}", lambda P, x, n=_n, pn=_pn: getattr(
            nf(P), f"lp_pool{n}d")(x, pn, 3, 2, 1), [F(*_shape)], gtol=1e-4)

# ---- convolutions ----
for _n, _shape in ((1, (2, 4, 13)), (2, (2, 4, 9, 8)), (3, (1, 4, 7, 6, 5))):
    _w = (6, 2) + (3, 2, 3)[:_n]
    for _kw in (dict(stride=1, padding=1), dict(stride=2, padding="SAME"),
                dict(padding="VALID", dilation=2),
                dict(padding=[1, 0] * _n, groups=2),
                dict(stride=[2, 1, 1][:_n], padding=[2, 1, 0][:_n])):
        _g = _kw.get("groups", 1)
        case(f"conv{_n}d-{'-'.join(str(v) for v in _kw.values())}",
             lambda P, x, w, b, n=_n, kw=_kw, g=_g:
             getattr(nf(P), f"conv{n}d")(x, w, b, **{**kw, "groups": g}),
             [F(*_shape), F(6, 4 // _g, *_w[2:], scale=0.3), F(6)],
             (0, 1, 2))
case("conv2d-nhwc", lambda P, x, w, b: nf(P).conv2d(
    x, w, b, 1, 1, data_format="NHWC"), [F(2, 9, 8, 4), F(6, 4, 3, 3), F(6)],
    (0, 1, 2))
case("conv1d-nlc", lambda P, x, w: nf(P).conv1d(
    x, w, padding=2, data_format="NLC"), [F(2, 13, 4), F(6, 4, 5)], (0, 1))
for _n, _shape in ((1, (2, 4, 7)), (2, (2, 4, 5, 6)), (3, (1, 4, 3, 4, 5))):
    for _kw in (dict(stride=2, padding=1, output_padding=1),
                dict(stride=1, padding=0, groups=2, dilation=2),
                dict(stride=2, padding=[1, 0] * _n, output_padding=1,
                     groups=2),
                dict(stride=3, padding=2, output_padding=2, dilation=1)):
        _g = _kw.get("groups", 1)
        case(f"conv{_n}d_transpose-{'-'.join(map(str, _kw.values()))}",
             lambda P, x, w, b, n=_n, kw=_kw:
             getattr(nf(P), f"conv{n}d_transpose")(x, w, b, **kw),
             [F(*_shape), F(4, 6 // _g, *(3, 2, 3)[:_n], scale=0.3), F(6)],
             (0, 1, 2))
case("conv2d_transpose-nhwc", lambda P, x, w: nf(P).conv2d_transpose(
    x, w, stride=2, padding=1, data_format="NHWC"),
    [F(2, 5, 6, 4), F(4, 3, 3, 3)], (0, 1))


@pytest.mark.parametrize("fn,inputs,grad,tol,gtol", CASES)
def test_functional_matches_jax(fn, inputs, grad, tol, gtol):
    check(fn, inputs, grad, tol, gtol)


@pytest.mark.parametrize("fn,inputs,grad,tol,gtol", CASES)
def test_functional_amp_dtypes_match_jax(fn, inputs, grad, tol, gtol):
    jax_names, port_names = amp_dtypes(fn, inputs)
    assert port_names == jax_names


def test_inplace_activations_write_into_their_input():
    x = pt.to_tensor(F(3, 4))
    ref = PF.relu(x.clone())
    assert PF.relu_(x) is x and torch.equal(x, ref)
    y = pt.to_tensor(F(3, 4))
    ref = PF.softmax(y.clone(), axis=0)
    assert PF.softmax_(y, axis=0) is y and torch.allclose(y, ref)


def test_random_functionals_keep_their_rates():
    """dropout2d drops whole channels, alpha_dropout keeps a SELU
    network's mean and variance, rrelu's training slopes lie in [lower,
    upper], gumbel_softmax rows are distributions (hard: one-hot)."""
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(64, 512, 2, 2)
    out = PF.dropout2d(x, 0.25, generator=gen)
    per_channel = out.reshape(64, 512, 4)
    assert bool((per_channel == per_channel[..., :1]).all())
    kept = float((per_channel[..., 0] != 0).float().mean())
    assert abs(kept - 0.75) < 6 * (0.75 * 0.25 / (64 * 512)) ** 0.5
    assert torch.equal(out[out != 0], torch.full_like(out[out != 0],
                                                      1 / 0.75))
    out3 = PF.dropout3d(torch.ones(8, 16, 2, 2, 2), 0.5, generator=gen)
    assert bool((out3.reshape(8, 16, 8) == out3.reshape(8, 16, 8)[..., :1])
                .all())
    z = torch.randn(1 << 16, generator=gen)
    a = PF.alpha_dropout(z, 0.2, generator=gen)
    assert abs(float(a.mean())) < 0.03 and abs(float(a.std()) - 1) < 0.03
    r = PF.rrelu(-torch.ones(1 << 15), 0.1, 0.3, training=True,
                 generator=gen)
    assert float(r.max()) <= -0.1 and float(r.min()) >= -0.3
    assert abs(float(r.mean()) + 0.2) < 6 * (0.2 / 12 ** 0.5) / 2 ** 7.5
    logits = torch.randn(256, 7, generator=gen)
    soft = PF.gumbel_softmax(logits, 0.5, generator=gen)
    assert torch.allclose(soft.sum(-1), torch.ones(256), atol=1e-6)
    hard = PF.gumbel_softmax(logits, hard=True, generator=gen)
    onehot = torch.nn.functional.one_hot(hard.argmax(-1), 7).float()
    assert torch.allclose(hard, onehot, atol=1e-6)   # y + (onehot - y)


def test_paddle_meanings_the_jax_package_drops():
    x = torch.from_numpy(F(2, 3, 9, 8))
    out = PF.avg_pool2d(x, 3, 2, 1, divisor_override=4)
    ref = torch.nn.functional.avg_pool2d(x, 3, 2, 1, divisor_override=4)
    assert torch.equal(out, ref)
    for n, shape in ((1, (2, 3, 11)), (2, (2, 3, 9, 8)),
                     (3, (1, 2, 7, 6, 5))):
        a = torch.from_numpy(F(*shape))
        out, mask = getattr(PF, f"adaptive_max_pool{n}d")(a, 3,
                                                         return_mask=True)
        ref, idx = getattr(torch.nn.functional, f"adaptive_max_pool{n}d")(
            a, 3, return_indices=True)
        assert torch.equal(out, ref) and mask.dtype == torch.int32
        assert torch.equal(mask.long(), idx)
        out, mask = getattr(PF, f"max_pool{n}d")(a, 2, 2, 0,
                                                 return_mask=True,
                                                 ceil_mode=True)
        flat = a.flatten(2)
        assert torch.equal(flat.gather(2, mask.long().flatten(2)),
                           out.flatten(2))
    nhwc = torch.from_numpy(F(2, 9, 8, 3))
    out, mask = PF.max_pool2d(nhwc, 3, 2, 1, return_mask=True,
                              data_format="NHWC")
    ref, rmask = PF.max_pool2d(nhwc.permute(0, 3, 1, 2), 3, 2, 1,
                               return_mask=True)
    assert torch.equal(out, ref.permute(0, 2, 3, 1))
    assert torch.equal(mask, rmask.permute(0, 2, 3, 1))
    for mode in ("bilinear", "bicubic"):
        out = PF.interpolate(x, size=[5, 13], mode=mode, align_corners=True)
        ref = torch.nn.functional.interpolate(x, size=[5, 13], mode=mode,
                                              align_corners=True)
        assert torch.equal(out, ref)
    # align_mode=1 (Paddle's, which JAX ignores): source index i * in /
    # out, no half-pixel shift; at scale 2 the even outputs copy the input
    # and the odd ones average two neighbours (the last repeats)
    out = PF.interpolate(x, scale_factor=2, mode="bilinear", align_mode=1)
    xe = torch.cat([x, x[..., -1:]], -1)
    rows = torch.stack([x, (xe[..., :-1] + xe[..., 1:]) / 2], -1).flatten(-2)
    rows_e = torch.cat([rows, rows[..., -1:, :]], -2)
    ref = torch.stack([rows, (rows_e[..., :-1, :] + rows_e[..., 1:, :]) / 2],
                      -2).flatten(-3, -2)
    assert torch.allclose(out, ref, atol=1e-6)
    out = PF.interpolate(x[:, :, 0], size=[5], mode="linear", align_mode=1,
                         data_format="NCW")
    src = np.arange(5) * x.shape[-1] / 5
    lo = np.floor(src).astype(int)
    hi = np.minimum(lo + 1, x.shape[-1] - 1)
    w = torch.from_numpy((src - lo).astype(np.float32))
    ref = x[:, :, 0, lo] * (1 - w) + x[:, :, 0, hi] * w
    assert torch.allclose(out, ref, atol=1e-6)
    for shuffle, r, shape in ((PF.pixel_shuffle, 2, (2, 3, 4, 8)),
                              (PF.pixel_unshuffle, 2, (2, 4, 6, 3))):
        a = torch.from_numpy(F(*shape))
        compare(shuffle(a, r, data_format="NHWC"),
                shuffle(a.permute(0, 3, 1, 2), r).permute(0, 2, 3, 1), 0.0)
    w = torch.from_numpy(F(4, 6, 3, 3, scale=0.3))
    a = torch.from_numpy(F(2, 4, 5, 5))
    out = PF.conv2d_transpose(a, w, stride=2, padding=1, output_size=[10, 10])
    ref = torch.nn.functional.conv_transpose2d(a, w, None, 2, 1, 1)
    assert tuple(out.shape) == (2, 6, 10, 10) and torch.equal(out, ref)
    with pytest.raises(ValueError, match="output_size"):
        PF.conv2d_transpose(a, w, stride=2, padding=1, output_size=[12, 12])
    # padding="SAME" (Paddle's, which JAX reads as "VALID"): the padding
    # of a SAME conv of the input, so 5 x 5 at stride 2 and kernel 3 pads
    # 2 (one each side) and 4 x 4 at stride 2 gives 8 x 8
    out = PF.conv2d_transpose(a, w, stride=2, padding="SAME")
    ref = torch.nn.functional.conv_transpose2d(a, w, None, 2, 1)
    assert tuple(out.shape) == (2, 6, 9, 9) and torch.equal(out, ref)
    a4 = a[..., :4, :4]
    out = PF.conv2d_transpose(a4, w, stride=2, padding="SAME", dilation=2)
    full = torch.nn.functional.conv_transpose2d(a4, w, None, 2)
    assert tuple(out.shape) == (2, 6, 8, 8)
    assert torch.equal(out, full[..., :8, :8])
    # running statistics (which JAX ignores): torch's instance_norm with
    # them, normalising by them without input statistics, Paddle's momentum
    rm, rv = torch.from_numpy(F(4)), torch.from_numpy(POS(4))
    out = PF.instance_norm(a, rm, rv, use_input_stats=False)
    ref = (a - rm[:, None, None]) / torch.sqrt(rv[:, None, None] + 1e-5)
    assert torch.allclose(out, ref, atol=1e-5)
    rm2, rv2 = rm.clone(), rv.clone()
    out = PF.instance_norm(a, rm2, rv2, momentum=0.8)
    assert torch.allclose(out, PF.instance_norm(a), atol=1e-6)
    n = a.shape[2] * a.shape[3]
    batch_var = a.var((2, 3), unbiased=False).mean(0) * n / (n - 1)
    assert torch.allclose(rm2, 0.8 * rm + 0.2 * a.mean((0, 2, 3)), atol=1e-6)
    assert torch.allclose(rv2, 0.8 * rv + 0.2 * batch_var, atol=1e-5)


def test_lp_pool_ceil_mode_sums_the_in_bounds_window():
    x = F(1, 2, 7)
    out = PF.lp_pool1d(torch.from_numpy(x), 2, 2, ceil_mode=True).numpy()
    ref = np.stack([np.sqrt((x[..., i:i + 2] ** 2).sum(-1))
                    for i in range(0, 7, 2)], -1)
    compare(out, ref, 1e-6)


def test_sdp_kernel_selects_the_dense_path():
    from paddle_tpu_torch import flags

    assert flags.get_flag("use_pallas_attention")
    with PF.sdp_kernel(enable_flash=False):
        assert not flags.get_flag("use_pallas_attention")
    assert flags.get_flag("use_pallas_attention")
    with pytest.raises(ValueError, match="no attention backend"):
        with PF.sdp_kernel(enable_math=False, enable_flash=False):
            pass


def test_manifest_names_are_ported_or_refused():
    """Every name of ``tools/api_manifest.json``'s ``paddle.nn`` and
    ``paddle.nn.functional`` lists exists in the port, none raising
    ``later_slice``, except the JAX modules' own imports of ``jax`` /
    ``jax.numpy`` and its key source ``next_key``, which the port,
    importing no JAX, has not."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "tools", "api_manifest.json")) as f:
        manifest = json.load(f)
    jax_only = {"jax", "jnp", "next_key"}
    for key, mod in (("paddle.nn", pt.nn), ("paddle.nn.functional", PF)):
        assert not hasattr(mod, "EXTRAS"), key
        for name in manifest[key]:
            if name in jax_only:
                assert not hasattr(mod, name), name
                continue
            assert getattr(mod, name) is not None, (key, name)


@pytest.mark.parametrize("name", ["group_norm", "instance_norm", "rms_norm",
                                  "layer_norm"])
def test_bf16_norms_against_jax(name):
    """In bf16 torch's group and instance norms accumulate in fp32 where
    the JAX package reduces in bf16; rms_norm and layer_norm upcast in
    both. Held: port vs JAX within 2e-2 of max(1, max |ref|) (about two
    bf16 ulps of the largest output; measured <= 1.0e-2), and the port
    within 1e-2 of the fp64 result (measured <= 6.8e-3)."""
    import paddle_tpu as jp

    rng = np.random.default_rng(11)
    x = (rng.standard_normal((4, 64, 14, 14)) * 2 + 1).astype(np.float32)
    w = rng.uniform(0.5, 1.5, 64 if name in ("group_norm", "instance_norm")
                    else 14).astype(np.float32)
    b = rng.standard_normal(w.shape).astype(np.float32)
    calls = {
        "group_norm": lambda P, x, w, b: P.nn.functional.group_norm(
            x, 32, 1e-5, w, b),
        "instance_norm": lambda P, x, w, b: P.nn.functional.instance_norm(
            x, weight=w, bias=b),
        "rms_norm": lambda P, x, w, b: P.nn.functional.rms_norm(x, w) + b,
        "layer_norm": lambda P, x, w, b: P.nn.functional.layer_norm(
            x, 14, w, b)}
    call = calls[name]
    ref = call(pt, *(torch.from_numpy(a).double() for a in (x, w, b)))
    ref = ref.numpy()
    port = call(pt, *(torch.from_numpy(a).bfloat16() for a in (x, w, b)))
    jout = call(jp, *(jp.to_tensor(a).astype("bfloat16") for a in (x, w, b)))
    scale = max(1.0, float(np.abs(ref).max()))
    port = port.float().numpy()
    assert float(np.abs(port - np.asarray(jout._data, np.float32)).max()) \
        <= 2e-2 * scale
    assert float(np.abs(port - ref).max()) <= 1e-2 * scale
