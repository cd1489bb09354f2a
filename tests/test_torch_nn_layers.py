"""Every ``paddle_tpu_torch.nn`` layer of the JAX package's activation,
loss, common, norm, pooling and conv modules against the JAX package's
(CPU, fp32, numpy inputs from a seed), one case a layer configuration.

Each case builds the layer in both packages with the same arguments,
asserts that their parameters and buffers carry the same names and shapes,
carries the JAX layer's state across with ``weights.load_jax_state`` (no
renames), then compares the outputs (1e-5 of max(1, max |jax|)), the
gradients of sum(out * cotangent) for the inputs and every parameter
(1e-5; 1e-4 for the cubic resize and the convolutions' weight gradients,
which sum many products in another order), the buffers after the call
(batch norms' running statistics in training) and, under
``auto_cast(level="O1", dtype="bfloat16")``, each output's dtype. Layers
with random draws in training (the dropouts, ``RReLU``) run in eval mode;
where the port gives Paddle's meaning to an argument the JAX layer drops
(``UpsamplingBilinear2D``'s ``align_corners``, ``Conv2D(padding_mode=)``,
``InstanceNorm*D``'s ``data_format``), the reference is torch's own layer
or the port's functional on the padded input, exactly. Default
initializers are held to their distributions (sample std within 5%,
bounds exact).
"""

import math

import jax  # noqa: F401  (JAX on the CPU, as tests/conftest.py sets it)
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as pt
from paddle_tpu_torch import device as pt_device
from paddle_tpu_torch.weights import load_jax_state, state_from_jax_layer
from torch_nn_parity import (F, INT, PROB, SIGN, as_np, compare, dtype_name,
                             flat, is_float)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def cpu_place():
    prev = pt_device._PLACE
    pt.set_device("cpu")
    yield
    pt_device._PLACE = prev


CASES = []


def case(name, make, inputs, grad=(0,), tol=1e-5, gtol=1e-5, train=True):
    CASES.append(pytest.param(make, inputs, grad, tol, gtol, train, id=name))


def _shapes(named):
    return [(n, tuple(int(d) for d in p.shape)) for n, p in named]


def _pair(make, train):
    jm, tm = make(jp), make(pt)
    assert _shapes(tm.named_parameters()) == _shapes(jm.named_parameters())
    assert list(tm.state_dict()) == list(jm.state_dict())
    load_jax_state(tm, state_from_jax_layer(jm))
    for m in (jm, tm):
        m.train() if train else m.eval()
    return jm, tm


def _forward(P, m, inputs, grad):
    ts = [P.to_tensor(x, stop_gradient=i not in grad)
          for i, x in enumerate(inputs)]
    return ts, m(*ts)


def _backward(P, out, cots):
    loss = None
    for o, c in zip([o for o in flat(out) if is_float(o)], cots):
        term = (o * P.to_tensor(c)).sum()
        loss = term if loss is None else loss + term
    loss.backward()


@pytest.mark.parametrize("make,inputs,grad,tol,gtol,train", CASES)
def test_layer_matches_jax(make, inputs, grad, tol, gtol, train):
    jm, tm = _pair(make, train)
    jts, jout = _forward(jp, jm, inputs, grad)
    tts, tout = _forward(pt, tm, inputs, grad)
    compare(tout, jout, tol)
    compare([as_np(v) for v in tm.state_dict().values()],
            [as_np(v) for v in jm.state_dict().values()], tol)
    cots = [np.random.default_rng(7).standard_normal(as_np(o).shape)
            .astype(np.float32) for o in flat(jout) if is_float(o)]
    if not cots:
        return
    _backward(jp, jout, cots)
    _backward(pt, tout, cots)
    compare([tts[i].grad for i in grad], [jts[i].grad for i in grad], gtol)
    jg = {n: p.grad for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        compare(p.grad, jg[n], gtol)


@pytest.mark.parametrize("make,inputs,grad,tol,gtol,train", CASES)
def test_layer_amp_dtypes_match_jax(make, inputs, grad, tol, gtol, train):
    names = []
    for P, m in zip((jp, pt), _pair(make, train)):
        ts = [P.to_tensor(x) for x in inputs]
        with P.amp.auto_cast(level="O1", dtype="bfloat16"):
            out = m(*ts)
        names.append(["int" if n.startswith("int") else n
                      for n in map(dtype_name, flat(out))])
    assert names[1] == names[0]


X = F(4, 34, scale=3.0)
IMG = F(2, 6, 5, 4)

# ---- activations: each class of JAX's _make table, positional args ----
for _cls, _args in [
        ("ReLU", ()), ("ReLU6", ()), ("LeakyReLU", (0.2,)), ("ELU", (0.6,)),
        ("CELU", (0.7,)), ("SELU", ()), ("GELU", ()), ("GELU", (True,)),
        ("Silu", ()), ("Swish", ()), ("Mish", ()), ("Hardswish", ()),
        ("Hardsigmoid", ()), ("Hardsigmoid", (0.25, 0.45)),
        ("Hardtanh", (-0.4, 0.6)), ("Hardshrink", (0.3,)),
        ("Softshrink", (0.2,)), ("Tanhshrink", ()),
        ("ThresholdedReLU", (0.4, 0.2)), ("Softplus", (1.5, 4.0)),
        ("Softsign", ()), ("Sigmoid", ()), ("LogSigmoid", ()), ("Tanh", ()),
        ("Softmax", ()), ("Softmax", (0,)), ("LogSoftmax", (0,)),
        ("GLU", ()), ("GLU", (0,))]:
    case(f"{_cls}{_args}", lambda P, c=_cls, a=_args: getattr(P.nn, c)(*a),
         [X])
case("RReLU-eval", lambda P: P.nn.RReLU(), [X], train=False)
case("Maxout", lambda P: P.nn.Maxout(3), [F(2, 6, 3, 2)])
case("Maxout-axis", lambda P: P.nn.Maxout(2, -1), [F(2, 3, 4)])
case("PReLU", lambda P: P.nn.PReLU(6, 0.1), [IMG])
case("PReLU-one", lambda P: P.nn.PReLU(), [IMG])

# ---- losses ----
LOGITS, LABELS = F(6, 5), np.array([0, 4, -100, 2, 1, 3])
A, B = F(5, 7), F(5, 7)
case("CrossEntropyLoss", lambda P: P.nn.CrossEntropyLoss(), [LOGITS, LABELS])
case("CrossEntropyLoss-smoothing", lambda P: P.nn.CrossEntropyLoss(
    label_smoothing=0.1, reduction="sum"), [LOGITS, LABELS])
case("CrossEntropyLoss-soft", lambda P: P.nn.CrossEntropyLoss(
    soft_label=True), [LOGITS, PROB(6, 5)], (0, 1))
case("MSELoss", lambda P: P.nn.MSELoss(), [A, B], (0, 1))
case("L1Loss", lambda P: P.nn.L1Loss("sum"), [A, B], (0, 1))
case("SmoothL1Loss", lambda P: P.nn.SmoothL1Loss(delta=0.6), [A, B], (0, 1))
case("HuberLoss", lambda P: P.nn.HuberLoss(delta=0.8), [A, B], (0, 1))
case("BCELoss", lambda P: P.nn.BCELoss(), [PROB(5, 7), PROB(5, 7)], (0, 1))
case("BCEWithLogitsLoss", lambda P: P.nn.BCEWithLogitsLoss(),
     [A, PROB(5, 7)], (0, 1))
case("NLLLoss", lambda P: P.nn.NLLLoss(), [F(6, 5), LABELS])
case("KLDivLoss", lambda P: P.nn.KLDivLoss("batchmean"),
     [F(4, 6), PROB(4, 6)], (0, 1))
case("MarginRankingLoss", lambda P: P.nn.MarginRankingLoss(0.2),
     [F(8), F(8), SIGN(8)], (0, 1))
case("HingeEmbeddingLoss", lambda P: P.nn.HingeEmbeddingLoss(0.9),
     [F(4, 6), SIGN(4, 6)])
case("CosineEmbeddingLoss", lambda P: P.nn.CosineEmbeddingLoss(0.1),
     [F(6, 5), F(6, 5), SIGN(6)], (0, 1))
case("TripletMarginLoss", lambda P: P.nn.TripletMarginLoss(swap=True),
     [F(6, 5), F(6, 5), F(6, 5)], (0, 1, 2), gtol=1e-4)

# ---- common ----
case("Identity", lambda P: P.nn.Identity(), [X])
case("Linear", lambda P: P.nn.Linear(5, 3), [F(4, 5)])
case("Linear-no-bias", lambda P: P.nn.Linear(5, 3, bias_attr=False),
     [F(4, 5)])
case("Embedding", lambda P: P.nn.Embedding(9, 4, padding_idx=2),
     [INT(3, 5, hi=9)], ())
case("Dropout-eval", lambda P: P.nn.Dropout(0.4), [X], train=False)
case("Dropout2D-eval", lambda P: P.nn.Dropout2D(0.4), [IMG], train=False)
case("Dropout3D-eval", lambda P: P.nn.Dropout3D(0.4), [F(2, 3, 2, 3, 4)],
     train=False)
case("AlphaDropout-eval", lambda P: P.nn.AlphaDropout(0.4), [X],
     train=False)
case("Flatten", lambda P: P.nn.Flatten(), [IMG])
case("Flatten-range", lambda P: P.nn.Flatten(0, 2), [IMG])
case("Upsample-nearest", lambda P: P.nn.Upsample(scale_factor=2), [IMG])
case("Upsample-bicubic", lambda P: P.nn.Upsample(size=[3, 7],
                                                  mode="bicubic"), [IMG],
     gtol=1e-4)
case("UpsamplingNearest2D", lambda P: P.nn.UpsamplingNearest2D(
    size=[7, 9]), [IMG])
case("Pad1D", lambda P: P.nn.Pad1D([1, 2], mode="reflect"), [F(2, 3, 6)])
case("Pad2D", lambda P: P.nn.Pad2D([1, 0, 2, 1], value=0.5), [IMG])
case("Pad3D", lambda P: P.nn.Pad3D([1, 0, 2, 1, 0, 1], mode="replicate"),
     [F(1, 2, 3, 4, 5)])
case("ZeroPad2D", lambda P: P.nn.ZeroPad2D([2, 1, 0, 1]), [IMG])
case("CosineSimilarity", lambda P: P.nn.CosineSimilarity(axis=-1),
     [F(4, 6), F(4, 6)], (0, 1))
case("Bilinear", lambda P: P.nn.Bilinear(3, 5, 4), [F(6, 3), F(6, 5)],
     (0, 1))
case("Bilinear-no-bias", lambda P: P.nn.Bilinear(3, 5, 4, bias_attr=False),
     [F(6, 3), F(6, 5)], (0, 1))
case("PixelShuffle", lambda P: P.nn.PixelShuffle(2), [F(2, 8, 3, 4)])
case("PixelUnshuffle", lambda P: P.nn.PixelUnshuffle(2), [F(2, 3, 4, 6)])
case("ChannelShuffle", lambda P: P.nn.ChannelShuffle(3), [IMG])
case("Unfold", lambda P: P.nn.Unfold([2, 3], 1, 1), [F(2, 3, 5, 6)])
case("Fold", lambda P: P.nn.Fold([5, 6], [2, 3], 1, 1),
     [F(2, 3 * 6, 6 * 6)])

# ---- norms ----
case("LayerNorm", lambda P: P.nn.LayerNorm([5, 4]), [IMG])
case("RMSNorm", lambda P: P.nn.RMSNorm(8), [F(3, 4, 8)])
for _cls, _shape in (("BatchNorm", (4, 6, 3, 5)), ("BatchNorm1D", (4, 6, 7)),
                     ("BatchNorm2D", (4, 6, 3, 5)),
                     ("BatchNorm3D", (2, 6, 3, 2, 4)),
                     ("SyncBatchNorm", (4, 6, 3, 5))):
    case(f"{_cls}-train", lambda P, c=_cls: getattr(P.nn, c)(6),
         [F(*_shape, scale=2.0) + 1.0])
    case(f"{_cls}-eval", lambda P, c=_cls: getattr(P.nn, c)(6),
         [F(*_shape)], train=False)
case("BatchNorm2D-nhwc", lambda P: P.nn.BatchNorm2D(
    6, data_format="NHWC"), [F(4, 3, 5, 6)])
case("BatchNorm-no-affine", lambda P: P.nn.BatchNorm(
    6, weight_attr=False, bias_attr=False), [F(4, 6, 3, 5)])
case("GroupNorm", lambda P: P.nn.GroupNorm(3, 6), [IMG])
case("GroupNorm-nhwc", lambda P: P.nn.GroupNorm(2, 6, data_format="NHWC"),
     [F(2, 5, 4, 6)])
case("InstanceNorm1D", lambda P: P.nn.InstanceNorm1D(6), [F(2, 6, 7)])
case("InstanceNorm2D", lambda P: P.nn.InstanceNorm2D(6), [IMG])
case("InstanceNorm3D", lambda P: P.nn.InstanceNorm3D(6),
     [F(2, 6, 3, 2, 4)])
case("LocalResponseNorm", lambda P: P.nn.LocalResponseNorm(3), [IMG])

# ---- pooling ----
for _n, _shape in ((1, (2, 3, 11)), (2, (2, 3, 9, 8)), (3, (1, 2, 7, 6, 5))):
    case(f"MaxPool{_n}D", lambda P, n=_n: getattr(P.nn, f"MaxPool{n}D")(
        3, 2, 1), [F(*_shape)])
    case(f"AvgPool{_n}D", lambda P, n=_n: getattr(P.nn, f"AvgPool{n}D")(
        3, 2, 1), [F(*_shape)])
    case(f"AvgPool{_n}D-inclusive", lambda P, n=_n: getattr(
        P.nn, f"AvgPool{n}D")(2, exclusive=False), [F(*_shape)])
    case(f"AdaptiveAvgPool{_n}D", lambda P, n=_n: getattr(
        P.nn, f"AdaptiveAvgPool{n}D")(3), [F(*_shape)])
    case(f"AdaptiveMaxPool{_n}D", lambda P, n=_n: getattr(
        P.nn, f"AdaptiveMaxPool{n}D")(2), [F(*_shape)])

# ---- convolutions ----
case("Conv1D", lambda P: P.nn.Conv1D(4, 6, 3, stride=2, padding=1),
     [F(2, 4, 13)], gtol=1e-4)
case("Conv1D-groups-nlc", lambda P: P.nn.Conv1D(
    4, 6, 3, padding="SAME", groups=2, data_format="NLC"), [F(2, 13, 4)],
    gtol=1e-4)
case("Conv2D", lambda P: P.nn.Conv2D(4, 6, [3, 2], padding=[1, 0],
                                     dilation=2), [F(2, 4, 9, 8)],
     gtol=1e-4)
case("Conv2D-no-bias", lambda P: P.nn.Conv2D(4, 6, 3, bias_attr=False),
     [F(2, 4, 9, 8)], gtol=1e-4)
case("Conv3D", lambda P: P.nn.Conv3D(4, 6, 3, padding=1, groups=2),
     [F(1, 4, 5, 6, 4)], gtol=1e-4)
case("Conv1DTranspose", lambda P: P.nn.Conv1DTranspose(
    4, 6, 3, stride=2, padding=1, output_padding=1), [F(2, 4, 7)],
    gtol=1e-4)
case("Conv2DTranspose", lambda P: P.nn.Conv2DTranspose(
    4, 6, 3, stride=2, padding=1, output_padding=1, groups=2),
    [F(2, 4, 5, 6)], gtol=1e-4)
case("Conv2DTranspose-dilation", lambda P: P.nn.Conv2DTranspose(
    4, 6, [3, 2], dilation=2), [F(2, 4, 5, 6)], gtol=1e-4)
case("Conv3DTranspose", lambda P: P.nn.Conv3DTranspose(
    4, 6, 2, stride=2), [F(1, 4, 3, 4, 2)], gtol=1e-4)


def test_paddle_meanings_the_jax_layers_drop():
    x = torch.from_numpy(F(2, 3, 5, 4))
    out = pt.nn.UpsamplingBilinear2D(size=[9, 7])(x)
    ref = torch.nn.functional.interpolate(x, size=[9, 7], mode="bilinear",
                                          align_corners=True)
    assert torch.equal(out, ref)
    for mode in ("reflect", "replicate", "circular"):
        conv = pt.nn.Conv2D(3, 4, 3, padding=[1, 2], padding_mode=mode)
        out = conv(x)
        ref = torch.nn.functional.conv2d(torch.nn.functional.pad(
            x, (2, 2, 1, 1), mode=mode), conv.weight, conv.bias)
        assert tuple(out.shape) == (2, 4, 5, 6)
        assert torch.allclose(out, ref, atol=1e-6, rtol=0)
    nlc = torch.from_numpy(F(2, 7, 6))
    compare(pt.nn.InstanceNorm1D(6, data_format="NLC")(nlc),
            pt.nn.InstanceNorm1D(6)(nlc.transpose(1, 2)).transpose(1, 2),
            1e-6)
    rr = pt.nn.RReLU(0.1, 0.3)
    neg = -torch.ones(1 << 12)
    assert bool((rr(neg) >= -0.3).all()) and rr(neg).unique().numel() > 100
    rr.eval()
    assert torch.equal(rr(neg), torch.full_like(neg, -0.2))
    with pytest.raises(ValueError, match="padding_mode"):
        pt.nn.Conv2D(3, 4, 3, padding_mode="mirror")


def test_sync_batch_norm_converts_and_keeps_state():
    net = pt.nn.Sequential(pt.nn.Conv2D(3, 4, 3), pt.nn.BatchNorm2D(4),
                           pt.nn.Sequential(pt.nn.BatchNorm1D(4)))
    net[1]._mean.fill_(0.5)
    out = pt.nn.SyncBatchNorm.convert_sync_batchnorm(net)
    assert isinstance(out[1], pt.nn.SyncBatchNorm)
    assert isinstance(out[2][0], pt.nn.SyncBatchNorm)
    assert torch.equal(out[1]._mean, torch.full((4,), 0.5))
    assert out[2][0]._data_format == "NCL"


@pytest.mark.parametrize("make,shape,fan_in,bias_bound", [
    (lambda: pt.nn.Conv1D(16, 32, 5), (32, 16, 5), 80, 80 ** -0.5),
    (lambda: pt.nn.Conv3D(8, 64, 3, groups=2), (64, 4, 3, 3, 3), 108,
     108 ** -0.5),
    (lambda: pt.nn.Conv2DTranspose(32, 16, 3, groups=4), (32, 4, 3, 3),
     72, 72 ** -0.5),
    (lambda: pt.nn.Conv1DTranspose(64, 8, 4), (64, 8, 4), 256, 256 ** -0.5),
])
def test_conv_default_initializers(make, shape, fan_in, bias_bound):
    """Kaiming-normal weights over fan_in = in / groups x prod(k) (the
    JAX layers' count, a transpose's too), biases inside +-1 /
    sqrt(fan_in)."""
    torch.manual_seed(0)
    pt.seed(0)
    conv = make()
    assert tuple(conv.weight.shape) == shape
    assert abs(conv.weight.std().item() / math.sqrt(2.0 / fan_in) - 1) < 0.05
    assert conv.bias.abs().max().item() <= bias_bound


def test_norm_and_activation_default_parameters():
    assert torch.equal(pt.nn.PReLU(3, 0.1).weight, torch.full((3,), 0.1))
    assert torch.equal(pt.nn.RMSNorm(5).weight, torch.ones(5))
    g = pt.nn.GroupNorm(2, 4)
    assert torch.equal(g.weight, torch.ones(4)) and torch.equal(
        g.bias, torch.zeros(4))
    i = pt.nn.InstanceNorm2D(4)
    assert torch.equal(i.scale, torch.ones(4))
    assert pt.nn.InstanceNorm2D(4, weight_attr=False).scale is None
    b = pt.nn.Bilinear(30, 40, 50)
    assert abs(b.weight.std().item() / math.sqrt(2.0 / (1200 + 2000)) - 1) \
        < 0.05
    assert tuple(b.bias.shape) == (1, 50) and not b.bias.any()
