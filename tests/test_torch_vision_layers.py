"""Port conv, norm, pool, activation, dropout and loss functionals and
layers (paddle_tpu_torch.nn) against the JAX package's on the same inputs
(fp32, CPU, numpy's ``default_rng``), and ``load_jax_state`` with
BatchNorm buffers.

Tolerances (fp32; only summation orders differ):
- conv2d, linear, pools, batch_norm outputs and running statistics:
  max abs error <= 1e-5 x max(1, max |jax|);
- activations and cross entropy: 1e-6 x max(1, max |jax|);
- ``ceil_mode``: the JAX package ignores it (its ``_pool``), so the port's
  max pool is held to JAX's floor-mode pool of the input padded with -inf
  at the end, and its average pool to a numpy loop over the in-bounds
  window elements (Paddle's rule), both to 1e-6;
- dropout at p = 0.25 over 2^16 elements: the keep rate within 0.01 of
  0.75 (about 5.8 standard deviations) and every kept value scaled by
  exactly 1 / 0.75; its bits cannot equal ``jax.random``'s;
- initializers: each layer's sample std within 5% of its distribution's
  (Conv2D Kaiming-normal, Linear Xavier-normal) and conv biases inside
  +-1 / sqrt(fan_in).
"""

import math

import jax  # noqa: F401  (JAX on the CPU, as tests/conftest.py sets it)
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu_torch import nn
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.weights import load_jax_state, state_from_jax_layer

torch.set_num_threads(1)


def _close(port, ref, tol=1e-5):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(getattr(ref, "_data", ref))
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = np.abs(port - ref).max() if ref.size else 0.0
    assert err <= tol * max(1.0, np.abs(ref).max()), err


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("case", [
    dict(stride=1, padding=1),
    dict(stride=2, padding=[1, 2]),
    dict(stride=1, padding=[0, 1, 2, 1]),            # per side
    dict(stride=1, padding=[[0, 0], [0, 0], [2, 1], [1, 0]]),
    dict(stride=2, padding="SAME"),                  # 1 before, 2 after
    dict(stride=1, padding="SAME", dilation=2),
    dict(stride=2, padding="VALID"),
    dict(stride=1, padding=2, dilation=2),
    dict(stride=1, padding=1, groups=2),
    dict(stride=2, padding=1, depthwise=True),
    dict(stride=1, padding=0, bias=False),
])
def test_conv2d_matches_jax(case):
    case = dict(case)
    depthwise, bias = case.pop("depthwise", False), case.pop("bias", True)
    groups = 6 if depthwise else case.pop("groups", 1)
    cout = 12 if depthwise else 8
    x = _x((2, 6, 11, 10))
    w = _x((cout, 6 // groups, 3, 4), 1) * 0.3
    b = _x((cout,), 2) if bias else None
    ref = JF.conv2d(paddle.to_tensor(x), paddle.to_tensor(w),
                    None if b is None else paddle.to_tensor(b),
                    groups=groups, **case)
    out = F.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                   None if b is None else torch.from_numpy(b),
                   groups=groups, **case)
    _close(out, ref)


def test_linear_and_flatten_match_jax():
    x, w, b = _x((3, 4, 5)), _x((5, 7), 1), _x((7,), 2)
    _close(F.linear(torch.from_numpy(x), torch.from_numpy(w),
                    torch.from_numpy(b)),
           JF.linear(paddle.to_tensor(x), paddle.to_tensor(w),
                     paddle.to_tensor(b)))
    _close(F.linear(torch.from_numpy(x), torch.from_numpy(w)),
           JF.linear(paddle.to_tensor(x), paddle.to_tensor(w)))
    for start, stop in ((0, -1), (1, -1), (1, 2)):
        _close(F.flatten(torch.from_numpy(x), start, stop),
               paddle.flatten(paddle.to_tensor(x), start, stop))


@pytest.mark.parametrize("kind,kernel,stride,padding,exclusive", [
    ("max", 3, 2, 1, None), ("max", 2, 2, 0, None),
    ("max", [3, 2], [1, 2], [1, 0], None),
    ("avg", 3, 2, 1, True), ("avg", 3, 2, 1, False),
    ("avg", 2, None, 0, True), ("avg", [3, 3], 1, [1, 1], True),
    ("avg", [3, 3], 1, [1, 1], False),
])
def test_pools_match_jax(kind, kernel, stride, padding, exclusive):
    x = _x((2, 3, 9, 8))
    if kind == "max":
        ref = JF.max_pool2d(paddle.to_tensor(x), kernel, stride, padding)
        out = F.max_pool2d(torch.from_numpy(x), kernel, stride, padding)
    else:
        ref = JF.avg_pool2d(paddle.to_tensor(x), kernel, stride, padding,
                            exclusive=exclusive)
        out = F.avg_pool2d(torch.from_numpy(x), kernel, stride, padding,
                           exclusive=exclusive)
    _close(out, ref)


def test_max_pool_ceil_mode_is_floor_mode_over_a_minus_inf_tail():
    """A 9 x 8 input, kernel 3, stride 2, padding 1: ceil mode keeps a
    fifth column of windows (starting at padded column 8, inside the input)
    that floor mode drops (the rows give 5 either way); JAX ignores
    ``ceil_mode``, so the reference is its floor pool over the input with
    one more -inf row and column at the end."""
    x = _x((2, 3, 9, 8))
    out = F.max_pool2d(torch.from_numpy(x), 3, 2, 1, ceil_mode=True)
    assert tuple(out.shape) == (2, 3, 5, 5)
    floor = F.max_pool2d(torch.from_numpy(x), 3, 2, 1)
    assert tuple(floor.shape) == (2, 3, 5, 4)
    tail = np.pad(x, ((0, 0), (0, 0), (0, 1), (0, 1)),
                  constant_values=-np.inf)
    _close(out, JF.max_pool2d(paddle.to_tensor(tail), 3, 2, 1), 1e-6)


def test_avg_pool_ceil_mode_averages_the_in_bounds_elements():
    x = _x((1, 2, 7, 7))
    out = F.avg_pool2d(torch.from_numpy(x), 2, 2, 0, ceil_mode=True).numpy()
    assert out.shape == (1, 2, 4, 4)
    ref = np.zeros_like(out)
    for i in range(4):
        for j in range(4):
            ref[..., i, j] = x[..., 2 * i:2 * i + 2, 2 * j:2 * j + 2].mean(
                axis=(-1, -2))
    _close(out, ref, 1e-6)


@pytest.mark.parametrize("in_hw,out_size", [
    ((7, 7), 3), ((5, 9), (2, 4)), ((1, 1), 7), ((4, 4), (4, 4)),
    ((6, 6), (1, 1))])
def test_adaptive_avg_pool_matches_jax(in_hw, out_size):
    """Windows [floor(i in / out), ceil((i + 1) in / out)) per axis, which
    also upsample (1 x 1 -> 7 x 7, VGG's pool on a small image)."""
    x = _x((2, 3, *in_hw))
    _close(F.adaptive_avg_pool2d(torch.from_numpy(x), out_size),
           JF.adaptive_avg_pool2d(paddle.to_tensor(x), out_size))


@pytest.mark.parametrize("affine", [True, False])
def test_batch_norm_train_and_eval_match_jax(affine):
    """Three training calls (batch statistics, the running ones updated with
    Paddle's momentum 0.9 and the unbiased variance), then eval (the running
    statistics) and use_global_stats in training."""
    c = 5
    w, b = (_x((c,), 7) + 2.0, _x((c,), 8)) if affine else (None, None)
    jrm, jrv = paddle.to_tensor(np.zeros(c, np.float32)), \
        paddle.to_tensor(np.ones(c, np.float32))
    trm, trv = torch.zeros(c), torch.ones(c)
    jw, jb = (paddle.to_tensor(w), paddle.to_tensor(b)) if affine \
        else (None, None)
    tw, tb = (torch.from_numpy(w), torch.from_numpy(b)) if affine \
        else (None, None)
    for step in range(3):
        x = _x((4, c, 3, 5), step) * (step + 1) + step
        ref = JF.batch_norm(paddle.to_tensor(x), jrm, jrv, jw, jb,
                            training=True)
        out = F.batch_norm(torch.from_numpy(x), trm, trv, tw, tb,
                           training=True)
        _close(out, ref)
        _close(trm, jrm)
        _close(trv, jrv)
    x = _x((3, c, 4, 4), 9)
    for kw in (dict(training=False), dict(training=True,
                                          use_global_stats=True)):
        ref = JF.batch_norm(paddle.to_tensor(x), jrm, jrv, jw, jb, **kw)
        out = F.batch_norm(torch.from_numpy(x), trm, trv, tw, tb, **kw)
        _close(out, ref)
    _close(trm, jrm)    # untouched by eval and use_global_stats
    _close(trv, jrv)


def test_activations_match_jax():
    x = _x((4, 33)) * 4
    tx, jx = torch.from_numpy(x), paddle.to_tensor(x)
    _close(F.relu(tx), JF.relu(jx), 1e-6)
    _close(F.relu6(tx), JF.relu6(jx), 1e-6)
    _close(F.silu(tx), JF.silu(jx), 1e-6)
    _close(F.gelu(tx), JF.gelu(jx), 1e-6)
    _close(F.gelu(tx, approximate=True), JF.gelu(jx, approximate=True),
           1e-6)
    assert not np.allclose(F.gelu(tx).numpy(),
                           F.gelu(tx, approximate=True).numpy())
    _close(nn.ReLU()(tx), JF.relu(jx), 1e-6)
    _close(nn.ReLU6()(tx), JF.relu6(jx), 1e-6)


def test_dropout_keep_rate_and_scale():
    x = torch.ones(1 << 16)
    assert F.dropout(x, 0.25, training=False) is x
    assert F.dropout(x, 0.0, training=True) is x
    gen = torch.Generator().manual_seed(3)
    y = F.dropout(x, 0.25, training=True, generator=gen)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.01
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.75))
    again = F.dropout(x, 0.25, generator=torch.Generator().manual_seed(3))
    assert torch.equal(y, again)
    layer = nn.Dropout(0.25, generator=torch.Generator().manual_seed(3))
    assert torch.equal(layer(x), y)
    layer.eval()
    assert layer(x) is x
    # axis= (ported with the Paddle API slice): one keep draw per row
    rows = F.dropout(torch.ones(256, 8), 0.25, axis=0,
                     generator=torch.Generator().manual_seed(3))
    assert torch.equal(rows.min(1).values, rows.max(1).values)
    assert set(rows[:, 0].tolist()) == {0.0, torch.tensor(1 / 0.75).item()}


@pytest.mark.parametrize("label_shape", ["n", "n1"])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("weighted", [False, True])
def test_cross_entropy_matches_jax(label_shape, reduction, weighted):
    logits = _x((9, 6)) * 3
    labels = np.random.default_rng(1).integers(0, 6, 9)
    labels[[2, 5]] = -100                     # ignore_index
    if label_shape == "n1":
        labels = labels[:, None]
    wt = np.linspace(0.5, 2.0, 6).astype(np.float32) if weighted else None
    ref = JF.cross_entropy(paddle.to_tensor(logits),
                           paddle.to_tensor(labels),
                           None if wt is None else paddle.to_tensor(wt),
                           reduction=reduction)
    loss = nn.CrossEntropyLoss(None if wt is None else torch.from_numpy(wt),
                               reduction=reduction)
    out = loss(torch.from_numpy(logits), torch.from_numpy(labels))
    _close(out, ref, 1e-6)
    assert out.dtype == torch.float32


def test_cross_entropy_refuses_what_it_does_not_take():
    x, y = torch.zeros(2, 3), torch.zeros(2, dtype=torch.long)
    # soft labels with a weight are ported (Paddle's rule): each row's loss
    # times label @ weight; "mean" divides by those row weights' sum
    logits = torch.tensor([[0.5, -1.0, 2.0], [1.5, 0.2, -0.3]])
    soft = torch.tensor([[0.2, 0.3, 0.5], [0.6, 0.4, 0.0]])
    wt = torch.tensor([1.0, 2.0, 0.5])
    rows = -(soft * torch.log_softmax(logits, -1)).sum(-1) * (soft @ wt)
    for reduction, ref in (("none", rows), ("sum", rows.sum()),
                           ("mean", rows.sum() / (soft @ wt).sum())):
        out = F.cross_entropy(logits, soft, wt, soft_label=True,
                              reduction=reduction)
        _close(out, ref.numpy(), 1e-6)
    with pytest.raises(ValueError, match="reduction"):
        F.cross_entropy(x, y, reduction="batchmean")


def _jax_block():
    return paddle.nn.Sequential(
        paddle.nn.Conv2D(3, 8, 3, stride=2, padding=1),
        paddle.nn.BatchNorm2D(8), paddle.nn.ReLU(),
        paddle.nn.MaxPool2D(2, 2), paddle.nn.Conv2D(8, 4, 1, bias_attr=False),
        paddle.nn.AdaptiveAvgPool2D(1))


def _port_block():
    kw = dict(device="cpu", generator=torch.Generator().manual_seed(0))
    return nn.Sequential(
        nn.Conv2D(3, 8, 3, stride=2, padding=1, **kw),
        nn.BatchNorm2D(8, device="cpu"), nn.ReLU(), nn.MaxPool2D(2, 2),
        nn.Conv2D(8, 4, 1, bias_attr=False, **kw), nn.AdaptiveAvgPool2D(1))


def test_layers_carry_jax_names_shapes_and_buffers():
    """A JAX state dict with moved BatchNorm statistics loads whole: the
    parameters and the ``_mean`` / ``_variance`` buffers; the layers then
    compute JAX's outputs in train mode (updating the statistics alike)
    and in eval mode."""
    jm, tm = _jax_block(), _port_block()
    x = _x((4, 3, 12, 12))
    jm.train()
    jm(paddle.to_tensor(x * 2 + 1))           # move the JAX statistics
    state = state_from_jax_layer(jm)
    assert set(state) == set(tm.state_dict())
    assert {"1._mean", "1._variance"} <= set(state)
    assert not np.allclose(state["1._mean"], 0.0)
    load_jax_state(tm, state)
    for k, v in tm.state_dict().items():
        _close(v, state[k], 0.0)
    tm.train()
    _close(tm(torch.from_numpy(x)), jm(paddle.to_tensor(x)))
    after = state_from_jax_layer(jm)
    for k in ("1._mean", "1._variance"):
        _close(tm.state_dict()[k], after[k])
    jm.eval(), tm.eval()
    _close(tm(torch.from_numpy(x)), jm(paddle.to_tensor(x)))


def test_load_jax_state_refuses_a_missing_unexpected_or_misshapen_entry():
    tm = _port_block()
    state = state_from_jax_layer(_jax_block())
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    missing = {k: v for k, v in state.items() if k != "1._variance"}
    with pytest.raises(KeyError, match=r"missing \['1._variance'\]"):
        load_jax_state(tm, missing)
    with pytest.raises(KeyError, match="unexpected"):
        load_jax_state(tm, dict(state, extra=np.zeros(1, np.float32)))
    with pytest.raises(ValueError, match="1._mean"):
        load_jax_state(tm, dict(state, **{"1._mean": np.zeros(
            9, np.float32)}))
    for k, v in tm.state_dict().items():    # nothing was copied
        assert torch.equal(v, before[k])


def test_layer_initializers_draw_jax_distributions():
    gen = torch.Generator().manual_seed(0)
    conv = nn.Conv2D(64, 128, 3, groups=2, device="cpu", generator=gen)
    fan_in = 32 * 9
    std = conv.weight.std().item()
    assert abs(std / math.sqrt(2.0 / fan_in) - 1) < 0.05
    assert conv.bias.abs().max().item() <= 1 / math.sqrt(fan_in)
    lin = nn.Linear(300, 200, device="cpu", generator=gen)
    assert abs(lin.weight.std().item() / math.sqrt(2.0 / 500) - 1) < 0.05
    assert torch.equal(lin.bias, torch.zeros(200))
    assert tuple(lin.weight.shape) == (300, 200)      # [in, out]
    bn = nn.BatchNorm2D(7, device="cpu")
    assert torch.equal(bn.weight, torch.ones(7))
    assert torch.equal(bn._variance, torch.ones(7))
    assert bn._mean.dtype == torch.float32
    assert nn.Linear(3, 4, bias_attr=False, device="cpu").bias is None
    with pytest.raises(TypeError, match="ParamAttr"):
        nn.Linear(3, 4, weight_attr=object(), device="cpu")
