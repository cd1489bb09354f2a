"""The long tail of ``nn`` (``paddle_tpu_torch/nn/functional/extras.py`` and
``nn/layer/extras.py``) against the JAX package's (CPU, fp32, numpy inputs
from a seed).

Each functional case runs one function in both packages on the same
inputs and compares the outputs within ``tol`` of max(1, max |jax|) and the
gradients of sum(out * cotangent) within ``gtol`` (``tests/
torch_nn_parity.check``); 1e-5 unless a case says otherwise (1e-4 where a
reduction over many terms sums in another order). Layers carry the JAX
layer's parameters and buffers across by name (``weights.load_jax_state``)
and compare the same way, every parameter's gradient too.

Where the JAX package is wrong or ignores an argument the port's meaning
is held against an independent reference instead, each case saying which:
CTC's empty label (JAX counts its one path twice: + log 2), an infeasible
CTC row (JAX's finite 1e30 kept, its gradient zero), ``grid_sample``'s
reflection (JAX's own), the fractional pools' mask, ``ctc_loss(
norm_by_times=)``. Random draws (``class_center_sample``,
``feature_alpha_dropout``) come from the port's generators, so they are
held to their invariants and rates, not to JAX's bits.
"""

import math

import jax  # noqa: F401  (JAX on the CPU, as tests/conftest.py sets it)
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as pt
from chip_smoke import _unique_unpool
from paddle_tpu_torch import device as pt_device
from paddle_tpu_torch.weights import load_jax_state, state_from_jax_layer
from torch_nn_parity import (F, INT, POS, PROB, SIGN, as_np, check, compare,
                             flat, is_float)

torch.set_num_threads(1)
PF = pt.nn.functional


@pytest.fixture(autouse=True)
def cpu_place():
    prev = pt_device._PLACE
    pt.set_device("cpu")
    yield
    pt_device._PLACE = prev


FN = []


def fcase(name, fn, inputs, grad=(0,), tol=1e-5, gtol=1e-5):
    FN.append(pytest.param(fn, inputs, grad, tol, gtol, id=name))


def _f(name):
    return lambda P, *a: getattr(P.nn.functional, name)(*a)


RNG = np.random.default_rng(2110)

# ---- max pool with mask, unpool ----
fcase("max_pool2d_with_mask", lambda P, x: P.nn.functional
      .max_pool2d_with_mask(x, 3, 2, 1), [F(2, 3, 9, 8)])
fcase("max_pool2d_with_mask-nopad", lambda P, x: P.nn.functional
      .max_pool2d_with_mask(x, 2), [F(2, 3, 6, 8)])
for _n, _sp in ((1, (10,)), (2, (6, 8)), (3, (4, 6, 4))):
    _idx, _osp = _unique_unpool(np, RNG, (2, 3), _sp, 2)
    fcase(f"max_unpool{_n}d", lambda P, x, i, n=_n: getattr(
        P.nn.functional, f"max_unpool{n}d")(x, i, 2),
        [F(2, 3, *_osp), _idx])
    fcase(f"max_unpool{_n}d-output_size", lambda P, x, i, n=_n, sp=_sp:
          getattr(P.nn.functional, f"max_unpool{n}d")(
              x, i, 2, output_size=[2, 3] + [s + 1 for s in sp]),
          [F(2, 3, *_osp), _idx])

# ---- losses ----
LG, LAB = F(6, 5), INT(6, hi=5)
for _red in ("mean", "sum", "none"):
    fcase(f"soft_margin_loss-{_red}", lambda P, x, y, r=_red: P.nn.functional
          .soft_margin_loss(x, y, r), [F(4, 7), SIGN(4, 7)])
    fcase(f"multi_margin_loss-{_red}", lambda P, x, y, r=_red:
          P.nn.functional.multi_margin_loss(x, y, reduction=r), [LG, LAB])
    fcase(f"poisson_nll_loss-{_red}", lambda P, x, y, r=_red:
          P.nn.functional.poisson_nll_loss(x, y, reduction=r),
          [F(4, 7), POS(4, 7)])
    fcase(f"gaussian_nll_loss-{_red}", lambda P, x, y, v, r=_red:
          P.nn.functional.gaussian_nll_loss(x, y, v, reduction=r),
          [F(4, 7), F(4, 7), POS(4, 7)], (0, 1, 2))
fcase("multi_label_soft_margin_loss", _f("multi_label_soft_margin_loss"),
      [F(4, 7), PROB(4, 7).round()], (0, 1))
fcase("multi_label_soft_margin_loss-weight", lambda P, x, y, w:
      P.nn.functional.multi_label_soft_margin_loss(x, y, w, "sum"),
      [F(4, 7), PROB(4, 7).round(), PROB(7)])
fcase("multi_margin_loss-p2-weight", lambda P, x, y, w: P.nn.functional
      .multi_margin_loss(x, y, 2, 0.7, w), [LG, LAB, PROB(5)])
fcase("poisson_nll_loss-linear-full", lambda P, x, y: P.nn.functional
      .poisson_nll_loss(x, y, log_input=False, full=True),
      [POS(4, 7), POS(4, 7) * 3], (0,))
fcase("gaussian_nll_loss-full", lambda P, x, y, v: P.nn.functional
      .gaussian_nll_loss(x, y, v, full=True), [F(4, 7), F(4, 7), POS(4, 7)],
      (0, 1, 2))
for _p in (1.0, 2.0, 3.0):
    fcase(f"pairwise_distance-p{_p}", lambda P, x, y, p=_p: P.nn.functional
          .pairwise_distance(x, y, p), [F(5, 6), F(5, 6)], (0, 1),
          gtol=1e-4)
fcase("pairwise_distance-keepdim", lambda P, x, y: P.nn.functional
      .pairwise_distance(x, y, keepdim=True), [F(5, 6), F(5, 6)], (0, 1))
fcase("triplet_margin_with_distance_loss", _f(
    "triplet_margin_with_distance_loss"), [F(6, 5), F(6, 5), F(6, 5)],
    (0, 1, 2))
fcase("triplet_margin_with_distance_loss-custom-swap", lambda P, a, p, n:
      P.nn.functional.triplet_margin_with_distance_loss(
          a, p, n, lambda u, v: ((u - v) ** 2).sum(-1), margin=0.5, swap=True,
          reduction="sum"), [F(6, 5), F(6, 5), F(6, 5)], (0, 1, 2))
fcase("npair_loss", _f("npair_loss"), [F(6, 4), F(6, 4),
                                       np.array([0, 1, 0, 2, 1, 3])], (0, 1))
fcase("margin_cross_entropy", lambda P, x, y: P.nn.functional
      .margin_cross_entropy(x, y, return_softmax=True),
      [np.tanh(F(6, 5)), LAB], (0,), gtol=1e-4)
fcase("margin_cross_entropy-none", lambda P, x, y: P.nn.functional
      .margin_cross_entropy(x, y, 1.2, 0.3, 0.1, 16.0, reduction="none"),
      [np.tanh(F(6, 5)), LAB], (0,), gtol=1e-4)

# CTC: [T, B, C] logits, labels of 1-4 (the empty label is held below)
CTC_T, CTC_B, CTC_C = 16, 5, 7
CTC_X = F(CTC_T, CTC_B, CTC_C)
CTC_LAB = INT(CTC_B, 4, lo=1, hi=CTC_C)
CTC_IL, CTC_LL = np.array([16, 12, 9, 16, 5]), np.array([4, 2, 3, 1, 2])
for _red in ("mean", "sum", "none"):
    fcase(f"ctc_loss-{_red}", lambda P, x, lab, il, ll, r=_red:
          P.nn.functional.ctc_loss(x, lab, il, ll, reduction=r),
          [CTC_X, CTC_LAB, CTC_IL, CTC_LL], (0,), gtol=1e-5)
fcase("ctc_loss-blank3", lambda P, x, lab, il, ll: P.nn.functional.ctc_loss(
    x, lab, il, ll, blank=3), [CTC_X, np.where(CTC_LAB == 3, 1, CTC_LAB),
                               CTC_IL, CTC_LL], (0,))
fcase("ctc_loss-repeats", lambda P, x, lab, il, ll: P.nn.functional.ctc_loss(
    x, lab, il, ll), [CTC_X, np.array([[2, 2, 3, 3]] * CTC_B), CTC_IL,
                      np.array([4, 4, 4, 2, 2])], (0,))

# RNN-T: [B, T, U + 1, C]
RT_B, RT_T, RT_U, RT_C = 3, 7, 4, 6
RT_X = F(RT_B, RT_T, RT_U + 1, RT_C)
RT_LAB = INT(RT_B, RT_U, lo=1, hi=RT_C)
RT_TL, RT_UL = np.array([7, 5, 2]), np.array([4, 2, 3])
for _red in ("mean", "sum", "none"):
    fcase(f"rnnt_loss-{_red}", lambda P, x, lab, tl, ul, r=_red:
          P.nn.functional.rnnt_loss(x, lab, tl, ul, reduction=r),
          [RT_X, RT_LAB, RT_TL, RT_UL], (0,))
fcase("rnnt_loss-fastemit-blank2", lambda P, x, lab, tl, ul: P.nn.functional
      .rnnt_loss(x, lab, tl, ul, blank=2, fastemit_lambda=0.25),
      [RT_X, np.where(RT_LAB == 2, 1, RT_LAB), RT_TL, RT_UL], (0,))

# hierarchical sigmoid: 6 classes, features 5
HS_W, HS_B = F(5, 5), F(5)
fcase("hsigmoid_loss", lambda P, x, y, w, b: P.nn.functional.hsigmoid_loss(
    x, y, 6, w, b), [F(8, 5), INT(8, hi=6), HS_W, HS_B], (0, 2, 3))
fcase("hsigmoid_loss-no-bias", lambda P, x, y, w: P.nn.functional
      .hsigmoid_loss(x, y, 7, w), [F(8, 5), INT(8, hi=7), F(6, 5)], (0, 2))
HS_TABLE = np.array([[0, 1, -1], [0, 1, 3], [0, 2, 4], [0, 2, -1]])
HS_CODE = np.array([[0, 0, 0], [0, 1, 1], [1, 0, 1], [1, 1, 0]])
fcase("hsigmoid_loss-custom", lambda P, x, y, w, b: P.nn.functional
      .hsigmoid_loss(x, y, 4, w, b, path_table=HS_TABLE, path_code=HS_CODE),
      [F(8, 5), INT(8, hi=4), HS_W, HS_B], (0, 2, 3))

fcase("adaptive_log_softmax_with_loss", lambda P, x, y, hw, hb, a1, a2, b1,
      b2: P.nn.functional.adaptive_log_softmax_with_loss(
          x, y, hw, [(a1, a2), (b1, b2)], [4, 7, 10], hb),
      [F(9, 6), np.array([0, 3, 4, 6, 7, 9, 1, 5, 8]), F(6, 6), F(6),
       F(6, 3), F(3, 3), F(6, 2), F(2, 3)], (0, 2, 3, 4, 5, 6, 7))

# ---- sampling, beams, shifts ----
THETA = (np.eye(2, 3)[None] + 0.3 * F(2, 2, 3)).astype(np.float32)
for _ac in (True, False):
    fcase(f"affine_grid-align{_ac}", lambda P, th, a=_ac: P.nn.functional
          .affine_grid(th, [2, 3, 5, 7], align_corners=a), [THETA])
GS_X = F(2, 3, 5, 6)
GS_GRID = (F(2, 4, 7, 2) * 0.8).astype(np.float32)
GS_GRID[0, 0, :3] = [[0.2, -1.3], [1.4, 0.25], [-1.2, 1.1]]   # outside
for _mode in ("bilinear", "nearest"):
    for _pm in ("zeros", "border", "reflection"):
        for _ac in (True, False):
            fcase(f"grid_sample-{_mode}-{_pm}-align{_ac}",
                  lambda P, x, g, m=_mode, p=_pm, a=_ac: P.nn.functional
                  .grid_sample(x, g, m, p, a), [GS_X, GS_GRID],
                  (0, 1) if _mode == "bilinear" else (0,), gtol=1e-4)
# nearest at half-way points: x = 2.5 and y = 1.5 round away from zero
# (torch's grid_sample would round half to even)
fcase("grid_sample-nearest-halfway", lambda P, x, g: P.nn.functional
      .grid_sample(x, g, "nearest"), [F(1, 2, 4, 6),
                                      np.array([[[[0.0, 0.0], [-0.2, 0.0],
                                                  [-1.0, -1.0]]]],
                                               np.float32)], (0,))
GT_IDS = INT(5, 2, 3, hi=9)
GT_PAR = INT(5, 2, 3, hi=3)
fcase("gather_tree", _f("gather_tree"), [GT_IDS, GT_PAR], ())
for _fmt in ("NCHW", "NHWC"):
    fcase(f"temporal_shift-{_fmt}", lambda P, x, f=_fmt: P.nn.functional
          .temporal_shift(x, 3, 0.25, f), [F(6, 8, 3, 2)])
SA_Q = [F(2, 2, 6, 4) for _ in range(3)]
SA_OFF = np.array([[[0, 2, 3, 5, 6, 8, 10], [0, 1, 2, 3, 4, 5, 6]]] * 2,
                  np.int32)
SA_COLS = np.array([[[0, 1, 1, 0, 2, 3, 2, 4, 4, 5],
                     [0, 1, 2, 3, 4, 5, 0, 0, 0, 0]]] * 2, np.int32)
fcase("sparse_attention", lambda P, q, k, v, o, c: P.nn.functional
      .sparse_attention(q, k, v, o, c), SA_Q + [SA_OFF, SA_COLS], (0, 1, 2))
fcase("sparse_attention-masks", lambda P, q, k, v, o, c, kpm, am:
      P.nn.functional.sparse_attention(q, k, v, o, c, kpm, am),
      SA_Q + [SA_OFF, SA_COLS, np.array([[1, 1, 1, 1, 0, 1]] * 2, np.float32),
              F(2, 2, 6, 6)], (0, 1, 2))
fcase("sequence_mask", lambda P, x: P.nn.functional.sequence_mask(x),
      [np.array([3, 0, 5, 2])], ())
fcase("sequence_mask-maxlen-float", lambda P, x: P.nn.functional
      .sequence_mask(x, 7, "float32"), [np.array([[3, 1], [6, 2]])], ())
fcase("softmax_2d", _f("softmax_2d"), [F(2, 4, 3, 5)])
fcase("zeropad2d", lambda P, x: P.nn.functional.zeropad2d(x, [1, 2, 0, 1]),
      [F(2, 3, 4, 5)])
fcase("zeropad2d-nhwc", lambda P, x: P.nn.functional.zeropad2d(
    x, [1, 0, 2, 1], "NHWC"), [F(2, 4, 5, 3)])
fcase("fractional_max_pool2d", lambda P, x: P.nn.functional
      .fractional_max_pool2d(x, [4, 3], random_u=0.3), [F(2, 3, 9, 7)])
fcase("fractional_max_pool2d-int", lambda P, x: P.nn.functional
      .fractional_max_pool2d(x, 5, random_u=0.85), [F(1, 2, 11, 8)])
fcase("fractional_max_pool3d", lambda P, x: P.nn.functional
      .fractional_max_pool3d(x, [2, 3, 3], random_u=0.6),
      [F(1, 2, 5, 7, 6)])
fcase("feature_alpha_dropout-eval", lambda P, x: P.nn.functional
      .feature_alpha_dropout(x, 0.4, training=False), [F(2, 3, 4)])
for _name, _args in (("elu_", (0.7,)), ("hardtanh_", (-0.5, 0.4)),
                     ("leaky_relu_", (0.2,)), ("tanh_", ()),
                     ("thresholded_relu_", (0.3,))):
    # JAX's in-place form rebinds the handle off its tape (no gradient):
    # values here, gradients in test_in_place_activations_write_into_x
    fcase(f"F.{_name}", lambda P, x, n=_name, a=_args: getattr(
        P.nn.functional, n)(x * 1.0, *a), [F(4, 6)], ())


@pytest.mark.parametrize("fn,inputs,grad,tol,gtol", FN)
def test_functional_matches_jax(fn, inputs, grad, tol, gtol):
    check(fn, inputs, grad, tol, gtol)


def test_ctc_empty_label_and_infeasible_rows():
    """JAX's CTC counts an empty label's one path twice (its last two
    extended positions are the same blank: + log 2) and gives an
    infeasible row its finite log zero (1e30). The port keeps torch's
    empty-label value, JAX's 1e30 for the infeasible row, and gives that
    row a zero gradient; the other rows equal JAX forward and backward."""
    x = F(10, 4, 6)
    lab = np.array([[1, 2, 3], [1, 2, 1], [4, 4, 4], [2, 3, 1]])
    il, ll = np.array([10, 9, 3, 10]), np.array([3, 0, 3, 2])
    jx = jp.to_tensor(x, stop_gradient=False)
    jl = jp.nn.functional.ctc_loss(jx, jp.to_tensor(lab), jp.to_tensor(il),
                                   jp.to_tensor(ll), reduction="none")
    tx = pt.to_tensor(x, stop_gradient=False)
    tl = PF.ctc_loss(tx, pt.to_tensor(lab), pt.to_tensor(il),
                     pt.to_tensor(ll), reduction="none")
    j, t = as_np(jl), as_np(tl)
    np.testing.assert_allclose(t[[0, 3]], j[[0, 3]], rtol=1e-6)
    np.testing.assert_allclose(t[1], j[1] + math.log(2), rtol=1e-6)
    assert t[2] == np.float32(1e30) and j[2] == np.float32(1e30)
    # the empty label's one path: blanks all the way
    lp = torch.log_softmax(torch.from_numpy(x[:, 1]), -1)
    np.testing.assert_allclose(t[1], -float(lp[:9, 0].sum()), rtol=1e-6)
    cot = np.array([0.3, 0.0, 0.7, -0.4], np.float32)
    (jl * jp.to_tensor(cot)).sum().backward()
    (tl * pt.to_tensor(cot)).sum().backward()
    jg, tg = as_np(jx.grad), as_np(tx.grad)
    np.testing.assert_allclose(tg[:, [0, 3]], jg[:, [0, 3]], atol=1e-5)
    assert not tg[:, 2].any()


def test_ctc_mean_and_norm_by_times():
    """``mean`` divides each row by its label length, then averages
    (torch's own ``ctc_loss`` with ``mean`` equal); ``norm_by_times``
    (Paddle's, which JAX ignores) keeps the loss and divides each row's
    gradient by its input length."""
    x = torch.from_numpy(CTC_X)
    args = [pt.to_tensor(a) for a in (CTC_LAB, CTC_IL, CTC_LL)]
    ref = torch.nn.functional.ctc_loss(
        torch.log_softmax(x, -1), torch.from_numpy(CTC_LAB),
        torch.from_numpy(CTC_IL), torch.from_numpy(CTC_LL))
    compare(PF.ctc_loss(x, *args), ref, 1e-6)
    grads = []
    for nbt in (False, True):
        t = x.clone().requires_grad_()
        loss = PF.ctc_loss(t, *args, reduction="none", norm_by_times=nbt)
        loss.sum().backward()
        grads.append((loss.detach(), t.grad))
    compare(grads[1][0], grads[0][0], 0.0)
    compare(grads[1][1], grads[0][1] / torch.from_numpy(CTC_IL)[None, :,
                                                                 None], 1e-6)


def test_rnnt_single_rows_match_the_batch():
    """Each row alone (cut to its lengths) gives the batch's value: the
    anti-diagonal recursion keeps rows apart."""
    batch = PF.rnnt_loss(torch.from_numpy(RT_X), torch.from_numpy(RT_LAB),
                         torch.from_numpy(RT_TL), torch.from_numpy(RT_UL),
                         reduction="none")
    for b in range(RT_B):
        t, u = int(RT_TL[b]), int(RT_UL[b])
        one = PF.rnnt_loss(torch.from_numpy(RT_X[b:b + 1, :t, :u + 1]),
                           torch.from_numpy(RT_LAB[b:b + 1, :u]),
                           torch.tensor([t]), torch.tensor([u]),
                           reduction="none")
        compare(one, batch[b:b + 1], 1e-6)


def test_max_unpool_duplicate_indices_shape_only():
    """Overlapping windows can send two values to one index: which one
    lands is undefined in both packages, so only the shape is held."""
    x = torch.from_numpy(F(1, 2, 5, 5))
    out, mask = PF.max_pool2d_with_mask(x, 3, 1, 1)
    up = PF.max_unpool2d(out, mask, 3, 1, 1)
    assert tuple(up.shape) == (1, 2, 5, 5)


@pytest.mark.parametrize("n,shape,out", [(2, (2, 3, 9, 7), [4, 3]),
                                         (3, (1, 2, 5, 7, 6), [2, 3, 3])])
def test_fractional_pool_mask_and_draws(n, shape, out):
    """``return_mask`` (Paddle's, which JAX drops): the mask gathers the
    output from the input; without ``random_u`` the intervals come from
    the port's generator: reproducible under ``paddle.seed``."""
    x = torch.from_numpy(F(*shape))
    f = getattr(PF, f"fractional_max_pool{n}d")
    y, mask = f(x, out, random_u=0.4, return_mask=True)
    assert mask.dtype == torch.int32 and tuple(y.shape) == shape[:2] + tuple(
        out)
    assert torch.equal(x.flatten(2).gather(2, mask.long().flatten(2)),
                       y.flatten(2))
    pt.seed(5)
    a = f(x, out)
    pt.seed(5)
    assert torch.equal(f(x, out), a)
    with pytest.raises(NotImplementedError, match="item 8"):
        f(x, out, kernel_size=2)


def test_class_center_sample_keeps_positives_and_remaps():
    y = torch.tensor([3, 17, 3, 8, 29])
    pt.seed(1)
    remap, chosen = PF.class_center_sample(y, 40, 10)
    assert chosen.shape == (10,) and bool((chosen[1:] > chosen[:-1]).all())
    assert torch.equal(chosen[remap], y)
    pt.seed(1)
    assert torch.equal(PF.class_center_sample(y, 40, 10)[1], chosen)
    j_remap, j_chosen = jp.nn.functional.class_center_sample(
        jp.to_tensor(y.numpy()), 40, 10)
    assert np.array_equal(as_np(j_chosen)[as_np(j_remap)], y.numpy())
    with pytest.raises(NotImplementedError, match="item 6"):
        PF.class_center_sample(y, 40, 10, group=object())


def test_feature_alpha_dropout_drops_whole_channels():
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(64, 256, 4, 4, generator=gen)
    y = PF.feature_alpha_dropout(x, 0.3, generator=gen)
    q, alpha_p = 0.7, -1.7580993408473766
    a = (q + alpha_p ** 2 * q * 0.3) ** -0.5
    # exactly a alpha' + b, the dropped value (isclose would take kept
    # elements near it too)
    dropped = y == a * torch.full_like(y, alpha_p) - a * alpha_p * 0.3
    per_channel = dropped.flatten(2).float().mean(-1)
    assert bool(((per_channel == 0) | (per_channel == 1)).all())
    rate = float(per_channel.mean())
    assert abs(rate - 0.3) < 6 * (0.3 * 0.7 / (64 * 256)) ** 0.5
    assert PF.feature_alpha_dropout(x, 0.0) is x


@pytest.mark.parametrize("name,args", [("elu", (0.7,)),
                                       ("hardtanh", (-0.5, 0.4)),
                                       ("leaky_relu", (0.2,)), ("tanh", ()),
                                       ("thresholded_relu", (0.3,))])
def test_in_place_activations_write_into_x(name, args):
    """The in-place form returns x holding the out-of-place result, and a
    gradient through it equals the out-of-place one's (within 1e-6: ELU's
    in-place backward reads its result, exp(x) - 1 + 1, not its input)."""
    data = F(3, 4)
    a = pt.to_tensor(data, stop_gradient=False)
    b = pt.to_tensor(data, stop_gradient=False)
    ref = getattr(PF, name)(a * 1.0, *args)
    y = b * 1.0
    out = getattr(PF, name + "_")(y, *args)
    assert out is y and torch.equal(y, ref)
    cot = torch.from_numpy(F(3, 4))
    (ref * cot).sum().backward()
    (out * cot).sum().backward()
    assert torch.allclose(b.grad, a.grad, rtol=0, atol=1e-6)


# ---- layers ----
LAYERS = []


def lcase(name, make, inputs, grad=(0,), tol=1e-5, gtol=1e-5, train=True):
    LAYERS.append(pytest.param(make, inputs, grad, tol, gtol, train,
                               id=name))


def _pair(make, train):
    jm, tm = make(jp), make(pt)
    assert [(n, tuple(p.shape)) for n, p in tm.named_parameters()] == \
        [(n, tuple(p.shape)) for n, p in jm.named_parameters()]
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


lcase("PairwiseDistance", lambda P: P.nn.PairwiseDistance(3.0),
      [F(5, 6), F(5, 6)], (0, 1), gtol=1e-4)
lcase("Softmax2D", lambda P: P.nn.Softmax2D(), [F(2, 4, 3, 5)])
lcase("Unflatten", lambda P: P.nn.Unflatten(1, [2, 3]), [F(4, 6, 5)])
lcase("FeatureAlphaDropout-eval", lambda P: P.nn.FeatureAlphaDropout(0.4),
      [F(2, 3, 4)], train=False)
lcase("ZeroPad1D", lambda P: P.nn.ZeroPad1D([2, 1]), [F(2, 3, 6)])
lcase("ZeroPad3D", lambda P: P.nn.ZeroPad3D([1, 0, 2, 1, 0, 1]),
      [F(1, 2, 3, 4, 5)])
lcase("LPPool1D", lambda P: P.nn.LPPool1D(2, 3, 2), [POS(2, 3, 9)])
lcase("LPPool2D", lambda P: P.nn.LPPool2D(3, 2), [POS(2, 3, 6, 8)])
lcase("FractionalMaxPool2D", lambda P: P.nn.FractionalMaxPool2D(
    [3, 4], random_u=0.45), [F(2, 3, 7, 9)])
lcase("FractionalMaxPool3D", lambda P: P.nn.FractionalMaxPool3D(
    2, random_u=0.2), [F(1, 2, 5, 4, 6)])
_idx2, _osp2 = _unique_unpool(np, RNG, (2, 3), (6, 8), 2)
lcase("MaxUnPool2D", lambda P: P.nn.MaxUnPool2D(2), [F(2, 3, *_osp2), _idx2])
_idx1, _osp1 = _unique_unpool(np, RNG, (2, 3), (10,), 2)
lcase("MaxUnPool1D", lambda P: P.nn.MaxUnPool1D(2), [F(2, 3, *_osp1), _idx1])
_idx3, _osp3 = _unique_unpool(np, RNG, (2, 3), (4, 6, 4), 2)
lcase("MaxUnPool3D", lambda P: P.nn.MaxUnPool3D(2), [F(2, 3, *_osp3), _idx3])
lcase("SoftMarginLoss", lambda P: P.nn.SoftMarginLoss("sum"),
      [F(4, 7), SIGN(4, 7)])
lcase("MultiLabelSoftMarginLoss", lambda P: P.nn.MultiLabelSoftMarginLoss(),
      [F(4, 7), PROB(4, 7).round()])
lcase("MultiMarginLoss", lambda P: P.nn.MultiMarginLoss(2, 0.5), [LG, LAB])
lcase("PoissonNLLLoss", lambda P: P.nn.PoissonNLLLoss(full=True),
      [F(4, 7), POS(4, 7) * 2])
lcase("GaussianNLLLoss", lambda P: P.nn.GaussianNLLLoss(),
      [F(4, 7), F(4, 7), POS(4, 7)], (0, 1, 2))
lcase("TripletMarginWithDistanceLoss", lambda P:
      P.nn.TripletMarginWithDistanceLoss(swap=True),
      [F(6, 5), F(6, 5), F(6, 5)], (0, 1, 2))
lcase("CTCLoss", lambda P: P.nn.CTCLoss(), [CTC_X, CTC_LAB, CTC_IL, CTC_LL])
lcase("RNNTLoss", lambda P: P.nn.RNNTLoss(fastemit_lambda=0.1),
      [RT_X, RT_LAB, RT_TL, RT_UL])
lcase("HSigmoidLoss", lambda P: P.nn.HSigmoidLoss(5, 6),
      [F(8, 5), INT(8, hi=6)])
lcase("HSigmoidLoss-no-bias", lambda P: P.nn.HSigmoidLoss(
    5, 9, bias_attr=False), [F(8, 5), INT(8, hi=9)])
lcase("AdaptiveLogSoftmaxWithLoss", lambda P: P.nn.AdaptiveLogSoftmaxWithLoss(
    8, 12, [4, 8], div_value=2.0), [F(9, 8), INT(9, hi=12)], gtol=1e-4)
lcase("AdaptiveLogSoftmaxWithLoss-head-bias", lambda P:
      P.nn.AdaptiveLogSoftmaxWithLoss(8, 12, [5], head_bias=True),
      [F(9, 8), INT(9, hi=12)], gtol=1e-4)
lcase("SpectralNorm", lambda P: P.nn.SpectralNorm([6, 4, 2], axis=1,
                                                  power_iters=3),
      [F(6, 4, 2)], gtol=1e-4)


@pytest.mark.parametrize("make,inputs,grad,tol,gtol,train", LAYERS)
def test_layer_matches_jax(make, inputs, grad, tol, gtol, train):
    jm, tm = _pair(make, train)
    jts, jout = _forward(jp, jm, inputs, grad)
    tts, tout = _forward(pt, tm, inputs, grad)
    compare(tout, jout, tol)
    compare([as_np(v) for v in tm.state_dict().values()],
            [as_np(v) for v in jm.state_dict().values()], tol)
    cots = [np.random.default_rng(7).standard_normal(as_np(o).shape)
            .astype(np.float32) for o in flat(jout) if is_float(o)]
    _backward(jp, jout, cots)
    _backward(pt, tout, cots)
    compare([tts[i].grad for i in grad], [jts[i].grad for i in grad], gtol)
    jg = {n: p.grad for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        compare(p.grad, jg[n], gtol)


def test_adaptive_softmax_log_prob_and_predict_match_jax():
    jm, tm = _pair(lambda P: P.nn.AdaptiveLogSoftmaxWithLoss(
        8, 12, [4, 8], div_value=2.0, head_bias=True), False)
    x = F(7, 8)
    compare(tm.log_prob(pt.to_tensor(x)), jm.log_prob(jp.to_tensor(x)), 1e-5)
    compare(tm.predict(pt.to_tensor(x)), jm.predict(jp.to_tensor(x)), 0)
    assert torch.allclose(tm.log_prob(pt.to_tensor(x)).exp().sum(-1),
                          torch.ones(7), atol=1e-5)
    with pytest.raises(ValueError, match="labels must be in"):
        tm(pt.to_tensor(x), pt.to_tensor(np.array([0, 12, 1, 1, 1, 1, 1])))


def test_spectral_norm_buffers_converge_and_draw_from_the_generator():
    """The buffers carry JAX's names and shapes, start from the port's
    generator (reproducible under ``paddle.seed``) and move to the top
    singular vectors across calls: sigma of the normalised weight -> 1."""
    pt.seed(4)
    a = pt.nn.SpectralNorm([5, 3, 4])
    pt.seed(4)
    b = pt.nn.SpectralNorm([5, 3, 4])
    assert [(n, tuple(v.shape)) for n, v in a.state_dict().items()] == \
        [("weight_u", (5,)), ("weight_v", (12,))]
    assert torch.equal(a.weight_u, b.weight_u)
    w = pt.to_tensor(F(5, 3, 4))
    for _ in range(30):
        out = a(w)
    assert abs(float(torch.linalg.matrix_norm(out.reshape([5, 12]), 2)) - 1) \
        < 1e-4


def test_layer_dict_and_cell_initial_states():
    d = pt.nn.LayerDict({"a": pt.nn.Linear(2, 3), "b": pt.nn.ReLU()})
    d["c"] = pt.nn.Tanh()
    assert list(d.keys()) == ["a", "b", "c"] and len(d) == 3 and "b" in d
    assert [n for n, _ in d.named_parameters()] == ["a.weight", "a.bias"]
    assert isinstance(d.pop("b"), pt.nn.ReLU) and list(d) == ["a", "c"]
    d.update([("e", pt.nn.Sigmoid())])
    assert list(d) == ["a", "c", "e"]

    class Cell(pt.nn.RNNCellBase):
        state_shape = 4

    x = pt.to_tensor(F(3, 2))
    for P, cell in ((jp, None), (pt, Cell())):
        if P is jp:
            class JCell(jp.nn.RNNCellBase):
                state_shape = 4
            cell = JCell()
            ref = (as_np(cell.get_initial_states(jp.to_tensor(F(3, 2)),
                                                 init_value=0.5)),
                   [as_np(s) for s in cell.get_initial_states(
                       jp.to_tensor(F(3, 2)), shape=[2, 5])])
        else:
            got = (as_np(cell.get_initial_states(x, init_value=0.5)),
                   [as_np(s) for s in cell.get_initial_states(
                       x, shape=[2, 5])])
    compare(got[0], ref[0], 0)
    compare(got[1], ref[1], 0)
    h = Cell().get_initial_states(x, dtype="float64", batch_dim_idx=1)
    assert h.dtype == torch.float64 and tuple(h.shape) == (2, 4)


def test_unflatten_and_zero_pad_layers_are_exported():
    for name in ("ZeroPad1D", "ZeroPad3D", "Unflatten", "LayerDict",
                 "dynamic_decode", "BeamSearchDecoder", "BiRNN"):
        assert hasattr(pt.nn, name)


def test_thresholded_relu_rounds_its_threshold_in_bf16():
    """JAX compares a bf16 input with the threshold rounded to bf16 (weak
    typing); torch's CPU kernel would compare with 0.3 itself, its CUDA
    kernel with the rounded value: the port rounds first, so 0.30078125
    (bf16's 0.3) is not above it on either device."""
    x = np.array([0.30078125, 0.29, 0.5, -1.0], np.float32)
    ref = jp.nn.functional.thresholded_relu(
        jp.to_tensor(x).astype("bfloat16"), 0.3)
    for f in (PF.thresholded_relu, lambda t, th: PF.thresholded_relu_(
            t * 1.0, th)):
        out = f(pt.to_tensor(x).astype("bfloat16"), 0.3)
        np.testing.assert_array_equal(as_np(out), as_np(ref))
