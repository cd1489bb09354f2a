"""The port's ``quantization`` against the JAX package's, on the CPU: the
observers, ``fake_quant`` and its straight-through gradient, the int8
product of ``ConvertedLinear`` (its int32 accumulator byte-equal to JAX's
``lax.dot_general``), QAT and PTQ on the 2-layer encoder of
tests/torch_slice_encoder.py (token and position embeddings, two
TransformerEncoderLayers, a Linear head: 13 Linears) with the JAX
package's weights, and the conv layers.

Tolerance: the quantized weights and the int32 accumulators are
byte-equal; fp32 logits within 1e-4 of the largest |logit| (the same
quantization grid on both sides: the per-tensor scales agree to the last
bit, so an activation can round differently only where the fp32 matmul
before it lands within an ulp of a rounding boundary, which the check
would see as one quantization step in one product, ~1e-2 — it does not
happen on these inputs); gradients within 1e-4 of the largest.
"""

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.quantization as JQ
import paddle_tpu_torch as pt
import paddle_tpu_torch.quantization as TQ
from paddle_tpu_torch import device as pt_device
from paddle_tpu_torch.weights import load_jax_state, state_from_jax_layer
from torch_slice_encoder import ENC as CFG, encoder as _encoder


@pytest.fixture(autouse=True)
def _cpu():
    prev = pt_device._PLACE
    pt.set_device("cpu")
    yield
    pt_device._PLACE = prev


def N(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x._data if hasattr(x, "_data") else x)


def _pair():
    jp.seed(5)
    jm = _encoder(jp)
    tm = _encoder(pt)
    load_jax_state(tm, state_from_jax_layer(jm))
    return jm, tm


def _ids(seed, batch=4, seq=12):
    return np.random.default_rng(seed).integers(0, CFG["vocab"],
                                                (batch, seq))


def _n_linear(model, cls):
    return sum(isinstance(m, cls) for _, m in model.named_sublayers())


# ---- observers and fake quant ----------------------------------------------

@pytest.mark.parametrize("name", ["AbsmaxObserver",
                                  "MovingAverageAbsmaxObserver",
                                  "PerChannelAbsmaxObserver"])
def test_observers_match_jax(name):
    rng = np.random.default_rng(0)
    jo, to = getattr(JQ, name)(), getattr(TQ, name)()
    for _ in range(4):
        x = (rng.standard_normal((5, 6)) * rng.uniform(0.5, 3)).astype(
            np.float32)
        jo.sample(jp.to_tensor(x))
        to.sample(torch.from_numpy(x))
    np.testing.assert_array_equal(
        np.asarray(N(to.scale()), np.float32).reshape(-1),
        np.asarray(jo.scale(), np.float32).reshape(-1))


def test_fake_quant_values_and_straight_through_gradient():
    x = np.random.default_rng(1).standard_normal((6, 7)).astype(np.float32)
    jx, tx = jp.to_tensor(x), torch.from_numpy(x).requires_grad_(True)
    jx.stop_gradient = False
    jy, ty = JQ.fake_quant(jx, 2.5), TQ.fake_quant(tx, 2.5)
    np.testing.assert_array_equal(N(ty), N(jy))
    (jy * jy).sum().backward()
    (ty * ty).sum().backward()
    np.testing.assert_allclose(N(tx.grad), N(jx.grad), rtol=1e-6)
    np.testing.assert_allclose(N(tx.grad), 2 * N(ty), rtol=1e-6)


@pytest.mark.parametrize("m,k,n", [(5, 12, 3), (33, 64, 40)])
def test_converted_linear_int32_accumulator_equals_jax(m, k, n):
    rng = np.random.default_rng(m)
    x = rng.standard_normal((m, k)).astype(np.float32)
    jl = jp.nn.Linear(k, n)
    tl = pt.nn.Linear(k, n)
    load_jax_state(tl, state_from_jax_layer(jl))
    w_scale = np.abs(N(jl.weight)).max(axis=0)
    jc = JQ.ConvertedLinear(jl, w_scale, 3.0)
    tc = TQ.ConvertedLinear(tl, w_scale, 3.0)
    np.testing.assert_array_equal(N(tc.qweight), N(jc.qweight))
    a_s = np.float32(3.0 / 127)
    aq = np.clip(np.round(x / a_s), -127, 127).astype(np.int8)
    ref = jax.lax.dot_general(aq, N(jc.qweight), (((1,), (0,)), ((), ())),
                              preferred_element_type=np.int32)
    got = TQ.int8_matmul(torch.from_numpy(aq), tc.qweight)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(N(got), np.asarray(ref))
    np.testing.assert_allclose(N(tc(torch.from_numpy(x))),
                               N(jc(jp.to_tensor(x))), rtol=1e-6,
                               atol=1e-6)


def test_int8_matmul_refuses_float_operands():
    with pytest.raises(TypeError, match="int8"):
        TQ.int8_matmul(torch.ones(4, 8), torch.ones(8, 8, dtype=torch.int8))


# ---- QAT and PTQ on the encoder --------------------------------------------

def _logit_close(got, ref, tol=1e-4):
    ref = N(ref)
    assert np.abs(N(got) - ref).max() <= tol * np.abs(ref).max()


def test_qat_encoder_forward_gradients_and_convert():
    jm, tm = _pair()
    JQ.QAT(JQ.QuantConfig()).quantize(jm)
    TQ.QAT(TQ.QuantConfig()).quantize(tm)
    n_q = _n_linear(tm, TQ.QuantedLinear)
    assert n_q == _n_linear(jm, JQ.QuantedLinear) == 6 * CFG["layers"] + 1
    labels, ids = np.array([0, 1, 1, 0]), _ids(1)
    jl = jp.nn.functional.cross_entropy(jm(jp.to_tensor(ids)),
                                        jp.to_tensor(labels))
    tl = pt.nn.functional.cross_entropy(tm(pt.to_tensor(ids)),
                                        pt.to_tensor(labels))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    jl.backward()
    tl.backward()
    jg = {n: N(p.grad) for n, p in jm.named_parameters()}
    tg = {n: N(p.grad) for n, p in tm.named_parameters()}
    assert set(jg) == set(tg)
    top = max(np.abs(g).max() for g in jg.values())
    for name in jg:
        assert np.abs(tg[name] - jg[name]).max() <= 1e-4 * top, name
    jm.eval()
    tm.eval()
    JQ.QAT().convert(jm)
    TQ.QAT().convert(tm)
    jc = [m for _, m in jm.named_sublayers()
          if isinstance(m, JQ.ConvertedLinear)]
    tc = [m for _, m in tm.named_sublayers()
          if isinstance(m, TQ.ConvertedLinear)]
    assert len(tc) == len(jc) == n_q
    for a, b in zip(tc, jc):
        np.testing.assert_array_equal(N(a.qweight), N(b.qweight))
    ids = _ids(3)
    _logit_close(tm(pt.to_tensor(ids)), jm(jp.to_tensor(ids)))


def test_ptq_calibrate_and_convert_encoder():
    jm, tm = _pair()
    jq, tq = JQ.PTQ(), TQ.PTQ()
    jq.quantize(jm)
    tq.quantize(tm)
    assert not tm.training
    for seed in (4, 5, 6):
        ids = _ids(seed)
        _logit_close(tm(pt.to_tensor(ids)), jm(jp.to_tensor(ids)))
    jq.convert(jm)
    tq.convert(tm)
    ids = _ids(7)
    _logit_close(tm(pt.to_tensor(ids)), jm(jp.to_tensor(ids)))


def test_quanted_and_converted_conv2d():
    jp.seed(2)
    jn = jp.nn.Sequential(jp.nn.Conv2D(3, 8, 3, padding=1), jp.nn.ReLU(),
                          jp.nn.Conv2D(8, 4, 3))
    tn = pt.nn.Sequential(pt.nn.Conv2D(3, 8, 3, padding=1), pt.nn.ReLU(),
                          pt.nn.Conv2D(8, 4, 3))
    load_jax_state(tn, state_from_jax_layer(jn))
    jc, tc = JQ.QuantConfig(), TQ.QuantConfig()
    jc.add_type_config(jp.nn.Conv2D)
    tc.add_type_config(pt.nn.Conv2D)
    JQ.PTQ(jc).quantize(jn)
    TQ.PTQ(tc).quantize(tn)
    x = np.random.default_rng(3).standard_normal((2, 3, 8, 8)).astype(
        np.float32)
    _logit_close(tn(pt.to_tensor(x)), jn(jp.to_tensor(x)))
    JQ.PTQ(jc).convert(jn)
    TQ.PTQ(tc).convert(tn)
    assert isinstance(tn[0], TQ.ConvertedConv2D)
    np.testing.assert_array_equal(N(tn[0].qweight), N(jn[0].qweight))
    _logit_close(tn(pt.to_tensor(x)), jn(jp.to_tensor(x)))


def test_config_refuses_what_jax_ignores():
    with pytest.raises(NotImplementedError, match="weight"):
        TQ.QuantConfig(weight=object())


def test_int8_kv_names_are_the_ops_ones():
    from paddle_tpu_torch import ops

    assert TQ.quantize_kv is ops.quantize_kv and TQ.KV_QMAX == 127
