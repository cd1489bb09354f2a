"""The port's attention functionals (``paddle_tpu_torch.nn.functional``)
against the JAX package's (``paddle_tpu.nn.functional``) on the same numpy
inputs: scaled_dot_product_attention, flash_attention, flashmask_attention
in every encoding it takes, flash_attn_qkvpacked and
flash_attn_varlen_qkvpacked, with the ``use_pallas_attention`` flag both
ways; and which path each call takes (the kernels' wrappers or the dense
composite), counted by spies on the port's module.

CPU, fp32, b 2, s 128, 4 q / 2 kv heads, head_dim 64. On the CPU both
packages run their plain versions (the JAX kernels route to their XLA
fallbacks off the TPU), so outputs agree to atol 2e-5 (fp32, other
summation order). Masks leave every row a visible key. Dropout is checked
for its statistics and its seed determinism only: ``torch.Generator`` and
``jax.random`` give different bits.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.flags as jflags
import paddle_tpu.nn.functional as JF
from paddle_tpu_torch import flags
import paddle_tpu_torch.nn.functional as F

torch.set_num_threads(1)

ATOL = 2e-5
B, S, HQ, HKV, D = 2, 128, 4, 2, 64
fmod = importlib.import_module("paddle_tpu_torch.nn.functional."
                               "flash_attention")


def _qkv(seed, hkv=HKV):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, HQ, D)).astype(np.float32),
            rng.standard_normal((B, S, hkv, D)).astype(np.float32),
            rng.standard_normal((B, S, hkv, D)).astype(np.float32))


def _pt(*arrays):
    return [paddle.to_tensor(a) for a in arrays]


def _th(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.fixture
def spy(monkeypatch):
    """Counts of the calls into the kernels' wrappers (the flash kernel and
    its row-bound mode) and into the dense composite."""
    calls = {"flash": 0, "rowmask": 0, "dense": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(fmod, "_flash", counted("flash", fmod._flash))
    monkeypatch.setattr(fmod, "flash_attention_rowmask",
                        counted("rowmask", fmod.flash_attention_rowmask))
    monkeypatch.setattr(fmod, "_xla_attention",
                        counted("dense", fmod._xla_attention))
    return calls


@pytest.fixture
def flag_off():
    flags.set_flags({"use_pallas_attention": False})
    jflags.set_flags({"use_pallas_attention": False})
    yield
    flags.set_flags({"use_pallas_attention": True})
    jflags.set_flags({"use_pallas_attention": True})


@pytest.mark.parametrize("mask", [None, "bool", "additive"])
@pytest.mark.parametrize("causal", [True, False])
def test_sdpa_matches_jax(spy, mask, causal):
    q, k, v = _qkv(1)
    rng = np.random.default_rng(2)
    m = None
    if mask == "bool":
        m = rng.random((B, 1, S, S)) < 0.7
        m[..., np.arange(S), np.arange(S)] = True     # every row sees a key
    elif mask == "additive":
        m = rng.standard_normal((B, 1, S, S)).astype(np.float32)
    jm = None if m is None else paddle.to_tensor(m)
    ref = JF.scaled_dot_product_attention(*_pt(q, k, v), attn_mask=jm,
                                          is_causal=causal).numpy()
    tm = None if m is None else torch.from_numpy(m)
    out = F.scaled_dot_product_attention(*_th(q, k, v), attn_mask=tm,
                                         is_causal=causal)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)
    assert spy == ({"flash": 1, "rowmask": 0, "dense": 0} if m is None
                   else {"flash": 0, "rowmask": 0, "dense": 1})


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_jax_both_flag_ways(spy, causal):
    q, k, v = _qkv(3)
    out, sm = F.flash_attention(*_th(q, k, v), causal=causal)
    ref, jsm = JF.flash_attention(*_pt(q, k, v), causal=causal)
    assert sm is None and jsm is None
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL)
    assert spy == {"flash": 1, "rowmask": 0, "dense": 0}
    flags.set_flags({"FLAGS_use_pallas_attention": "0"})
    jflags.set_flags({"use_pallas_attention": False})
    try:
        assert flags.get_flag("use_pallas_attention") is False
        out2, _ = F.flash_attention(*_th(q, k, v), causal=causal)
        ref2, _ = JF.flash_attention(*_pt(q, k, v), causal=causal)
    finally:
        flags.set_flags({"use_pallas_attention": True})
        jflags.set_flags({"use_pallas_attention": True})
    np.testing.assert_allclose(out2.numpy(), ref2.numpy(), atol=ATOL)
    np.testing.assert_allclose(out2.numpy(), out.numpy(), atol=ATOL)
    assert spy == {"flash": 1, "rowmask": 0, "dense": 1}


def test_flag_off_routes_every_call_to_the_dense_path(spy, flag_off):
    q, k, v = _qkv(4)
    out = F.scaled_dot_product_attention(*_th(q, k, v), is_causal=True)
    ref = JF.scaled_dot_product_attention(*_pt(q, k, v), is_causal=True)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL)
    assert spy == {"flash": 0, "rowmask": 0, "dense": 1}
    with pytest.raises(KeyError, match="unknown flag"):
        flags.get_flag("eager_delete_tensor_gb")


def _indices(kind, hm, seed):
    """startend_row_indices [B, hm, S, n] for each encoding, each leaving
    every row its diagonal: LTS[c] in (c, c + 32], LTE = LTS + 16; UTS =
    max(c - 40, 0), UTE = c (the non-causal bands end at the diagonal)."""
    rng = np.random.default_rng(seed)
    c = np.arange(S)
    lts = c + 1 + rng.integers(0, 32, (B, hm, S))
    lte = lts + 16
    uts = np.broadcast_to(np.maximum(c - 40, 0), lts.shape)
    ute = np.broadcast_to(c, lts.shape)
    cols = {"c1": [lts], "c2": [lts, lte], "c4": [lts, lte, uts, ute],
            "n2": [lts, ute], "n4": [lts, lte, uts, ute]}[kind]
    return np.stack(cols, -1).astype(np.int32)


@pytest.mark.parametrize("kind,causal,hm,path", [
    ("c1", True, 1, "rowmask"), ("c1", True, HKV, "rowmask"),
    ("c2", True, 1, "rowmask"), ("c2", True, HKV, "rowmask"),
    ("c4", True, 1, "dense"), ("n2", False, 1, "dense"),
    ("n4", False, 1, "dense"), (None, True, 1, "flash"),
    (None, False, 1, "flash")])
def test_flashmask_encodings_match_jax_and_route(spy, kind, causal, hm, path):
    q, k, v = _qkv(5)
    idx = None if kind is None else _indices(kind, hm, 6)
    ref = JF.flashmask_attention(
        *_pt(q, k, v), None if idx is None else paddle.to_tensor(idx),
        causal=causal).numpy()
    out = F.flashmask_attention(
        *_th(q, k, v), None if idx is None else torch.from_numpy(idx),
        causal=causal)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)
    want = {"flash": 0, "rowmask": 0, "dense": 0}
    want[path] = 1
    assert spy == want


def test_flashmask_refuses_a_non_causal_single_index(spy):
    q, k, v = _th(*_qkv(7))
    with pytest.raises(ValueError, match="2 or 4 indices"):
        F.flashmask_attention(q, k, v, torch.zeros(B, 1, S, 1,
                                                   dtype=torch.int32))


def test_flashmask_gradients_through_the_row_bound_path():
    # the kernel path is differentiable: gradients equal autograd through
    # the plain flashmask attention
    q, k, v = _qkv(8)
    idx = torch.from_numpy(_indices("c2", HKV, 9))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = F.flashmask_attention(tq, tk, tv, idx, causal=True)
    grads = torch.autograd.grad(out.square().sum(), (tq, tk, tv))
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    rq, rk, rv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    ref = fa.flash_attention_rowmask_reference(rq, rk, rv, idx[..., 0],
                                               idx[..., 1], True)
    want = torch.autograd.grad(ref.square().sum(), (rq, rk, rv))
    for a, b in zip(grads, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attn_qkvpacked_matches_jax(spy, causal):
    rng = np.random.default_rng(10)
    qkv = rng.standard_normal((B, S, 3, HQ, D)).astype(np.float32)
    out, sm = F.flash_attn_qkvpacked(torch.from_numpy(qkv), causal=causal)
    ref, _ = JF.flash_attn_qkvpacked(paddle.to_tensor(qkv), causal=causal)
    assert sm is None
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL)
    assert spy["flash"] == 1


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attn_varlen_qkvpacked_matches_jax(causal):
    rng = np.random.default_rng(11)
    lens = [100, 28, 128]
    total = sum(lens)
    qkv = rng.standard_normal((total, 3, HQ, D)).astype(np.float32)
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    ref, _ = JF.flash_attn_varlen_qkvpacked(
        paddle.to_tensor(qkv), paddle.to_tensor(cu), paddle.to_tensor(cu),
        max(lens), max(lens), causal=causal)
    out, sm = F.flash_attn_varlen_qkvpacked(
        torch.from_numpy(qkv), torch.from_numpy(cu), torch.from_numpy(cu),
        max(lens), max(lens), causal=causal)
    assert sm is None and out.shape == (total, HQ, D)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL)
    # each sequence alone: the packed call attends within it only
    s0, s1 = cu[1], cu[2]
    alone, _ = F.flash_attn_qkvpacked(torch.from_numpy(qkv[None, s0:s1]),
                                      causal=causal)
    np.testing.assert_allclose(out.numpy()[s0:s1], alone.numpy()[0],
                               atol=ATOL)


def test_dropout_is_seeded_and_unbiased(spy):
    q, k, v = _th(*_qkv(12))
    ones = torch.ones_like(v)

    def run(seed, value=v, p=0.25):
        g = torch.Generator().manual_seed(seed)
        return F.scaled_dot_product_attention(q, k, value, dropout_p=p,
                                              is_causal=True, generator=g)

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert spy["dense"] == 3 and spy["flash"] == 0
    # with v = 1 every output is the sum of a row's kept probabilities over
    # the keep rate: 1 on average over the 1024 (row, head) pairs
    mean = run(2, ones).mean().item()
    assert abs(mean - 1.0) < 0.02
    # not training: no dropout, the kernel path
    out = F.scaled_dot_product_attention(q, k, v, dropout_p=0.5,
                                         is_causal=True, training=False)
    ref = JF.scaled_dot_product_attention(
        *[paddle.to_tensor(x.numpy()) for x in (q, k, v)], dropout_p=0.5,
        is_causal=True, training=False)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL)
    assert jnp.asarray(ref.numpy()).shape == (B, S, HQ, D)
