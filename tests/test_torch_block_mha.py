"""The port's incubate functionals against the JAX package's:
``block_multihead_attention`` (paged-KV serving attention), ``gather_paged_
kv`` and ``fused_moe``, on the same numpy inputs.

CPU. On the CPU both packages run their plain versions (the JAX paged and
flash kernels route to their dense fallbacks off the TPU; the port's
wrappers run theirs on CPU tensors). block_multihead_attention: a batch
with a prefill row, decode rows, a multi-token continuation and an idle
row; 4 q / 2 kv heads of 64, pages of 8. fp32 outputs within atol 2e-5
(other summation order); bf16 within 1e-2 (a bf16 step at 1 is 0.0078:
both sides compute in fp32 and round once, so they differ by at most a
step where the fp32 values straddle a rounding boundary); int8 caches
within 2e-5 (int8 math is exact in fp32). The updated caches are compared
byte for byte. fused_moe: fp32 within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.incubate.nn.functional as JIF
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.ops import paged_attention as jpa
import paddle_tpu_torch.incubate.nn.functional as IF
from paddle_tpu_torch.ops import QuantizedKVPool, gather_paged_kv

torch.set_num_threads(1)

NH, KV, HD, PAGE, MAXP = 4, 2, 64, 8, 6
# rows: prefill 20 tokens; decode after 13; 5 new after 9 cached; decode
# after 24; idle (5 cached, no token this time)
ENC = np.array([20, 0, 0, 0, 0])
DEC = np.array([0, 13, 9, 24, 5])
THIS = np.array([20, 1, 5, 1, 0])


def _batch(dtype, quant=False, rope=None, mask=False, seed=0):
    """numpy inputs of one call; ``dtype`` "float32"/"bfloat16" for qkv
    (and the caches unless ``quant``)."""
    rng = np.random.default_rng(seed)
    b = len(ENC)
    npages = b * MAXP
    tok = int(THIS.sum())
    inp = dict(
        qkv=rng.standard_normal((tok, (NH + 2 * KV) * HD)).astype(np.float32),
        tables=rng.permutation(npages).reshape(b, MAXP).astype(np.int32))
    if quant:
        inp["kc"] = rng.integers(-127, 128, (npages, KV, PAGE, HD),
                                 dtype=np.int8)
        inp["vc"] = rng.integers(-127, 128, (npages, KV, PAGE, HD),
                                 dtype=np.int8)
        qs = np.asarray([40.0, 25.0], np.float32)
        inp["scales"] = dict(
            cache_k_quant_scales=qs, cache_v_quant_scales=qs * 1.5,
            cache_k_dequant_scales=1.0 / qs,
            cache_v_dequant_scales=1.0 / (qs * 1.5))
    else:
        inp["kc"] = rng.standard_normal((npages, KV, PAGE, HD)).astype(
            np.float32)
        inp["vc"] = rng.standard_normal((npages, KV, PAGE, HD)).astype(
            np.float32)
    if rope is not None:
        ang = rng.uniform(0, 6.3, (1, MAXP * PAGE, 1, HD // 2))
        inp["rope"] = np.stack([np.cos(ang), np.sin(ang)]).astype(np.float32)
    if mask:
        inp["mask"] = rng.standard_normal(
            (b, NH, 20, MAXP * PAGE)).astype(np.float32)
    inp["dtype"] = dtype
    return inp


def _lens(a):
    return a.astype(np.int32)[:, None]


def _jax_call(inp, neox=False, round_type=1):
    cast = jnp.bfloat16 if inp["dtype"] == "bfloat16" else jnp.float32
    cdt = jnp.int8 if "scales" in inp else cast
    cu = np.concatenate([[0], np.cumsum(THIS)]).astype(np.int32)[:, None]
    kw = dict(
        qkv=Tensor(jnp.asarray(inp["qkv"], cast)),
        key_cache=Tensor(jnp.asarray(inp["kc"], cdt)),
        value_cache=Tensor(jnp.asarray(inp["vc"], cdt)),
        seq_lens_encoder=Tensor(jnp.asarray(_lens(ENC))),
        seq_lens_decoder=Tensor(jnp.asarray(_lens(DEC))),
        seq_lens_this_time=Tensor(jnp.asarray(_lens(THIS))),
        padding_offsets=Tensor(jnp.zeros((int(THIS.sum()),), jnp.int32)),
        cum_offsets=Tensor(jnp.zeros((len(ENC),), jnp.int32)),
        cu_seqlens_q=Tensor(jnp.asarray(cu)),
        cu_seqlens_k=Tensor(jnp.asarray(cu)),
        block_tables=Tensor(jnp.asarray(inp["tables"])),
        block_size=PAGE, use_neox_style=neox, quant_round_type=round_type)
    if "rope" in inp:
        kw["rope_emb"] = Tensor(jnp.asarray(inp["rope"]))
    if "mask" in inp:
        kw["mask"] = Tensor(jnp.asarray(inp["mask"]))
    for name, s in inp.get("scales", {}).items():
        kw[name] = Tensor(jnp.asarray(s))
    out, _, kc, vc = JIF.block_multihead_attention(**kw)
    return (np.asarray(jnp.asarray(out._data, jnp.float32)),
            np.asarray(kc._data.astype(jnp.float32) if cdt != jnp.int8
                       else kc._data), np.asarray(
                vc._data.astype(jnp.float32) if cdt != jnp.int8
                else vc._data))


def _port_args(inp, neox=False, round_type=1):
    dt = torch.bfloat16 if inp["dtype"] == "bfloat16" else torch.float32
    cdt = torch.int8 if "scales" in inp else dt
    cu = torch.from_numpy(np.concatenate([[0], np.cumsum(THIS)]).astype(
        np.int32)[:, None])
    kw = dict(
        qkv=torch.from_numpy(inp["qkv"]).to(dt),
        key_cache=torch.from_numpy(inp["kc"].copy()).to(cdt),
        value_cache=torch.from_numpy(inp["vc"].copy()).to(cdt),
        seq_lens_encoder=torch.from_numpy(_lens(ENC)),
        seq_lens_decoder=torch.from_numpy(_lens(DEC)),
        seq_lens_this_time=torch.from_numpy(_lens(THIS)),
        padding_offsets=torch.zeros(int(THIS.sum()), dtype=torch.int32),
        cum_offsets=torch.zeros(len(ENC), dtype=torch.int32),
        cu_seqlens_q=cu, cu_seqlens_k=cu,
        block_tables=torch.from_numpy(inp["tables"]), block_size=PAGE,
        use_neox_style=neox, quant_round_type=round_type)
    if "rope" in inp:
        kw["rope_emb"] = torch.from_numpy(inp["rope"])
    if "mask" in inp:
        kw["mask"] = torch.from_numpy(inp["mask"])
    for name, s in inp.get("scales", {}).items():
        kw[name] = torch.from_numpy(s)
    return kw


def _port_call(inp, **kw):
    args = _port_args(inp, **kw)
    out, qkv, kc, vc = IF.block_multihead_attention(**args)
    assert kc is args["key_cache"] and vc is args["value_cache"]
    assert qkv is args["qkv"]
    as_np = (lambda t: t.numpy()) if "scales" in inp else \
        (lambda t: t.float().numpy())
    return out.float().numpy(), as_np(kc), as_np(vc)


@pytest.mark.parametrize("dtype,quant,rope,neox,mask", [
    ("float32", False, None, False, False),
    ("float32", False, "rope", True, False),
    ("float32", False, "rope", False, False),
    ("bfloat16", False, "rope", True, False),
    ("float32", True, None, False, False),
    ("bfloat16", True, "rope", False, False),
    ("float32", False, None, False, True),
], ids=["fp32", "fp32-neox", "fp32-interleaved", "bf16-neox", "int8",
        "bf16-int8-interleaved", "fp32-mask"])
def test_block_mha_matches_jax(dtype, quant, rope, neox, mask):
    inp = _batch(dtype, quant, rope, mask)
    ref, rkc, rvc = _jax_call(inp, neox)
    out, kc, vc = _port_call(inp, neox=neox)
    tol = 1e-2 if dtype == "bfloat16" else 2e-5
    assert out.shape == ref.shape == (int(THIS.sum()), NH * HD)
    np.testing.assert_allclose(out, ref, atol=tol)
    # the caches, updated in place, byte for byte
    np.testing.assert_array_equal(kc, rkc)
    np.testing.assert_array_equal(vc, rvc)
    # every new token landed in its row's pages
    assert not np.array_equal(kc, inp["kc"].astype(kc.dtype))


@pytest.mark.parametrize("round_type", [0, 1])
def test_block_mha_int8_rounding_matches_jax(round_type):
    # values at exact halves under the quant scales: the two rounding rules
    # differ there, and the port follows the JAX package in each
    inp = _batch("float32", quant=True, seed=3)
    inp["qkv"] = (np.round(inp["qkv"] * 80) / 80).astype(np.float32)
    _, rkc, rvc = _jax_call(inp, round_type=round_type)
    _, kc, vc = _port_call(inp, round_type=round_type)
    np.testing.assert_array_equal(kc, rkc)
    np.testing.assert_array_equal(vc, rvc)


def test_block_mha_refuses_what_jax_refuses():
    inp = _batch("float32")
    args = _port_args(inp)
    with pytest.raises(NotImplementedError, match="smooth-quant"):
        IF.block_multihead_attention(**args, qkv_out_scale=torch.ones(1))
    with pytest.raises(NotImplementedError, match="dynamic"):
        IF.block_multihead_attention(**args, use_dynamic_cachekv_quant=True)
    with pytest.raises(ValueError, match="all four"):
        IF.block_multihead_attention(**args,
                                     cache_k_quant_scales=torch.ones(KV))
    with pytest.raises(ValueError, match="rope_emb must be"):
        IF.block_multihead_attention(**args,
                                     rope_emb=torch.ones(3, 1, 48, 1, 32))
    with pytest.raises(ValueError, match="covers 8 positions"):
        IF.block_multihead_attention(**args,
                                     rope_emb=torch.ones(2, 1, 8, 1, 32))


@pytest.mark.parametrize("kind", ["float32", "int8", "pool"])
def test_gather_paged_kv_matches_jax(kind):
    rng = np.random.default_rng(4)
    npages, b = 12, 3
    tables = rng.permutation(npages).reshape(b, 4).astype(np.int32)
    tables[1, 2:] = -1                  # unassigned: reads page 0
    if kind == "float32":
        kc, vc = (rng.standard_normal((npages, KV, PAGE, HD)).astype(
            np.float32) for _ in range(2))
        jk, jv, tk, tv = (jnp.asarray(kc), jnp.asarray(vc),
                          torch.from_numpy(kc), torch.from_numpy(vc))
    else:
        kc, vc = (rng.integers(-127, 128, (npages, KV, PAGE, HD),
                               dtype=np.int8) for _ in range(2))
        jk, jv, tk, tv = (jnp.asarray(kc), jnp.asarray(vc),
                          torch.from_numpy(kc), torch.from_numpy(vc))
        if kind == "pool":
            ks, vs = (rng.uniform(0.5, 2, (npages, KV)).astype(np.float32)
                      for _ in range(2))
            jk = jpa.QuantizedKVPool(jk, jnp.asarray(ks))
            jv = jpa.QuantizedKVPool(jv, jnp.asarray(vs))
            tk = QuantizedKVPool(tk, torch.from_numpy(ks))
            tv = QuantizedKVPool(tv, torch.from_numpy(vs))
    rk, rv = jpa.gather_paged_kv(jk, jv, jnp.asarray(tables), 3 * PAGE)
    gk, gv = gather_paged_kv(tk, tv, torch.from_numpy(tables), 3 * PAGE)
    assert gk.shape == (b, 3 * PAGE, KV, HD)
    assert str(gk.dtype).split(".")[-1] == str(rk.dtype)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))


def _moe_inputs(gated, bias, seed):
    rng = np.random.default_rng(seed)
    e, d, ff = 4, 32, 24

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32) * 0.3
    inp = dict(x=r(2, 16, d), gate=r(2, 16, e) * 3,
               w1=r(e, d, 2 * ff if gated else ff), w2=r(e, ff, d))
    if bias:
        inp["b1"] = r(e, 1, 2 * ff if gated else ff)
        inp["b2"] = r(e, d)
    return inp


@pytest.mark.parametrize("gated,bias,cf,norm", [
    (True, False, None, True), (True, True, None, True),
    (False, False, None, True), (False, True, 0.5, True),
    (True, True, 0.5, False), (True, False, 1.25, True)])
def test_fused_moe_matches_jax(gated, bias, cf, norm):
    inp = _moe_inputs(gated, bias, 5 + gated + 2 * bias)
    names = ("x", "gate", "w1", "w2", "b1", "b2")
    j = {n: Tensor(jnp.asarray(inp[n])) if n in inp else None for n in names}
    t = {n: torch.from_numpy(inp[n]) if n in inp else None for n in names}
    ref = JIF.fused_moe(j["x"], j["gate"], j["w1"], j["w2"],
                        ffn1_bias=j["b1"], ffn2_bias=j["b2"], moe_topk=2,
                        norm_topk_prob=norm, capacity_factor=cf)
    out = IF.fused_moe(t["x"], t["gate"], t["w1"], t["w2"],
                       ffn1_bias=t["b1"], ffn2_bias=t["b2"], moe_topk=2,
                       norm_topk_prob=norm, capacity_factor=cf)
    assert out.shape == out.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref._data), atol=1e-5)


def test_fused_moe_refuses_quantization():
    inp = _moe_inputs(True, False, 9)
    t = [torch.from_numpy(inp[n]) for n in ("x", "gate", "w1", "w2")]
    with pytest.raises(NotImplementedError, match="quantization"):
        IF.fused_moe(*t, quant_method="weight_only_int8")
    with pytest.raises(NotImplementedError, match="quantization"):
        IF.fused_moe(*t, ffn1_scale=torch.ones(4))
