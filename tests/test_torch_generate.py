"""Port ``generate()`` (paddle_tpu_torch.models.generation_utils) and the
dense-cache decode hooks against the JAX package's on carried tiny-Llama
weights (fp32, CPU).

Greedy tokens must be exactly JAX's, with the dense cache and with
``cache_impl="paged"``, across a decode-block boundary, with left padding
(``attention_mask``), ``max_length`` and eos (stop, then eos padding);
errors must be JAX's ``ValueError``s. The hooks: ``_decode_chunk`` over a
dense cache (prefill with a left-pad bias, then a token) against JAX's,
logits and caches within 1e-4 (both fp32, other summation orders), and
``causal_cache_bias`` exactly. Sampled draws cannot equal jax.random's
bits; the port's contract is held instead: the same seed gives the same
stream whatever the batching, padding or cache, the serving engine's
stream for the same request; ``top_p`` -> 0 is greedy. The MoE model
generates JAX's tokens too (``pgmm`` in interpret mode at ``TILE_M`` 16,
as tests/test_torch_moe.py runs it, and ``scatter``).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.distributed.models.moe import moe_layer as jml
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import generation_utils as jgu
from paddle_tpu.ops import grouped_matmul as jgm
from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                Request)
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models import generation_utils as tgu
from paddle_tpu_torch.weights import load_jax_state, state_from_jax_layer

torch.set_num_threads(1)

ATOL = 1e-4
tgm = importlib.import_module("paddle_tpu_torch.ops.grouped_matmul")


def _pair(**over):
    paddle.seed(3)
    jm = JaxLlama(JaxConfig.tiny(num_hidden_layers=2, **over))
    tm = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=2, **over),
                          device="cpu")
    load_jax_state(tm, state_from_jax_layer(jm))
    return jm, tm


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _jax_gen(jm, ids, **kw):
    if "attention_mask" in kw:
        kw["attention_mask"] = paddle.to_tensor(kw["attention_mask"])
    return jm.generate(paddle.to_tensor(ids), **kw).numpy()


def _ids(seed, b, n):
    return np.random.default_rng(seed).integers(1, 256, (b, n)).astype(
        np.int32)


@pytest.mark.parametrize("cache_impl", ["dense", "paged"])
def test_greedy_equals_jax(pair, cache_impl):
    """20 new tokens: the prompt chunk, one block of 16, then 3."""
    jm, tm = pair
    ids = _ids(4, 3, 9)
    kw = dict(max_new_tokens=20, temperature=0.0, cache_impl=cache_impl,
              page_size=8)
    got = tm.generate(ids, **kw)
    assert got.dtype == torch.int32 and got.shape == (3, 20)
    np.testing.assert_array_equal(got.numpy(), _jax_gen(jm, ids, **kw))


def test_paged_equals_dense(pair):
    _, tm = pair
    ids = _ids(5, 2, 12)
    dense = tm.generate(ids, max_new_tokens=18, temperature=0.0)
    paged = tm.generate(torch.from_numpy(ids), max_new_tokens=18,
                        temperature=0.0, cache_impl="paged", page_size=4)
    assert torch.equal(dense, paged)


def test_left_padded_batch_equals_jax_and_unpadded(pair):
    """Rows of 9, 7 and 5 real tokens left-padded to 9: equal to JAX's
    padded batch and to each row generated alone."""
    jm, tm = pair
    ids = _ids(6, 3, 9)
    mask = np.array([[1] * 9, [0] * 2 + [1] * 7, [0] * 4 + [1] * 5],
                    np.int32)
    ids[mask == 0] = 0
    kw = dict(max_new_tokens=19, temperature=0.0)
    got = tm.generate(ids, attention_mask=mask, **kw).numpy()
    np.testing.assert_array_equal(got, _jax_gen(jm, ids, attention_mask=mask,
                                                **kw))
    for row in range(3):
        alone = tm.generate(ids[row:row + 1, 9 - mask[row].sum():], **kw)
        np.testing.assert_array_equal(got[row], alone.numpy()[0])


def test_max_length_bucket_with_mask_equals_jax(pair):
    jm, tm = pair
    ids = _ids(7, 2, 5)
    mask = np.array([[1] * 5, [0, 0, 1, 1, 1]], np.int32)
    kw = dict(max_new_tokens=6, temperature=0.0, attention_mask=mask)
    got = tm.generate(ids, max_length=32, **kw).numpy()
    np.testing.assert_array_equal(got, tm.generate(ids, **kw).numpy())
    np.testing.assert_array_equal(got, _jax_gen(jm, ids, max_length=32,
                                                **kw))


@pytest.mark.parametrize("cache_impl", ["dense", "paged"])
def test_eos_stops_and_pads_equal_jax(pair, cache_impl):
    """A batch where one row hits eos mid-block (eos after it), and a lone
    row that finishes early (the output padded with eos after the
    break)."""
    jm, tm = pair
    ids = _ids(8, 3, 6)
    kw = dict(temperature=0.0, cache_impl=cache_impl, page_size=8)
    free = tm.generate(ids, max_new_tokens=24, **kw).numpy()
    eos = int(free[0, 2])
    for batch in (ids, ids[:1]):
        got = tm.generate(batch, max_new_tokens=24, eos_token_id=eos,
                          **kw).numpy()
        want = _jax_gen(jm, batch, max_new_tokens=24, eos_token_id=eos,
                        **kw)
        np.testing.assert_array_equal(got, want)
        assert (got[0, 2:] == eos).all()


@pytest.mark.parametrize("kw,match", [
    (dict(attention_mask=np.array([[1, 1, 1, 0]], np.int32)), "LEFT-padded"),
    (dict(attention_mask=np.array([[1, 0, 1, 1]], np.int32)), "LEFT-padded"),
    (dict(attention_mask=np.ones((1, 4), np.int32), cache_impl="paged"),
     "paged"),
    (dict(max_new_tokens=40, max_length=8), "max_length"),
    (dict(temperature=-1.0), "temperature"),
    (dict(temperature=0.5, top_p=0.0), "top_p"),
    (dict(temperature=0.5, top_p=1.5), "top_p"),
], ids=["right_pad", "hole", "paged_mask", "max_length", "temperature",
        "top_p_zero", "top_p_over"])
def test_errors_equal_jax(pair, kw, match):
    jm, tm = pair
    ids = np.ones((1, 4), np.int32)
    kw = dict(dict(max_new_tokens=2, temperature=0.0), **kw)
    with pytest.raises(ValueError, match=match) as got:
        tm.generate(ids, **kw)
    with pytest.raises(ValueError, match=match) as want:
        _jax_gen(jm, ids, **kw)
    assert str(got.value) == str(want.value)


def test_sampling_contract(pair):
    """The same seed: the same stream alone, in a batch, left-padded, with
    the paged cache, and from the serving engine; another seed another
    stream; top_p -> 0 greedy."""
    _, tm = pair
    ids = _ids(9, 3, 8)
    kw = dict(max_new_tokens=12, temperature=0.9, top_p=0.95, seed=21)
    batch = tm.generate(ids, **kw).numpy()
    alone = tm.generate(ids[1:2], **kw).numpy()[0]
    np.testing.assert_array_equal(batch[1], alone)
    padded = np.concatenate([np.zeros((1, 3), np.int32), ids[1:2]], 1)
    mask = np.concatenate([np.zeros((1, 3), np.int32),
                           np.ones((1, 8), np.int32)], 1)
    both = np.concatenate([padded, np.concatenate([ids[0:1], ids[0:1, :3]],
                                                  1)])
    both_mask = np.concatenate([mask, np.ones((1, 11), np.int32)])
    np.testing.assert_array_equal(
        tm.generate(both, attention_mask=both_mask, **kw).numpy()[0], alone)
    paged = tm.generate(ids[1:2], cache_impl="paged", page_size=8, **kw)
    np.testing.assert_array_equal(paged.numpy()[0], alone)
    eng = ContinuousBatchingEngine(tm, max_batch=2, max_len=32, page_size=8,
                                   block_size=4, device="cpu")
    req = Request(ids[1], max_new_tokens=12, temperature=0.9, top_p=0.95,
                  seed=21)
    eng.add_request(req)
    eng.run_until_done()
    assert req.tokens == alone.tolist()
    other = tm.generate(ids[1:2], **dict(kw, seed=22)).numpy()[0]
    assert not np.array_equal(other, alone)
    greedy = tm.generate(ids, max_new_tokens=12, temperature=0.0)
    tight = tm.generate(ids, max_new_tokens=12, temperature=0.9, top_p=1e-9,
                        seed=21)
    assert torch.equal(greedy, tight)


def test_dense_decode_chunk_matches_jax(pair):
    """The dense hook: a left-padded prefill chunk, then one token per
    row, logits and caches against JAX's."""
    jm, tm = pair
    ids = _ids(10, 2, 6)
    mask = np.array([[1] * 6, [0, 0, 1, 1, 1, 1]], np.int32)
    max_len = 10
    pad = np.concatenate([mask == 0, np.zeros((2, 4), bool)], 1)
    bias = np.where(pad, -1e9, 0.0).astype(np.float32)[:, None, None, :]
    off = (6 - mask.sum(-1)).astype(np.int32)
    jc = jm._init_caches(2, max_len)
    tc = tm._init_caches(2, max_len)
    jlog, jc = jm._decode_chunk(jnp.asarray(ids), jc, 0, jnp.asarray(bias),
                                jnp.asarray(off))
    tlog, tc = tm._decode_chunk(torch.from_numpy(ids), tc, 0,
                                torch.from_numpy(bias), torch.from_numpy(off))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL)
    tok = np.asarray(jlog).argmax(-1).astype(np.int32)[:, None]
    jlog, jc = jm._decode_chunk(jnp.asarray(tok), jc, 6, jnp.asarray(bias),
                                jnp.asarray(off))
    tlog, tc = tm._decode_chunk(torch.from_numpy(tok), tc, 6,
                                torch.from_numpy(bias), torch.from_numpy(off))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL)
    for (jk, jv), (tk, tv) in zip(jc, tc):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)


@pytest.mark.parametrize("pos,s", [(0, 5), (7, 1), (3, 4)])
def test_causal_cache_bias_equals_jax(pos, s):
    pad = np.where(np.arange(12)[None, :] < 2, -1e9, 0.0).astype(
        np.float32)[:, None, None, :]
    for pad_bias in (None, pad):
        want = jgu.causal_cache_bias(
            jnp.zeros((1, 12, 2, 4)), pos, s,
            None if pad_bias is None else jnp.asarray(pad_bias))
        got = tgu.causal_cache_bias(
            torch.zeros(1, 12, 2, 4), pos, s,
            None if pad_bias is None else torch.from_numpy(pad_bias))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture
def moe_interpret(monkeypatch):
    monkeypatch.setattr(jgm, "TILE_M", 16)
    monkeypatch.setattr(tgm, "TILE_M", 16)
    for cls in (jml.SwiGLUExpertFFN, jml.ExpertFFN):
        orig = cls.forward_pgmm

        def fp(self, xp, gids, tile_m=None, interpret=False, _orig=orig):
            return _orig(self, xp, gids, tile_m=tile_m, interpret=True)

        monkeypatch.setattr(cls, "forward_pgmm", fp)


@pytest.mark.parametrize("mode", ["pgmm", "scatter"])
def test_moe_generate_equals_jax(moe_interpret, mode):
    jm, tm = _pair(num_experts=4, moe_dispatch=mode)
    ids = _ids(11, 2, 7)
    for cache_impl in ("dense", "paged"):
        kw = dict(max_new_tokens=18, temperature=0.0, cache_impl=cache_impl,
                  page_size=8)
        np.testing.assert_array_equal(tm.generate(ids, **kw).numpy(),
                                      _jax_gen(jm, ids, **kw))
    assert all(layer.mlp.gate.loss is None for layer in tm.model.layers)
