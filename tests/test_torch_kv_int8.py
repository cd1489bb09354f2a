"""Port int8 paged-KV block format (paddle_tpu_torch) against the JAX
package, case by case after tests/test_kv_int8.py.

Ops: ``quantize_kv``, ``append_paged_kv`` (scale growth, requantization,
duplicate page indices, pages not written byte-stable) and ``copy_pages``
give the JAX functions' int8 bytes and fp32 scales exactly, on the same
inputs (fp32). The port requantizes only the pages an append writes, the
JAX package the whole pool: the bytes are the same because the ratio is
exactly 1.0 on every other page. Decode, prefill and verify attention on
int8 pools agree with the JAX functions within 1e-5 (both dequantize in
fp32; only the summation order differs).

Engines (tiny Llama, 1 layer, fp32, CPU, carried weights): int8 and
spec+int8 greedy streams equal the JAX engine's; after the same wave the
two packages' pools differ by at most one quantization step (the k/v
values they quantize agree to ~1e-6, so a value on a rounding boundary may
land on either side; the count is printed); identical spec+int8 engines
give identical bytes; warm == cold with copy-on-write, greedy and seeded.

Left out until the port has them (ROADMAP Queue 1 item 8): the migration
(chain export/import) case and the metrics family.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import serving as jserving
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                KVCacheConfig,
                                                PrefixCacheConfig, Request,
                                                SpecConfig)
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.weights import load_jax_state, state_from_jax_layer

torch.set_num_threads(1)

ATOL = 1e-5


def _pools(P=4, h=2, page=8, d=4):
    """A zeroed (JAX, port) pool side."""
    return (jpa.QuantizedKVPool(jnp.zeros((P, h, page, d), jnp.int8),
                                jnp.zeros((P, h), jnp.float32)),
            tpa.QuantizedKVPool(torch.zeros((P, h, page, d),
                                            dtype=torch.int8),
                                torch.zeros((P, h))))


def _assert_pool_equal(tpool, jpool):
    np.testing.assert_array_equal(tpool.data.numpy(), np.asarray(jpool.data))
    np.testing.assert_array_equal(tpool.scale.numpy(),
                                  np.asarray(jpool.scale))


def _append(jk, jv, tk, tv, kn, vn, tables, positions, seq_ids=None):
    args = [kn, vn, tables, positions] + ([] if seq_ids is None
                                          else [seq_ids])
    jk, jv = jpa.append_paged_kv(jk, jv, *(jnp.asarray(a) for a in args))
    out = tpa.append_paged_kv(tk, tv, *(torch.from_numpy(a) for a in args))
    assert out[0] is tk and out[1] is tv        # in place
    return jk, jv


# ---------------------------------------------------------------------------
# the block format's arithmetic against JAX
# ---------------------------------------------------------------------------

def test_quantize_dequantize_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 3.0, (16, 4)).astype(np.float32)
    x[0, :2] = [0.5, -0.5]                      # halves: round to even
    scale = np.abs(x).max(axis=-1, keepdims=True)
    scale[1] = 0.0                              # a zero-scale block
    q = tpa.quantize_kv(torch.from_numpy(x), torch.from_numpy(scale))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(
        jpa.quantize_kv(jnp.asarray(x), jnp.asarray(scale))))
    back = tpa.dequantize_kv(q, torch.from_numpy(scale)).numpy()
    np.testing.assert_array_equal(back, np.asarray(
        jpa.dequantize_kv(jnp.asarray(q.numpy()), jnp.asarray(scale))))
    ok = scale[:, 0] > 0
    assert np.all(np.abs(back - x)[ok] <= (scale / (2 * tpa.KV_QMAX))[ok]
                  + 1e-7)
    np.testing.assert_array_equal(
        tpa.kv_absmax(torch.from_numpy(x[:, None, :])).numpy(),
        np.asarray(jpa.kv_absmax(jnp.asarray(x[:, None, :]))))


def test_append_quantizes_and_requants_on_scale_growth_like_jax():
    (jk, tk), (jv, tv) = _pools(), _pools()
    tables = np.array([[0, 1], [2, 3]], np.int32)
    rng = np.random.default_rng(1)
    small = rng.normal(0, 0.5, (2, 2, 4)).astype(np.float32)
    jk, jv = _append(jk, jv, tk, tv, small, small, tables,
                     np.array([0, 0], np.int32))
    _assert_pool_equal(tk, jk)
    assert not tk.scale.numpy()[[1, 3]].any()   # untouched blocks stay 0
    big = (10.0 * small).astype(np.float32)     # the scales grow 10x
    jk, jv = _append(jk, jv, tk, tv, big, big, tables,
                     np.array([1, 1], np.int32))
    _assert_pool_equal(tk, jk)
    _assert_pool_equal(tv, jv)


def test_pages_not_written_are_byte_stable():
    """An append that does not grow a block's scale leaves its stored bytes
    as they were, and every other page's bytes untouched."""
    (jk, tk), (jv, tv) = _pools(), _pools()
    tables = np.array([[0, 1]], np.int32)
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1.0, (1, 2, 4)).astype(np.float32)
    jk, jv = _append(jk, jv, tk, tv, x, x, tables, np.array([0], np.int32))
    before = tk.data.clone()
    y = (0.1 * x).astype(np.float32)
    jk, jv = _append(jk, jv, tk, tv, y, y, tables, np.array([1], np.int32))
    _assert_pool_equal(tk, jk)
    assert torch.equal(before[0, :, 0], tk.data[0, :, 0])
    assert torch.equal(before[1:], tk.data[1:])


@pytest.mark.parametrize("seed", range(4))
def test_append_chunks_with_duplicate_pages_match_jax(seed):
    """Twelve appends of seeded chunks at random positions of two rows:
    several tokens of a chunk land in one page (the scatter-max and the
    requantization see duplicate page indices), scales grow and shrink
    across appends. Bytes and scales equal JAX's after every append."""
    rng = np.random.default_rng(seed)
    P, h, page, d = 6, 2, 4, 8
    (jk, tk), (jv, tv) = _pools(P, h, page, d), _pools(P, h, page, d)
    tables = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    for _ in range(12):
        n = int(rng.integers(1, 6))
        seq = rng.integers(0, 2, n).astype(np.int32)
        pos = rng.integers(0, 3 * page, n).astype(np.int32)
        kn = (rng.normal(0, 1, (n, h, d))
              * rng.uniform(0.1, 5)).astype(np.float32)
        vn = rng.normal(0, 2, (n, h, d)).astype(np.float32)
        # one writer per (row, position): duplicate positions in one
        # scatter keep an unspecified writer in both packages
        _, first = np.unique(seq * 100 + pos, return_index=True)
        seq, pos, kn, vn = seq[first], pos[first], kn[first], vn[first]
        jk, jv = _append(jk, jv, tk, tv, kn, vn, tables, pos, seq)
        _assert_pool_equal(tk, jk)
        _assert_pool_equal(tv, jv)


def test_cow_copy_pages_carries_scales_like_jax():
    (jk, tk), (jv, tv) = _pools(), _pools()
    tables = np.array([[0, 1]], np.int32)
    x = np.random.default_rng(4).normal(0, 2.0, (1, 2, 4)).astype(np.float32)
    jk, jv = _append(jk, jv, tk, tv, x, x, tables, np.array([3], np.int32))
    for src, dst in ((0, 2), ([0, 1, 3, 3], [2, 3, 3, 3])):
        jk, jv = jpa.copy_pages(jk, jv, jnp.asarray(src), jnp.asarray(dst))
        out = tpa.copy_pages(tk, tv, src, dst)
        assert out[0] is tk and out[1] is tv
        _assert_pool_equal(tk, jk)
        _assert_pool_equal(tv, jv)
    assert tk.scale[2].any()                    # a real scale traveled


def test_raw_int8_tensor_pool_is_refused():
    pool = torch.zeros(4, 2, 8, 16, dtype=torch.int8)
    with pytest.raises(TypeError, match="QuantizedKVPool"):
        tpa.paged_decode_attention(torch.zeros(1, 2, 16), pool, pool,
                                   torch.zeros(1, 2, dtype=torch.int32),
                                   torch.ones(1, dtype=torch.int32))
    q8 = tpa.QuantizedKVPool(pool, torch.zeros(4, 2))
    with pytest.raises(TypeError, match="both"):
        tpa.paged_decode_attention(torch.zeros(1, 2, 16), q8, pool,
                                   torch.zeros(1, 2, dtype=torch.int32),
                                   torch.ones(1, dtype=torch.int32))


def _filled(rng, P=8, h=2, page=4, d=16, rows=2, n_pos=12):
    """Both packages' int8 pools filled through the same appends, and the
    tables."""
    (jk, tk), (jv, tv) = _pools(P, h, page, d), _pools(P, h, page, d)
    tables = rng.permutation(P)[: rows * (P // rows)].reshape(
        rows, P // rows).astype(np.int32)
    for pos in range(n_pos):
        kn = rng.normal(0, 1.0, (rows, h, d)).astype(np.float32)
        vn = rng.normal(0, 1.0, (rows, h, d)).astype(np.float32)
        jk, jv = _append(jk, jv, tk, tv, kn, vn, tables,
                         np.full(rows, pos, np.int32))
    return (jk, jv), (tk, tv), tables


@pytest.mark.parametrize("hq,h", [(2, 2), (4, 2), (8, 1)])
def test_attention_reads_on_int8_pools_match_jax(hq, h):
    """Decode (lengths 0, partial and full), prefill and verify attention
    on int8 pools within 1e-5 of the JAX functions; verify is the prefill
    body."""
    rng = np.random.default_rng(3 + hq)
    d = 16
    (jk, jv), (tk, tv), tables = _filled(rng, h=h, d=d, n_pos=13)
    ctx = np.array([13, 0], np.int32)
    q1 = rng.normal(0, 1.0, (2, hq, d)).astype(np.float32)
    want = np.asarray(jpa.paged_decode_attention(
        jnp.asarray(q1), jk, jv, jnp.asarray(tables), jnp.asarray(ctx)))
    got = tpa.paged_decode_attention(torch.from_numpy(q1), tk, tv,
                                     torch.from_numpy(tables),
                                     torch.from_numpy(ctx))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert not got[1].any()                     # a zero-length row
    qs = rng.normal(0, 1.0, (2, 3, hq, d)).astype(np.float32)
    starts = np.array([4, 9], np.int32)
    for jfn, tfn in ((jpa.paged_prefill_attention,
                      tpa.paged_prefill_attention),
                     (jpa.paged_verify_attention,
                      tpa.paged_verify_attention)):
        want = np.asarray(jfn(jnp.asarray(qs), jk, jv, jnp.asarray(tables),
                              jnp.asarray(starts)))
        got = tfn(torch.from_numpy(qs), tk, tv, torch.from_numpy(tables),
                  torch.from_numpy(starts))
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert torch.equal(
        tpa.paged_verify_attention(torch.from_numpy(qs), tk, tv,
                                   torch.from_numpy(tables),
                                   torch.from_numpy(starts)),
        tpa.paged_prefill_attention(torch.from_numpy(qs), tk, tv,
                                    torch.from_numpy(tables),
                                    torch.from_numpy(starts)))


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    paddle.seed(11)
    jm = JaxLlama(JaxConfig.tiny(num_hidden_layers=1))
    tm = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1),
                          device="cpu")
    load_jax_state(tm, state_from_jax_layer(jm))
    return jm, tm


def test_engine_int8_init_and_gauge(pair):
    _, tm = pair
    for kv_cache in ("int8", KVCacheConfig(dtype="int8")):
        eng = ContinuousBatchingEngine(tm, max_batch=2, max_len=32,
                                       page_size=8, fused=True,
                                       kv_cache=kv_cache, device="cpu")
        k0 = eng.caches["kv"][0][0]
        assert isinstance(k0, tpa.QuantizedKVPool)
        assert k0.dtype == torch.int8 and k0.scale.dtype == torch.float32
        assert tuple(k0.scale.shape) == tuple(k0.shape[:2])
        assert eng._kv_quant_blocks == k0.shape[0]
    fp = ContinuousBatchingEngine(tm, max_batch=2, max_len=32, page_size=8,
                                  device="cpu")
    assert fp._kv_quant_blocks == 0


def _requests(seed=41, sampled=False):
    rng = np.random.default_rng(seed)
    kws = []
    for i in range(4):
        kw = dict(prompt_ids=rng.integers(0, 256, (8 + 3 * i,)).astype(
            np.int32), max_new_tokens=8, seed=700 + i)
        if sampled and i % 2 == 1:
            kw.update(temperature=0.9)
        kws.append(kw)
    return kws


def _run(eng, request_cls, kws, max_steps=500):
    reqs = [request_cls(**kw) for kw in kws]
    for r in reqs:
        eng.add_request(r)
    eng.run_until_done(max_steps=max_steps)
    return [list(r.tokens) for r in reqs]


_INT8 = dict(max_batch=2, max_len=32, page_size=8, block_size=2,
             kv_cache="int8")


@pytest.mark.parametrize("fused,prefix,spec", [
    (False, False, False), (True, False, False), (True, True, False),
    (True, True, True)], ids=["legacy", "fused", "fused_prefix",
                              "spec_prefix"])
def test_int8_streams_equal_jax_engine(pair, fused, prefix, spec):
    """Greedy streams of int8 engines (legacy and fused, with and without
    the prefix cache, with speculative decoding) equal the JAX engine's;
    the pools after the wave differ by at most one quantization step, and
    scales agree to fp32 rounding."""
    jm, tm = pair
    kws = _requests()
    jkw, tkw = dict(_INT8, fused=fused), dict(_INT8, fused=fused)
    if prefix:
        jkw["prefix_cache"] = jserving.PrefixCacheConfig(extra_blocks=4)
        tkw["prefix_cache"] = PrefixCacheConfig(extra_blocks=4)
    if spec:
        jkw["speculative"] = jserving.SpecConfig(k=4)
        tkw["speculative"] = SpecConfig(k=4)
    jeng = jserving.ContinuousBatchingEngine(jm, **jkw)
    teng = ContinuousBatchingEngine(tm, device="cpu", **tkw)
    want = _run(jeng, jserving.Request, kws)
    got = _run(teng, Request, kws)
    assert got == want
    if spec:
        assert teng.stats["spec_steps"] == jeng.stats["spec_steps"] > 0
    n_diff, n_all = 0, 0
    for (jk, jv), (tk, tv) in zip(jeng.caches["kv"], teng.caches["kv"]):
        for jp, tp in ((jk, tk), (jv, tv)):
            diff = np.abs(tp.data.numpy().astype(np.int32)
                          - np.asarray(jp.data).astype(np.int32))
            assert diff.max() <= 1
            n_diff += int((diff != 0).sum())
            n_all += diff.size
            np.testing.assert_allclose(tp.scale.numpy(),
                                       np.asarray(jp.scale), rtol=1e-5,
                                       atol=1e-6)
    print(f"int8 pools: {n_diff} of {n_all} bytes differ from JAX's by one "
          "quantization step")


def test_spec_int8_engines_are_deterministic_and_warm_equals_cold(pair):
    """Two identical spec+int8 engines give identical streams and pool
    bytes; a warm re-serve (full-prompt hits, copy-on-write) equals the
    cold one, greedy and seeded."""
    _, tm = pair

    def build():
        return ContinuousBatchingEngine(
            tm, device="cpu", fused=True, speculative=SpecConfig(k=3),
            prefix_cache=PrefixCacheConfig(extra_blocks=4), **_INT8)

    kws = _requests(seed=43)
    a, b = build(), build()
    sa = _run(a, Request, kws)
    assert sa == _run(b, Request, kws)
    for (ak, av), (bk, bv) in zip(a.caches["kv"], b.caches["kv"]):
        for x, y in ((ak, bk), (av, bv)):
            assert torch.equal(x.data, y.data)
            assert torch.equal(x.scale, y.scale)
    assert a.stats["spec_steps"] > 0
    assert _run(a, Request, kws) == sa
    assert a.stats["hit_tokens"] > 0
    mixed = _requests(seed=44, sampled=True)
    cold = _run(a, Request, mixed)
    assert _run(a, Request, mixed) == cold
    assert a.stats["cow_copies"] > 0


@pytest.mark.parametrize("fused", [False, True], ids=["legacy", "fused"])
def test_int8_warm_equals_cold_with_recycled_blocks(pair, fused):
    """Pages that held another request come back cleared of its scales:
    a request served after a wave that recycled every page emits what it
    emits on a fresh engine (legacy engines: static slot pages, reset at
    admission)."""
    _, tm = pair
    kw = dict(_INT8, fused=fused, prefix_cache=PrefixCacheConfig())
    first = _requests(seed=45)
    probe = _requests(seed=46)[:2]
    fresh = _run(ContinuousBatchingEngine(tm, device="cpu", **kw), Request,
                 probe)
    eng = ContinuousBatchingEngine(tm, device="cpu", **kw)
    _run(eng, Request, first)
    eng._radix.evict_lru(eng._alloc.num_blocks)  # every page recycled
    assert _run(eng, Request, probe) == fresh
    static = dict(_INT8, fused=fused)
    eng = ContinuousBatchingEngine(tm, device="cpu", **static)
    _run(eng, Request, first)
    assert _run(eng, Request, probe) == _run(
        ContinuousBatchingEngine(tm, device="cpu", **static), Request, probe)
