"""Port prefix-cache serving (paddle_tpu_torch) against the JAX package.

Ops: ``BlockAllocator`` and ``RadixPrefixCache`` against the JAX classes on
the same operation sequences (every return value and the final state
equal); ``paged_prefill_attention`` and ``copy_pages`` against the JAX
functions on random pools (fp32, atol 2e-5: both sides compute in fp32,
only the summation order differs; copies exactly); the Llama
``paged_prefill_chunk`` hook against JAX's (pools and the following token
step's logits, atol 1e-4 as in tests/test_torch_llama.py).

Streams: the port's ``ContinuousBatchingEngine(prefix_cache=...)``, with and
without the fused step, emits exactly the JAX engine's greedy streams on
carried tiny-Llama weights (fp32, CPU). The rest pins the JAX engine's
contracts inside the port, byte for byte: warm == cold (greedy and
seeded), across a copy-on-write divergence, fused == legacy (greedy and
seeded, 8 and 128 slots), chunked prefill interleaved with decode,
deadline eviction that decrefs but never frees shared blocks (also
mid-prefill), pool exhaustion that defers and recovers, the occupancy
counters, and no graph recapture across admission churn.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.inference.serving import PrefixCacheConfig as JaxPrefix
from paddle_tpu.inference.serving import Request as JaxRequest
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                PrefixCacheConfig, Request)
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.weights import load_jax_state, state_from_jax_layer

torch.set_num_threads(1)

ATOL = 2e-5
MODEL_ATOL = 1e-4
# the JAX fused tests' engines (tests/test_serving_fused.py)
SMALL = dict(max_len=64, page_size=8, block_size=4)
CHUNKED = dict(prefill_chunk=16, extra_blocks=8)


@pytest.fixture(scope="module")
def pair():
    paddle.seed(11)
    jm = JaxLlama(JaxConfig.tiny(num_hidden_layers=1))
    tm = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1),
                          device="cpu")
    load_jax_state(tm, state_from_jax_layer(jm))
    return jm, tm


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n,)).astype(np.int32)


def _engine(tm, fused, prefix=True, max_batch=None, **kw):
    """Port engine: fused engines take 8 slots, legacy ones 2 (the JAX
    fused tests' pair)."""
    kw = {**SMALL, **kw}
    if prefix:
        kw.setdefault("prefix_cache", PrefixCacheConfig(**CHUNKED))
    return ContinuousBatchingEngine(
        tm, max_batch=max_batch or (8 if fused else 2), fused=fused,
        device="cpu", **kw)


def _serve(eng, request_cls, prompts, kws, stagger=True):
    """Three requests, two steps, then the rest; returns the streams."""
    reqs = [request_cls(p, **k) for p, k in zip(prompts, kws)]
    head, tail = (reqs[:3], reqs[3:]) if stagger else (reqs, [])
    for r in head:
        eng.add_request(r)
    if tail:
        eng.step()
        eng.step()
        for r in tail:
            eng.add_request(r)
    eng.run_until_done(max_steps=500)
    return [list(r.tokens) for r in reqs]


def _wave(sampled=True):
    """tests/test_serving_fused.py's wave: prompt 16 fills two pages, so a
    warm re-serve takes the full-prompt-hit COW path; prompt 40 is longer
    than the chunk (16), so packed prefill carries several chunks of it in
    one call; two rows share a 16-token system prompt."""
    sys_p = _prompt(16, 299)
    prompts = [_prompt(n, 300 + n) for n in (5, 16, 9, 16, 40, 3)]
    prompts.append(np.concatenate([sys_p, _prompt(5, 310)]))
    prompts.append(np.concatenate([sys_p, _prompt(7, 311)]))
    kws = [dict(max_new_tokens=6), dict(max_new_tokens=4),
           dict(max_new_tokens=8, temperature=0.8, seed=7, top_k=5),
           dict(max_new_tokens=4, temperature=1.1, seed=3, top_p=0.9),
           dict(max_new_tokens=6), dict(max_new_tokens=8),
           dict(max_new_tokens=5), dict(max_new_tokens=7)]
    if not sampled:
        kws = [dict(max_new_tokens=k["max_new_tokens"]) for k in kws]
    return prompts, kws


# ---------------------------------------------------------------------------
# host-side bookkeeping against the JAX classes
# ---------------------------------------------------------------------------

def _run_ops(mod, seed, n_blocks=12, page=4):
    """A seeded random sequence of allocator and radix-cache operations;
    returns every operation's result (or the error it raised) and the final
    state."""
    rng = np.random.default_rng(seed)
    alloc = mod.BlockAllocator(n_blocks)
    radix = mod.RadixPrefixCache(page, alloc)
    live: list = []
    log = []
    vocab = 3                       # few distinct chunks: shared prefixes
    for _ in range(200):
        op = rng.integers(0, 7)
        try:
            if op == 0:
                got = alloc.alloc(int(rng.integers(1, 5)),
                                  evict=radix.evict_lru)
                if got:
                    live.append(list(got))
                log.append(("alloc", got))
            elif op == 1 and live:
                blocks = live.pop(int(rng.integers(0, len(live))))
                alloc.decref(blocks)
                log.append(("decref", blocks))
            elif op == 2 and live:
                blocks = live[int(rng.integers(0, len(live)))]
                toks = rng.integers(0, vocab, (len(blocks) * page,))
                log.append(("insert", radix.insert(toks, blocks)))
            elif op == 3:
                toks = rng.integers(0, vocab, (int(rng.integers(1, 4)) * page,))
                got = radix.match(toks)
                alloc.incref(got)
                live.append(list(got))
                log.append(("match", got))
            elif op == 4:
                log.append(("evict", radix.evict_lru(int(rng.integers(1, 4)))))
            elif op == 5:
                log.append(("hold", alloc.hold(int(rng.integers(0, 3)))))
            else:
                log.append(("release", alloc.release_held()))
        except RuntimeError as e:
            log.append(("error", str(e)))
    state = (sorted(alloc._free), sorted(alloc._ref.items()),
             sorted(radix._by_block), radix.hits, radix.misses,
             radix.evictions, alloc.free_blocks, len(radix))
    return log, state


@pytest.mark.parametrize("seed", range(4))
def test_allocator_and_radix_match_jax(seed):
    assert _run_ops(tpa, seed) == _run_ops(jpa, seed)


def test_allocator_refcount_cycle_and_double_free():
    a = tpa.BlockAllocator(4)
    got = a.alloc(3)
    a.incref([got[0]])
    a.decref([got[0]])
    assert a.refcount(got[0]) == 1
    a.decref(got)
    assert a.free_blocks == 4
    with pytest.raises(RuntimeError, match="double free"):
        a.decref([got[0]])
    assert a.hold(3) == 3 and a.alloc(2) is None
    assert a.release_held() == 3 and a.alloc(2) is not None


def test_radix_evicts_leaves_first_and_keeps_live_blocks():
    a = tpa.BlockAllocator(8)
    rx = tpa.RadixPrefixCache(4, a)
    toks = np.arange(8, dtype=np.int32)
    blocks = a.alloc(2)
    assert rx.insert(toks, blocks) == blocks
    assert rx.insert(toks, a.alloc(2)) == []      # first writer wins
    a.decref([blocks[1]])
    assert rx.evict_lru(2) == 1                   # only the idle leaf
    assert not rx.has_block(blocks[1]) and rx.has_block(blocks[0])
    with pytest.raises(RuntimeError, match="free block"):
        a.incref([blocks[1]])


# ---------------------------------------------------------------------------
# paged ops against JAX
# ---------------------------------------------------------------------------

def _pools(rng, n_pages, hkv, page, d):
    return (rng.standard_normal((n_pages, hkv, page, d)).astype(np.float32),
            rng.standard_normal((n_pages, hkv, page, d)).astype(np.float32))


@pytest.mark.parametrize("hq,hkv,d,s", [(4, 4, 16, 8), (4, 2, 16, 5),
                                        (8, 1, 32, 16)])
def test_paged_prefill_attention_matches_jax(hq, hkv, d, s):
    rng = np.random.default_rng(hq * 100 + hkv * 10 + s)
    page, maxp, b = 4, 6, 3
    kc, vc = _pools(rng, 24, hkv, page, d)
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    tables = rng.permutation(24)[: b * maxp].reshape(b, maxp).astype(np.int32)
    tables[2, 4:] = -1                     # unassigned entries read page 0
    starts = np.asarray([0, 7, 3], np.int32)
    ref = np.asarray(jpa.paged_prefill_attention(
        *(jnp.asarray(a) for a in (q, kc, vc, tables, starts))))
    out = tpa.paged_prefill_attention(
        *(torch.from_numpy(a) for a in (q, kc, vc, tables, starts)))
    assert out.shape == (b, s, hq, d)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("src,dst", [(3, 7), ([1, 2, 9, 9], [5, 6, 9, 9])],
                         ids=["scalar", "vector"])
def test_copy_pages_matches_jax_exactly(src, dst):
    kc, vc = _pools(np.random.default_rng(5), 12, 2, 4, 8)
    jk, jv = jpa.copy_pages(jnp.asarray(kc), jnp.asarray(vc),
                            jnp.asarray(src), jnp.asarray(dst))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    ok, ov = tpa.copy_pages(tk, tv, src, dst)
    assert ok is tk and ov is tv                  # in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_append_with_seq_ids_matches_jax_exactly():
    rng = np.random.default_rng(6)
    kc, vc = _pools(rng, 10, 2, 4, 8)
    tables = rng.permutation(10)[:8].reshape(2, 4).astype(np.int32)
    k_new = rng.standard_normal((6, 2, 8)).astype(np.float32)
    v_new = rng.standard_normal((6, 2, 8)).astype(np.float32)
    seq_ids = np.asarray([0, 0, 0, 1, 1, 1], np.int32)
    positions = np.asarray([4, 5, 6, 13, 14, 15], np.int32)
    jk, jv = jpa.append_paged_kv(*(jnp.asarray(a) for a in (
        kc, vc, k_new, v_new, tables, positions, seq_ids)))
    tk, tv = tpa.append_paged_kv(*(torch.from_numpy(a.copy()) for a in (
        kc, vc, k_new, v_new, tables, positions, seq_ids)))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_paged_prefill_chunk_hook_matches_jax(pair):
    """Two rows at offsets 0 and 5 (the second row's chunk runs past the
    table, so its positions clip to max_len - 1 as in the JAX hook), then a
    token step over the filled pools."""
    jm, tm = pair
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 256, (2, 12)).astype(np.int32)
    starts = np.asarray([0, 5], np.int32)
    jc = jm._init_paged_caches(2, 16, 4, num_blocks=9)
    tc = tm._init_paged_caches(2, 16, 4, num_blocks=9, device="cpu")
    jc = jm.paged_prefill_chunk(jnp.asarray(ids), jc, jnp.asarray(starts))
    tc = tm.paged_prefill_chunk(torch.from_numpy(ids), tc,
                                torch.from_numpy(starts))
    for (jk, jv), (tk, tv) in zip(jc["kv"], tc["kv"]):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk),
                                   atol=MODEL_ATOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv),
                                   atol=MODEL_ATOL)
    tok = np.asarray([3, 4], np.int32)
    pos = np.asarray([12, 15], np.int32)
    ref, _ = jm.paged_token_step(jnp.asarray(tok), jc, jnp.asarray(pos))
    out, _ = tm.paged_token_step(torch.from_numpy(tok), tc,
                                 torch.from_numpy(pos))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=MODEL_ATOL)


# ---------------------------------------------------------------------------
# streams against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True], ids=["legacy", "fused"])
def test_prefix_streams_equal_jax_engine(pair, fused):
    """Greedy streams, cold then warm (radix hits, COW of full-prompt
    hits, packed prefill in fused mode), plus an eos request, equal the
    JAX engine's on the same weights and config."""
    jm, tm = pair
    prompts, kws = _wave(sampled=False)
    slots = 8 if fused else 2
    jeng = JaxEngine(jm, max_batch=slots, fused=fused,
                     prefix_cache=JaxPrefix(**CHUNKED), **SMALL)
    teng = _engine(tm, fused)
    want = [_serve(jeng, JaxRequest, prompts, kws) for _ in range(2)]
    got = [_serve(teng, Request, prompts, kws) for _ in range(2)]
    assert got == want
    assert teng.stats["cow_copies"] == jeng.stats["cow_copies"] > 0
    assert teng.stats["hit_tokens"] == jeng.stats["hit_tokens"] > 0
    if fused:
        assert teng.stats["packed_rows"] == jeng.stats["packed_rows"] > 0
    # eos: stop at a token the first stream emits mid-way
    eos = want[0][0][3]
    jr = JaxRequest(prompts[0], max_new_tokens=12, eos_token_id=eos)
    tr = Request(prompts[0], max_new_tokens=12, eos_token_id=eos)
    jeng.add_request(jr)
    jeng.run_until_done(max_steps=200)
    teng.add_request(tr)
    teng.run_until_done(max_steps=200)
    assert tr.tokens == list(jr.tokens) and tr.tokens[-1] == eos


def test_fused_128_slots_equal_legacy_and_jax(pair):
    """The counterpart of tests/test_serving_fused.py::
    test_fused_128_slots_byte_identical_to_legacy: a 128-slot engine (fused
    by default; prefix cache, packed prefill, batched COW) serves a
    160-request wave cold and warm, every stream equal to the port's and
    the JAX package's legacy 8-slot engines."""
    jm, tm = pair
    eng = ContinuousBatchingEngine(
        tm, max_batch=128, max_len=32, page_size=8, block_size=4,
        prefix_cache=PrefixCacheConfig(prefill_chunk=8, extra_blocks=16),
        device="cpu")
    assert eng._fused
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 256, (8 + (i % 3) * 4,)).astype(np.int32)
               for i in range(160)]
    kws = [dict(max_new_tokens=4 + (i % 4) * 2) for i in range(160)]
    cold = _serve(eng, Request, prompts, kws, stagger=False)
    warm = _serve(eng, Request, prompts, kws, stagger=False)
    legacy = dict(max_batch=8, max_len=32, page_size=8, block_size=4,
                  fused=False)
    want = _serve(ContinuousBatchingEngine(tm, device="cpu", **legacy),
                  Request, prompts, kws, stagger=False)
    assert cold == want and warm == want
    assert want == _serve(JaxEngine(jm, **legacy), JaxRequest, prompts, kws,
                          stagger=False)
    assert eng.stats["cow_copies"] > 0 and eng.stats["packed_rows"] > 0
    assert eng.active_slots() == 0 and len(eng._free_slots) == 128
    assert (eng.caches["tables"] == eng._park).all()
    assert not eng._dev_act.any()


# ---------------------------------------------------------------------------
# the JAX engine's contracts inside the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True], ids=["legacy", "fused"])
@pytest.mark.parametrize("kw", [dict(), dict(temperature=0.8, top_p=0.9,
                                             seed=1234)],
                         ids=["greedy", "seeded"])
def test_warm_equals_cold(pair, fused, kw):
    _, tm = pair
    eng = _engine(tm, fused)
    p = _prompt(12, 100)
    cold = _serve(eng, Request, [p], [dict(max_new_tokens=6, **kw)])
    assert eng.stats["miss_tokens"] == 12
    warm = _serve(eng, Request, [p], [dict(max_new_tokens=6, **kw)])
    assert warm == cold
    assert eng.stats["hit_tokens"] == 8          # the prompt's full page


@pytest.mark.parametrize("fused", [False, True], ids=["legacy", "fused"])
def test_warm_equals_cold_across_cow_divergence(pair, fused):
    """A full-prompt hit copies its last block before the re-step; a
    sampled continuation that diverges leaves the shared blocks intact
    for a third request."""
    _, tm = pair
    eng = _engine(tm, fused)
    p = _prompt(16, 102)
    cold = _serve(eng, Request, [p], [dict(max_new_tokens=5)])
    warm = _serve(eng, Request, [p], [dict(max_new_tokens=5)])
    assert eng.stats["cow_copies"] == 1 and warm == cold
    _serve(eng, Request, [p], [dict(max_new_tokens=5, temperature=1.2,
                                    seed=7)])
    assert _serve(eng, Request, [p], [dict(max_new_tokens=5)]) == cold
    assert eng.stats["cow_copies"] == 3


@pytest.mark.parametrize("prefix", [False, True], ids=["static", "prefix"])
def test_fused_equals_legacy_greedy_and_seeded(pair, prefix):
    _, tm = pair
    prompts, kws = _wave()
    want = _serve(_engine(tm, False, prefix=False), Request, prompts, kws)
    fus = _engine(tm, True, prefix=prefix)
    assert _serve(fus, Request, prompts, kws) == want
    assert fus.stats["fused_updates"] > 0
    assert not fus._dev_act.any()
    assert fus.active_slots() == 0 and len(fus._free_slots) == fus.max_batch
    if prefix:
        assert (fus.caches["tables"] == fus._park).all()


def test_fused_eos_early_exit_equals_legacy(pair):
    _, tm = pair
    p = _prompt(7, 401)
    free = _serve(_engine(tm, False, prefix=False), Request, [p],
                  [dict(max_new_tokens=12)])[0]
    eos = free[5]
    out = [_serve(_engine(tm, fused, prefix=prefix), Request, [p],
                  [dict(max_new_tokens=12, eos_token_id=eos)])[0]
           for fused, prefix in ((False, False), (True, False), (True, True))]
    assert out[0] == out[1] == out[2] == free[: free.index(eos) + 1]


@pytest.mark.parametrize("fused", [False, True], ids=["legacy", "fused"])
def test_chunked_prefill_interleaves_with_decode(pair, fused):
    """A long admit advances one chunk a step (legacy) while an active
    slot keeps decoding; both streams equal a lone cold serve."""
    _, tm = pair
    chunk = dict(prefill_chunk=8, pack_rows=1)
    eng = _engine(tm, fused, max_len=32, block_size=2,
                  prefix_cache=PrefixCacheConfig(**chunk))
    long_p, short_p = _prompt(24, 107), _prompt(6, 108)
    rs = Request(short_p, max_new_tokens=8)
    eng.add_request(rs)
    eng.step()                                   # short admitted, decoding
    rl = Request(long_p, max_new_tokens=4)
    eng.add_request(rl)
    eng.step()                                   # long: ONE chunk only
    assert list(eng._prefill_next.values()) == [8]
    decoded = rs._n_out
    eng.run_until_done(max_steps=300)
    assert rs._n_out > decoded
    for r, p, n in ((rs, short_p, 8), (rl, long_p, 4)):
        alone = _serve(_engine(tm, False, prefix=False, max_len=32),
                       Request, [p], [dict(max_new_tokens=n)])[0]
        assert r.tokens == alone


@pytest.mark.parametrize("fused", [False, True], ids=["legacy", "fused"])
def test_deadline_eviction_decrefs_not_frees_shared_blocks(pair, fused):
    _, tm = pair
    eng = _engine(tm, fused, max_len=32, block_size=2,
                  prefix_cache=PrefixCacheConfig(prefill_chunk=8))
    shared = _prompt(16, 109)
    pa = np.concatenate([shared, _prompt(4, 110)])
    pb = np.concatenate([shared, _prompt(5, 111)])
    ref = _serve(_engine(tm, False, prefix=False, max_len=32), Request,
                 [pa], [dict(max_new_tokens=12)])[0]
    ra = Request(pa, max_new_tokens=12)
    eng.add_request(ra)
    for _ in range(10):
        eng.step()
        if ra._n_out:
            break
    assert ra._n_out and not ra.done
    hits = eng.stats["hit_tokens"]
    eng.shed_infeasible = False
    rb = Request(pb, max_new_tokens=11, deadline_s=0.05)
    eng.add_request(rb)
    eng.step()                                   # rb shares ra's prefix
    assert eng.stats["hit_tokens"] - hits == 16
    shared_blocks = eng._radix.match(shared)
    assert all(eng._alloc.refcount(b) == 2 for b in shared_blocks)
    time.sleep(0.1)
    eng.run_until_done(max_steps=300)
    assert rb.failed and "deadline" in rb.error
    assert not ra.failed and ra.tokens == ref
    # evicted and finished: the shared blocks stay cached, idle
    assert all(eng._radix.has_block(b) and eng._alloc.refcount(b) == 0
               for b in shared_blocks)


@pytest.mark.parametrize("fused", [False, True], ids=["legacy", "fused"])
def test_deadline_eviction_mid_prefill_releases_pages(pair, fused):
    _, tm = pair
    eng = _engine(tm, fused, max_batch=2, max_len=32, block_size=2,
                  prefix_cache=PrefixCacheConfig(prefill_chunk=8,
                                                 pack_rows=1))
    eng.shed_infeasible = False
    pa, pb, pc = _prompt(6, 130), _prompt(24, 131), _prompt(6, 132)
    alone = {}
    for p, n in ((pa, 26), (pc, 4)):
        alone[n] = _serve(_engine(tm, False, prefix=False, max_len=32),
                          Request, [p], [dict(max_new_tokens=n)])[0]
    ra = Request(pa, max_new_tokens=26)
    eng.add_request(ra)
    eng.step()
    rb = Request(pb, max_new_tokens=4, deadline_s=0.25)
    eng.add_request(rb)
    eng.step()                                   # rb: one chunk prefilled
    slot_b = next(iter(eng._prefill_next))
    assert eng._prefill_next[slot_b] < len(pb)
    blocks_b = list(eng._slot_blocks[slot_b])
    assert len(blocks_b) == 4 and eng._alloc.free_blocks == 0
    time.sleep(0.3)
    eng.step()                                   # the deadline tick
    assert rb.failed and slot_b not in eng._prefill_next
    assert eng._slots[slot_b] is None
    assert all(eng._alloc.refcount(b) == 0 for b in blocks_b)
    rc = Request(pc, max_new_tokens=4)           # the freed slot serves
    eng.add_request(rc)
    eng.run_until_done(max_steps=300)
    assert ra.tokens == alone[26] and rc.tokens == alone[4]
    eng._radix.evict_lru(eng._alloc.num_blocks)
    assert eng._alloc.free_blocks == eng._alloc.num_blocks  # nothing leaked


@pytest.mark.parametrize("fused", [False, True], ids=["legacy", "fused"])
def test_pool_exhaustion_defers_admission_then_recovers(pair, fused):
    """The queue head that cannot get its blocks (even after evicting idle
    cached ones) waits, and later arrivals wait behind it; matched blocks
    are pinned before the eviction-capable alloc, so a shortfall never
    hands a just-matched block back as a fresh one."""
    _, tm = pair
    eng = _engine(tm, fused, max_batch=2, max_len=32,
                  prefix_cache=PrefixCacheConfig())
    pa = _prompt(16, 117)
    pb = np.concatenate([pa[:8], _prompt(8, 118)])
    pc = _prompt(5, 119)
    _serve(eng, Request, [pa], [dict(max_new_tokens=8)])   # pa cached
    eng._alloc.hold(eng._alloc.free_blocks)      # only pa's chain is free
    rb, rc = Request(pb, max_new_tokens=8), Request(pc, max_new_tokens=2)
    eng.add_request(rb)
    eng.add_request(rc)
    eng.step()
    assert len(eng._queue) == 2 and not rb.tokens and not rc.tokens
    assert eng._radix.match(pa[:8]), "the pinned matched chain was evicted"
    assert eng.stats["evictions"] == 1           # pa's idle leaf only
    eng._alloc.release_held()
    eng.run_until_done(max_steps=200)
    for r, p in ((rb, pb), (rc, pc)):
        assert r.tokens == _serve(_engine(tm, False, prefix=False,
                                          max_len=32),
                                  Request, [p], [dict(max_new_tokens=8 if
                                                      p is pb else 2)])[0]


def test_overcommit_steals_blocks_live_tables_map(pair):
    """``_unsafe_overcommit`` (a test-only knob) admits under exhaustion by
    taking a block out of the radix cache while a live table still maps
    it; the refcounted path defers instead."""
    _, tm = pair
    for steal in (False, True):
        eng = _engine(tm, False, max_batch=2, max_len=16, block_size=2,
                      prefix_cache=PrefixCacheConfig(),
                      _unsafe_overcommit=steal)
        ra = Request(_prompt(8, 120), max_new_tokens=8)
        eng.add_request(ra)
        eng.step()                    # ra decoding, its prompt block cached
        assert ra._n_out and not ra.done
        live = eng._radix.match(ra.prompt)
        assert eng._alloc.refcount(live[0]) == 1
        eng._alloc.hold(eng._alloc.free_blocks)
        eng.add_request(Request(_prompt(4, 121), max_new_tokens=4))
        eng.step()                    # needs one block: none is free
        assert len(eng._queue) == (0 if steal else 1)
        if steal:                     # one block in two live tables
            blocks = [eng._slot_blocks[i] for i in eng._occupied]
            assert live[0] in blocks[0] and live[0] in blocks[1]


def test_fused_counters_track_occupancy(pair):
    _, tm = pair
    eng = _engine(tm, True, prefix=False)
    reqs = [Request(_prompt(5, 500 + i), max_new_tokens=16) for i in range(3)]
    for r in reqs:
        eng.add_request(r)
    assert eng.has_work()
    eng.step()
    assert eng.active_slots() == 3
    assert len(eng._free_slots) == eng.max_batch - 3
    assert sorted(eng._occupied) == [i for i, s in enumerate(eng._slots)
                                     if s is not None]
    eng.run_until_done(max_steps=200)
    assert not eng.has_work() and eng.active_slots() == 0
    assert len(eng._free_slots) == eng.max_batch
    assert all(r.done and not r.failed for r in reqs)


@pytest.mark.parametrize("prefix", [False, True], ids=["static", "prefix"])
def test_admission_churn_never_recaptures(pair, prefix):
    """Admission and release go through ``_flush_updates`` only: the graph
    count stays where construction left it (no graph on the CPU), and
    every decode step is counted as a replay or an eager step."""
    _, tm = pair
    eng = _engine(tm, True, prefix=prefix)
    captures = eng.stats["graph_captures"]
    prompts, kws = _wave()
    for _ in range(2):
        _serve(eng, Request, prompts, kws)
    assert eng.stats["graph_captures"] == captures == 0
    assert eng.stats["fused_updates"] >= 2 * 2 * len(prompts)
    assert eng.stats["decode_steps"] == (eng.stats["graph_replays"]
                                         + eng.stats["eager_decode_steps"])


@pytest.mark.parametrize("max_batch,fused,want", [
    (8, None, False), (32, None, True), (32, False, False), (2, True, True)])
def test_fused_default_follows_jax(pair, max_batch, fused, want):
    _, tm = pair
    eng = ContinuousBatchingEngine(tm, max_batch=max_batch, fused=fused,
                                   device="cpu", **SMALL)
    assert eng._fused is want


# ---------------------------------------------------------------------------
# the disaggregated-tier hooks against the JAX engine
# ---------------------------------------------------------------------------

def _tier_hooks(mod, eng, R, prompts, kws):
    """Step a wave and record after each step the migration candidates and
    each request's slot; withdraw the first candidate once two are ready.
    Returns (the log, the withdrawn request's chain: blocks, position, last
    token, page bytes, request)."""
    reqs = [R(p, **k) for p, k in zip(prompts, kws)]
    for r in reqs:
        eng.add_request(r)
    log, moved = [], None
    while eng.has_work():
        eng.step()
        ready = eng.migration_ready()
        log.append((ready, [eng.slot_of(r.rid) for r in reqs]))
        if moved is None and len(ready) >= 2:
            req = next(r for r in reqs if r.rid == ready[0])
            slot = eng.slot_of(req.rid)
            eng._drain_pending()
            pos = int(eng._pos[slot])
            blocks = list(eng._slot_blocks[slot])
            n = -(-(pos - 1) // eng.page_size)
            pages = mod.gather_chain_pages(eng.caches["kv"], blocks[:n])
            free = eng._alloc.free_blocks
            assert eng.withdraw_active(req.rid)
            assert not eng.withdraw_active(req.rid)
            moved = (blocks, pos, int(req.output[-1]), pages, req)
            log.append(("withdrawn", eng.slot_of(req.rid), len(ready),
                        eng._alloc.free_blocks - free,
                        len(eng._free_slots)))
    return log, moved


def _admit(eng, mod, moved, R):
    """``admit_migrated`` of a withdrawn chain into ``eng``: fresh blocks,
    the page bytes written, the request resumed with its delivered
    tokens; returns its slot and its finished stream."""
    blocks, pos, last, pages, src = moved
    fresh = eng._alloc.alloc(len(blocks))
    got = mod.scatter_chain_pages(eng.caches["kv"],
                                  fresh[:pages[0][0].shape[0]], pages)
    if got is not eng.caches["kv"]:             # JAX returns new arrays
        eng.caches = {"kv": got, "tables": eng.caches["tables"]}
    req = R(src.prompt, max_new_tokens=src.max_new_tokens)
    req.output = list(src.output)
    req._n_out = len(req.output)
    slot = eng.admit_migrated(req, fresh, pos, last_tok=last)
    state = (slot, int(eng._pos[slot]), list(eng._slot_blocks[slot]),
             len(eng._radix), eng.migration_ready())
    eng.run_until_done(max_steps=500)
    return state, list(req.tokens)


@pytest.mark.parametrize("fused", [False, True], ids=["legacy", "fused"])
def test_tier_hooks_match_jax_engine(pair, fused):
    """``migration_ready``, ``slot_of``, ``withdraw_active`` and
    ``admit_migrated`` step for step against the JAX engine on one greedy
    wave: the same candidates and slots after every step, the same slot
    and pages released, and the withdrawn chain (its own package's page
    bytes) resumed in a fresh engine at the same slot, position and radix
    state, continuing to the same stream; admit_migrated refuses a full
    engine and a prefixless one."""
    jm, tm = pair
    prompts, kws = _wave(sampled=False)
    slots = 8 if fused else 2
    runs = []
    base = max(JaxRequest._counter[0], Request._counter[0])
    for mod, eng, R in (
            (jpa, JaxEngine(jm, max_batch=slots, fused=fused,
                            prefix_cache=JaxPrefix(**CHUNKED), **SMALL),
             JaxRequest),
            (tpa, _engine(tm, fused), Request)):
        R._counter[0] = base                    # the same rids
        log, moved = _tier_hooks(mod, eng, R, prompts, kws)
        assert moved is not None
        dst = (JaxEngine(jm, max_batch=slots, fused=fused,
                         prefix_cache=JaxPrefix(**CHUNKED), **SMALL)
               if mod is jpa else _engine(tm, fused))
        runs.append((log, moved[:3], _admit(dst, mod, moved, R)))
        dst._free_slots.clear()
        with pytest.raises(Exception, match="no free slot"):
            dst.admit_migrated(R(prompts[0]), [0], 3, last_tok=1)
    assert runs[0] == runs[1]
    plain = _engine(tm, fused, prefix=False)
    with pytest.raises(ValueError, match="prefix-cache"):
        plain.admit_migrated(Request(prompts[0]), [0], 3, last_tok=1)
