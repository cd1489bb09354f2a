"""Port speculative decoding (paddle_tpu_torch) against the JAX package,
case by case after tests/test_serving_spec.py.

Pure functions: ``spec_accept`` and ``ngram_draft`` give exactly the JAX
functions' outputs on the same inputs (the fixed cases of the JAX tests,
ring wrap-around, ``caps`` 0, and seeded random inputs); ``_spec_seed``
lays a prompt into the ring as the JAX engine does; ``SpecConfig`` and
``KVCacheConfig`` validation raise as the JAX engine raises.

Engines (tiny Llama, 1 layer, fp32, CPU, carried weights): the port's
speculative greedy streams equal the JAX speculative engine's and the
port's own non-speculative engine's, at two slot widths, with the prefix
cache cold and warm (copy-on-write of full-prompt hits), with the same
spec counters as JAX; blocks with an eos row or a sampled row keep the
right streams; ``_unsafe_accept_all`` diverges, as the JAX drill expects;
and the card's replay bookkeeping, rehearsed with the eager step standing
in for the graph, counts every dispatch as a replay.

Left out until the port has them (ROADMAP Queue 1 item 8): the migration,
crash-replay and metrics-family cases of the JAX file.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import serving as jserving
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                KVCacheConfig,
                                                PrefixCacheConfig, Request,
                                                SpecConfig)
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.weights import load_jax_state, state_from_jax_layer

torch.set_num_threads(1)


def _both(fn_name, *arrays, **kw):
    """The JAX function and the port's on the same numpy inputs, as numpy
    int arrays."""
    j = getattr(jserving, fn_name)(*(jnp.asarray(a) for a in arrays), **kw)
    t = getattr(tserving, fn_name)(*(torch.from_numpy(a) for a in arrays),
                                   **kw)
    if not isinstance(j, tuple):
        j, t = (j,), (t,)
    return ([np.asarray(x).astype(np.int64) for x in j],
            [x.numpy().astype(np.int64) for x in t])


# ---------------------------------------------------------------------------
# accept/reject and the drafter against JAX
# ---------------------------------------------------------------------------

def test_spec_accept_longest_prefix_plus_bonus():
    drafts = np.array([[5, 6, 7], [5, 9, 7], [1, 2, 3]], np.int32)
    targets = np.array([[5, 6, 7, 8], [5, 6, 7, 8], [9, 9, 9, 9]], np.int32)
    caps = np.array([10, 10, 10], np.int32)
    want, got = _both("spec_accept", drafts, targets, caps)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    out, emit, n_acc = got
    assert list(n_acc) == [3, 1, 0] and list(emit) == [4, 2, 1]
    assert list(out[0][:4]) == [5, 6, 7, 8] and list(out[1][:2]) == [5, 6]
    assert list(out[2][:1]) == [9]


def test_spec_accept_caps_clamp_and_mask():
    drafts = np.array([[5, 6], [5, 6]], np.int32)
    targets = np.array([[5, 6, 7], [5, 6, 7]], np.int32)
    want, got = _both("spec_accept", drafts, targets,
                      np.array([2, 0], np.int32))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert list(got[1]) == [2, 0]          # cap truncates; cap 0 masks
    assert list(got[0][0][:2]) == [5, 6]


@pytest.mark.parametrize("seed", range(6))
def test_spec_accept_random_matches_jax(seed):
    rng = np.random.default_rng(seed)
    B, K = 16, int(rng.integers(1, 6))
    targets = rng.integers(0, 3, (B, K + 1)).astype(np.int32)
    # drafts copy a random-length prefix of the targets, then guess
    drafts = rng.integers(0, 3, (B, K)).astype(np.int32)
    keep = rng.integers(0, K + 1, B)
    for b in range(B):
        drafts[b, :keep[b]] = targets[b, :keep[b]]
    caps = rng.integers(-1, K + 3, B).astype(np.int32)
    want, got = _both("spec_accept", drafts, targets, caps)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_ngram_draft_continuation_and_fallback():
    H, k, n = 8, 3, 2
    hist = np.zeros((2, H), np.int32)
    hist[0, :6] = [1, 2, 3, 4, 1, 2]
    hlen = np.array([6, 0], np.int32)
    last = np.array([3, 7], np.int32)
    (want,), (got,) = _both("ngram_draft", hist, hlen, last, k=k, n=n)
    np.testing.assert_array_equal(got, want)
    assert list(got[0]) == [4, 1, 2]       # tail (2, 3) seen at 1..2
    assert list(got[1]) == [7, 7, 7]       # no history: repeat last


def test_ngram_draft_ring_wraparound():
    H, k, n = 4, 2, 2
    stream = [1, 2, 3, 4, 2, 3]
    hist = np.zeros((1, H), np.int32)
    for g, t in enumerate(stream):
        hist[0, g % H] = t
    hlen = np.array([len(stream)], np.int32)
    last = np.array([4], np.int32)
    (want,), (got,) = _both("ngram_draft", hist, hlen, last, k=k, n=n)
    np.testing.assert_array_equal(got, want)
    assert list(got[0]) == [2, 3]


@pytest.mark.parametrize("seed", range(6))
def test_ngram_draft_random_matches_jax(seed):
    """Seeded rings over a 3-token vocabulary (many matches), written
    counts below n, below H and past H (wrapped), several k and n."""
    rng = np.random.default_rng(100 + seed)
    B, H = 12, int(rng.integers(6, 12))
    n = int(rng.integers(1, 4))
    k = int(rng.integers(1, H - n + 1))
    hist = rng.integers(0, 3, (B, H)).astype(np.int32)
    hlen = rng.integers(0, 3 * H, B).astype(np.int32)
    hlen[:3] = [0, n - 1, H]
    last = rng.integers(0, 3, B).astype(np.int32)
    (want,), (got,) = _both("ngram_draft", hist, hlen, last, k=k, n=n)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("history,prompt_len", [(8, 12), (8, 3), (8, 8),
                                                (4, 20)])
def test_spec_seed_ring_layout_matches_jax(history, prompt_len):
    """The activation seed: the last ``history`` tokens at ring slot g % H
    (prompts longer than, shorter than and as long as the ring)."""
    prompt = np.arange(100, 100 + prompt_len, dtype=np.int32)
    want = jserving.ContinuousBatchingEngine._spec_seed(
        types.SimpleNamespace(_spec=jserving.SpecConfig(history=history)),
        prompt)
    got = ContinuousBatchingEngine._spec_seed(
        types.SimpleNamespace(_spec=SpecConfig(history=history)), prompt)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == prompt_len


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


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_paged_verify_step_hook_matches_jax(pair, kv_dtype):
    """The Llama verify hook after a prefill chunk: two rows' windows of 4
    at positions 12 and 13 (the second runs past the table's extent, so its
    positions clip to max_len - 1 as in the JAX hook), on fp and int8
    pools: logits at every window position within 1e-4 (as
    tests/test_torch_llama.py) and the pools after the append."""
    jm, tm = pair
    rng = np.random.default_rng(8)
    ids = rng.integers(0, 256, (2, 12)).astype(np.int32)
    zeros = np.zeros(2, np.int32)
    jc = jm._init_paged_caches(2, 16, 4, num_blocks=9, kv_dtype=kv_dtype)
    tc = tm._init_paged_caches(2, 16, 4, num_blocks=9, kv_dtype=kv_dtype,
                               device="cpu")
    jc = jm.paged_prefill_chunk(jnp.asarray(ids), jc, jnp.asarray(zeros))
    tc = tm.paged_prefill_chunk(torch.from_numpy(ids), tc,
                                torch.from_numpy(zeros))
    win = rng.integers(0, 256, (2, 4)).astype(np.int32)
    pos = np.asarray([12, 13], np.int32)
    want, jc = jm.paged_verify_step(jnp.asarray(win), jc, jnp.asarray(pos))
    got, tc = tm.paged_verify_step(torch.from_numpy(win), tc,
                                   torch.from_numpy(pos))
    assert got.shape == (2, 4, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    for (jk, jv), (tk, tv) in zip(jc["kv"], tc["kv"]):
        for jp, tp in ((jk, tk), (jv, tv)):
            if kv_dtype == "int8":
                diff = np.abs(tp.data.numpy().astype(np.int32)
                              - np.asarray(jp.data).astype(np.int32))
                assert diff.max() <= 1
                np.testing.assert_allclose(tp.scale.numpy(),
                                           np.asarray(jp.scale), rtol=1e-5)
            else:
                np.testing.assert_allclose(tp.numpy(), np.asarray(jp),
                                           atol=1e-4)


@pytest.mark.parametrize("kw,exc,match", [
    (dict(speculative=SpecConfig(k=0)), ValueError, "must be >= 1"),
    (dict(speculative=SpecConfig(ngram=0)), ValueError, "must be >= 1"),
    (dict(speculative=SpecConfig(k=4, history=4)), ValueError,
     "history .* too short"),
    (dict(speculative=True, fused=False), ValueError, "fused"),
    (dict(kv_cache="int4"), ValueError, "unsupported KV cache dtype"),
], ids=["k0", "ngram0", "history", "not_fused", "int4"])
def test_spec_config_validation_matches_jax(pair, kw, exc, match):
    jm, tm = pair
    jkw = dict(kw)
    if isinstance(kw.get("speculative"), SpecConfig):
        s = kw["speculative"]
        jkw["speculative"] = jserving.SpecConfig(k=s.k, ngram=s.ngram,
                                                 history=s.history)
    base = dict(max_batch=2, max_len=32, page_size=8)
    with pytest.raises(exc, match=match):
        jserving.ContinuousBatchingEngine(jm, **{"fused": True, **base,
                                                 **jkw})
    with pytest.raises(exc, match=match):
        ContinuousBatchingEngine(tm, device="cpu", **{"fused": True, **base,
                                                      **kw})
    with pytest.raises(ValueError, match="unsupported KV cache dtype"):
        KVCacheConfig(dtype="int4")


def _wave(vocab=256, rng_seed=300):
    """tests/test_serving_spec.py's wave: prompt 0 repeats a motif with a
    long continuation (the drafter's food), 16/24-token prompts fill whole
    pages (a warm re-serve copies their last block)."""
    rng = np.random.default_rng(rng_seed)
    motif = rng.integers(0, vocab, (4,)).astype(np.int32)
    prompts = [np.tile(motif, 6), np.tile(motif, 4),
               rng.integers(0, vocab, (9,)).astype(np.int32),
               rng.integers(0, vocab, (5,)).astype(np.int32)]
    kws = [dict(max_new_tokens=24), dict(max_new_tokens=10),
           dict(max_new_tokens=8), dict(max_new_tokens=6)]
    return prompts, kws


def _serve(eng, request_cls, prompts, kws, stagger=True):
    reqs = [request_cls(p, **k) for p, k in zip(prompts, kws)]
    head, tail = (reqs[:2], reqs[2:]) if stagger else (reqs, [])
    for r in head:
        eng.add_request(r)
    eng.step()
    for r in tail:
        eng.add_request(r)
    eng.run_until_done(max_steps=800)
    return [list(r.tokens) for r in reqs]


def _engines(jm, tm, jax_kw=None, **kw):
    """The JAX engine and the port's on the same settings (``kw`` with
    port classes; SpecConfig and PrefixCacheConfig are mirrored)."""
    jkw = dict(kw)
    if "speculative" in kw:
        s = kw["speculative"]
        jkw["speculative"] = jserving.SpecConfig(
            k=s.k, ngram=s.ngram, history=s.history,
            _unsafe_accept_all=s._unsafe_accept_all)
    if "prefix_cache" in kw:
        p = kw["prefix_cache"]
        jkw["prefix_cache"] = jserving.PrefixCacheConfig(
            prefill_chunk=p.prefill_chunk, extra_blocks=p.extra_blocks)
    jkw.update(jax_kw or {})
    return (jserving.ContinuousBatchingEngine(jm, **jkw),
            ContinuousBatchingEngine(tm, device="cpu", **kw))


_SPEC = dict(max_len=64, page_size=8, block_size=2, fused=True)
_STATS = ("spec_proposed", "spec_accepted", "spec_steps")


def test_spec_streams_equal_jax_and_non_spec(pair):
    """Width 4 without the prefix cache: the port's spec streams equal the
    JAX spec engine's and the port's non-spec engine's, with the same
    spec counters; acceptance > 0 on the repetitive prompt."""
    jm, tm = pair
    prompts, kws = _wave()
    ref = _serve(ContinuousBatchingEngine(tm, max_batch=4, device="cpu",
                                          **_SPEC), Request, prompts, kws)
    jeng, teng = _engines(jm, tm, max_batch=4, speculative=SpecConfig(k=3),
                          **_SPEC)
    want = _serve(jeng, jserving.Request, prompts, kws)
    got = _serve(teng, Request, prompts, kws)
    assert got == want == ref
    assert {k: teng.stats[k] for k in _STATS} == \
        {k: jeng.stats[k] for k in _STATS}
    assert teng.stats["spec_accepted"] > 0
    assert 0 < teng.stats["spec_steps"] < sum(k["max_new_tokens"]
                                              for k in kws)
    assert teng.stats["eager_spec_steps"] == teng.stats["spec_steps"]
    assert not teng._dev_act.any()


def test_spec_prefix_cache_cold_warm_cow_equal_jax(pair):
    """Six slots with the prefix cache: cold, then warm (full-prompt hits
    copy their last block); every stream equals the JAX engine's and the
    non-spec reference."""
    jm, tm = pair
    prompts, kws = _wave()
    ref = _serve(ContinuousBatchingEngine(tm, max_batch=4, device="cpu",
                                          **_SPEC), Request, prompts, kws)
    prefix = PrefixCacheConfig(prefill_chunk=16, extra_blocks=12)
    jeng, teng = _engines(jm, tm, max_batch=6, speculative=SpecConfig(k=3),
                          prefix_cache=prefix, **_SPEC)
    for _ in range(2):
        want = _serve(jeng, jserving.Request, prompts, kws)
        got = _serve(teng, Request, prompts, kws)
        assert got == want == ref
    assert teng.stats["cow_copies"] == jeng.stats["cow_copies"] >= 1
    assert {k: teng.stats[k] for k in _STATS} == \
        {k: jeng.stats[k] for k in _STATS}
    assert (teng.caches["tables"] == teng._park).all()


def test_spec_eos_and_mixed_sampling_take_the_right_step(pair):
    """An eos inside a speculative dispatch stops the stream where the
    non-spec engine stops it (and where JAX's does); a block with a sampled
    row takes the ordinary step, and the streams still equal the non-spec
    engine's."""
    jm, tm = pair
    prompts, kws = _wave()

    def build(**kw):
        return ContinuousBatchingEngine(tm, max_batch=4, device="cpu",
                                        **_SPEC, **kw)

    free = _serve(build(), Request, prompts, kws, stagger=False)
    eos = free[0][4]
    kws_eos = [dict(k, eos_token_id=eos) for k in kws]
    ref = _serve(build(), Request, prompts, kws_eos, stagger=False)
    spec = build(speculative=SpecConfig(k=3))
    got = _serve(spec, Request, prompts, kws_eos, stagger=False)
    jeng, _ = _engines(jm, tm, max_batch=4, speculative=SpecConfig(k=3),
                       **_SPEC)
    want = _serve(jeng, jserving.Request, prompts, kws_eos, stagger=False)
    assert got == ref == want
    assert got[0][-1] == eos and spec.stats["spec_steps"] > 0
    kws_mix = [dict(kws[0]), dict(kws[1], temperature=0.9, seed=7),
               dict(kws[2]), dict(kws[3], temperature=1.1, seed=3)]
    ref_mix = _serve(build(), Request, prompts, kws_mix)
    mix = build(speculative=SpecConfig(k=3))
    assert _serve(mix, Request, prompts, kws_mix) == ref_mix
    assert mix.stats["eager_decode_steps"] > 0


def test_unsafe_accept_all_diverges(pair):
    """The drill-only knob trusts every draft: greedy streams diverge from
    the verified ones, in the port as in the JAX engine (same streams)."""
    jm, tm = pair
    prompts, kws = _wave()
    ref = _serve(ContinuousBatchingEngine(tm, max_batch=4, device="cpu",
                                          **_SPEC), Request, prompts, kws)
    jeng, teng = _engines(jm, tm, max_batch=4,
                          speculative=SpecConfig(k=3,
                                                 _unsafe_accept_all=True),
                          **_SPEC)
    got = _serve(teng, Request, prompts, kws)
    assert got != ref
    assert got == _serve(jeng, jserving.Request, prompts, kws)
    assert [len(s) for s in got] == [k["max_new_tokens"] for k in kws]


def test_spec_replay_bookkeeping_rehearsed(pair):
    """The card path's bookkeeping with the eager steps standing in for the
    two graphs: every spec dispatch is counted as a replay, the ordinary
    blocks (rows near max_len) as greedy replays, and the streams do not
    change."""
    _, tm = pair
    prompts, kws = _wave()
    ref = _serve(ContinuousBatchingEngine(tm, max_batch=4, device="cpu",
                                          **_SPEC), Request, prompts, kws)
    eng = ContinuousBatchingEngine(tm, max_batch=4, device="cpu",
                                   speculative=SpecConfig(k=3), **_SPEC)
    # the stand-ins launch eagerly and count their own launches: a replay
    # credits the kernels with none (_graph_counts stays zero)
    eng._graph = types.SimpleNamespace(replay=eng._fused_step)
    eng._spec_graph = types.SimpleNamespace(replay=eng._spec_step)
    assert _serve(eng, Request, prompts, kws) == ref
    st = eng.stats
    assert st["spec_graph_replays"] == st["spec_steps"] > 0
    assert st["eager_spec_steps"] == 0
    assert st["graph_replays"] == st["decode_steps"]
