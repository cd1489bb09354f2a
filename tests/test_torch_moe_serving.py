"""Port MoE serving (paddle_tpu_torch: ``ContinuousBatchingEngine`` over a
Mixtral-class MoE Llama) against the JAX engine of the same kind on carried
tiny weights (fp32, CPU).

Every dispatch (``pgmm``, ``ragged``, ``einsum``, ``scatter``, ``auto``)
through each engine kind (legacy, legacy with the prefix cache, fused with
the prefix cache): greedy streams must be exactly the JAX engine's, cold
and warm, with an eos request. The JAX ``pgmm`` runs its Pallas kernel in
interpret mode at ``TILE_M`` 16, as tests/test_torch_moe.py runs it.

Engines are held against the JAX engine of their own kind only: under the
capacity dispatches a token's dropped choices depend on which rows share
its step, so the JAX engine's legacy and fused streams differ from each
other there. Under the dropless ``pgmm`` and ``ragged`` the port keeps the
JAX engine's contracts inside itself: fused == legacy and warm == cold.
Speculative decode and int8 pools on the MoE model equal the JAX engine's
too. The serving hooks leave the gate's aux side channel empty, and the
fused step's replays credit K5 with the launches they replay (rehearsed
here with the eager step standing in for the graph).
"""

import importlib
import types

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.distributed.models.moe import moe_layer as jml
from paddle_tpu.inference import serving as jserving
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.ops import grouped_matmul as jgm
from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                KVCacheConfig,
                                                PrefixCacheConfig, Request,
                                                SpecConfig)
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.weights import load_jax_state, state_from_jax_layer

torch.set_num_threads(1)

# the module (the package attribute ``ops.pgmm`` is the function)
tgm = importlib.import_module("paddle_tpu_torch.ops.grouped_matmul")
TM = 16
MOE = dict(num_experts=4, num_hidden_layers=1)
SMALL = dict(max_len=64, page_size=8, block_size=4)
CHUNKED = dict(prefill_chunk=16, extra_blocks=8)
DISPATCHES = ("pgmm", "ragged", "einsum", "scatter", "auto")
# engine kinds: slots, fused, prefix cache
KINDS = {"legacy": (2, False, False), "prefix": (2, False, True),
         "fused": (8, True, True)}


@pytest.fixture(autouse=True)
def small_tiles_and_interpret(monkeypatch):
    monkeypatch.setattr(jgm, "TILE_M", TM)
    monkeypatch.setattr(tgm, "TILE_M", TM)
    for cls in (jml.SwiGLUExpertFFN, jml.ExpertFFN):
        orig = cls.forward_pgmm

        def fp(self, xp, gids, tile_m=None, interpret=False, _orig=orig):
            return _orig(self, xp, gids, tile_m=tile_m, interpret=True)

        monkeypatch.setattr(cls, "forward_pgmm", fp)


@pytest.fixture(scope="module")
def pair():
    paddle.seed(11)
    jm = JaxLlama(JaxConfig.tiny(**MOE))
    tm = LlamaForCausalLM(LlamaConfig.tiny(**MOE), device="cpu")
    load_jax_state(tm, state_from_jax_layer(jm))
    return jm, tm


def _dispatch(jm, tm, mode):
    """Both models' MoE layers onto dispatch ``mode``."""
    for m in (jm, tm):
        for layer in m.model.layers:
            layer.mlp.dispatch_mode = mode


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n,)).astype(np.int32)


def _wave():
    """Prompt 16 fills two pages (a warm re-serve copies its last block);
    prompt 40 outruns the chunk (16); two rows share a 16-token prefix."""
    sys_p = _prompt(16, 299)
    prompts = [_prompt(n, 300 + n) for n in (5, 16, 9, 40, 3)]
    prompts += [np.concatenate([sys_p, _prompt(5, 310)]),
                np.concatenate([sys_p, _prompt(7, 311)])]
    news = (6, 4, 8, 6, 8, 5, 7)
    return prompts, [dict(max_new_tokens=n) for n in news]


def _serve(eng, request_cls, prompts, kws):
    """Three requests, two steps, then the rest; returns the streams."""
    reqs = [request_cls(p, **k) for p, k in zip(prompts, kws)]
    for r in reqs[:3]:
        eng.add_request(r)
    eng.step()
    eng.step()
    for r in reqs[3:]:
        eng.add_request(r)
    eng.run_until_done(max_steps=500)
    return [list(r.tokens) for r in reqs]


def _engines(jm, tm, kind, **kw):
    slots, fused, prefix = KINDS[kind]
    jkw, tkw = dict(kw), dict(kw)
    if prefix:
        jkw["prefix_cache"] = jserving.PrefixCacheConfig(**CHUNKED)
        tkw["prefix_cache"] = PrefixCacheConfig(**CHUNKED)
    return (jserving.ContinuousBatchingEngine(jm, max_batch=slots,
                                              fused=fused, **SMALL, **jkw),
            ContinuousBatchingEngine(tm, max_batch=slots, fused=fused,
                                     device="cpu", **SMALL, **tkw))


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("mode", DISPATCHES)
def test_moe_streams_equal_jax_engine(pair, mode, kind):
    """Cold, then warm (prefix engines: radix hits and COW), then an eos
    request: every greedy stream equals the JAX engine's of the same kind,
    and so do the prefix cache's counters."""
    jm, tm = pair
    _dispatch(jm, tm, mode)
    prompts, kws = _wave()
    jeng, teng = _engines(jm, tm, kind)
    want = [_serve(jeng, jserving.Request, prompts, kws) for _ in range(2)]
    got = [_serve(teng, Request, prompts, kws) for _ in range(2)]
    assert got == want
    if KINDS[kind][2]:
        for k in ("hit_tokens", "cow_copies", "packed_rows"):
            assert teng.stats[k] == jeng.stats[k], k
        assert teng.stats["hit_tokens"] > 0
    eos = want[0][0][3]
    jr = jserving.Request(prompts[0], max_new_tokens=12, eos_token_id=eos)
    tr = Request(prompts[0], max_new_tokens=12, eos_token_id=eos)
    jeng.add_request(jr)
    jeng.run_until_done(max_steps=200)
    teng.add_request(tr)
    teng.run_until_done(max_steps=200)
    assert tr.tokens == list(jr.tokens) and tr.tokens[-1] == eos
    # the serving hooks drop the aux loss: nothing lands in the gate
    assert all(layer.mlp.gate.loss is None for layer in tm.model.layers)


@pytest.mark.parametrize("mode", ["pgmm", "ragged"])
def test_dropless_fused_equals_legacy_and_warm_equals_cold(pair, mode):
    """The JAX engine's byte-identity contracts inside the port, where the
    dispatch drops nothing: the fused prefix-cache engine (packed prefill,
    8 slots) cold and warm, and the legacy prefix-cache engine, equal the
    legacy engine without a cache."""
    jm, tm = pair
    _dispatch(jm, tm, mode)
    prompts, kws = _wave()
    want = _serve(ContinuousBatchingEngine(tm, max_batch=2, fused=False,
                                           device="cpu", **SMALL),
                  Request, prompts, kws)
    for kind in ("prefix", "fused"):
        eng = _engines(jm, tm, kind)[1]
        cold = _serve(eng, Request, prompts, kws)
        warm = _serve(eng, Request, prompts, kws)
        assert cold == warm == want, kind
        assert eng.stats["hit_tokens"] > 0


def test_moe_spec_streams_equal_jax_and_non_spec(pair):
    """Speculative decode on the MoE model (pgmm): the verify step runs the
    same MoE layer over the K+1 window; streams equal the JAX spec
    engine's and the port's non-spec engine's, with the same acceptance."""
    jm, tm = pair
    _dispatch(jm, tm, "pgmm")
    rng = np.random.default_rng(5)
    motif = rng.integers(0, 256, (4,)).astype(np.int32)
    prompts = [np.tile(motif, 5), _prompt(9, 320), np.tile(motif[:3], 4)]
    kws = [dict(max_new_tokens=n) for n in (10, 7, 9)]
    spec = dict(max_len=64, page_size=8, block_size=2, fused=True)
    ref = _serve(ContinuousBatchingEngine(tm, max_batch=4, device="cpu",
                                          **spec), Request, prompts, kws)
    jeng = jserving.ContinuousBatchingEngine(
        jm, max_batch=4, speculative=jserving.SpecConfig(k=3), **spec)
    teng = ContinuousBatchingEngine(tm, max_batch=4, device="cpu",
                                    speculative=SpecConfig(k=3), **spec)
    want = _serve(jeng, jserving.Request, prompts, kws)
    got = _serve(teng, Request, prompts, kws)
    assert got == want == ref
    for k in ("spec_proposed", "spec_accepted", "spec_steps"):
        assert teng.stats[k] == jeng.stats[k], k
    assert teng.stats["spec_steps"] > 0


def test_moe_int8_streams_equal_jax(pair):
    """int8 KV pools on the MoE model (pgmm), the fused prefix-cache
    engine cold and warm: streams equal the JAX int8 engine's."""
    jm, tm = pair
    _dispatch(jm, tm, "pgmm")
    prompts, kws = _wave()
    jeng = jserving.ContinuousBatchingEngine(
        jm, max_batch=8, fused=True, kv_cache="int8",
        prefix_cache=jserving.PrefixCacheConfig(**CHUNKED), **SMALL)
    teng = ContinuousBatchingEngine(
        tm, max_batch=8, fused=True, device="cpu",
        kv_cache=KVCacheConfig(dtype="int8"),
        prefix_cache=PrefixCacheConfig(**CHUNKED), **SMALL)
    for _ in range(2):
        assert _serve(teng, Request, prompts, kws) == \
            _serve(jeng, jserving.Request, prompts, kws)
    assert teng._kv_quant_blocks > 0


def test_replays_credit_k5_with_the_captured_launches(pair):
    """The card path's bookkeeping with the eager step standing in for the
    graph: each replay credits K5 (``ops.pgmm.launches``) with the launches
    the capture recorded, never K6, and the streams do not change."""
    jm, tm = pair
    _dispatch(jm, tm, "pgmm")
    prompts, kws = _wave()
    ref = _serve(_engines(jm, tm, "fused")[1], Request, prompts, kws)
    eng = _engines(jm, tm, "fused")[1]
    eng._graph = types.SimpleNamespace(replay=eng._fused_step)
    per_replay = 3 * tm.config.num_hidden_layers
    eng._graph_counts = (0, 0, per_replay, 0)
    k5, k6 = tgm.pgmm.launches, tgm.pgmm_dw.launches
    assert _serve(eng, Request, prompts, kws) == ref
    replays = eng.stats["graph_replays"]
    assert replays == eng.stats["decode_steps"] > 0
    assert tgm.pgmm.launches - k5 == per_replay * replays
    assert tgm.pgmm_dw.launches == k6
