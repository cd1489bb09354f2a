"""Port serving engine (paddle_tpu_torch.inference.serving) against the JAX
legacy ``ContinuousBatchingEngine`` on carried tiny-Llama weights (fp32,
CPU): greedy token streams must be EXACTLY equal — mixed prompt lengths
with a bucket (so exact-length and re-stepped prompts both run), an eos
request, and more requests than slots. The rest pins the port's own
contracts: backpressure, deadlines, seeded sampling, and refusing the
paths later slices bring.
"""

import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.inference.serving import Request as JaxRequest
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                EngineSaturated, Request,
                                                RequestShed)
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.weights import load_jax_state, state_from_jax_layer

torch.set_num_threads(1)

ENGINE = dict(max_batch=2, max_len=48, page_size=8, block_size=4,
              prompt_buckets=[16])
LENS = (16, 9, 12, 5, 16)       # bucket 16: exact and padded (re-step) rows
NEW = (6, 9, 5, 7, 4)


@pytest.fixture(scope="module")
def pair():
    paddle.seed(3)
    jm = JaxLlama(JaxConfig.tiny())
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_jax_state(tm, state_from_jax_layer(jm))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, (n,)).astype(np.int32) for n in LENS]
    return jm, tm, prompts


def _wave(engine, request_cls, prompts, eos=None):
    """Three requests, one step, two more: 5 requests through 2 slots.
    Request 1 carries ``eos`` (when given)."""
    reqs = [request_cls(p, max_new_tokens=k,
                        eos_token_id=eos if i == 1 else None)
            for i, (p, k) in enumerate(zip(prompts, NEW))]
    for r in reqs[:3]:
        engine.add_request(r)
    engine.step()
    for r in reqs[3:]:
        engine.add_request(r)
    done = engine.run_until_done()
    assert len(done) == len(reqs) and not engine.has_work()
    return [r.output for r in reqs]


def _port_engine(tm, **kw):
    return ContinuousBatchingEngine(tm, device="cpu", **{**ENGINE, **kw})


def test_greedy_streams_equal_jax_engine(pair):
    jm, tm, prompts = pair
    free = _wave(_port_engine(tm), Request, prompts)
    # an eos that request 1 emits mid-decode (its 4th token), so the eos
    # path stops it early in both engines
    eos = free[1][3]
    assert eos not in free[1][:3]
    ref = _wave(JaxEngine(jm, **ENGINE), JaxRequest, prompts, eos=eos)
    out = _wave(_port_engine(tm), Request, prompts, eos=eos)
    assert out == ref
    assert out[1] == free[1][:4]
    assert [len(o) for i, o in enumerate(out) if i != 1] == \
        [k for i, k in enumerate(NEW) if i != 1]


def test_max_queue_raises_engine_saturated(pair):
    _, tm, prompts = pair
    eng = _port_engine(tm, max_queue=1)
    eng.add_request(Request(prompts[0], max_new_tokens=2))
    with pytest.raises(EngineSaturated):
        eng.add_request(Request(prompts[1], max_new_tokens=2))


def test_deadline_evicts_queued_and_active(pair):
    _, tm, prompts = pair
    eng = _port_engine(tm, max_batch=1)
    active = Request(prompts[0], max_new_tokens=30, deadline_s=0.05)
    queued = Request(prompts[1], max_new_tokens=4, deadline_s=0.05)
    survivor = Request(prompts[2], max_new_tokens=3)
    for r in (active, queued, survivor):
        eng.add_request(r)
    eng.step()                      # admits `active` into the only slot
    assert eng.active_slots() == 1
    time.sleep(0.06)
    done = eng.run_until_done()
    assert active.failed and "deadline" in active.error
    assert queued.failed and queued.output == []
    assert not survivor.failed and len(survivor.output) == 3
    assert set(done) == {active.rid, queued.rid, survivor.rid}


def test_infeasible_deadline_is_shed_at_submit(pair):
    _, tm, prompts = pair
    eng = _port_engine(tm)
    eng.add_request(Request(prompts[0], max_new_tokens=8))
    eng.run_until_done()            # arms the measured decode rate
    assert eng._ema_tok_s and eng._ema_tok_s > 0
    with pytest.raises(RequestShed, match="PT-SRV-003"):
        eng.add_request(Request(prompts[1], max_new_tokens=20,
                                deadline_s=1e-9))
    assert eng.stats["shed"] == 1 and not eng.has_work()


def test_top_k_one_equals_greedy(pair):
    _, tm, prompts = pair
    greedy = Request(prompts[1], max_new_tokens=8)
    sampled = Request(prompts[1], max_new_tokens=8, temperature=0.9,
                      top_k=1, seed=5)
    for r in (greedy, sampled):
        eng = _port_engine(tm)
        eng.add_request(r)
        eng.run_until_done()
    assert sampled.output == greedy.output


def test_seeded_stream_independent_of_batch_composition(pair):
    _, tm, prompts = pair

    def sampled():
        return Request(prompts[3], max_new_tokens=10, temperature=1.0,
                       top_p=0.9, seed=7)

    alone = sampled()
    eng = _port_engine(tm)
    eng.add_request(alone)
    eng.run_until_done()
    crowded = sampled()
    eng = _port_engine(tm)
    eng.add_request(Request(prompts[0], max_new_tokens=5))
    eng.add_request(Request(prompts[2], max_new_tokens=3, temperature=0.7))
    eng.add_request(crowded)        # arrives third: waits for a slot
    eng.run_until_done()
    assert crowded.output == alone.output
    other = Request(prompts[3], max_new_tokens=10, temperature=1.0,
                    top_p=0.9, seed=8)
    eng = _port_engine(tm)
    eng.add_request(other)
    eng.run_until_done()
    assert other.output != alone.output


@pytest.mark.parametrize("kw,match", [
    (dict(fused=True), "fused"),
    (dict(max_batch=32), "fused"),
    (dict(prefix_cache=True), "prefix"),
    (dict(speculative=True), "speculative"),
    (dict(kv_cache="int8"), "int8"),
    (dict(mesh=2), "mesh"),
    (dict(brownout=True), "brownout"),
    (dict(tracer=object()), "tracing"),
])
def test_unported_paths_raise(pair, kw, match):
    _, tm, _ = pair
    with pytest.raises(NotImplementedError, match=match):
        _port_engine(tm, **kw)


def test_rejects_out_of_vocab_and_oversized(pair):
    _, tm, prompts = pair
    eng = _port_engine(tm)
    with pytest.raises(ValueError, match="token ids"):
        eng.add_request(Request(np.asarray([1, 256]), max_new_tokens=2))
    with pytest.raises(ValueError, match="max_len"):
        eng.add_request(Request(prompts[0], max_new_tokens=40))
