"""Port brownout (``ContinuousBatchingEngine(brownout=...)``) against the
JAX engine on carried tiny-Llama weights (fp32, CPU).

The counterpart of tests/test_serving_recovery.py::
test_brownout_enters_serves_legacy_exits_hysteretically, on the legacy and
the fused prefix-cache engine: sustained pool pressure enters brownout
(idle cached blocks flushed, the cache not matched), the deferred request
serves the cache-off stream once the pool frees, the engine exits after
``exit_after`` pressure-free steps and matches again. The port's engine
and the JAX engine are driven through the same steps: the state, the
stats and every stream must be equal at each point. Then the whole-prompt
prefill of brownout (chunked interleaving off) and the knob's defaults.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import serving as jserving
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.inference.serving import (BrownoutConfig,
                                                ContinuousBatchingEngine,
                                                PrefixCacheConfig, Request)
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.weights import load_jax_state, state_from_jax_layer

torch.set_num_threads(1)

STATS = ("brownouts", "brownout_steps", "hit_tokens", "miss_tokens",
         "evictions", "cow_copies")


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


class _Twin:
    """The JAX engine and the port's, built alike and driven alike."""

    def __init__(self, jm, tm, fused, exit_after=2):
        kw = dict(max_batch=2, max_len=32, page_size=8, block_size=2,
                  fused=fused)
        knobs = dict(enter_after=2, exit_free_frac=0.5,
                     exit_after=exit_after)
        self.j = jserving.ContinuousBatchingEngine(
            jm, prefix_cache=jserving.PrefixCacheConfig(prefill_chunk=8),
            brownout=jserving.BrownoutConfig(**knobs), **kw)
        self.t = ContinuousBatchingEngine(
            tm, prefix_cache=PrefixCacheConfig(prefill_chunk=8),
            brownout=BrownoutConfig(**knobs), device="cpu", **kw)

    def add(self, prompt, n):
        reqs = (jserving.Request(prompt, max_new_tokens=n),
                Request(prompt, max_new_tokens=n))
        self.j.add_request(reqs[0])
        self.t.add_request(reqs[1])
        return reqs

    def each(self, fn):
        fn(self.j)
        fn(self.t)

    def step(self, n=1):
        for _ in range(n):
            self.each(lambda e: e.step())
        self.check()

    def run(self):
        self.each(lambda e: e.run_until_done(max_steps=300))
        self.check()

    def check(self):
        assert self.t._brownout_active == self.j._brownout_active
        assert {k: self.t.stats[k] for k in STATS} == \
            {k: self.j.stats[k] for k in STATS}
        assert self.t._alloc.free_blocks == self.j._alloc.free_blocks


@pytest.mark.parametrize("fused", [False, True], ids=["legacy", "fused"])
def test_brownout_enters_serves_cache_off_exits_hysteretically(pair, fused):
    jm, tm = pair
    tw = _Twin(jm, tm, fused)
    pa = _prompt(8, 240)                         # exactly one full page
    ra = tw.add(pa, 8)
    tw.run()                                     # registers pa's chain
    assert tw.t._radix.match(pa)
    tw.each(lambda e: e._alloc.hold(e._alloc.free_blocks))  # pool exhausted
    rb = tw.add(pa, 9)                           # 3 pages; 1 evictable
    hits0 = tw.t.stats["hit_tokens"]
    tw.step(3)                                   # deferrals accumulate
    assert tw.t._brownout_active and tw.t.stats["brownouts"] == 1
    assert not tw.t._radix.match(pa)             # idle cache flushed
    assert rb[1]._n_out == 0                     # still deferred
    tw.each(lambda e: e._alloc.release_held())
    tw.run()
    assert tw.t.stats["hit_tokens"] == hits0     # admission skipped it
    ref = tm.generate(pa[None], max_new_tokens=9, temperature=0.0,
                      max_length=32).tolist()[0]
    assert rb[1].tokens == list(rb[0].tokens) == ref
    tw.step(4)                                   # pressure-free, pool free
    assert not tw.t._brownout_active             # hysteretic exit
    assert tw.t.stats["brownout_steps"] > 0
    rc = tw.add(pa, 8)                           # cache on: registers
    tw.run()
    rd = tw.add(pa, 8)
    tw.run()
    assert tw.t.stats["hit_tokens"] > hits0      # ...and matches again
    for r in (ra, rc, rd):
        assert r[1].tokens == list(r[0].tokens) == ref[:8]
    if fused:
        assert tw.t.stats["graph_captures"] == 0   # no graph on the CPU
        assert not tw.t._dev_act.any()


@pytest.mark.parametrize("fused", [False, True], ids=["legacy", "fused"])
def test_brownout_prefills_whole_prompts(pair, fused):
    """In brownout a 24-token prompt (3 chunks of 8) prefills whole in its
    admission step while the other slot decodes; its stream is the
    cache-off one, as in the JAX engine."""
    jm, tm = pair
    tw = _Twin(jm, tm, fused, exit_after=100)
    tw.each(lambda e: setattr(e, "_brownout_active", True))
    rs = tw.add(_prompt(6, 250), 10)
    tw.step()                                    # short prompt decoding
    long_p = _prompt(24, 251)
    rl = tw.add(long_p, 4)
    tw.step()                                    # whole prompt, one tick
    assert not tw.t._prefill_next and rl[1]._n_out >= 1
    assert tw.t.stats["hit_tokens"] == 0
    tw.run()
    for r, p, n in ((rs, _prompt(6, 250), 10), (rl, long_p, 4)):
        assert r[1].tokens == list(r[0].tokens) == tm.generate(
            p[None], max_new_tokens=n, temperature=0.0).tolist()[0]


def test_brownout_config_defaults_and_prefix_only(pair):
    _, tm = pair
    assert BrownoutConfig() == BrownoutConfig(**{
        k: getattr(jserving.BrownoutConfig(), k)
        for k in ("enter_after", "exit_free_frac", "exit_after")})
    on = ContinuousBatchingEngine(tm, max_batch=2, max_len=32, page_size=8,
                                  prefix_cache=True, brownout=True,
                                  device="cpu")
    assert on._brownout_cfg == BrownoutConfig()
    assert on.stats["brownouts"] == on.stats["brownout_steps"] == 0
    # without a prefix cache there is nothing to brown out: it stays off
    off = ContinuousBatchingEngine(tm, max_batch=2, max_len=32, page_size=8,
                                   brownout=True, device="cpu")
    assert off._brownout_cfg is None and "brownouts" not in off.stats
