"""Port GPT (paddle_tpu_torch.models.gpt) against the JAX package's on
carried ``GPTConfig.tiny()`` weights (fp32, CPU): the training forward,
loss, gradients and ``Engine`` steps, the dense and paged ``generate``,
and the serving engines.

Tolerances, from what both sides compute (fp32; only BLAS summation
orders and the attention fallbacks differ):
- logits: absolute 1e-4 (measured ~3e-7); losses relative 1e-5;
- gradients: max abs error <= 1e-5 * max(1, max |jax grad|) per
  parameter, the tied ``gpt.wte`` (embedding and lm head) and ``gpt.wpe``
  among them;
- three ``Engine.step``s: losses relative 1e-5; parameters within 2 * lr
  * steps, at most 0.1% of elements more than 2e-5 apart (the bounds of
  tests/test_torch_training.py); moments within 1e-4 of each one's
  largest magnitude after the first step and 1e-3 after the third (why:
  in the test);
- greedy token streams: exactly equal (the port's legacy engine, the JAX
  engine and both packages' ``generate``; warm == cold; fused == legacy;
  speculative == non-speculative; two int8 engines byte for byte).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.auto_parallel import Engine as JaxTrainer
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.inference.serving import Request as JaxRequest
from paddle_tpu.models import GPTConfig as JaxConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu_torch.distributed import Engine
from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                PrefixCacheConfig, Request,
                                                SpecConfig)
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.observability import TraceRecorder
from paddle_tpu_torch.weights import (engine_state_from_jax,
                                      engine_state_to_host, load_jax_state,
                                      state_from_jax_layer)

torch.set_num_threads(1)

fa_mod = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
ATOL = 1e-4
ENGINE = dict(max_batch=2, max_len=32, page_size=8)
# the wave: a 12-token motif prompt (spec drafts accept on it), two short
# ones; more requests than legacy slots
LENS, NEW = (4, 6, 12), (4, 5, 9)


def _pair(**over):
    paddle.seed(12)
    jm = JaxGPT(JaxConfig.tiny(**over))
    tm = GPTForCausalLM(GPTConfig.tiny(**over), device="cpu")
    load_jax_state(tm, state_from_jax_layer(jm))
    return jm, tm


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _batch(seed, b=2, s=24):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, (b, s)).astype(np.int32)
    labels = ids.copy()
    labels[0, 5] = labels[1, 17] = -100
    return ids, labels


def _prompts():
    rng = np.random.default_rng(2)
    motif = rng.integers(0, 256, (4,)).astype(np.int32)
    return [rng.integers(0, 256, (LENS[0],)).astype(np.int32),
            rng.integers(0, 256, (LENS[1],)).astype(np.int32),
            np.tile(motif, LENS[2] // 4)]


def _serve(engine, request_cls, prompts=None):
    prompts = _prompts() if prompts is None else prompts
    reqs = [request_cls(p, max_new_tokens=k) for p, k in zip(prompts, NEW)]
    for r in reqs:
        engine.add_request(r)
    engine.run_until_done()
    return [list(r.output) for r in reqs]


@pytest.fixture(scope="module")
def jax_streams(pair):
    """The JAX legacy engine's greedy streams of the wave (one compile
    wave for the module)."""
    jm, _ = pair
    return _serve(JaxEngine(jm, **ENGINE), JaxRequest)


def _grads(model, ids, labels):
    loss = model.loss_fn(torch.from_numpy(ids), torch.from_numpy(labels))
    names = [n for n, _ in model.named_parameters()]
    return loss, dict(zip(names, torch.autograd.grad(
        loss, list(model.parameters()))))


def _jax_grads(jm, ids, labels):
    je = JaxTrainer(jm, mesh=None)
    g = jax.grad(je._pure_loss)(je.params, jnp.asarray(ids),
                                jnp.asarray(labels))
    return dict(zip(je._param_names, g))


def _assert_grads(grads, jgrads):
    assert sorted(grads) == sorted(jgrads)
    for name, g in grads.items():
        ref = np.asarray(jgrads[name])
        err = np.abs(g.numpy() - ref).max()
        assert err <= 1e-5 * max(1.0, np.abs(ref).max()), (name, err)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def test_logits_and_loss_match_jax(pair):
    jm, tm = pair
    ids, labels = _batch(0)
    logits = tm(torch.from_numpy(ids))
    assert logits.shape == (2, 24, 256) and logits.dtype == torch.float32
    ref = np.asarray(jm(paddle.to_tensor(ids))._data)
    np.testing.assert_allclose(logits.detach().numpy(), ref, atol=ATOL,
                               rtol=0)
    jloss = float(jm.loss_fn(jnp.asarray(ids), jnp.asarray(labels)))
    loss = tm.loss_fn(torch.from_numpy(ids), torch.from_numpy(labels))
    assert loss.ndim == 0 and loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    np.testing.assert_allclose(
        tm(torch.from_numpy(ids), torch.from_numpy(labels)).item(), jloss,
        rtol=1e-5)


def test_every_gradient_matches_jax(pair):
    """The tied wte takes the embedding's and the lm head's gradient in
    one parameter; wpe and every bias are held too."""
    jm, tm = pair
    ids, labels = _batch(1)
    _, grads = _grads(tm, ids, labels)
    assert {"gpt.wte", "gpt.wpe", "gpt.layers.0.attn.qkv_bias"} <= set(grads)
    assert "lm_head_weight" not in grads
    _assert_grads(grads, _jax_grads(jm, ids, labels))


def _assert_moments(js, ts, tol):
    for key in ("m", "v"):
        assert sorted(ts[key]) == sorted(js[key])
        for name, ref in js[key].items():
            err = np.abs(ts[key][name] - ref).max()
            assert err <= tol * np.abs(ref).max(), (key, name, err)


def test_three_engine_steps_match_jax():
    jm, tm = _pair()
    batches = [_batch(10 + i) for i in range(3)]
    je = JaxTrainer(jm, mesh=None, lr=1e-3)
    te = Engine(tm, lr=1e-3)
    # the tied embedding is listed once and decays (ndim >= 2) as JAX's
    assert te._param_names.count("gpt.wte") == 1
    assert te._decay_mask[te._param_names.index("gpt.wte")]
    assert not te._decay_mask[te._param_names.index("gpt.ln_f.bias")]
    jl, tl = [], []
    for i, (ids, lb) in enumerate(batches):
        jl.append(float(je.step(ids, lb)))
        tl.append(te.step(torch.from_numpy(ids), torch.from_numpy(lb)).item())
        if i == 0:
            # one step: the moments are the clipped gradients' alone
            _assert_moments(engine_state_from_jax(je),
                            engine_state_to_host(te), 1e-4)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    js, ts = engine_state_from_jax(je), engine_state_to_host(te)
    assert js["step"] == ts["step"] == 3
    lr, steps = 1e-3, 3
    far = total = 0
    for name, ref in js["model"].items():
        err = np.abs(ts["model"][name] - ref)
        assert err.max() <= 2 * lr * steps, (name, err.max())
        far += int((err > 2e-5).sum())
        total += err.size
    assert far <= 1e-3 * total, (far, total)
    # after the first step the parameters differ where Adam normalised a
    # rounding-noise gradient (one fc_weight element 7.7e-5 apart,
    # measured), which moves the later gradients by ~1e-4 of their scale
    # (measured 1.8e-4): chip_smoke.py's card-vs-CPU moment bound, 1e-3
    _assert_moments(js, ts, 1e-3)


def _spy_flash(monkeypatch):
    """Count the CPU flash forwards with lse (the training op's plain
    side)."""
    calls = []
    real = fa_mod.flash_attention_reference_lse

    def spy(q, k, v, causal=False, scale=None):
        calls.append(causal)
        return real(q, k, v, causal, scale)

    monkeypatch.setattr(fa_mod, "flash_attention_reference_lse", spy)
    return calls


def test_recompute_equals_no_recompute(pair, monkeypatch):
    """recompute=True checkpoints every layer whole while autograd
    records: the flash forward runs again in the backward (2 L calls
    against L), and the loss and gradients are the same."""
    _, tm = pair
    ids, labels = _batch(2)
    calls = _spy_flash(monkeypatch)
    loss, grads = _grads(tm, ids, labels)
    assert calls == [True] * 2
    rm = GPTForCausalLM(GPTConfig.tiny(recompute=True), device="cpu")
    rm.load_state_dict(tm.state_dict())
    calls.clear()
    rloss, rgrads = _grads(rm, ids, labels)
    assert calls == [True] * 4
    assert rloss.item() == loss.item()
    for name, g in grads.items():
        torch.testing.assert_close(rgrads[name], g, rtol=0, atol=1e-7)
    with torch.no_grad():       # no checkpoint without autograd
        calls.clear()
        rm(torch.from_numpy(ids))
    assert calls == []


def test_xla_attention_flag_matches_jax(monkeypatch):
    """use_flash_attention=False: the dense _xla_attention in both
    packages, no flash op."""
    jm, tm = _pair(use_flash_attention=False)
    ids, labels = _batch(3)
    calls = _spy_flash(monkeypatch)
    np.testing.assert_allclose(
        tm(torch.from_numpy(ids)).detach().numpy(),
        np.asarray(jm(paddle.to_tensor(ids))._data), atol=ATOL, rtol=0)
    loss, grads = _grads(tm, ids, labels)
    assert calls == []
    np.testing.assert_allclose(
        loss.item(), float(jm.loss_fn(jnp.asarray(ids), jnp.asarray(labels))),
        rtol=1e-5)
    _assert_grads(grads, _jax_grads(jm, ids, labels))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _port_engine(tm, **kw):
    return ContinuousBatchingEngine(tm, device="cpu", **{**ENGINE, **kw})


def _jax_generate(jm, prompt, k):
    return list(jm.generate(paddle.to_tensor(np.asarray(prompt)[None]),
                            max_new_tokens=k,
                            temperature=0.0).numpy()[0])


def test_legacy_engine_equals_jax_engine_and_generate(pair, jax_streams):
    """tests/test_serving_engine.py:75 through both packages: the port's
    legacy engine, the JAX engine and JAX's generate give one stream."""
    jm, tm = pair
    out = _serve(_port_engine(tm), Request)
    assert out == jax_streams
    assert [len(o) for o in out] == list(NEW)
    for p, k, o in zip(_prompts()[:2], NEW, out):
        assert o == _jax_generate(jm, p, k)
        assert o == tm.generate(p[None], max_new_tokens=k,
                                temperature=0.0)[0].tolist()


def test_prefix_cache_warm_equals_cold(pair, jax_streams):
    """tests/test_serving_prefix_cache.py:421: the radix cache's warm wave
    equals the cold one, which equals the legacy engine's."""
    _, tm = pair
    eng = _port_engine(tm, prefix_cache=PrefixCacheConfig(prefill_chunk=8,
                                                          extra_blocks=8))
    cold = _serve(eng, Request)
    hits = eng.stats["hit_tokens"]
    warm = _serve(eng, Request)
    assert cold == jax_streams and warm == cold
    assert eng.stats["hit_tokens"] - hits >= 8


def test_fused_and_speculative_equal_legacy(pair, jax_streams):
    """The fused engine (the captured step's body, run eagerly here) and
    the speculative one over it give the legacy streams; the spec drafts
    accept on the motif prompt."""
    _, tm = pair
    fused = _port_engine(tm, max_batch=4, block_size=4, fused=True,
                         prefix_cache=PrefixCacheConfig(extra_blocks=4))
    assert _serve(fused, Request) == jax_streams
    assert fused.stats["decode_steps"] > 0
    spec = _port_engine(tm, max_batch=4, block_size=4, fused=True,
                        prefix_cache=PrefixCacheConfig(extra_blocks=4),
                        speculative=SpecConfig(k=3))
    assert _serve(spec, Request) == jax_streams
    assert spec.stats["spec_steps"] > 0 and spec.stats["spec_accepted"] > 0


def test_int8_engines_are_byte_identical(pair):
    """Two identical int8-pool engines: the same streams and the same pool
    bytes (pages and scales)."""
    _, tm = pair
    runs = []
    for _ in range(2):
        eng = _port_engine(tm, max_batch=4, block_size=4, fused=True,
                           prefix_cache=PrefixCacheConfig(extra_blocks=4),
                           kv_cache="int8")
        runs.append((_serve(eng, Request), eng.caches["kv"]))
    (a, kva), (b, kvb) = runs
    assert a == b and [len(o) for o in a] == list(NEW)
    for pa, pb in zip(kva, kvb):
        for x, y in zip(pa, pb):
            assert torch.equal(x.data, y.data)
            assert torch.equal(x.scale, y.scale)


def test_generate_dense_and_paged_equal_jax(pair):
    """20 new tokens (across a decode block) from 3 prompts of 9, dense
    and paged caches."""
    jm, tm = pair
    ids = np.random.default_rng(4).integers(1, 256, (3, 9)).astype(np.int32)
    ref = jm.generate(paddle.to_tensor(ids), max_new_tokens=20,
                      temperature=0.0).numpy()
    for impl in ("dense", "paged"):
        got = tm.generate(ids, max_new_tokens=20, temperature=0.0,
                          cache_impl=impl, page_size=8)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)


def test_left_padded_generate_matches_unpadded(pair):
    """tests/test_generation.py:125: a left-padded row's learned positions
    start at its first real token, so it generates its unpadded stream;
    the padded batch equals JAX's."""
    jm, tm = pair
    rng = np.random.default_rng(7)
    p1 = rng.integers(1, 256, (1, 5)).astype(np.int32)
    p2 = rng.integers(1, 256, (1, 3)).astype(np.int32)
    padded = np.vstack([p1, np.concatenate([np.zeros((1, 2), np.int32), p2],
                                           1)])
    mask = np.array([[1, 1, 1, 1, 1], [0, 0, 1, 1, 1]], np.int32)
    got = tm.generate(padded, max_new_tokens=4, temperature=0.0,
                      attention_mask=mask).numpy()
    for row, p in zip(got, (p1, p2)):
        np.testing.assert_array_equal(
            row, tm.generate(p, max_new_tokens=4, temperature=0.0)[0])
    np.testing.assert_array_equal(got, jm.generate(
        paddle.to_tensor(padded), max_new_tokens=4, temperature=0.0,
        attention_mask=paddle.to_tensor(mask)).numpy())


def test_position_table_limit_is_enforced(pair):
    """generate() (tests/test_generation.py:144) and the engine
    (tests/test_serving_engine.py:107) refuse a request past the learned
    position table; the engine refuses it before the tracer's submit
    stamp, so the refused request leaves none."""
    _, tm = pair
    n = tm.config.max_position_embeddings
    with pytest.raises(ValueError, match="position table"):
        tm.generate(np.ones((1, n - 2), np.int32), max_new_tokens=8,
                    temperature=0.0)
    tr = TraceRecorder()
    eng = ContinuousBatchingEngine(tm, max_batch=1, max_len=512, page_size=8,
                                   device="cpu", tracer=tr)
    req = Request(np.zeros(100, np.int32), max_new_tokens=100)
    with pytest.raises(ValueError, match="position"):
        eng.add_request(req)
    assert tr.counters()["events"] == 0 and tr.lifecycle(req.rid) == []
    assert not eng.has_work()
    ok = Request(np.zeros(100, np.int32), max_new_tokens=n - 100)
    eng.add_request(ok)
    assert tr.lifecycle(ok.rid) == ["submit"]


def test_token_step_clips_positions_to_the_table():
    """Positions past the learned table are clipped on the device (JAX
    :337), not read from the host: a row at position 20 over a 32-token
    cache of a 16-position model embeds with wpe[15], and the step runs
    (an unclipped gather would index past wpe)."""
    tm = GPTForCausalLM(GPTConfig.tiny(max_position_embeddings=16),
                        device="cpu")
    pos = torch.tensor([5, 20], dtype=torch.int32)
    toks = torch.tensor([3, 7])
    x = tm.gpt.embed(toks[:, None], tm._positions(pos, 1, toks.device))
    torch.testing.assert_close(
        x[:, 0], tm.gpt.wte[toks] + tm.gpt.wpe[[5, 15]], rtol=0, atol=0)
    logits, _ = tm.paged_token_step(toks, tm._init_paged_caches(
        2, 32, 8, device="cpu"), pos)
    assert logits.shape == (2, 256) and torch.isfinite(logits).all()


def test_refusals_this_slice_touches_name_their_items(pair):
    """sequence_parallel is ported with the distributed slice (item 6's
    first half): the flag is taken and, with no mesh, changes nothing; an
    optimizer that is not one raises TypeError."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    _, tm = pair
    assert LlamaConfig.tiny(sequence_parallel=True).sequence_parallel
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (2, 8)))
    a, b = (LlamaForCausalLM(LlamaConfig.tiny(sequence_parallel=sp),
                             device="cpu", seed=1).loss_fn(ids, ids)
            for sp in (False, True))
    assert torch.equal(a, b)
    with pytest.raises(TypeError, match="Optimizer, got object"):
        Engine(tm, optimizer=object())
