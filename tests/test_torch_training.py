"""Port training (paddle_tpu_torch: Llama loss, gradients, Engine) against
the JAX package on carried ``LlamaConfig.tiny()`` weights (fp32, CPU).

Tolerances, from what both sides compute (fp32 everywhere; only the
summation orders of the BLAS calls, the attention fallback and the chunked
CE differ):
- losses: relative 1e-5 (measured <= 2e-7);
- gradients: max abs error <= 1e-5 * max(1, max |jax grad|) per parameter;
- three ``Engine.step``s: the same losses (relative 1e-5), the same step
  count, ``m`` and ``v`` within 1e-4 of each moment's largest magnitude
  (measured <= 5e-6), and parameters within 2 * lr * steps = 6e-3 of each
  other with at most 0.1% of all elements more than 2e-5 apart. Adam
  normalises each update, so an element whose gradient is close to
  rounding noise can move by up to ``lr`` per step either way: 2 * lr *
  steps is that bound. Measured: every element within 1.8e-6 untied; tied,
  one element of 90,432 (in an o_proj weight) 2.4e-5 apart, the rest
  within 1.8e-6.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.auto_parallel import Engine as JaxEngine
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.distributed import Engine
from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                Request)
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.weights import (engine_state_from_jax,
                                      engine_state_to_host, load_jax_state,
                                      state_from_jax_layer)

torch.set_num_threads(1)

# the module (``paddle_tpu_torch.ops.flash_attention`` the attribute is the
# function of that name)
fa_mod = importlib.import_module("paddle_tpu_torch.ops.flash_attention")


def _pair(tie):
    paddle.seed(21)
    jm = JaxLlama(JaxConfig.tiny(tie_word_embeddings=tie))
    tm = LlamaForCausalLM(LlamaConfig.tiny(tie_word_embeddings=tie),
                          device="cpu")
    load_jax_state(tm, state_from_jax_layer(jm))
    return jm, tm


def _batch(seed, b=2, s=24):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, (b, s)).astype(np.int32)
    labels = ids.copy()
    labels[0, 5] = labels[1, 17] = -100
    return ids, labels


@pytest.fixture(scope="module", params=[False, True], ids=["untied", "tied"])
def pair(request):
    return _pair(request.param)


def test_fused_and_unfused_loss_match_jax(pair):
    jm, tm = pair
    ids, labels = _batch(0)
    jfused = float(jm.loss_fn(jnp.asarray(ids), jnp.asarray(labels)))
    junfused = float(jm(paddle.to_tensor(ids), paddle.to_tensor(labels)))
    tids, tlabels = torch.from_numpy(ids), torch.from_numpy(labels)
    fused = tm.loss_fn(tids, tlabels)
    unfused = tm(tids, labels=tlabels)
    assert fused.ndim == 0 and fused.dtype == torch.float32
    np.testing.assert_allclose(fused.item(), jfused, rtol=1e-5)
    np.testing.assert_allclose(unfused.item(), junfused, rtol=1e-5)
    np.testing.assert_allclose(fused.item(), unfused.item(), rtol=1e-5)


def test_every_gradient_matches_jax(pair):
    jm, tm = pair
    ids, labels = _batch(1)
    je = JaxEngine(jm, mesh=None)
    jgrads = jax.grad(je._pure_loss)(je.params, jnp.asarray(ids),
                                     jnp.asarray(labels))
    jg = dict(zip(je._param_names, jgrads))
    names = [n for n, _ in tm.named_parameters()]
    loss = tm.loss_fn(torch.from_numpy(ids), torch.from_numpy(labels))
    grads = torch.autograd.grad(loss, list(tm.parameters()))
    assert sorted(names) == sorted(jg)
    for name, g in zip(names, grads):
        ref = np.asarray(jg[name])
        err = np.abs(g.numpy() - ref).max()
        assert err <= 1e-5 * max(1.0, np.abs(ref).max()), (name, err)


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_three_engine_steps_match_jax(tie):
    jm, tm = _pair(tie)
    batches = [_batch(10 + i) for i in range(3)]
    je = JaxEngine(jm, mesh=None, lr=1e-3)
    te = Engine(tm, lr=1e-3)
    jl = [float(je.step(ids, lb)) for ids, lb in batches]
    tl = [te.step(torch.from_numpy(ids), torch.from_numpy(lb))
          for ids, lb in batches]
    assert all(t.ndim == 0 and not t.requires_grad for t in tl)
    np.testing.assert_allclose([t.item() for t in tl], jl, rtol=1e-5)
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
    for key in ("m", "v"):
        assert sorted(ts[key]) == sorted(js[key])
        for name, ref in js[key].items():
            err = np.abs(ts[key][name] - ref).max()
            assert err <= 1e-4 * np.abs(ref).max(), (key, name, err)
    # the JAX state crosses back in by name: a resumed port engine takes
    # the same fourth step as the JAX engine
    te2 = Engine(LlamaForCausalLM(LlamaConfig.tiny(tie_word_embeddings=tie),
                                  device="cpu"), lr=1e-3)
    te2.set_state_dict(js)
    ids, lb = _batch(20)
    np.testing.assert_allclose(
        te2.step(torch.from_numpy(ids), torch.from_numpy(lb)).item(),
        float(je.step(ids, lb)), rtol=1e-5)
    assert int(te2.step_count) == 4


def test_unported_training_paths_raise():
    """What stays refused: the guard with a pluggable optimizer (JAX's
    ValueError; the guard itself is ported: tests/test_torch_numeric_guard.
    py); a mesh that is not one (meshes are ported: tests/test_torch_dist_
    engine.py); an optimizer that is not one; invalid remat settings.
    Remat itself is ported (tests/test_torch_remat.py), and so is pipeline
    parallelism (tests/test_torch_pipeline.py): with no pp mesh the
    engine takes the pipeline's arguments and runs no pipeline, as JAX's
    does."""
    assert LlamaForCausalLM(LlamaConfig.tiny(recompute=True),
                            device="cpu").remat_policy() is not None
    with pytest.raises(ValueError, match="remat_policy"):
        LlamaConfig.tiny(remat_policy="most")
    with pytest.raises(ValueError, match="remat_every"):
        LlamaConfig.tiny(remat_every=0)
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    with pytest.raises(TypeError, match="not a mesh"):
        Engine(tm, mesh=object())
    with pytest.raises(TypeError, match="Optimizer, got object"):
        Engine(tm, optimizer=object())
    from paddle_tpu_torch.framework.numeric_guard import GuardPolicy
    from paddle_tpu_torch.optimizer import SGD
    with pytest.raises(ValueError, match="guard supports the built-in"):
        Engine(tm, guard=GuardPolicy(), optimizer=SGD())
    assert not Engine(tm, n_micro=2, pp_schedule="zb")._pp


def test_serving_builds_no_graph(monkeypatch):
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    calls = []
    real = fa_mod.flash_attention_forward

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    launches0 = real.launches
    monkeypatch.setattr(fa_mod, "flash_attention_forward", spy)
    eng = ContinuousBatchingEngine(tm, max_batch=2, max_len=32, page_size=8,
                                   block_size=4, device="cpu")
    rng = np.random.default_rng(4)
    reqs = [Request(rng.integers(0, 256, (n,)).astype(np.int32),
                    max_new_tokens=5) for n in (9, 12, 6)]
    for r in reqs:
        eng.add_request(r)
    eng.run_until_done()
    assert all(len(r.output) == 5 for r in reqs)
    assert calls == [] and real.launches == launches0
    for kp, vp in eng.caches["kv"]:
        assert not kp.requires_grad and not vp.requires_grad
    toks = torch.zeros(2, dtype=torch.long)
    logits, _ = tm.paged_token_step(toks, eng.caches,
                                    torch.zeros(2, dtype=torch.int32))
    assert not logits.requires_grad and calls == []
