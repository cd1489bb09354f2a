"""Port remat (paddle_tpu_torch: recompute=True with the four remat
policies and remat_every, the flash custom ops a policy saves, the MoE aux
loss and the switch gate's jitter under recompute) against the port
without remat and against the JAX package's remat on carried tiny weights
(fp32, CPU).

The JAX model applies remat only under tracing, so its side runs under
``jax.grad`` (jit): there ``jax.checkpoint`` with the same policy. On the
CPU the JAX flash path is its XLA fallback, whose residuals carry no names,
so the JAX side is a value reference here, not a count of saved kernels.
The port's counts come from a spy on the CPU implementation of the op
``paddle_tpu_torch::flash_fwd_lse`` (the plain forward with lse): a forward
the policy saves is not run again in the backward.

Tolerances:
- remat against no remat in the port: the same ops on the same values (a
  recompute replays the forward), so losses and gradients within 1e-6 x
  max(1, max |no-remat|) (measured: bitwise equal);
- against JAX: losses relative 1e-5, gradients max abs error <= 1e-5 x
  max(1, max |jax grad|) per parameter (fp32, other summation orders, as
  tests/test_torch_training.py);
- three ``Engine.step``s: as tests/test_torch_training.py.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

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

fa_mod = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
modeling = importlib.import_module("paddle_tpu_torch.models.llama.modeling")

POLICIES = ["flash", "flash_qkv", "flash_mlp", "full"]
LAYERS = 3    # remat_every=2 then checkpoints layers 0 and 2, not 1


def _close(got, ref, tol=1e-5, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max() if got.size else 0.0
    assert err <= tol * max(1.0, np.abs(ref).max()), (what, err)


def _batch(seed, b=2, s=24):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, (b, s)).astype(np.int32)
    labels = ids.copy()
    labels[0, 5] = labels[1, 17] = -100
    return ids, labels


def _cfg(**over):
    return {"num_hidden_layers": LAYERS, **over}


def _port(seed=0, **over):
    return LlamaForCausalLM(LlamaConfig.tiny(**_cfg(**over)), device="cpu",
                            seed=seed)


def _loss_and_grads(tm, ids, labels):
    loss = tm.loss_fn(torch.from_numpy(ids), torch.from_numpy(labels))
    return loss, torch.autograd.grad(loss, list(tm.parameters()))


@pytest.mark.parametrize("every", [1, 2])
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_loss_and_grads_match_no_remat_and_jax(policy, every):
    paddle.seed(21)
    jm = JaxLlama(JaxConfig.tiny(**_cfg(recompute=True, remat_policy=policy,
                                        remat_every=every)))
    tm = _port(recompute=True, remat_policy=policy, remat_every=every)
    plain = _port(recompute=False)
    state = state_from_jax_layer(jm)
    load_jax_state(tm, state)
    load_jax_state(plain, state)
    ids, labels = _batch(1)
    loss, grads = _loss_and_grads(tm, ids, labels)
    ploss, pgrads = _loss_and_grads(plain, ids, labels)
    names = [n for n, _ in tm.named_parameters()]
    _close(loss.detach(), ploss.detach(), 1e-6, "loss vs no remat")
    for name, g, pg in zip(names, grads, pgrads):
        _close(g, pg, 1e-6, name + " vs no remat")
    je = JaxEngine(jm, mesh=None)
    jloss, jgrads = jax.jit(jax.value_and_grad(je._pure_loss))(
        je.params, jnp.asarray(ids), jnp.asarray(labels))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    jg = dict(zip(je._param_names, jgrads))
    assert sorted(names) == sorted(jg)
    for name, g in zip(names, grads):
        _close(g, jg[name], what=name)


def _count_plain_forwards(monkeypatch):
    calls = []
    real = fa_mod.flash_attention_reference_lse

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(fa_mod, "flash_attention_reference_lse", spy)
    return calls


@pytest.mark.parametrize("policy,every,want", [
    ("flash", 1, LAYERS), ("flash_qkv", 1, LAYERS), ("flash_mlp", 1, LAYERS),
    ("flash", 2, LAYERS), ("full", 1, 2 * LAYERS),
    ("full", 2, LAYERS + (LAYERS + 1) // 2)])
def test_flash_forwards_per_step_follow_the_policy(monkeypatch, policy,
                                                   every, want):
    """A saved flash forward runs once a step (L); under 'full' each
    checkpointed layer runs it again in the backward (2L, or L + ceil(L/2)
    at remat_every=2)."""
    tm = _port(recompute=True, remat_policy=policy, remat_every=every)
    calls = _count_plain_forwards(monkeypatch)
    ids, labels = _batch(2)
    loss = tm.loss_fn(torch.from_numpy(ids), torch.from_numpy(labels))
    assert len(calls) == LAYERS
    torch.autograd.grad(loss, list(tm.parameters()))
    assert len(calls) == want


def test_remat_policy_hook_names_what_each_policy_saves():
    want = {"flash": {"flash_out", "flash_lse"},
            "flash_qkv": {"flash_out", "flash_lse", "attn_q", "attn_k",
                          "attn_v"},
            "flash_mlp": {"flash_out", "flash_lse", "mlp_act"}}
    for policy, names in want.items():
        tm = _port(recompute=True, remat_policy=policy, remat_every=2)
        assert tm.remat_policy().names == names
        assert [lyr.remat for lyr in tm.model.layers] == [True, False, True]
    assert _port(recompute=True, remat_policy="full").remat_policy() is None


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _backward_matmuls(tm, ids, labels):
    loss = tm.loss_fn(torch.from_numpy(ids), torch.from_numpy(labels))
    with _CountMatmuls() as count:
        torch.autograd.grad(loss, list(tm.parameters()))
    return count.n


@pytest.mark.parametrize("policy,recomputed", [
    ("full", 6), ("flash", 6), ("flash_qkv", 3), ("flash_mlp", 6)])
def test_each_policy_recomputes_only_the_projections_it_does_not_keep(
        policy, recomputed):
    """A dense layer runs 7 projections (q, k, v, o, gate, up, down). The
    backward of a checkpointed layer replays its region up to the last
    tensor the backward needs, the down projection's input, so 'full' and
    'flash' replay six (q, k, v, o, gate, up); 'flash_qkv' keeps q/k/v
    (their projections run outside the region) and replays o, gate, up;
    'flash_mlp' keeps the swiglu product (the region ends there) and still
    replays the six, as the JAX package's recomputes gate and up. Counted
    as the backward's matmuls beyond those of the same model without
    remat."""
    ids, labels = _batch(6)
    plain = _backward_matmuls(_port(recompute=False), ids, labels)
    got = _backward_matmuls(_port(recompute=True, remat_policy=policy),
                            ids, labels)
    assert got - plain == recomputed * LAYERS


@pytest.mark.parametrize("policy,every", [("flash_qkv", 1), ("full", 2)])
def test_three_remat_engine_steps_match_jax(policy, every):
    over = dict(recompute=True, remat_policy=policy, remat_every=every)
    paddle.seed(21)
    jm = JaxLlama(JaxConfig.tiny(**_cfg(**over)))
    tm = _port(**over)
    load_jax_state(tm, state_from_jax_layer(jm))
    batches = [_batch(10 + i) for i in range(3)]
    je = JaxEngine(jm, mesh=None, lr=1e-3)
    te = Engine(tm, lr=1e-3)
    jl = [float(je.step(ids, lb)) for ids, lb in batches]
    tl = [te.step(torch.from_numpy(ids), torch.from_numpy(lb)).item()
          for ids, lb in batches]
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
    for key in ("m", "v"):
        for name, ref in js[key].items():
            err = np.abs(ts[key][name] - ref).max()
            assert err <= 1e-4 * np.abs(ref).max(), (key, name, err)


def _moe(recompute, **over):
    return _port(seed=7, num_experts=4, num_hidden_layers=2,
                 recompute=recompute, **over)


@pytest.mark.parametrize("dispatch", ["auto", "scatter", "ragged"])
def test_moe_aux_loss_and_its_gradient_under_remat(dispatch):
    """As tests/test_moe.py:211: the aux loss is a checkpoint output; its
    value and gradient equal no remat, the recompute leaves no tensor in a
    gate's side channel, and the JAX remat model agrees."""
    remat, plain = _moe(True, moe_dispatch=dispatch), \
        _moe(False, moe_dispatch=dispatch)
    ids, labels = _batch(3)
    tids, tlabels = torch.from_numpy(ids), torch.from_numpy(labels)
    out = []
    for tm in (remat, plain):
        # one backward a forward: a region under selective checkpointing
        # takes one backward
        tm.loss_fn(tids, tlabels)
        aux = tm.moe_aux_loss()
        gaux = torch.autograd.grad(aux, list(tm.parameters()),
                                   allow_unused=True)
        loss = tm.loss_fn(tids, tlabels)
        out.append((loss, aux, gaux,
                    torch.autograd.grad(loss, list(tm.parameters()))))
        assert all(lyr.mlp.gate.loss is None for lyr in tm.model.layers)
    (loss, aux, gaux, g), (ploss, paux, pgaux, pg) = out
    assert aux.item() > 1.0
    _close(aux.detach(), paux.detach(), 1e-6, "aux")
    _close(loss.detach(), ploss.detach(), 1e-6, "loss")
    for a, b in zip(gaux, pgaux):
        assert (a is None) == (b is None)
        if a is not None:
            _close(a, b, 1e-6, "d aux")
    for a, b in zip(g, pg):
        _close(a, b, 1e-6, "d loss")
    paddle.seed(7)
    jm = JaxLlama(JaxConfig.tiny(num_experts=4, num_hidden_layers=2,
                                 recompute=True, moe_dispatch=dispatch))
    load_jax_state(remat, state_from_jax_layer(jm))
    loss = remat.loss_fn(tids, tlabels)
    aux = remat.moe_aux_loss()
    jloss, jaux = jax.jit(lambda i, lb: (jm.loss_fn(i, lb),
                                         jm.moe_aux_loss()))(
        jnp.asarray(ids), jnp.asarray(labels))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5)


def test_switch_moe_under_remat_in_training_matches_no_remat():
    """The switch gate's jitter draws from the model's generator; the
    recompute rewinds it, so the gradients equal those of the same model,
    same seed, without remat (both in training mode)."""
    over = dict(moe_gate="switch", moe_dispatch="scatter")
    remat, plain = _moe(True, **over), _moe(False, **over)
    assert remat.training and remat.model.layers[0].mlp.gate.switch_eps > 0
    ids, labels = _batch(4)
    loss, grads = _loss_and_grads(remat, ids, labels)
    ploss, pgrads = _loss_and_grads(plain, ids, labels)
    _close(loss.detach(), ploss.detach(), 1e-6, "loss")
    for (name, _), g, pg in zip(remat.named_parameters(), grads, pgrads):
        _close(g, pg, 1e-6, name)
    # the jitter is live: a second forward draws other noise
    loss2 = remat.loss_fn(torch.from_numpy(ids), torch.from_numpy(labels))
    assert loss2.item() != loss.item()


def test_serving_and_no_grad_forwards_never_checkpoint(monkeypatch):
    calls = []
    real = modeling.checkpoint

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(modeling, "checkpoint", spy)
    tm = _port(recompute=True, remat_every=2)
    eng = ContinuousBatchingEngine(tm, max_batch=2, max_len=32, page_size=8,
                                   block_size=4, device="cpu")
    rng = np.random.default_rng(4)
    reqs = [Request(rng.integers(0, 256, (n,)).astype(np.int32),
                    max_new_tokens=4) for n in (9, 12)]
    for r in reqs:
        eng.add_request(r)
    eng.run_until_done()
    assert all(len(r.output) == 4 for r in reqs)
    ids, labels = _batch(5)
    with torch.no_grad():
        tm.loss_fn(torch.from_numpy(ids), torch.from_numpy(labels))
        tm(torch.from_numpy(ids))
    assert calls == []
    tm.loss_fn(torch.from_numpy(ids), torch.from_numpy(labels))
    assert len(calls) == 2          # layers 0 and 2 of 3
