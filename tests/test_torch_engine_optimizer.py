"""``Engine(model, optimizer=X)`` of the port against the JAX Engine with the
same X, on carried ``LlamaConfig.tiny()`` weights (fp32, CPU, where the
plain attention runs: no kernel launches).

X: AdamW under ``LinearWarmup(CosineAnnealingDecay)`` with
``apply_decay_param_fun`` and a global-norm clip, Lamb, RAdam, NAdam,
Adagrad, Momentum with weight decay. The schedule advances on the host
between steps (``_lr_step``), as a training loop drives it.

Tolerances (three steps, both sides fp32; the loss and gradients agree to
~1e-7, tests/test_torch_training.py):
- losses: relative 1e-5;
- parameters: within 2 * lr * steps of each other (an adaptive optimizer
  normalises each update, so an element whose gradient is rounding noise
  may move by up to lr a step either way), with at most 0.1% of the
  elements more than 2e-5 apart (measured: the worst element 3.0e-6,
  NAdam; the others <= 1.2e-7);
- accumulators: under JAX's names, each within 1e-4 of its largest
  magnitude (measured <= 7.2e-6 relative);
- resumed from the JAX state, the port's fourth loss within 1e-5.
"""

import importlib

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu.distributed.auto_parallel import Engine as JaxEngine
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.distributed import Engine
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.weights import (engine_state_from_jax,
                                      engine_state_to_host, load_jax_state,
                                      state_from_jax_layer)

torch.set_num_threads(1)
ops = importlib.import_module("paddle_tpu_torch.ops")

STEPS = 3


def _adamw(m):
    L = m.optimizer.lr
    return m.optimizer.AdamW(
        learning_rate=L.LinearWarmup(L.CosineAnnealingDecay(1e-3, T_max=10),
                                     warmup_steps=2, start_lr=0.0,
                                     end_lr=1e-3),
        weight_decay=0.01, apply_decay_param_fun=lambda n: "norm" not in n,
        grad_clip=m.nn.ClipGradByGlobalNorm(1.0))


OPTIMIZERS = {
    "adamw_warmup_cosine": _adamw,
    "lamb": lambda m: m.optimizer.Lamb(learning_rate=1e-3),
    "radam": lambda m: m.optimizer.RAdam(learning_rate=1e-3),
    "nadam": lambda m: m.optimizer.NAdam(learning_rate=1e-3),
    "adagrad": lambda m: m.optimizer.Adagrad(learning_rate=1e-2,
                                             initial_accumulator_value=0.1),
    "momentum": lambda m: m.optimizer.Momentum(learning_rate=1e-2,
                                               momentum=0.9,
                                               weight_decay=1e-2),
}


def _pair():
    paddle.seed(21)
    jm = JaxLlama(JaxConfig.tiny())
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_jax_state(tm, state_from_jax_layer(jm))
    return jm, tm


def _batch(seed, b=2, s=24):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, (b, s)).astype(np.int32)
    labels = ids.copy()
    labels[0, 5] = -100
    return ids, labels


def _counts():
    return (ops.flash_attention.launches, ops.flash_attention_forward.launches,
            ops.flash_attention_backward.launches_dq,
            ops.flash_attention_backward.launches_dkv)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_three_steps_match_the_jax_engine(name):
    jm, tm = _pair()
    jo, to = OPTIMIZERS[name](paddle), OPTIMIZERS[name](pt)
    je = JaxEngine(jm, mesh=None, optimizer=jo)
    te = Engine(tm, optimizer=to)
    before = _counts()
    jl, tl = [], []
    for i in range(STEPS):
        ids, lb = _batch(10 + i)
        jl.append(float(je.step(ids, lb)))
        loss = te.step(torch.from_numpy(ids), torch.from_numpy(lb))
        assert loss.ndim == 0 and not loss.requires_grad
        tl.append(loss.item())
        jo._lr_step()
        to._lr_step()
    assert _counts() == before    # the CPU runs the plain attention
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    js, ts = engine_state_from_jax(je), engine_state_to_host(te)
    assert ts["step"] == js["step"] == STEPS
    lr = max(to.get_lr(), 1e-3)
    far = total = 0
    for pname, ref in js["model"].items():
        err = np.abs(ts["model"][pname] - ref)
        assert err.max() <= 2 * lr * STEPS, (pname, err.max())
        far += int((err > 2e-5).sum())
        total += err.size
    assert far <= 1e-3 * total, (far, total)
    # the opt layout is the JAX engine's: {acc: {param name: array}}
    assert sorted(ts["opt"]) == sorted(js["opt"])
    for acc, d in js["opt"].items():
        assert list(ts["opt"][acc]) == list(d), acc
        for pname, ref in d.items():
            err = np.abs(ts["opt"][acc][pname] - ref).max()
            assert err <= 1e-4 * max(np.abs(ref).max(), 1e-30), (acc, pname)
    # the JAX state resumes in a fresh port engine: the same fourth step
    _, tm2 = _pair()
    to2 = OPTIMIZERS[name](pt)
    for _ in range(STEPS):
        to2._lr_step()
    te2 = Engine(tm2, optimizer=to2)
    te2.set_state_dict(js)
    ids, lb = _batch(20)
    np.testing.assert_allclose(
        te2.step(torch.from_numpy(ids), torch.from_numpy(lb)).item(),
        float(je.step(ids, lb)), rtol=1e-5)
    assert int(te2.step_count) == STEPS + 1
    assert sorted(te2.state_dict()["opt"]) == sorted(js["opt"])


def test_clip_rules_and_refusals():
    """A non-global-norm clip raises JAX's ValueError; a global-norm clip's
    clip_norm becomes the engine's unless the caller passed one; guard=
    with a pluggable optimizer raises JAX's ValueError; LBFGS has no
    per-tensor rule to run."""
    _, tm = _pair()
    with pytest.raises(ValueError, match="ClipGradByGlobalNorm only"):
        Engine(tm, optimizer=pt.optimizer.SGD(
            grad_clip=pt.nn.ClipGradByValue(1.0)))
    clip = pt.nn.ClipGradByGlobalNorm(0.25)
    assert Engine(tm, optimizer=pt.optimizer.SGD(grad_clip=clip)
                  ).clip_norm == 0.25
    assert Engine(tm, optimizer=pt.optimizer.SGD(grad_clip=clip),
                  clip_norm=None).clip_norm is None
    assert Engine(tm, optimizer=pt.optimizer.SGD()).clip_norm == 1.0
    with pytest.raises(ValueError, match="built-in AdamW path only"):
        Engine(tm, optimizer=pt.optimizer.SGD(), guard=object())
    eng = Engine(tm, optimizer=pt.optimizer.LBFGS())
    ids, lb = _batch(0)
    with pytest.raises(NotImplementedError, match="LBFGS"):
        eng.step(torch.from_numpy(ids), torch.from_numpy(lb))
