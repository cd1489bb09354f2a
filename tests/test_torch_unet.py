"""Port UNet (paddle_tpu_torch.models.UNet2DConditionModel) against the
JAX package's on carried ``UNetConfig.tiny()`` weights (fp32, CPU): the
timestep embedding, the output, ``loss_fn``, every gradient and one bench
step (bench.py bench_unet: the loss's value and gradients, then
``p - 1e-4 * g``; JAX jitted over ``_collect_state`` / ``_Swap`` as bench
does); then bf16 against the port's own fp32 on the same weights, as the
JAX package's ``test_unet_bf16_matches_fp32`` (tests/test_model_families.py
:146) does.

Tolerances:
- fp32 output and timestep embedding: max abs error <= 1e-5 x max(1, max
  |jax|); loss 1e-6 relative; gradients 1e-5 x max(1, max |jax grad|) per
  parameter; the bench step's parameters 1e-6 absolute;
- bf16 against fp32: the loss within 5% relative (the JAX test's bound),
  the output within 5e-2 x max |fp32 output|, every gradient finite and the
  gradients not all zero.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.api import _collect_state, _Swap
from paddle_tpu.models import UNet2DConditionModel as JaxUNet
from paddle_tpu.models import UNetConfig as JaxConfig
from paddle_tpu.models.unet.modeling import \
    timestep_embedding as jax_timestep_embedding
from paddle_tpu_torch.models import UNet2DConditionModel, UNetConfig
from paddle_tpu_torch.models.unet import timestep_embedding
from paddle_tpu_torch.weights import load_jax_state, state_from_jax_layer

torch.set_num_threads(1)

LR = 1e-4


@pytest.fixture(scope="module")
def pair():
    paddle.seed(13)
    jm = JaxUNet(JaxConfig.tiny())
    tm = UNet2DConditionModel(UNetConfig.tiny(), device="cpu", seed=13)
    load_jax_state(tm, state_from_jax_layer(jm))
    return jm, tm


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"sample": rng.standard_normal((2, 4, 16, 16)).astype(np.float32),
            "timesteps": np.array([10, 500], np.int32),
            "context": rng.standard_normal((2, 6, 32)).astype(np.float32),
            "noise": rng.standard_normal((2, 4, 16, 16)).astype(np.float32)}


def _torch_batch(batch, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _close(out, ref, tol=1e-5):
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= tol * max(1.0, np.abs(ref).max())


def test_timestep_embedding_matches_jax():
    t = np.array([0, 1, 10, 999], np.int32)
    _close(timestep_embedding(torch.from_numpy(t), 64).numpy(),
           np.asarray(jax_timestep_embedding(t, 64)))


def test_output_matches_jax(pair):
    jm, tm = pair
    b = _batch()
    ref = np.asarray(jm(b["sample"], b["timesteps"], b["context"]))
    tb = _torch_batch(b)
    with torch.no_grad():
        out = tm(tb["sample"], tb["timesteps"], tb["context"]).numpy()
    assert out.shape == (2, 4, 16, 16)
    _close(out, ref)


def test_loss_gradients_and_bench_step_match_jax(pair):
    jm, tm0 = pair
    tm = UNet2DConditionModel(UNetConfig.tiny(), device="cpu")
    tm.load_state_dict(tm0.state_dict())
    batch = _batch(1)
    names, tensors = _collect_state(jm)

    def loss_of(ps):
        with _Swap(tensors, ps):
            return jm.loss_fn(batch)

    @jax.jit
    def step(ps):
        loss, g = jax.value_and_grad(loss_of)(ps)
        return loss, g, [p - LR * gg.astype(p.dtype) for p, gg in zip(ps, g)]

    jl, jg, jnew = step([t._data for t in tensors])
    jg = {n[2:]: np.asarray(g) for n, g in zip(names, jg)}
    jnew = {n[2:]: np.asarray(v) for n, v in zip(names, jnew)}

    params = dict(tm.named_parameters())
    assert set(params) == set(jg)
    loss = tm.loss_fn(_torch_batch(batch))
    grads = torch.autograd.grad(loss, list(params.values()))
    with torch.no_grad():
        for p, g in zip(params.values(), grads):
            p.sub_(LR * g.to(p.dtype))
    assert abs(loss.item() - float(jl)) <= 1e-6 * abs(float(jl))
    for (name, p), g in zip(params.items(), grads):
        err = np.abs(g.numpy() - jg[name]).max()
        assert err <= 1e-5 * max(1.0, np.abs(jg[name]).max()), (name, err)
        assert np.abs(p.detach().numpy() - jnew[name]).max() <= 1e-6, name


def test_bf16_matches_the_ports_fp32(pair):
    _, tm32 = pair
    m16 = UNet2DConditionModel(UNetConfig.tiny(dtype="bfloat16"),
                               device="cpu")
    m16.load_state_dict(tm32.state_dict())   # cast to bf16
    assert all(p.dtype == torch.bfloat16 for p in m16.parameters())
    tb = _torch_batch(_batch(2))
    with torch.no_grad():
        o32 = tm32(tb["sample"], tb["timesteps"], tb["context"])
    l16 = m16.loss_fn(tb)
    o16 = m16(tb["sample"], tb["timesteps"], tb["context"])
    assert o16.dtype == torch.bfloat16
    err = (o16.float() - o32).abs().max().item()
    assert err <= 5e-2 * o32.abs().max().item(), err
    l32 = tm32.loss_fn(tb).item()
    assert abs(l16.item() - l32) / l32 < 0.05, (l16.item(), l32)
    grads = torch.autograd.grad(l16, list(m16.parameters()))
    assert all(bool(torch.isfinite(g.float()).all()) for g in grads)
    assert sum(g.float().abs().sum().item() for g in grads) > 0


def test_attention_is_the_dense_path(pair, monkeypatch):
    """Self- and cross-attention of every block go through
    ``_xla_attention`` (causal=False), as in the JAX model."""
    _, tm = pair
    unet = importlib.import_module("paddle_tpu_torch.models.unet.modeling")
    calls = []
    real = unet._xla_attention
    monkeypatch.setattr(unet, "_xla_attention",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    tb = _torch_batch(_batch(3))
    with torch.no_grad():
        tm(tb["sample"], tb["timesteps"], tb["context"])
    cfg = tm.config
    blocks = 2 * len(cfg.block_channels) * cfg.layers_per_block + 1
    assert calls == [dict(causal=False)] * (2 * blocks)
