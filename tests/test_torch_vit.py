"""Port ViT (paddle_tpu_torch.vision.models.VisionTransformer) against the
JAX package's on carried ``ViTConfig.tiny()`` weights (fp32, CPU): logits,
``loss_fn``, every gradient, one bench step (bench.py bench_vit: the loss's
value and gradients, then ``p - 1e-4 * g``; JAX jitted over
``_collect_state`` / ``_Swap`` as bench does), ``recompute=True``, and the
model's routing (the dense ``_xla_attention``, never the flash kernels).

Tolerances (fp32; only summation orders differ):
- logits: max abs error <= 1e-5 x max(1, max |jax|); loss 1e-6 relative;
- gradients: max abs error <= 1e-5 x max(1, max |jax grad|) per
  parameter; recompute's gradients equal the plain ones within the same;
- the bench step's parameters: max abs error <= 1e-6.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.api import _collect_state, _Swap
from paddle_tpu.vision.models import ViTConfig as JaxConfig
from paddle_tpu.vision.models import VisionTransformer as JaxViT
from paddle_tpu.vision.models import vit_b_16 as jax_vit_b_16
from paddle_tpu_torch.vision.models import (ViTConfig, VisionTransformer,
                                            vit_b_16)
from paddle_tpu_torch.weights import load_jax_state, state_from_jax_layer

torch.set_num_threads(1)

B = 4
LR = 1e-4


def _pair(**over):
    paddle.seed(11)
    jm = JaxViT(JaxConfig.tiny(**over))
    tm = VisionTransformer(ViTConfig.tiny(**over), device="cpu", seed=11)
    load_jax_state(tm, state_from_jax_layer(jm))
    return jm, tm


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.standard_normal((B, cfg.in_channels, cfg.image_size,
                                cfg.image_size)).astype(np.float32)
    return imgs, rng.integers(0, cfg.num_classes, B).astype(np.int64)


def _jax_step(jm, imgs, labels):
    """bench.py:1703-1716: value_and_grad of loss_fn over the state, then
    p - 1e-4 g, jitted; returns (loss, {name: grad}, {name: new value})."""
    names, tensors = _collect_state(jm)

    def loss_of(ps):
        with _Swap(tensors, ps):
            return jm.loss_fn(imgs, labels)

    @jax.jit
    def step(ps):
        loss, g = jax.value_and_grad(loss_of)(ps)
        return loss, g, [p - LR * gg.astype(p.dtype) for p, gg in zip(ps, g)]

    loss, grads, new = step([t._data for t in tensors])
    return (float(loss), {n[2:]: np.asarray(g) for n, g in zip(names, grads)},
            {n[2:]: np.asarray(v) for n, v in zip(names, new)})


def _port_step(tm, imgs, labels):
    params = dict(tm.named_parameters())
    loss = tm.loss_fn(torch.from_numpy(imgs), torch.from_numpy(labels))
    grads = torch.autograd.grad(loss, list(params.values()))
    with torch.no_grad():
        for p, g in zip(params.values(), grads):
            p.sub_(LR * g.to(p.dtype))
    return loss.item(), {n: g.numpy() for n, g in zip(params, grads)}


def _grads_close(ours, ref):
    assert set(ours) == set(ref)
    for name, g in ref.items():
        err = np.abs(ours[name] - g).max()
        assert err <= 1e-5 * max(1.0, np.abs(g).max()), (name, err)


def test_logits_match_jax(pair):
    jm, tm = pair
    imgs, _ = _batch(tm.config)
    ref = np.asarray(jm(paddle.to_tensor(imgs)))   # a raw jax array
    with torch.no_grad():
        out = tm(torch.from_numpy(imgs)).numpy()
    assert out.shape == (B, 10)
    assert np.abs(out - ref).max() <= 1e-5 * max(1.0, np.abs(ref).max())


def test_loss_gradients_and_bench_step_match_jax():
    jm, tm = _pair()
    imgs, labels = _batch(tm.config, 1)
    jl, jg, jnew = _jax_step(jm, imgs, labels)
    tl, tg = _port_step(tm, imgs, labels)
    assert abs(tl - jl) <= 1e-6 * abs(jl)
    _grads_close(tg, jg)
    for name, v in tm.state_dict().items():
        assert np.abs(v.numpy() - jnew[name]).max() <= 1e-6, name


def test_recompute_gives_the_same_gradients(pair):
    jm, _ = pair
    imgs, labels = _batch(ViTConfig.tiny(), 2)
    _, jg, _ = _jax_step(jm, imgs, labels)
    state = state_from_jax_layer(jm)
    for recompute in (False, True):
        tm = VisionTransformer(ViTConfig.tiny(recompute=recompute),
                               device="cpu")
        load_jax_state(tm, state)
        _, tg = _port_step(tm, imgs, labels)
        _grads_close(tg, jg)


def test_attention_is_the_dense_path(pair, monkeypatch):
    """Every block attends through ``_xla_attention`` (causal=False), as
    the JAX model does, in the forward and the recompute alike."""
    _, tm = pair
    vit = importlib.import_module("paddle_tpu_torch.vision.models.vit")
    calls = []
    real = vit._xla_attention
    monkeypatch.setattr(vit, "_xla_attention",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    imgs, labels = _batch(tm.config, 3)
    tm.loss_fn(torch.from_numpy(imgs), torch.from_numpy(labels)).backward()
    tm.zero_grad()
    assert calls == [dict(causal=False)] * tm.config.num_layers


def test_vit_b_16_factory_matches_jax_at_a_small_image():
    """bench's ViT-B/16 widths (hidden 768, 12 layers, 12 heads) at 32 px,
    as the JAX package's own test builds it."""
    paddle.seed(12)
    jm = jax_vit_b_16(image_size=32, patch_size=16, num_classes=5)
    tm = vit_b_16(device="cpu", image_size=32, patch_size=16, num_classes=5)
    assert (tm.config.hidden_size, tm.config.num_layers,
            tm.config.num_heads) == (768, 12, 12)
    load_jax_state(tm, state_from_jax_layer(jm))
    imgs = np.random.default_rng(4).standard_normal(
        (1, 3, 32, 32)).astype(np.float32)
    ref = np.asarray(jm(paddle.to_tensor(imgs)))   # a raw jax array
    with torch.no_grad():
        out = tm(torch.from_numpy(imgs)).numpy()
    assert out.shape == (1, 5)
    assert np.abs(out - ref).max() <= 1e-5 * max(1.0, np.abs(ref).max())
