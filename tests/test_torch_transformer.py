"""The port's Transformer layers (``nn.MultiHeadAttention`` with ``Cache`` /
``StaticCache`` and masks, ``TransformerEncoderLayer`` / ``Encoder``
pre- and post-norm with relu and gelu, the decoder stack, ``Transformer``)
against the JAX package's, on the JAX layers' weights carried by name
(``weights.load_jax_state``), CPU, fp32.

Tolerances:
- forward outputs and every parameter's and input's gradient (of
  sum(out * cotangent), a fixed random cotangent): max abs error <= 1e-5 x
  max(1, max |jax|) (fp32; the attention's sums run in other orders);
- 3 dygraph AMP O1 bf16 steps (auto_cast, GradScaler.minimize, AdamW with a
  global-norm clip) of a 2-layer encoder classifier: losses within 2e-2
  relative (bf16 rounding of the white ops' inputs and outputs, at
  different points of the two packages' kernels), and the first step's
  unscaled gradients, which AdamW's update would normalise away, by
  ``chip_smoke.amp_grad_errors``: each parameter's max abs error within
  ``AMP_GRAD_TOL`` (5e-2, 6.4 bf16 epsilons) of its largest JAX gradient;
  a parameter whose JAX gradient is zero to rounding (below 2^-8 of the
  largest of all: the attention's k biases) against that largest.
"""

import jax  # noqa: F401  (JAX on the CPU, as tests/conftest.py sets it)
import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu as jp
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch import device as pt_device
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.weights import load_jax_state, state_from_jax_layer

torch.set_num_threads(1)
D, H, FF = 16, 2, 32


@pytest.fixture(autouse=True)
def cpu_place():
    prev = pt_device._PLACE
    pt.set_device("cpu")
    yield
    pt_device._PLACE = prev


def _x(*s, seed=0):
    return np.random.default_rng(seed).standard_normal(s).astype(np.float32)


def _np(t):
    return np.asarray(t.numpy())


def _close(a, b, tol=1e-5):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max() if b.size else 0.0
    assert err <= tol * max(1.0, np.abs(b).max()), err


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [y for o in out for y in _flat(o)]
    if hasattr(out, "k") and hasattr(out, "v"):
        return [out.k, out.v]
    return [out]


def _pair(make):
    """The same layer in both packages, the port's on the JAX weights."""
    jl, tl = make(jnn), make(pnn)
    load_jax_state(tl, state_from_jax_layer(jl))
    return jl, tl


def _check(jl, tl, inputs, run):
    """run(layer, P, tensors) in both packages: outputs, then the gradients
    of every parameter and input."""
    outs = {}
    for P, layer in ((jp, jl), (pt, tl)):
        ts = [P.to_tensor(x, stop_gradient=False) for x in inputs]
        out = _flat(run(layer, P, ts))
        loss = None
        for i, o in enumerate(out):
            c = P.to_tensor(_x(*o.shape, seed=100 + i))
            term = (o * c).sum()
            loss = term if loss is None else loss + term
        loss.backward()
        grads = {n: p.grad for n, p in layer.named_parameters()}
        outs[P] = (out, [t.grad for t in ts], grads)
    (jo, jg, jpg), (to, tg, tpg) = outs[jp], outs[pt]
    for a, b in zip(to, jo):
        _close(a, b)
    for a, b in zip(tg, jg):
        _close(a, b)
    assert sorted(tpg) == sorted(jpg)
    for n in jpg:
        if jpg[n] is None:
            assert tpg[n] is None or not np.any(_np(tpg[n])), n
        else:
            _close(tpg[n], jpg[n])


def _mha(nn_mod):
    return nn_mod.MultiHeadAttention(D, H)


def test_mha_self_and_cross_attention():
    jl, tl = _pair(_mha)
    _check(jl, tl, [_x(2, 5, D), _x(2, 7, D, seed=1)],
           lambda m, P, t: [m(t[0]), m(t[0], t[1], t[1])])


@pytest.mark.parametrize("kind", ["bool", "additive"])
def test_mha_masks(kind):
    jl, tl = _pair(_mha)
    rng = np.random.default_rng(2)
    if kind == "bool":
        mask = rng.random((2, 1, 5, 5)) > 0.3
        mask[..., 0] = True
    else:
        mask = np.where(rng.random((1, H, 5, 5)) > 0.3, 0.0,
                        -1e4).astype(np.float32)
    _check(jl, tl, [_x(2, 5, D)],
           lambda m, P, t: m(t[0], attn_mask=P.to_tensor(mask)))


def test_mha_incremental_cache():
    jl, tl = _pair(_mha)

    def run(m, P, t):
        cache = m.gen_cache(t[0])
        out1, cache = m(t[0][:, :2], cache=cache)
        out2, cache = m(t[0][:, 2:], cache=cache)
        assert cache.k.shape[1] == 5
        return [out1, out2, cache]
    _check(jl, tl, [_x(2, 5, D)], run)


def test_mha_static_cache():
    jl, tl = _pair(_mha)

    def run(m, P, t):
        cache = m.gen_cache(t[1], type=m.StaticCache)
        out, same = m(t[0], cache=cache)
        assert same is None
        return [out, cache]
    _check(jl, tl, [_x(2, 3, D), _x(2, 6, D, seed=1)], run)


@pytest.mark.parametrize("pre_norm", [False, True])
@pytest.mark.parametrize("act", ["relu", "gelu"])
def test_encoder(pre_norm, act):
    jl, tl = _pair(lambda nn_mod: nn_mod.TransformerEncoder(
        nn_mod.TransformerEncoderLayer(D, H, FF, dropout=0.0, activation=act,
                                       normalize_before=pre_norm), 2,
        nn_mod.LayerNorm(D) if pre_norm else None))
    _check(jl, tl, [_x(2, 6, D)], lambda m, P, t: m(t[0]))


def test_encoder_layers_start_from_the_same_weights():
    enc = pnn.TransformerEncoder(pnn.TransformerEncoderLayer(D, H, FF), 3)
    a, b = enc.layers[0], enc.layers[2]
    assert a.linear1.weight is not b.linear1.weight
    assert torch.equal(a.linear1.weight, b.linear1.weight)
    names = [n for n, _ in enc.named_parameters()]
    jenc = jnn.TransformerEncoder(jnn.TransformerEncoderLayer(D, H, FF), 3)
    assert names == [n for n, _ in jenc.named_parameters()]


def test_encoder_with_cache():
    jl, tl = _pair(lambda nn_mod: nn_mod.TransformerEncoder(
        nn_mod.TransformerEncoderLayer(D, H, FF, dropout=0.0), 2))

    def run(m, P, t):
        caches = m.gen_cache(t[0])
        out, caches = m(t[0], cache=caches)
        return [out] + caches
    _check(jl, tl, [_x(2, 4, D)], run)


@pytest.mark.parametrize("pre_norm", [False, True])
def test_decoder(pre_norm):
    jl, tl = _pair(lambda nn_mod: nn_mod.TransformerDecoder(
        nn_mod.TransformerDecoderLayer(D, H, FF, dropout=0.0,
                                       normalize_before=pre_norm), 2,
        nn_mod.LayerNorm(D) if pre_norm else None))
    mask = np.triu(np.full((5, 5), -1e9, np.float32), 1)
    _check(jl, tl, [_x(2, 5, D), _x(2, 7, D, seed=1)],
           lambda m, P, t: m(t[0], t[1], tgt_mask=P.to_tensor(mask)))


def test_decoder_with_caches():
    jl, tl = _pair(lambda nn_mod: nn_mod.TransformerDecoder(
        nn_mod.TransformerDecoderLayer(D, H, FF, dropout=0.0), 2))

    def run(m, P, t):
        caches = m.gen_cache(t[1])
        out, caches = m(t[0], t[1], cache=caches)
        # a static (cross-attention) cache comes back as None, as in JAX
        assert all(pair[1] is None for pair in caches)
        return [out] + [pair[0] for pair in caches]
    _check(jl, tl, [_x(2, 3, D), _x(2, 6, D, seed=1)], run)


def test_transformer():
    jl, tl = _pair(lambda nn_mod: nn_mod.Transformer(
        D, H, 2, 2, FF, dropout=0.0, activation="gelu"))
    jmask = jnn.Transformer.generate_square_subsequent_mask(4)
    tmask = pnn.Transformer.generate_square_subsequent_mask(4)
    np.testing.assert_array_equal(_np(tmask), _np(jmask))
    _check(jl, tl, [_x(2, 6, D), _x(2, 4, D, seed=1)],
           lambda m, P, t: m(t[0], t[1], tgt_mask=(
               jmask if P is jp else tmask)))


# ---- dygraph AMP: 3 O1 bf16 steps of a 2-layer encoder classifier ----

V, POS, LR, STEPS = 64, 32, 1e-3, 3


def _classifier(P, nn_mod):
    class Cls(nn_mod.Layer):
        def __init__(self):
            super().__init__()
            self.word = nn_mod.Embedding(V, D * 4)
            self.pos = nn_mod.Embedding(POS, D * 4)
            self.norm = nn_mod.LayerNorm(D * 4)
            self.encoder = nn_mod.TransformerEncoder(
                nn_mod.TransformerEncoderLayer(D * 4, 4, FF * 2, dropout=0.0,
                                               activation="gelu"), 2)
            self.head = nn_mod.Linear(D * 4, 2)

        def forward(self, ids):
            pos = P.arange(ids.shape[1]).unsqueeze(0)
            x = self.norm(self.word(ids) + self.pos(pos))
            return self.head(self.encoder(x)[:, 0])
    return Cls()


def _amp_steps(P, nn_mod, Fn, opt_mod, model, ids, labels):
    """The losses of STEPS steps and the first step's unscaled gradients
    ({name: float64 array})."""
    opt = opt_mod.AdamW(LR, parameters=model.parameters(), weight_decay=0.01,
                        grad_clip=nn_mod.ClipGradByGlobalNorm(1.0))
    scaler = P.amp.GradScaler(init_loss_scaling=1024)
    losses, grads = [], None
    for _ in range(STEPS):
        with P.amp.auto_cast(level="O1", dtype="bfloat16"):
            logits = model(P.to_tensor(ids))
            loss = Fn.cross_entropy(logits, P.to_tensor(labels))
        assert str(logits.dtype).endswith("bfloat16")
        losses.append(float(loss.numpy()))
        scaler.minimize(opt, scaler.scale(loss))
        if grads is None:
            grads = {n: np.asarray(_np(p.grad), np.float64)
                     for n, p in model.named_parameters()}
        opt.clear_grad()
    return losses, grads


def test_dygraph_amp_o1_bf16_steps_match_jax():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, V, (4, 12))
    labels = rng.integers(0, 2, (4,))
    jm = _classifier(jp, jnn)
    tm = _classifier(pt, pnn)
    load_jax_state(tm, state_from_jax_layer(jm))
    jl, jg = _amp_steps(jp, jnn, JF, jp.optimizer, jm, ids, labels)
    tl, tg = _amp_steps(pt, pnn, F, pt.optimizer, tm, ids, labels)
    for a, b in zip(tl, jl):
        assert abs(a - b) <= 2e-2 * abs(b), (tl, jl)
    assert set(tg) == set(jg)
    err, name, noise = chip_smoke.amp_grad_errors(tg, jg)
    assert err <= chip_smoke.AMP_GRAD_TOL, (name, err)
    assert sorted(noise) == [f"encoder.layers.{i}.self_attn.k_proj.bias"
                             for i in range(2)], noise
