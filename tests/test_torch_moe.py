"""Port MoE (paddle_tpu_torch: padded grouped matmul, gates, MoELayer, the
MoE Llama and its Engine steps) against the JAX package on the same
numpy-seeded inputs and carried weights (fp32, CPU).

The JAX Pallas kernels run in interpret mode: ``forward_pgmm`` of both JAX
expert layers is patched to pass ``interpret=True`` and both packages'
``grouped_matmul.TILE_M`` is lowered to 16 so that the kernels stay tiny
(as tests/test_moe.py does); the padded layouts then match row for row.
The port's CPU path runs the plain versions ``pgmm_reference`` and
``pgmm_dw_reference``.

Routing: the two gates' fp32 matmuls round differently (~1e-7), so a pair
of probabilities closer than that could pick different experts. The
tests that route through a gate first assert that the port's top-k
choices clear a margin of 1e-5 (their rank-k/rank-k+1 and rank-1/rank-2
gaps) on these seeded inputs, and the routed_ffn test hands both sides the
same probabilities and asserts equal choices.

Tolerances, from what both sides compute (fp32, other summation orders):
- layouts: exactly equal;
- outputs, losses: max abs error <= 1e-5 x max(1, max |jax|);
- gradients: max abs error <= 1e-5 x max(1, max |jax grad|) per tensor;
- K6's tileless expert: exactly 0 on both sides;
- three ``Engine.step``s: as tests/test_torch_training.py (losses relative
  1e-5, moments 1e-4 of their largest magnitude, parameters within
  2 * lr * steps with at most 0.1% of elements more than 2e-5 apart).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.auto_parallel import Engine as JaxEngine
from paddle_tpu.incubate.distributed.models.moe import moe_layer as jml
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.ops import grouped_matmul as jgm
from paddle_tpu_torch.distributed import Engine
from paddle_tpu_torch.incubate.distributed.models.moe import (
    ExpertFFN, GShardGate, MoELayer, NaiveGate, SwiGLUExpertFFN, SwitchGate,
    routed_ffn)
from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.weights import (engine_state_from_jax,
                                      engine_state_to_host, load_jax_state,
                                      state_from_jax_layer)

torch.set_num_threads(1)

# the module (the package attribute ``ops.pgmm`` is the function)
tgm = importlib.import_module("paddle_tpu_torch.ops.grouped_matmul")
TM = 16
MARGIN = 1e-5


@pytest.fixture(autouse=True)
def small_tiles_and_interpret(monkeypatch):
    monkeypatch.setattr(jgm, "TILE_M", TM)
    monkeypatch.setattr(tgm, "TILE_M", TM)
    for cls in (jml.SwiGLUExpertFFN, jml.ExpertFFN):
        orig = cls.forward_pgmm

        def fp(self, xp, gids, tile_m=None, interpret=False, _orig=orig):
            return _orig(self, xp, gids, tile_m=tile_m, interpret=True)

        monkeypatch.setattr(cls, "forward_pgmm", fp)


def _close(got, ref, tol=1e-5, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max() if got.size else 0.0
    assert err <= tol * max(1.0, np.abs(ref).max()), (what, err)


def _skewed_experts(rng, n, e, empty):
    """n expert ids over e experts, none on ``empty``, skewed."""
    live = [i for i in range(e) if i != empty]
    p = np.linspace(2.0, 1.0, len(live))
    return rng.choice(live, size=n, p=p / p.sum()).astype(np.int32)


def _routing_margin(probs, k):
    """The smallest gap between rank-1/rank-2 and rank-k/rank-k+1
    probabilities of any row."""
    s = np.sort(np.asarray(probs, np.float64), axis=-1)[:, ::-1]
    return min((s[:, 0] - s[:, 1]).min(), (s[:, k - 1] - s[:, k]).min())


@pytest.mark.parametrize("tile_m", [TM, 512])
def test_padded_group_layout_equals_jax(tile_m):
    rng = np.random.default_rng(0)
    n, e = 200, 5
    flat_e = _skewed_experts(rng, n, e, empty=3)
    jo, jp, jg, jP = jgm.padded_group_layout(jnp.asarray(flat_e), e, n,
                                             tile_m=tile_m)
    to, tp, tg, tP = tgm.padded_group_layout(torch.from_numpy(flat_e), e, n,
                                             tile_m=tile_m)
    assert tP == jP == ((n + tile_m - 1) // tile_m + e) * tile_m
    assert tg.dtype == torch.int32
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    assert 3 not in tg.tolist()


def _pgmm_operands(seed=1, n=90, e=4, k=24, m=40):
    """A padded layout with expert 2 empty, x with zero pad rows, w, and an
    output cotangent."""
    rng = np.random.default_rng(seed)
    flat_e = _skewed_experts(rng, n, e, empty=2)
    order, pos, gids, p = jgm.padded_group_layout(jnp.asarray(flat_e), e, n,
                                                  tile_m=TM)
    xs = rng.standard_normal((n, k)).astype(np.float32)
    xp = np.zeros((p, k), np.float32)
    xp[np.asarray(pos)] = xs[np.asarray(order)]
    w = rng.standard_normal((e, k, m)).astype(np.float32)
    gy = rng.standard_normal((p, m)).astype(np.float32)
    return np.array(gids), xp, w, gy


def test_pgmm_forward_and_grads_match_interpret_kernel():
    gids, xp, w, gy = _pgmm_operands()
    jout = jgm.pgmm(jnp.asarray(xp), jnp.asarray(w), jnp.asarray(gids), TM,
                    True)
    jdx, jdw = jax.grad(
        lambda a, b: jnp.sum(jgm.pgmm(a, b, jnp.asarray(gids), TM, True)
                             * gy), argnums=(0, 1))(jnp.asarray(xp),
                                                    jnp.asarray(w))
    x = torch.from_numpy(xp).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = tgm.pgmm(x, wt, torch.from_numpy(gids), TM)
    dx, dw = torch.autograd.grad(out, (x, wt), torch.from_numpy(gy))
    _close(out.detach(), jout, what="out")
    _close(dx, jdx, what="dx")
    _close(dw, jdw, what="dw")
    assert (dw[2] == 0).all() and (np.asarray(jdw)[2] == 0).all()


def test_pgmm_dw_matches_jax_with_tileless_expert():
    gids, xp, w, gy = _pgmm_operands(seed=2)
    assert 2 not in gids.tolist()
    jdw = np.asarray(jgm._pgmm_dw_raw(jnp.asarray(xp), jnp.asarray(gy),
                                      jnp.asarray(gids), 4, TM,
                                      interpret=True))
    dw = tgm.pgmm_dw(torch.from_numpy(xp), torch.from_numpy(gy),
                     torch.from_numpy(gids), 4, TM)
    assert dw.dtype == torch.float32 and dw.shape == (4, 24, 40)
    _close(dw, jdw, what="dw")
    assert (dw[2] == 0).all() and (jdw[2] == 0).all()
    # the dx side of the backward: K5 over the transposed weights
    jdx = np.asarray(jgm._pgmm_raw(jnp.asarray(gy),
                                   jnp.swapaxes(jnp.asarray(w), 1, 2),
                                   jnp.asarray(gids), TM, interpret=True))
    dx = tgm.pgmm_raw(torch.from_numpy(gy), torch.from_numpy(w),
                      torch.from_numpy(gids), TM, trans_w=True)
    _close(dx, jdx, what="dx")


def _swiglu_pair(e, d, h, seed):
    paddle.seed(seed)
    je = jml.SwiGLUExpertFFN(e, d, h)
    te = SwiGLUExpertFFN(e, d, h, device="cpu")
    load_jax_state(te, state_from_jax_layer(je))
    return je, te


def test_routed_ffn_pgmm_matches_jax():
    rng = np.random.default_rng(3)
    n, e, d, k = 40, 4, 16, 2
    tokens = rng.standard_normal((n, d)).astype(np.float32)
    logits = rng.standard_normal((n, e)).astype(np.float32)
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), -1))
    je, te = _swiglu_pair(e, d, 2 * d, seed=4)
    jout, jaux = jml.routed_ffn(jnp.asarray(tokens), jnp.asarray(probs), je,
                                k, n * k, True, dispatch_mode="pgmm")
    jeidx = np.asarray(jax.lax.top_k(jnp.asarray(probs), k)[1])
    teidx = torch.topk(torch.from_numpy(probs), k, dim=-1)[1].numpy()
    np.testing.assert_array_equal(teidx, jeidx)
    out, aux = routed_ffn(torch.from_numpy(tokens), torch.from_numpy(probs),
                          te, k, n * k, True, dispatch_mode="pgmm")
    _close(out.detach(), jout, what="out")
    _close(aux.detach(), jaux, what="aux")


def _set_random_biases(layer, seed):
    rng = np.random.default_rng(seed)
    for b in (layer.experts.b1, layer.experts.b2):
        b.set_value(rng.standard_normal(b.shape).astype(np.float32) * 0.1)


@pytest.mark.parametrize("gate,experts", [("gshard", "expert_ffn"),
                                          ("naive", "swiglu"),
                                          ("gshard", "swiglu")])
def test_moe_layer_output_and_every_gradient_match_jax(gate, experts):
    n, e, d, h = 24, 4, 16, 32
    paddle.seed(5)
    jexp = (jml.SwiGLUExpertFFN(e, d, h) if experts == "swiglu" else None)
    jlayer = jml.MoELayer(d, e, d_hidden=h, experts=jexp, gate=gate,
                          dispatch_mode="pgmm")
    if experts == "expert_ffn":
        _set_random_biases(jlayer, 6)
    texp = (SwiGLUExpertFFN(e, d, h, device="cpu") if experts == "swiglu"
            else None)
    tlayer = MoELayer(d, e, d_hidden=h, experts=texp, gate=gate,
                      dispatch_mode="pgmm", device="cpu")
    assert isinstance(tlayer.gate, GShardGate if gate == "gshard"
                      else NaiveGate)
    load_jax_state(tlayer, state_from_jax_layer(jlayer))
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, n // 2, d)).astype(np.float32)
    gy = rng.standard_normal((2, n // 2, d)).astype(np.float32)

    names = [nm for nm, _ in jlayer.named_parameters()]
    params = [p._data for _, p in jlayer.named_parameters()]

    def jloss(xa, *ps):
        out, aux = jlayer._routed_forward(xa, *ps)
        return jnp.sum(out * gy) + aux, (out, aux)

    (jl, (jout, jaux)), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=tuple(range(len(params) + 1)), has_aux=True))(
            jnp.asarray(x), *params)

    xt = torch.from_numpy(x).requires_grad_()
    with torch.no_grad():
        probs = tlayer.gate.probs(xt.reshape(-1, d))
    assert _routing_margin(probs, tlayer.top_k) > MARGIN
    out = tlayer(xt)
    aux = tlayer.get_loss()
    assert tlayer.get_loss() is None           # get_loss clears
    loss = (out * torch.from_numpy(gy)).sum() + aux
    tnames = [nm for nm, _ in tlayer.named_parameters()]
    assert sorted(tnames) == sorted(names)
    grads = torch.autograd.grad(loss, [xt] + list(tlayer.parameters()))
    _close(out.detach(), jout, what="out")
    _close(aux.detach(), jaux, what="aux")
    if gate == "naive":
        assert aux.item() == 0.0               # NaiveGate: no aux loss
    _close(grads[0], jgrads[0], what="dx")
    jg = dict(zip(names, jgrads[1:]))
    for nm, g in zip(tnames, grads[1:]):
        _close(g, jg[nm], what=nm)


def _moe_cfg(**over):
    return dict(num_experts=4, moe_dispatch="pgmm", **over)


def _llama_pair(seed=21):
    paddle.seed(seed)
    jm = JaxLlama(JaxConfig.tiny(**_moe_cfg()))
    tm = LlamaForCausalLM(LlamaConfig.tiny(**_moe_cfg()), device="cpu")
    load_jax_state(tm, state_from_jax_layer(jm))
    return jm, tm


def _batch(seed, b=2, s=24):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, (b, s)).astype(np.int32)
    labels = ids.copy()
    labels[0, 5] = labels[1, 17] = -100
    return ids, labels


def _record_port_probs(monkeypatch):
    """Record the probabilities every port MoE layer routes by."""
    seen = []
    mod = importlib.import_module(
        "paddle_tpu_torch.incubate.distributed.models.moe.moe_layer")
    real = mod.routed_ffn

    def spy(tokens, probs, *a, **kw):
        seen.append(probs.detach().clone())
        return real(tokens, probs, *a, **kw)

    monkeypatch.setattr(mod, "routed_ffn", spy)
    return seen


def test_tiny_moe_llama_logits_loss_and_grads_match_jax(monkeypatch):
    jm, tm = _llama_pair()
    seen = _record_port_probs(monkeypatch)
    ids, labels = _batch(0)
    tids, tlabels = torch.from_numpy(ids), torch.from_numpy(labels)
    logits = tm(tids)
    assert len(seen) == 2 and all(_routing_margin(p, 2) > MARGIN
                                  for p in seen)
    # the JAX side under jit: eager interpret-mode kernels are slow
    jlogits = jax.jit(jm.forward)(jnp.asarray(ids))
    _close(logits.detach(), jlogits, what="logits")
    loss = tm.loss_fn(tids, tlabels)
    aux = tm.moe_aux_loss()
    jloss, jaux = jax.jit(lambda i, lb: (jm.loss_fn(i, lb),
                                         jm.moe_aux_loss()))(
        jnp.asarray(ids), jnp.asarray(labels))
    _close(aux.detach(), jaux, what="aux")
    _close(loss.detach(), jloss, what="loss")
    assert aux.item() > 1.0          # two gshard layers' load-balance loss
    je = JaxEngine(jm, mesh=None)
    jgrads = dict(zip(je._param_names, jax.jit(jax.grad(je._pure_loss))(
        je.params, jnp.asarray(ids), jnp.asarray(labels))))
    names = [n for n, _ in tm.named_parameters()]
    assert sorted(names) == sorted(jgrads)
    assert "model.layers.0.mlp.gate.gate_weight" in names
    assert "model.layers.1.mlp.experts.w_down" in names
    grads = torch.autograd.grad(loss, list(tm.parameters()))
    for name, g in zip(names, grads):
        _close(g, jgrads[name], what=name)


def test_three_moe_engine_steps_match_jax():
    jm, tm = _llama_pair()
    batches = [_batch(10 + i) for i in range(3)]
    je = JaxEngine(jm, mesh=None, lr=1e-3)
    te = Engine(tm, lr=1e-3)
    # the decay mask is the JAX engine's (ndim >= 2): the fp32 gate and the
    # 3-D expert weights decay, the norm gains do not
    mask = dict(zip(te._param_names, te._decay_mask))
    assert mask["model.layers.0.mlp.gate.gate_weight"]
    assert mask["model.layers.0.mlp.experts.w_up"]
    assert not mask["model.layers.0.input_layernorm.weight"]
    jl = [float(je.step(ids, lb)) for ids, lb in batches]
    tl = [te.step(torch.from_numpy(ids), torch.from_numpy(lb))
          for ids, lb in batches]
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
    # the JAX state, moments included, crosses back in by name
    te2 = Engine(LlamaForCausalLM(LlamaConfig.tiny(**_moe_cfg()),
                                  device="cpu"), lr=1e-3)
    te2.set_state_dict(js)
    ids, lb = _batch(20)
    np.testing.assert_allclose(
        te2.step(torch.from_numpy(ids), torch.from_numpy(lb)).item(),
        float(je.step(ids, lb)), rtol=1e-5)


def test_bf16_moe_model_keeps_an_fp32_gate():
    tm = LlamaForCausalLM(LlamaConfig.tiny(dtype="bfloat16", **_moe_cfg()),
                          device="cpu")
    params = dict(tm.named_parameters())
    assert params["model.layers.0.mlp.gate.gate_weight"].dtype == \
        torch.float32
    assert params["model.layers.0.mlp.experts.w_gate"].dtype == \
        torch.bfloat16
    assert params["model.layers.0.mlp.experts.w_gate"].shape == (4, 64, 128)
    eng = Engine(tm)
    assert all(m.dtype == torch.float32 for m in eng.m + eng.v)


def test_unported_moe_paths_raise():
    """What stays refused: an unknown dispatch (sequence_parallel is
    ported; MoE over a mesh is refused by the Engine,
    tests/test_torch_distributed.py).
    Every dispatch, the switch gate, the experts' dense forward and MoE
    serving are ported (they build here, and tests/test_torch_moe_dispatch.py
    and tests/test_torch_moe_serving.py hold them against JAX), and so is
    the XLA attention path (``use_flash_attention=False``), held here to
    the JAX model with the same flag."""
    for mode in ("auto", "einsum", "scatter", "ragged"):
        MoELayer(16, 4, dispatch_mode=mode, device="cpu")
        LlamaForCausalLM(LlamaConfig.tiny(num_experts=4, moe_dispatch=mode),
                         device="cpu")
    with pytest.raises(ValueError, match="dispatch_mode"):
        MoELayer(16, 4, dispatch_mode="dense", device="cpu")
    with pytest.raises(ValueError, match="dispatch_mode"):
        routed_ffn(torch.zeros(4, 16), torch.full((4, 4), 0.25),
                   SwiGLUExpertFFN(4, 16, 32, device="cpu"), 2, 4,
                   dispatch_mode="dense")
    assert isinstance(MoELayer(16, 4, gate="switch", device="cpu").gate,
                      SwitchGate)
    with pytest.raises(ValueError, match="topk"):
        SwitchGate(16, 4, topk=2, device="cpu")
    assert SwiGLUExpertFFN(4, 16, 32, device="cpu")(
        torch.zeros(4, 2, 16)).shape == (4, 2, 16)
    assert ExpertFFN(4, 16, 32, device="cpu")(
        torch.zeros(4, 2, 16)).shape == (4, 2, 16)
    paddle.seed(9)
    jx = JaxLlama(JaxConfig.tiny(use_flash_attention=False))
    tx = LlamaForCausalLM(LlamaConfig.tiny(use_flash_attention=False),
                          device="cpu")
    assert not tx.config.use_flash_attention
    load_jax_state(tx, state_from_jax_layer(jx))
    ids = np.random.default_rng(9).integers(0, 256, (2, 16)).astype(np.int32)
    _close(tx(torch.from_numpy(ids)).detach(),
           np.asarray(jx(paddle.to_tensor(ids))._data), what="xla logits")
    _close(tx.loss_fn(torch.from_numpy(ids), torch.from_numpy(ids)).item(),
           float(jx.loss_fn(jnp.asarray(ids), jnp.asarray(ids))),
           what="xla loss")
    # sequence_parallel is ported (item 6's first half): with no mesh an
    # MoE model takes it and computes as without
    sp = LlamaForCausalLM(LlamaConfig.tiny(num_experts=4,
                                           sequence_parallel=True),
                          device="cpu", seed=2)
    ref = LlamaForCausalLM(LlamaConfig.tiny(num_experts=4), device="cpu",
                           seed=2)
    t = torch.from_numpy(ids)
    assert torch.equal(sp.loss_fn(t, t), ref.loss_fn(t, t))
    with pytest.raises(ValueError, match="remat_policy"):
        LlamaConfig.tiny(num_experts=4, remat_policy="most")
    with pytest.raises(ValueError, match="remat_every"):
        LlamaConfig.tiny(num_experts=4, recompute=True, remat_every=0)
    # the engine serves the MoE model (tests/test_torch_moe_serving.py
    # holds its streams against the JAX engine's)
    tm = LlamaForCausalLM(LlamaConfig.tiny(**_moe_cfg()), device="cpu")
    eng = ContinuousBatchingEngine(tm, max_batch=2, max_len=32, page_size=8,
                                   device="cpu")
    assert eng.model is tm and eng.caches["kv"]
