"""Port MoE capacity and ragged dispatches (paddle_tpu_torch: topk_routing,
topk_dispatch, routed_ffn in einsum / scatter / ragged / auto, the experts'
dense and ragged forwards, SwitchGate, MoELayer, the MoE Llama under
Engine) against the JAX package on the same numpy-seeded inputs and
carried weights (fp32, CPU).

No Pallas kernel is on these paths in the JAX package (its ``ragged`` runs
``lax.ragged_dot`` off the TPU); the port's ``ragged`` runs its plain
per-group matmul (``ops.grouped_dot_reference``) on CPU tensors.

Routing: handed the same probabilities, both sides must make the same
choices exactly (integer outputs equal). Where each side computes its own
probabilities through its gate, the fp32 matmuls round differently (~1e-7),
so those tests first assert that the port's top-k choices clear a margin of
1e-5 on these seeded inputs (as tests/test_torch_moe.py does).

Tolerances, from what both sides compute (fp32, other summation orders):
- routing: expert ids, capacity positions, keep and dispatch exactly
  equal; weights, combine and the aux loss within 1e-6 absolute;
- outputs, losses: max abs error <= 1e-5 x max(1, max |jax|);
- gradients: max abs error <= 1e-5 x max(1, max |jax grad|) per tensor;
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
from paddle_tpu.incubate.distributed.models.moe import gate as jgate
from paddle_tpu.incubate.distributed.models.moe import moe_layer as jml
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.distributed import Engine
from paddle_tpu_torch.incubate.distributed.models.moe import (
    ExpertFFN, MoELayer, SwiGLUExpertFFN, SwitchGate, resolve_dispatch,
    routed_ffn, topk_dispatch, topk_routing)
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.weights import (engine_state_from_jax,
                                      engine_state_to_host, load_jax_state,
                                      state_from_jax_layer)

torch.set_num_threads(1)

MARGIN = 1e-5
tgm = importlib.import_module("paddle_tpu_torch.ops.grouped_matmul")


def _close(got, ref, tol=1e-5, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max() if got.size else 0.0
    assert err <= tol * max(1.0, np.abs(ref).max()), (what, err)


def _routing_margin(probs, k):
    """The smallest gap between rank-1/rank-2 and rank-k/rank-k+1
    probabilities of any row."""
    s = np.sort(np.asarray(probs, np.float64), axis=-1)[:, ::-1]
    return min((s[:, 0] - s[:, 1]).min(), (s[:, k - 1] - s[:, k]).min())


def _probs(rng, n, e):
    logits = rng.standard_normal((n, e)).astype(np.float32)
    return np.array(jax.nn.softmax(jnp.asarray(logits), -1))


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("capacity", [12, 3], ids=["roomy", "overflowing"])
def test_topk_routing_and_dispatch_equal_jax(k, capacity):
    rng = np.random.default_rng(0)
    n, e = 48, 8
    probs = _probs(rng, n, e)
    je, jc, jw, jk, ja = jgate.topk_routing(jnp.asarray(probs), k, capacity)
    te, tc, tw, tk, ta = topk_routing(torch.from_numpy(probs), k, capacity)
    assert te.dtype == tc.dtype == torch.int32 and tk.dtype == torch.bool
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    np.testing.assert_allclose(ta.item(), float(ja), atol=1e-6)
    if capacity == 3:
        assert not tk.all()          # the overflowing case drops choices
    jcomb, jdisp, _ = jgate.topk_dispatch(jnp.asarray(probs), k, capacity)
    comb, disp, _ = topk_dispatch(torch.from_numpy(probs), k, capacity)
    assert comb.shape == (n, e, capacity) and disp.dtype == torch.bool
    np.testing.assert_array_equal(disp.numpy(), np.asarray(jdisp))
    np.testing.assert_allclose(comb.numpy(), np.asarray(jcomb), atol=1e-6)


def _swiglu_pair(e, d, h, seed):
    paddle.seed(seed)
    je = jml.SwiGLUExpertFFN(e, d, h)
    te = SwiGLUExpertFFN(e, d, h, device="cpu")
    load_jax_state(te, state_from_jax_layer(je))
    return je, te


def _routed_case(mode, capacity, seed=3, n=48, e=8, d=16, k=2):
    """routed_ffn on both sides: (port out, aux, d tokens, d probs) and the
    JAX counterparts, for sum(out * gy) + aux."""
    rng = np.random.default_rng(seed)
    tokens = rng.standard_normal((n, d)).astype(np.float32)
    probs = _probs(rng, n, e)
    gy = rng.standard_normal((n, d)).astype(np.float32)
    je, te = _swiglu_pair(e, d, 2 * d, seed=4)

    def jloss(t, p):
        out, aux = jml.routed_ffn(t, p, je, k, capacity, True,
                                  dispatch_mode=mode)
        return jnp.sum(out * gy) + aux, (out, aux)

    (_, (jout, jaux)), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(tokens),
                                             jnp.asarray(probs))
    t = torch.from_numpy(tokens).requires_grad_()
    p = torch.from_numpy(probs).requires_grad_()
    out, aux = routed_ffn(t, p, te, k, capacity, True, dispatch_mode=mode)
    grads = torch.autograd.grad((out * torch.from_numpy(gy)).sum() + aux,
                                (t, p))
    return (out, aux, grads), (jout, jaux, jgrads)


@pytest.mark.parametrize("mode,capacity", [
    ("einsum", 12), ("einsum", 3), ("scatter", 12), ("scatter", 3),
    ("ragged", 0)])
def test_routed_ffn_outputs_and_grads_match_jax(mode, capacity):
    (out, aux, grads), (jout, jaux, jgrads) = _routed_case(mode, capacity)
    _close(out.detach(), jout, what="out")
    _close(aux.detach(), jaux, what="aux")
    _close(grads[0], jgrads[0], what="d tokens")
    _close(grads[1], jgrads[1], what="d probs")


def test_ragged_matches_scatter_no_drop():
    # tests/test_moe.py:320's setup: at capacity n * k the scatter dispatch
    # drops nothing, so it computes the ragged dispatch's dropless function
    (so, sa, sg), _ = _routed_case("scatter", 48 * 2)
    (ro, ra, rg), (jout, _, jgrads) = _routed_case("ragged", 0)
    _close(ro.detach(), so.detach(), what="ragged vs scatter")
    _close(ra.detach(), sa.detach(), what="aux")
    for a, b in zip(rg, sg):
        _close(a, b, what="grad")
    _close(ro.detach(), jout, what="ragged vs jax")
    _close(rg[0], jgrads[0], what="ragged d tokens vs jax")


@pytest.mark.parametrize("tile_m", [16, 512])
def test_grouped_dot_tiled_route_equals_ragged_dot(tile_m):
    """The card's route of ``grouped_dot`` (the rows in pgmm's padded tile
    layout; pgmm runs its plain versions on CPU tensors) against JAX's
    ``lax.ragged_dot`` and the port's plain version, with an empty group
    that is not the last: outputs and the gradients of x and w."""
    rng = np.random.default_rng(12)
    sizes = np.array([7, 0, 30, 3, 20], np.int32)
    m, k, n = int(sizes.sum()), 12, 10
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((5, k, n)).astype(np.float32)
    gy = rng.standard_normal((m, n)).astype(np.float32)
    jout, (jdx, jdw) = jax.value_and_grad(
        lambda a, b: jnp.sum(jax.lax.ragged_dot(a, b, jnp.asarray(sizes))
                             * gy), argnums=(0, 1))(jnp.asarray(x),
                                                    jnp.asarray(w))
    for fn in (tgm.grouped_dot_reference,
               lambda a, b, gs: tgm.grouped_dot_tiled(a, b, gs, tile_m)):
        xt = torch.from_numpy(x).requires_grad_()
        wt = torch.from_numpy(w).requires_grad_()
        out = fn(xt, wt, torch.from_numpy(sizes))
        loss = (out * torch.from_numpy(gy)).sum()
        dx, dw = torch.autograd.grad(loss, (xt, wt))
        _close(loss.detach(), jout, what="out")
        _close(dx, jdx, what="dx")
        _close(dw, jdw, what="dw")
        assert (dw[1] == 0).all()


def test_grouped_dot_rows_past_the_groups_are_zero_on_both_routes():
    """group_sizes summing to less than m: ``lax.ragged_dot`` leaves the
    trailing rows zero (and their gradients), and so do the plain version
    and the card's tiled route, which would otherwise compute them in the
    last group's tiles."""
    rng = np.random.default_rng(13)
    sizes = np.array([5, 0, 9, 4], np.int32)
    m, k, n = int(sizes.sum()) + 6, 8, 6
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((4, k, n)).astype(np.float32)
    gy = rng.standard_normal((m, n)).astype(np.float32)
    jout, (jdx, jdw) = jax.value_and_grad(
        lambda a, b: jnp.sum(jax.lax.ragged_dot(a, b, jnp.asarray(sizes))
                             * gy), argnums=(0, 1))(jnp.asarray(x),
                                                    jnp.asarray(w))
    for fn in (tgm.grouped_dot_reference,
               lambda a, b, gs: tgm.grouped_dot_tiled(a, b, gs, 16)):
        xt = torch.from_numpy(x).requires_grad_()
        wt = torch.from_numpy(w).requires_grad_()
        out = fn(xt, wt, torch.from_numpy(sizes))
        assert (out[-6:] == 0).all()
        loss = (out * torch.from_numpy(gy)).sum()
        dx, dw = torch.autograd.grad(loss, (xt, wt))
        assert (dx[-6:] == 0).all()
        _close(loss.detach(), jout, what="out")
        _close(dx, jdx, what="dx")
        _close(dw, jdw, what="dw")


def test_grouped_dot_tiled_takes_a_layout_built_once():
    """The ragged dispatch builds the rows' tile layout once a layer
    (``padded_group_layout`` of the sorted rows' experts) and hands it to
    every ``grouped_dot``: the same result as the layout derived from the
    group sizes, bitwise."""
    rng = np.random.default_rng(14)
    row_e = np.sort(rng.integers(0, 5, 41)).astype(np.int64)
    sizes = torch.from_numpy(np.bincount(row_e, minlength=5))
    x = torch.from_numpy(rng.standard_normal((41, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((5, 8, 6)).astype(np.float32))
    _, pos, tile_gids, p = tgm.padded_group_layout(torch.from_numpy(row_e),
                                                   5, 41, 16)
    got = tgm.grouped_dot_tiled(x, w, sizes, layout=(pos, tile_gids, p))
    assert torch.equal(got, tgm.grouped_dot_tiled(x, w, sizes, 16))
    _close(got, tgm.grouped_dot_reference(x, w, sizes), what="vs plain")


def _jax_resolved(monkeypatch, n, e, capacity, expert_fn):
    """Which dispatch the JAX routed_ffn takes: its einsum branch calls
    ``topk_dispatch``, its scatter branch ``topk_routing`` directly, its
    grouped branches neither. Both spies stop the call."""
    taken = []

    class Taken(Exception):
        pass

    def spy(name):
        def f(*a, **kw):
            taken.append(name)
            raise Taken
        return f

    monkeypatch.setattr(jgate, "topk_dispatch", spy("einsum"))
    monkeypatch.setattr(jgate, "topk_routing", spy("scatter"))
    tokens = jnp.zeros((n, 4), jnp.float32)
    probs = jnp.full((n, e), 1.0 / e, jnp.float32)
    try:
        jml.routed_ffn(tokens, probs, expert_fn, 2, capacity, True,
                       dispatch_mode="auto")
    except Taken:
        pass
    monkeypatch.undo()
    return taken[0]


@pytest.mark.parametrize("n,e,capacity,want", [
    (32, 15, 8, "einsum"),          # e just below 16
    (32, 16, 8, "scatter"),         # e at 16
    (2048, 8, 1024, "einsum"),      # n * e * capacity == 2**24
    (2048, 8, 1025, "scatter"),     # just above
])
def test_auto_choice_matches_jax_on_both_sides_of_both_thresholds(
        monkeypatch, n, e, capacity, want):
    experts = lambda x: x   # noqa: E731  (never reached)
    assert resolve_dispatch("auto", n, e, capacity, experts) == want
    assert _jax_resolved(monkeypatch, n, e, capacity, experts) == want


@pytest.mark.parametrize("mode", ["ragged", "pgmm"])
def test_grouped_mode_without_the_method_takes_scatter_as_jax(mode):
    """An expert layer with only the dense [E, C, d] forward: the grouped
    modes route like ``scatter`` in both packages (the same capacity drops
    included)."""
    rng = np.random.default_rng(5)
    n, e, d, k, cap = 40, 4, 8, 2, 6
    tokens = rng.standard_normal((n, d)).astype(np.float32)
    probs = _probs(rng, n, e)
    w = (rng.standard_normal((e, d, d)) * 0.3).astype(np.float32)
    assert resolve_dispatch(mode, n, e, cap, lambda x: x) == "scatter"
    jout, jaux = jml.routed_ffn(
        jnp.asarray(tokens), jnp.asarray(probs),
        lambda x: jnp.einsum("ecd,edm->ecm", x, jnp.asarray(w)), k, cap,
        True, dispatch_mode=mode)
    tw = torch.from_numpy(w)
    out, aux = routed_ffn(torch.from_numpy(tokens), torch.from_numpy(probs),
                          lambda x: torch.bmm(x, tw), k, cap, True,
                          dispatch_mode=mode)
    sout, _ = routed_ffn(torch.from_numpy(tokens), torch.from_numpy(probs),
                         lambda x: torch.bmm(x, tw), k, cap, True,
                         dispatch_mode="scatter")
    _close(out, jout, what="out")
    _close(aux, jaux, what="aux")
    assert torch.equal(out, sout)


def test_unknown_dispatch_raises():
    with pytest.raises(ValueError, match="dispatch_mode"):
        routed_ffn(torch.zeros(4, 16), torch.full((4, 4), 0.25),
                   SwiGLUExpertFFN(4, 16, 32, device="cpu"), 2, 4,
                   dispatch_mode="dense")


@pytest.mark.parametrize("activation", ["gelu", "relu", "silu"])
def test_expert_ffn_dense_forward_matches_jax(activation):
    e, c, d, h = 4, 6, 8, 16
    paddle.seed(9)
    jexp = jml.ExpertFFN(e, d, h, activation)
    rng = np.random.default_rng(9)
    for b in (jexp.b1, jexp.b2):
        b.set_value(rng.standard_normal(b.shape).astype(np.float32) * 0.1)
    texp = ExpertFFN(e, d, h, activation, device="cpu")
    load_jax_state(texp, state_from_jax_layer(jexp))
    x = rng.standard_normal((e, c, d)).astype(np.float32)
    gy = rng.standard_normal((e, c, d)).astype(np.float32)
    jout = jexp(jnp.asarray(x))
    jdx = jax.grad(lambda a: jnp.sum(jexp(a) * gy))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = texp(xt)
    dx, = torch.autograd.grad((out * torch.from_numpy(gy)).sum(), xt)
    _close(out.detach(), jout, what="out")
    _close(dx, jdx, what="dx")


def _set_random_biases(layer, seed):
    rng = np.random.default_rng(seed)
    for b in (layer.experts.b1, layer.experts.b2):
        b.set_value(rng.standard_normal(b.shape).astype(np.float32) * 0.1)


@pytest.mark.parametrize("mode", ["einsum", "scatter", "ragged"])
@pytest.mark.parametrize("gate", ["gshard", "switch", "naive"])
def test_moe_layer_output_and_every_gradient_match_jax(gate, mode):
    """ExpertFFN experts with random biases, capacity factor 0.5 (the
    capacity modes drop choices); the switch gate in eval mode."""
    n, e, d, h = 24, 4, 16, 32
    paddle.seed(5)
    jlayer = jml.MoELayer(d, e, d_hidden=h, gate=gate, capacity_factor=0.5,
                          dispatch_mode=mode)
    _set_random_biases(jlayer, 6)
    tlayer = MoELayer(d, e, d_hidden=h, gate=gate, capacity_factor=0.5,
                      dispatch_mode=mode, device="cpu")
    load_jax_state(tlayer, state_from_jax_layer(jlayer))
    if gate == "switch":
        assert isinstance(tlayer.gate, SwitchGate) and tlayer.top_k == 1
        jlayer.eval()
        tlayer.eval()
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, n // 2, d)).astype(np.float32)
    gy = rng.standard_normal((2, n // 2, d)).astype(np.float32)

    # the same expert choices and the same dropped choices
    cap = tlayer.capacity(n)
    assert cap == jlayer.capacity(n)
    with torch.no_grad():
        probs = tlayer.gate.probs(torch.from_numpy(x).reshape(-1, d))
    jprobs = jlayer.gate.probs(jnp.asarray(x).reshape(-1, d))
    assert _routing_margin(probs, tlayer.top_k) > MARGIN
    renorm = tlayer.gate.renormalize
    te, tc, _, tk, _ = topk_routing(probs, tlayer.top_k, cap, renorm)
    je, jc, _, jk, _ = jgate.topk_routing(jprobs, tlayer.top_k, cap, renorm)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert not tk.all()

    names = [nm for nm, _ in jlayer.named_parameters()]
    params = [p._data for _, p in jlayer.named_parameters()]

    def jloss(xa, *ps):
        out, aux = jlayer._routed_forward(xa, *ps)
        return jnp.sum(out * gy) + aux, (out, aux)

    (_, (jout, jaux)), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=tuple(range(len(params) + 1)), has_aux=True))(
            jnp.asarray(x), *params)
    xt = torch.from_numpy(x).requires_grad_()
    out = tlayer(xt)
    aux = tlayer.get_loss()
    loss = (out * torch.from_numpy(gy)).sum() + aux
    tnames = [nm for nm, _ in tlayer.named_parameters()]
    assert sorted(tnames) == sorted(names)
    grads = torch.autograd.grad(loss, [xt] + list(tlayer.parameters()),
                                allow_unused=True)
    _close(out.detach(), jout, what="out")
    _close(aux.detach(), jaux, what="aux")
    _close(grads[0], jgrads[0], what="dx")
    jg = dict(zip(names, jgrads[1:]))
    for nm, g in zip(tnames, grads[1:]):
        if g is None:   # NaiveGate's probs get no gradient without aux in
            g = torch.zeros_like(dict(tlayer.named_parameters())[nm])
        _close(g, jg[nm], what=nm)


def _switch_gate(seed, eps=0.1):
    gen = torch.Generator().manual_seed(seed)
    return SwitchGate(16, 4, switch_eps=eps, device="cpu", generator=gen)


def test_switch_gate_training_jitter_is_seeded_and_bounded():
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (64, 16)).astype(np.float32))
    a, b = _switch_gate(3), _switch_gate(3)
    assert a.training
    pa, pb = a.probs(x), b.probs(x)
    assert torch.equal(pa, pb)                      # same seed, same noise
    assert not torch.equal(a.probs(x), pa)          # a fresh draw each call
    clean = x @ a.gate_weight
    # the jittered logits, recovered from the probs up to a per-row shift
    # that the clean logits' mean fixes: logits * noise, noise in [0.9, 1.1]
    noisy = torch.log(pa)
    noisy = noisy - noisy.mean(-1, keepdim=True)
    a.eval()
    assert torch.allclose(a.probs(x), torch.softmax(clean, -1))
    gen = torch.Generator().manual_seed(3)
    _ = SwitchGate(16, 4, device="cpu", generator=gen)   # the same weights
    noise = torch.empty_like(clean).uniform_(0.9, 1.1, generator=gen)
    assert ((noise >= 0.9) & (noise <= 1.1)).all()
    ref = clean * noise
    assert torch.allclose(noisy, ref - ref.mean(-1, keepdim=True),
                          atol=1e-5)
    # eps = 0: training mode equals eval mode
    z = _switch_gate(4, eps=0.0)
    assert torch.equal(z.probs(x), z.eval().probs(x))


def _moe_cfg(**over):
    return dict(num_experts=4, **over)


def _llama_pair(seed=21, **over):
    paddle.seed(seed)
    jm = JaxLlama(JaxConfig.tiny(**_moe_cfg(**over)))
    tm = LlamaForCausalLM(LlamaConfig.tiny(**_moe_cfg(**over)), device="cpu")
    load_jax_state(tm, state_from_jax_layer(jm))
    return jm, tm


def _batch(seed, b=2, s=24):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, (b, s)).astype(np.int32)
    labels = ids.copy()
    labels[0, 5] = labels[1, 17] = -100
    return ids, labels


@pytest.mark.parametrize("dispatch", ["auto", "scatter", "ragged"])
def test_three_moe_engine_steps_match_jax(dispatch):
    jm, tm = _llama_pair(moe_dispatch=dispatch)
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
