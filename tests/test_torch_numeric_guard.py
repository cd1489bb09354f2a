"""The port's numeric guard (``framework/numeric_guard.py``'s device half,
``NumericWatchdog``, the numeric fault hooks and ``Engine(guard=)``)
against the JAX package on the CPU.

Held:
- ``guard_step`` on the same numpy inputs (fp32 and bf16 gradients and
  losses; warm-up, a spike, NaN/inf losses, NaN and inf gradients): the
  words exactly equal, the detector state within 1e-6 (relative and
  absolute) every step;
- ``GuardPolicy`` / ``NumericWatchdog``: the decisions, skipped steps,
  events, rollbacks and LR re-warm factors exactly equal over the same
  word sequences;
- ``numeric_inject_code`` and ``poison_arrays``: the same codes and the
  same NaN positions under the same plan;
- ``BadBatchRecorder``: the same call writes byte-equal ``meta.json`` and
  ``batch.npz`` in both packages, and each loads the other's capture;
- the guarded ``Engine`` on a 2-layer tiny Llama with the same weights
  and the same ``FaultPlan``: the health words equal every step, the
  losses within ``test_torch_training.py``'s relative 1e-5 (a spiked step
  scales the loss by 1024, and so the bound with it), the detector state
  within 1e-6; a skipped step leaves every parameter and both moments
  bit-identical while the step counter advances; WARN applies the update;
- the float-batch repair: JAX's ``Toy`` (one ``Linear``, a float loss)
  takes 3 steps under both engines with losses within 1e-6 (the parent
  cast every batch to int64 and failed in the first matmul).
"""

import json
import warnings

import jax  # noqa: F401  (JAX on the CPU, as tests/conftest.py sets it)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.distributed.auto_parallel import Engine as JEngine
from paddle_tpu.distributed.resilience import faults as jfaults
from paddle_tpu.distributed.resilience import watchdog as jwd
from paddle_tpu.framework import numeric_guard as jng
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu_torch import device as pt_device
from paddle_tpu_torch.distributed import Engine
from paddle_tpu_torch.distributed.resilience import faults as tfaults
from paddle_tpu_torch.distributed.resilience import watchdog as twd
from paddle_tpu_torch.framework import numeric_guard as tng
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.weights import (engine_state_from_jax,
                                      engine_state_to_host, load_jax_state,
                                      state_from_jax_layer)

torch.set_num_threads(1)
D = 8


@pytest.fixture(autouse=True)
def cpu_place():
    prev = pt_device._PLACE
    pt.set_device("cpu")
    yield
    pt_device._PLACE = prev


# ---------------------------------------------------------------------------
# guard_step
# ---------------------------------------------------------------------------

def _sequence(kind):
    """(losses, per-step gradient edits) of one scenario; an edit is
    (tensor index, flat position, value)."""
    steady = [1.0, 1.1, 0.95, 1.02, 0.98, 1.05, 1.0, 0.97]
    if kind == "warmup_spike":
        losses = steady[:6] + [60.0, 1.01, 0.99, 40.0]
        return losses, {}
    if kind == "spike_before_warmup":
        return [1000.0, 1.0, 900.0, 1.0, 1.0, 1.0, 1.0], {}
    if kind == "nan_loss":
        return steady[:5] + [float("nan"), 1.0, float("inf"),
                             float("-inf"), 1.02], {}
    if kind == "bad_grads":
        return steady + [1.0, 1.0], {
            2: [(0, 3, np.nan)], 4: [(1, 0, np.inf)],
            6: [(2, 5, -np.inf), (0, 1, np.nan)], 8: [(1, 2, np.nan)]}
    raise ValueError(kind)


def _grads(rng):
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((4, 6), (16,), (3, 2, 5))]


KINDS = ("warmup_spike", "spike_before_warmup", "nan_loss", "bad_grads")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_guard_step_words_and_state_equal_jax(kind, dtype):
    losses, edits = _sequence(kind)
    rng = np.random.default_rng(5)
    kw = dict(spike_factor=6.0, warmup_steps=3)
    jstate = jng.guard_init_state()
    tstate = tng.guard_init_state()
    assert tstate.dtype == torch.float32 and tuple(tstate.shape) == (3,)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    words = []
    for i, loss in enumerate(losses):
        grads = _grads(rng)
        for t, pos, val in edits.get(i, ()):
            grads[t].reshape(-1)[pos] = val
        jw, jstate = jng.guard_step(
            jnp.asarray(np.float32(loss), jdt),
            [jnp.asarray(g, jdt) for g in grads], jstate, **kw)
        tw, tstate = tng.guard_step(
            torch.tensor(np.float32(loss)).to(tdt),
            [torch.from_numpy(g).to(tdt) for g in grads], tstate, **kw)
        assert tw.dtype == torch.int32 and tw.ndim == 0
        assert int(tw) == int(jw), (i, int(tw), int(jw))
        np.testing.assert_allclose(tstate.numpy(), np.asarray(jstate),
                                   rtol=1e-6, atol=1e-6)
        words.append(int(tw))
    # each scenario reaches the bits it was written for
    seen = 0
    for w in words:
        seen |= w
    want = {"warmup_spike": tng.SPIKE, "spike_before_warmup": 0,
            "nan_loss": tng.NAN_LOSS,
            "bad_grads": tng.NAN_GRAD | tng.INF_GRAD}[kind]
    assert seen & want == want and (want or seen == 0), words


def test_guard_step_default_arguments_equal_jax():
    rng = np.random.default_rng(9)
    jstate, tstate = jng.guard_init_state(), tng.guard_init_state()
    words = []
    for i in range(9):
        loss = np.float32(2.0 + 0.1 * rng.standard_normal()
                          + (30.0 if i == 7 else 0.0))
        g = rng.standard_normal(7).astype(np.float32)
        jw, jstate = jng.guard_step(jnp.float32(loss), [jnp.asarray(g)],
                                    jstate, ema_beta=0.8)
        tw, tstate = tng.guard_step(torch.tensor(loss), [torch.from_numpy(g)],
                                    tstate, ema_beta=0.8)
        assert int(tw) == int(jw)
        np.testing.assert_allclose(tstate.numpy(), np.asarray(jstate),
                                   rtol=1e-6, atol=1e-6)
        words.append(int(tw))
    assert words[7] == tng.SPIKE, words


def test_constants_and_policy_match_jax():
    for name in ("NAN_GRAD", "INF_GRAD", "NAN_LOSS", "SPIKE", "OVERFLOW",
                 "ALL_BITS", "INJECT_NONE", "INJECT_NAN_GRAD",
                 "INJECT_LOSS_SPIKE", "SPIKE_INJECT_FACTOR", "BIT_NAMES",
                 "BIT_CODES"):
        assert getattr(tng, name) == getattr(jng, name), name
    assert sorted(tng.__all__) == sorted(jng.__all__)
    for action in ("warn", "skip_step", "rollback", "abort"):
        assert (tng.GuardPolicy(action).skip_mask
                == jng.GuardPolicy(action).skip_mask)
    assert (tng.GuardPolicy().__dict__ == jng.GuardPolicy().__dict__)
    with pytest.raises(ValueError, match="unknown guard action"):
        tng.GuardPolicy(action="pray")
    word = tng.NAN_LOSS | tng.SPIKE
    t, j = (tng.NumericAnomalyError(word, step=3),
            jng.NumericAnomalyError(word, step=3))
    assert (t.word, t.step, t.codes, str(t)) == (j.word, j.step, j.codes,
                                                 str(j))
    assert t.codes == ["PT-NUM-003", "PT-NUM-004"]


# ---------------------------------------------------------------------------
# GuardPolicy / NumericWatchdog decisions
# ---------------------------------------------------------------------------

POLICIES = {
    "skip_window": dict(action="skip_step", max_skips_per_window=2,
                        window=5),
    "skip_escalates": dict(action="skip_step", max_skips_per_window=1,
                           window=50, max_rollbacks=2, rewarm_steps=3),
    "rollback_rewarm": dict(action="rollback", max_rollbacks=2,
                            rewarm_steps=4),
    "abort": dict(action="abort"),
    "warn": dict(action="warn"),
}


def _drive(mod, pol_kw, words):
    """Feed ``words`` through a watchdog as the trainer does: a rollback
    resumes three steps back."""
    wd = mod.NumericWatchdog(mod.GuardPolicy(**pol_kw))
    out = []
    step = 1
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for w in words:
            scale = wd.lr_scale(step)
            d = wd.observe(step, w)
            out.append((step, d, scale))
            if d == "rollback":
                step = max(0, step - 3)
                wd.note_rollback(step)
            elif d == "abort":
                break
            step += 1
    return (out, wd.events, wd.skipped_steps, wd.rollbacks,
            [str(c.message) for c in caught])


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_watchdog_decisions_equal_jax(policy):
    rng = np.random.default_rng(len(policy))
    bits = [0, 0, 0, tng.NAN_GRAD, tng.SPIKE, tng.INF_GRAD | tng.NAN_LOSS]
    words = [int(rng.choice(bits)) for _ in range(60)]
    got = _drive(twd, POLICIES[policy], words)
    ref = _drive(jwd, POLICIES[policy], words)
    assert got == ref
    assert any(d != "ok" for _, d, _ in got[0])


def test_watchdog_named_cases_as_jax_tests():
    """The JAX package's own watchdog cases (tests/test_numeric_guard.py
    TestWatchdog), on the port."""
    wd = twd.NumericWatchdog(tng.GuardPolicy(
        action="skip_step", max_skips_per_window=2, window=10))
    assert [wd.observe(s, w) for s, w in
            ((1, 0), (2, 1), (3, 1), (4, 1))] == [
        "ok", "skip_step", "skip_step", "rollback"]
    wd = twd.NumericWatchdog(tng.GuardPolicy(action="rollback",
                                             rewarm_steps=4))
    assert wd.lr_scale(10) == 1.0
    wd.note_rollback(10)
    assert [wd.lr_scale(s) for s in (10, 11, 13, 14)] == [0.25, 0.5, 1.0,
                                                          1.0]
    with pytest.warns(UserWarning, match="PT-NUM-001"):
        assert twd.NumericWatchdog(tng.GuardPolicy(action="warn")).observe(
            2, tng.NAN_GRAD) == "warn"


# ---------------------------------------------------------------------------
# the numeric fault hooks
# ---------------------------------------------------------------------------

def test_inject_codes_and_poison_positions_equal_jax():
    def run(mod):
        plan = mod.FaultPlan(seed=4, specs=[
            mod.FaultSpec("numeric.step", "nan_grad", at=1, count=2),
            mod.FaultSpec("numeric.step", "loss_spike", at=4),
            mod.FaultSpec("data.batch", "poison_batch", at=1, arg=3),
            mod.FaultSpec("data.batch", "poison_batch", at=3)])
        rng = np.random.default_rng(0)
        codes, batches = [], []
        with plan:
            for s in range(6):
                codes.append(mod.numeric_inject_code(str(s + 1)))
                x = rng.standard_normal((4, 50)).astype(np.float32)
                ids = rng.integers(0, 9, (4, 5)).astype(np.int32)
                batches.append(mod.poison_arrays(s, (x, ids)))
        return codes, batches, plan.log

    tc, tb, tlog = run(tfaults)
    jc, jb, jlog = run(jfaults)
    assert tc == jc == [0, 1, 1, 0, 2, 0]
    assert tlog == jlog
    for (tx, tids), (jx, jids) in zip(tb, jb):
        np.testing.assert_array_equal(np.isnan(tx), np.isnan(jx))
        np.testing.assert_array_equal(tids, jids)
    assert np.isnan(tb[1][0]).sum() == 3 and np.isnan(tb[3][0]).sum() == 2
    assert tfaults.numeric_inject_code("1") == 0      # no plan: no fault


# ---------------------------------------------------------------------------
# bad-batch capture
# ---------------------------------------------------------------------------

def test_bad_batch_captures_are_byte_equal_and_cross_load(tmp_path):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 4)).astype(np.float32)
    x[1, 2] = np.nan
    ids = rng.integers(0, 100, (3, 5)).astype(np.int32)
    word = tng.NAN_GRAD | tng.NAN_LOSS
    kw = dict(rng_seed=7, extra={"decision": "skip_step", "lr_scale": 1.0})
    tdir = tng.BadBatchRecorder(str(tmp_path / "t")).record(
        5, word, {"input_ids": torch.from_numpy(x), "labels": ids}, **kw)
    jdir = jng.BadBatchRecorder(str(tmp_path / "j")).record(
        5, word, {"input_ids": x, "labels": ids}, **kw)
    for name in ("meta.json", "batch.npz"):
        with open(f"{tdir}/{name}", "rb") as a, open(f"{jdir}/{name}",
                                                     "rb") as b:
            assert a.read() == b.read(), name
    for load_mod, root in ((jng, "t"), (tng, "j")):
        rec = load_mod.BadBatchRecorder(str(tmp_path / root))
        assert rec.steps() == [5]
        meta, arrays = rec.load(5)
        assert meta["codes"] == ["PT-NUM-001", "PT-NUM-003"]
        assert meta["bits"] == ["NAN_GRAD", "NAN_LOSS"]
        np.testing.assert_array_equal(arrays["input_ids"], x)
        np.testing.assert_array_equal(arrays["labels"], ids)
    assert tng.BadBatchRecorder(str(tmp_path / "none")).steps() == []
    with open(f"{tdir}/meta.json") as f:
        assert json.load(f)["arrays"] == ["input_ids", "labels"]


# ---------------------------------------------------------------------------
# the guarded Engine on a tiny Llama, against the JAX guarded Engine
# ---------------------------------------------------------------------------

STEPS, LR = 8, 1e-3
# nan_grad on the 3rd step, loss_spike on the 7th (after the warm-up)
PLAN = (("numeric.step", "nan_grad", 2), ("numeric.step", "loss_spike", 6))


def _llama_batches():
    rng = np.random.default_rng(31)
    return [rng.integers(0, 256, (2, 16)).astype(np.int32)
            for _ in range(STEPS)]


def _plan(mod):
    return mod.FaultPlan(seed=1, specs=[mod.FaultSpec(s, a, at=k)
                                        for s, a, k in PLAN])


def _snapshot(eng):
    return ([p.detach().clone() for p in eng.params],
            [m.clone() for m in eng.m], [v.clone() for v in eng.v])


def _llama_run(action):
    """The same guarded run in both packages: (JAX words, losses, final
    state, guard state), (port words, losses, snapshots before and after
    every step, final state, guard state)."""
    prev = pt_device._PLACE
    pt.set_device("cpu")
    pol = dict(action=action, warmup_steps=3, spike_factor=8.0)
    cfg = dict(num_hidden_layers=2)
    paddle.seed(21)
    jm = JLlama(JConfig.tiny(**cfg))
    tm = LlamaForCausalLM(LlamaConfig.tiny(**cfg), device="cpu")
    load_jax_state(tm, state_from_jax_layer(jm))
    je = JEngine(jm, mesh=None, lr=LR, guard=jng.GuardPolicy(**pol))
    te = Engine(tm, lr=LR, guard=tng.GuardPolicy(**pol))
    batches = _llama_batches()
    jw, jl = [], []
    with _plan(jfaults):
        for ids in batches:
            jl.append(float(je.step(ids, ids)))
            jw.append(int(je.last_health))
    tw, tl, snaps = [], [], []
    with _plan(tfaults):
        for ids in batches:
            before = _snapshot(te)
            loss = te.step(torch.from_numpy(ids), torch.from_numpy(ids))
            tw.append(int(te.last_health))
            tl.append(loss.item())
            snaps.append((before, _snapshot(te), int(te.step_count)))
    pt_device._PLACE = prev
    return dict(action=action, jw=jw, jl=jl, js=engine_state_from_jax(je),
                jg=np.asarray(je.guard_state), tw=tw, tl=tl, snaps=snaps,
                ts=engine_state_to_host(te), tg=te.guard_state.numpy())


@pytest.fixture(scope="module")
def skip_run():
    return _llama_run("skip_step")


@pytest.fixture(scope="module")
def warn_run():
    return _llama_run("warn")


@pytest.fixture(params=["skip_step", "warn"])
def llama_runs(request):
    return request.getfixturevalue(
        "skip_run" if request.param == "skip_step" else "warn_run")


def test_llama_guarded_words_equal_jax(llama_runs):
    r = llama_runs
    assert r["tw"] == r["jw"]
    assert r["tw"][2] & tng.NAN_GRAD
    if r["action"] == "skip_step":
        # (under WARN the NaN update went through: every later loss NaN)
        assert r["tw"][6] & tng.SPIKE


def test_llama_guarded_losses_and_state_equal_jax(llama_runs):
    r = llama_runs
    np.testing.assert_allclose(r["tl"], r["jl"], rtol=1e-5)
    np.testing.assert_allclose(r["tg"], r["jg"], rtol=1e-6, atol=1e-6)
    assert r["ts"]["step"] == r["js"]["step"] == STEPS
    if r["action"] == "skip_step":
        # the same updates applied and skipped: within the training
        # tests' parameter bound
        for name, ref in r["js"]["model"].items():
            err = np.abs(r["ts"]["model"][name] - ref).max()
            assert err <= 2 * LR * STEPS, (name, err)


def test_llama_skipped_step_is_bit_identical(skip_run):
    r = skip_run
    skipped = [i for i, w in enumerate(r["tw"]) if w]
    assert 2 in skipped and 6 in skipped
    for i, (before, after, count) in enumerate(r["snaps"]):
        assert count == i + 1              # the counter advances regardless
        same = all(torch.equal(a, b) for xs, ys in zip(before, after)
                   for a, b in zip(xs, ys))
        assert same == (i in skipped), i


def test_llama_warn_applies_the_update(warn_run):
    r = warn_run
    before, after, count = r["snaps"][2]
    assert count == 3 and r["tw"][2] & tng.NAN_GRAD
    # the NaN gradients went through: parameters and moments are NaN now
    assert all(torch.isnan(p).any() for p in after[0])
    assert all(torch.isnan(m).any() for m in after[1])


def test_guard_refuses_a_pluggable_optimizer_as_jax():
    tm = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1),
                          device="cpu")
    opt = pt.optimizer.AdamW(learning_rate=1e-3,
                             parameters=list(tm.parameters()))
    with pytest.raises(ValueError, match="built-in AdamW"):
        Engine(tm, optimizer=opt, guard=tng.GuardPolicy())


# ---------------------------------------------------------------------------
# float batches keep their dtype (the repair)
# ---------------------------------------------------------------------------

class JToy(paddle.nn.Layer):
    """The JAX package's guard fixture (tests/test_numeric_guard.py)."""

    def __init__(self):
        super().__init__()
        self.fc = paddle.nn.Linear(D, D)

    def loss_fn(self, x, y):
        out = self.fc(Tensor(x))
        diff = out._data - y
        return (diff * diff).mean()


class TToy(pt.nn.Layer):
    """The same model on the port."""

    def __init__(self):
        super().__init__()
        self.fc = pt.nn.Linear(D, D)

    def loss_fn(self, x, y):
        diff = self.fc(x) - y
        return (diff * diff).mean()


def toy_data(step, b=8):
    rng = np.random.default_rng(1000 + step)
    return (rng.standard_normal((b, D)).astype(np.float32),
            rng.standard_normal((b, D)).astype(np.float32))


def test_float_batches_keep_their_dtype_as_jax():
    paddle.seed(0)
    jm = JToy()
    tm = TToy()
    load_jax_state(tm, state_from_jax_layer(jm))
    je = JEngine(jm, None, lr=0.05, clip_norm=None)
    te = Engine(tm, None, lr=0.05, clip_norm=None)
    jl = [float(je.step(*toy_data(s))) for s in range(3)]
    tl = [te.step(*toy_data(s)).item() for s in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=1e-6, atol=1e-6)
    ids, lbl = te._to_device(np.zeros((2, 3), np.int32),
                             np.zeros((2, D), np.float64))
    assert ids.dtype == torch.int64 and lbl.dtype == torch.float64


# ---------------------------------------------------------------------------
# the unguarded path keeps its numbers
# ---------------------------------------------------------------------------

def _parent_adamw(eng, grads):
    """The unguarded AdamW as it was before the guard came (in place:
    ``mm.mul_(b1).add_(...)``, ``p.copy_(...)``), on ``eng``'s tensors."""
    b1, b2, eps, wd = eng.beta1, eng.beta2, eng.epsilon, eng.weight_decay
    stepf = eng.step_count.float()
    bc1, bc2 = 1.0 - b1 ** stepf, 1.0 - b2 ** stepf
    grads = eng._clip_grads(grads)
    with torch.no_grad():
        for p, mm, vv, g, decay in zip(eng.params, eng.m, eng.v, grads,
                                       eng._decay_mask):
            gf = g.float()
            mm.mul_(b1).add_((1.0 - b1) * gf)
            vv.mul_(b2).add_((1.0 - b2) * gf * gf)
            update = (mm / bc1) / (torch.sqrt(vv / bc2) + eps)
            pf = p.float()
            if decay:
                update = update + wd * pf
            p.copy_(pf - eng.lr * update)


def test_unguarded_and_healthy_guarded_steps_keep_the_parents_numbers():
    """guard=None: three steps bitwise the in-place AdamW of the engine
    before the guard came; a guarded engine's healthy steps bitwise the
    unguarded engine's (fp32: the port's bf16 Llama runs on the card only,
    where tests/test_torch_cuda.py holds the same)."""
    cfg = LlamaConfig.tiny(num_hidden_layers=2)
    batches = [torch.from_numpy(b).long() for b in _llama_batches()[:3]]
    engs = [Engine(LlamaForCausalLM(cfg, device="cpu", seed=5), lr=1e-3,
                   guard=g) for g in (None, None, tng.GuardPolicy(
                       warmup_steps=100))]
    eng, ref, guarded = engs
    for b in batches:
        loss = eng.step(b, b)
        with torch.no_grad():
            ref.step_count += 1
        ref_loss = ref.model.loss_fn(b, b)
        grads = torch.autograd.grad(ref_loss, ref.params, allow_unused=True,
                                    materialize_grads=True)
        _parent_adamw(ref, grads)
        assert torch.equal(loss, ref_loss.detach())
        assert torch.equal(guarded.step(b, b), loss)
        assert int(guarded.last_health) == 0
    for other in (ref, guarded):
        for a, b in zip(eng.params + eng.m + eng.v,
                        other.params + other.m + other.v):
            assert torch.equal(a, b)
