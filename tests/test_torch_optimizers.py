"""Port optimizers (paddle_tpu_torch.optimizer) against the JAX package's on
the same weights and gradients (CPU).

- Each of the fourteen optimizers (and the variants below: Nesterov,
  ``centered`` with momentum, ``amsgrad``, number / ``L1Decay`` /
  ``L2Decay`` decays, the three clips, ``apply_decay_param_fun``), three
  eager ``step()``s in fp32: parameters and accumulators within 1e-6 of
  the largest magnitude of the JAX side's (fp32 rounding of the same
  formulas; parameters measured <= 8.9e-8), accumulators under the same
  names and positions.
- The same through ``_functional_update`` with ``lr`` and ``step`` as
  fp32 0-dim tensors (JAX: ``jnp.float32`` scalars; ASGD's step an int32
  as JAX's hapi passes it), same tolerance. ``LBFGS`` has no per-tensor
  rule: both raise ``NotImplementedError``.
- RAdam over 6 steps, on both sides of ``rho_t = 4`` (steps 1-4 take the
  plain branch, 5-6 the adaptive one), eager and functional.
- bf16 parameters: byte-equal to JAX (tolerance 0), eager and functional.
  This is the repaired rounding: a Python ``lr`` meeting bf16 is rounded
  to bf16 first (JAX's weak type), an fp32 ``lr`` tensor promotes bf16 to
  fp32 (JAX's strong type). Also ``hapi.Model.train_batch`` on a bf16
  network whose gradients are exact (small integers).
- ``state_dict``: a JAX optimizer's state carried into the port goes on
  as JAX goes on, and the port's into JAX, within 1e-6.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu.core.tensor import Parameter, Tensor
from paddle_tpu.hapi.model import Model as JaxModel
from paddle_tpu_torch import hapi
from paddle_tpu_torch.weights import state_from_jax_optimizer

torch.set_num_threads(1)

SHAPES = [(4, 3), (3,), (2, 2, 2)]
TOL = 1e-6


def _reg(mod, kind, c):
    return getattr(mod.regularizer, kind)(c)


CASES = {
    "SGD": lambda m, ps: m.optimizer.SGD(0.1, parameters=ps),
    "SGD_l1decay": lambda m, ps: m.optimizer.SGD(
        0.1, parameters=ps, weight_decay=_reg(m, "L1Decay", 0.05)),
    "SGD_global_clip": lambda m, ps: m.optimizer.SGD(
        0.1, parameters=ps, grad_clip=m.nn.ClipGradByGlobalNorm(0.5)),
    "Momentum": lambda m, ps: m.optimizer.Momentum(
        0.05, momentum=0.9, parameters=ps, weight_decay=0.01),
    "Momentum_nesterov_norm_clip": lambda m, ps: m.optimizer.Momentum(
        0.05, momentum=0.9, parameters=ps, use_nesterov=True,
        grad_clip=m.nn.ClipGradByNorm(0.3)),
    "Adagrad": lambda m, ps: m.optimizer.Adagrad(
        0.1, parameters=ps, initial_accumulator_value=0.1,
        weight_decay=_reg(m, "L2Decay", 0.02)),
    "RMSProp": lambda m, ps: m.optimizer.RMSProp(0.01, parameters=ps),
    "RMSProp_centered": lambda m, ps: m.optimizer.RMSProp(
        0.01, parameters=ps, centered=True, momentum=0.5),
    "Adadelta": lambda m, ps: m.optimizer.Adadelta(1.0, parameters=ps),
    "Adam": lambda m, ps: m.optimizer.Adam(
        0.01, parameters=ps, grad_clip=m.nn.ClipGradByValue(0.8)),
    "Adam_amsgrad": lambda m, ps: m.optimizer.Adam(0.01, parameters=ps,
                                                   amsgrad=True),
    "AdamW": lambda m, ps: m.optimizer.AdamW(
        0.01, parameters=ps, weight_decay=0.1,
        apply_decay_param_fun=lambda n: n != "p1"),
    "AdamW_l2decay": lambda m, ps: m.optimizer.AdamW(
        0.01, parameters=ps, weight_decay=_reg(m, "L2Decay", 0.05)),
    "Adamax": lambda m, ps: m.optimizer.Adamax(0.01, parameters=ps),
    "NAdam": lambda m, ps: m.optimizer.NAdam(0.01, parameters=ps),
    "RAdam": lambda m, ps: m.optimizer.RAdam(0.01, parameters=ps),
    "Lamb": lambda m, ps: m.optimizer.Lamb(
        0.01, parameters=ps,
        exclude_from_weight_decay_fn=lambda p: len(p.shape) == 1),
    "LBFGS": lambda m, ps: m.optimizer.LBFGS(0.1, parameters=ps),
    "ASGD": lambda m, ps: m.optimizer.ASGD(0.1, batch_num=2, parameters=ps),
    "Rprop": lambda m, ps: m.optimizer.Rprop(0.01, parameters=ps),
}
FUNCTIONAL = sorted(set(CASES) - {"LBFGS"})


def _arrays(seed, steps):
    rng = np.random.default_rng(seed)
    w = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    g = [[rng.standard_normal(s).astype(np.float32) for s in SHAPES]
         for _ in range(steps)]
    return w, g


def _params(w):
    jps = [Parameter(jnp.asarray(a), name=f"p{i}") for i, a in enumerate(w)]
    tps = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in w]
    for i, p in enumerate(tps):
        p.param_name = f"p{i}"
    return jps, tps


def _close(got, ref, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    ref = np.asarray(getattr(ref, "_data", ref), np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max() if ref.size else 0.0
    assert err <= TOL * max(1.0, np.abs(ref).max()), (what, err)


def _eager(case, steps=3, seed=0):
    w, gs = _arrays(seed, steps)
    jps, tps = _params(w)
    jo, to = CASES[case](paddle, jps), CASES[case](pt, tps)
    for g in gs:
        for jp, tp, a in zip(jps, tps, g):
            jp.grad = Tensor(jnp.asarray(a))
            tp.grad = torch.from_numpy(a.copy())
        jo.step()
        to.step()
    return jps, tps, jo, to


def _check_state(jo, to):
    js, ts = jo.state_dict(), to.state_dict()
    assert ts["step_count"] == js["step_count"]
    assert sorted(ts["accumulators"]) == sorted(js["accumulators"])
    for name, d in js["accumulators"].items():
        assert sorted(ts["accumulators"][name]) == sorted(d), name
        for k, v in d.items():
            _close(ts["accumulators"][name][k], v, f"{name}[{k}]")


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_eager_steps_match_jax(case):
    jps, tps, jo, to = _eager(case)
    for i, (jp, tp) in enumerate(zip(jps, tps)):
        _close(tp, jp._data, f"p{i}")
    _check_state(jo, to)
    assert to._step_count == 3


def _functional(mod, case, w, gs, params, lrs, step_dtype):
    opt = CASES[case](mod, None)
    vals, acc = list(w), {}
    for t, g in enumerate(gs, start=1):
        if mod is pt:
            vals, acc = opt._functional_update(
                [torch.from_numpy(a.copy()) for a in g], vals, params, acc,
                torch.tensor(lrs, dtype=torch.float32),
                torch.tensor(float(t)))
        else:
            vals, acc = opt._functional_update(
                [jnp.asarray(a) for a in g], vals, params, acc,
                jnp.float32(lrs), jnp.asarray(t, step_dtype))
    return vals, acc


@pytest.mark.parametrize("case", FUNCTIONAL)
def test_functional_update_matches_jax(case):
    w, gs = _arrays(1, 3)
    jps, tps = _params(w)
    lr = CASES[case](pt, None).get_lr()
    step_dtype = jnp.int32 if case == "ASGD" else jnp.float32
    jv, jacc = _functional(paddle, case, [jnp.asarray(a) for a in w], gs,
                           jps, lr, step_dtype)
    tv, tacc = _functional(pt, case, [torch.from_numpy(a.copy()) for a in w],
                           gs, tps, lr, None)
    for i, (a, b) in enumerate(zip(tv, jv)):
        assert a.dtype == torch.float32
        _close(a, b, f"p{i}")
    assert sorted(tacc) == sorted(jacc)
    for name in jacc:
        for jp, tp in zip(jps, tps):
            _close(tacc[name][tp], jacc[name][id(jp)], name)


def test_lbfgs_has_no_functional_rule_in_either_package():
    w, gs = _arrays(2, 1)
    jps, tps = _params(w)
    with pytest.raises(NotImplementedError):
        paddle.optimizer.LBFGS(parameters=jps)._functional_update(
            [jnp.asarray(a) for a in gs[0]], [p._data for p in jps], jps,
            {}, jnp.float32(1.0), jnp.float32(1.0))
    with pytest.raises(NotImplementedError):
        pt.optimizer.LBFGS(parameters=tps)._functional_update(
            [torch.from_numpy(a) for a in gs[0]], [p.detach() for p in tps],
            tps, {}, torch.tensor(1.0), torch.tensor(1.0))


@pytest.mark.parametrize("mode", ["eager", "functional"])
def test_radam_on_both_sides_of_rho_4(mode):
    """beta2 = 0.999: rho_t is 1.0, 2.0, 3.0, 4.0 (to 1e-3) for steps 1-4
    and above 4 from step 5, so six steps run both branches."""
    b2 = 0.999
    rho_inf = 2 / (1 - b2) - 1
    rho = [rho_inf - 2 * t * b2 ** t / (1 - b2 ** t) for t in range(1, 7)]
    assert max(rho[:4]) <= 4 < min(rho[4:])
    if mode == "eager":
        jps, tps, jo, to = _eager("RAdam", steps=6, seed=3)
        for i, (jp, tp) in enumerate(zip(jps, tps)):
            _close(tp, jp._data, f"p{i}")
        _check_state(jo, to)
        return
    w, gs = _arrays(3, 6)
    jps, tps = _params(w)
    jv, _ = _functional(paddle, "RAdam", [jnp.asarray(a) for a in w], gs,
                        jps, 0.01, jnp.float32)
    tv, _ = _functional(pt, "RAdam", [torch.from_numpy(a.copy()) for a in w],
                        gs, tps, 0.01, None)
    for i, (a, b) in enumerate(zip(tv, jv)):
        _close(a, b, f"p{i}")


# ---- bf16: the repaired rounding ----

def _bf16(a):
    return a.astype(np.float32).astype(ml_dtypes.bfloat16)


def _torch_bf16(a):
    return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.detach().view(torch.int16).numpy()
    return np.asarray(getattr(x, "_data", x)).view(np.int16)


BF16_CASES = {
    "SGD": lambda m, ps, clip: m.optimizer.SGD(
        0.37, parameters=ps, grad_clip=clip),
    "Momentum": lambda m, ps, clip: m.optimizer.Momentum(
        0.37, momentum=0.9, parameters=ps, grad_clip=clip),
    "Momentum_nesterov": lambda m, ps, clip: m.optimizer.Momentum(
        0.37, momentum=0.9, use_nesterov=True, parameters=ps,
        grad_clip=clip),
}


def _bf16_case(seed=0, n=64):
    """The weights and gradients of the fault's check: weights
    ``default_rng(0).normal(size=64)``, gradients 3x the next 64 normals,
    both cast to bf16."""
    rng = np.random.default_rng(seed)
    return _bf16(rng.normal(size=n)), _bf16(3 * rng.normal(size=n))


@pytest.mark.parametrize("clip", [False, True], ids=["noclip", "globalclip"])
@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_bf16_eager_step_is_byte_equal_to_jax(case, clip):
    w, g = _bf16_case()
    jp = Parameter(jnp.asarray(w), name="w")
    tp = torch.nn.Parameter(_torch_bf16(w))
    jo = BF16_CASES[case](paddle, [jp], paddle.nn.ClipGradByGlobalNorm(1.0)
                          if clip else None)
    to = BF16_CASES[case](pt, [tp], pt.nn.ClipGradByGlobalNorm(1.0)
                          if clip else None)
    for _ in range(2):
        jp.grad = Tensor(jnp.asarray(g))
        tp.grad = _torch_bf16(g)
        jo.step()
        to.step()
        assert tp.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(tp), _bits(jp))


def test_bf16_sgd_step_of_the_fault_is_byte_equal():
    """The fault's own check: one SGD(0.37) step; before the repair 27 of
    64 elements differed by up to 0.015625."""
    w, g = _bf16_case()
    jp = Parameter(jnp.asarray(w), name="w")
    jp.grad = Tensor(jnp.asarray(g))
    paddle.optimizer.SGD(0.37, parameters=[jp]).step()
    tp = torch.nn.Parameter(_torch_bf16(w))
    tp.grad = _torch_bf16(g)
    pt.optimizer.SGD(0.37, parameters=[tp]).step()
    np.testing.assert_array_equal(_bits(tp), _bits(jp))
    naive = (_torch_bf16(w) - 0.37 * _torch_bf16(g)).view(torch.int16)
    assert (naive.numpy() != _bits(jp)).sum() > 0   # the unrepaired rule


@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_bf16_functional_update_is_byte_equal_to_jax(case):
    w, g = _bf16_case(1)
    jp = Parameter(jnp.asarray(w), name="w")
    tp = torch.nn.Parameter(_torch_bf16(w))
    jo, to = BF16_CASES[case](paddle, None, None), \
        BF16_CASES[case](pt, None, None)
    jv, tv, jacc, tacc = [jnp.asarray(w)], [_torch_bf16(w)], {}, {}
    for t in (1, 2):
        jv, jacc = jo._functional_update(
            [jnp.asarray(g).astype(jnp.float32)], jv, [jp], jacc,
            jnp.float32(0.37), jnp.float32(t))
        tv, tacc = to._functional_update(
            [_torch_bf16(g).float()], tv, [tp], tacc, torch.tensor(0.37),
            torch.tensor(float(t)))
        assert tv[0].dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(tv[0]), _bits(jv[0]))


def test_bf16_hapi_train_batch_is_byte_equal_to_jax():
    """A bias-free bf16 Linear whose loss is sum(out * y): with small
    integer inputs every gradient (x^T y) is exact in bf16, so the update's
    rounding alone is under test (SGD 0.37 and Momentum, 2 steps)."""
    rng = np.random.default_rng(5)
    w = _bf16(rng.normal(size=(6, 4)))
    xs = [_bf16(rng.integers(-3, 4, size=(5, 6))) for _ in range(2)]
    ys = [_bf16(rng.integers(-2, 3, size=(5, 4))) for _ in range(2)]
    for case in ("SGD", "Momentum"):
        jl = paddle.nn.Linear(6, 4, bias_attr=False)
        jl.weight._data = jnp.asarray(w)
        tl = pt.nn.Linear(6, 4, bias_attr=False, device="cpu").to(
            torch.bfloat16)
        with torch.no_grad():
            tl.weight.copy_(_torch_bf16(w))
        J, T = JaxModel(jl), hapi.Model(tl)
        J.prepare(BF16_CASES[case](paddle, jl.parameters(), None),
                  lambda out, y: (out * y).sum())
        T.prepare(BF16_CASES[case](pt, tl.parameters(), None),
                  lambda out, y: (out * y).sum())
        for x, y in zip(xs, ys):
            (jloss,), _ = J.train_batch(Tensor(jnp.asarray(x)),
                                        Tensor(jnp.asarray(y)))
            (tloss,), _ = T.train_batch(_torch_bf16(x), _torch_bf16(y))
            assert tloss == jloss
            assert tl.weight.dtype == torch.bfloat16
            np.testing.assert_array_equal(_bits(tl.weight),
                                          _bits(jl.weight))


# ---- state carried across ----

@pytest.mark.parametrize("case", ["Momentum", "Adam_amsgrad", "NAdam",
                                  "ASGD", "Rprop", "Adagrad"])
def test_jax_state_resumes_in_the_port_and_back(case):
    """JAX steps twice; its state (through state_from_jax_optimizer) goes
    into a port optimizer over the same values; both take two more steps.
    Then the port's state goes into a fresh JAX optimizer, which must take
    the next step as the port does."""
    w, gs = _arrays(4, 5)
    jps, _ = _params(w)
    jo = CASES[case](paddle, jps)
    for g in gs[:2]:
        for jp, a in zip(jps, g):
            jp.grad = Tensor(jnp.asarray(a))
        jo.step()
    _, tps = _params([np.asarray(p._data) for p in jps])
    to = CASES[case](pt, tps)
    to.set_state_dict(state_from_jax_optimizer(jo))
    assert to._step_count == 2
    for g in gs[2:4]:
        for jp, tp, a in zip(jps, tps, g):
            jp.grad = Tensor(jnp.asarray(a))
            tp.grad = torch.from_numpy(a.copy())
        jo.step()
        to.step()
    for i, (jp, tp) in enumerate(zip(jps, tps)):
        _close(tp, jp._data, f"p{i}")
    _check_state(jo, to)
    jps2, _ = _params([p.detach().numpy() for p in tps])
    jo2 = CASES[case](paddle, jps2)
    ts = to.state_dict()
    jo2.set_state_dict({"step_count": ts["step_count"], "accumulators": {
        n: {k: v.numpy() for k, v in d.items()}
        for n, d in ts["accumulators"].items()}})
    for jp, tp, a in zip(jps2, tps, gs[4]):
        jp.grad = Tensor(jnp.asarray(a))
        tp.grad = torch.from_numpy(a.copy())
    jo2.step()
    to.step()
    for i, (jp, tp) in enumerate(zip(jps2, tps)):
        _close(tp, jp._data, f"p{i}")


def test_lr_scheduler_state_rides_the_optimizer_state():
    w, _ = _arrays(6, 0)
    jps, tps = _params(w)
    jo = paddle.optimizer.SGD(paddle.optimizer.lr.StepDecay(0.1, 2, 0.5),
                              parameters=jps)
    to = pt.optimizer.SGD(pt.optimizer.lr.StepDecay(0.1, 2, 0.5),
                          parameters=tps)
    for _ in range(5):
        jo._lr_step()
    to.set_state_dict(state_from_jax_optimizer(jo))
    assert to.get_lr() == jo.get_lr() == 0.025
    assert to.state_dict()["LR_Scheduler"] == jo.state_dict()["LR_Scheduler"]
