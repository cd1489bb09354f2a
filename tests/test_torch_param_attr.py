"""``ParamAttr`` and the initializers of the port against the JAX
package's (CPU, fp32).

- A ``ParamAttr`` sets a parameter's initializer, name, trainability,
  learning-rate factor and regularizer, in every layer that takes one.
- Three eager SGD / Momentum / Adam steps of a model with a per-parameter
  learning rate, a per-parameter regularizer (over the optimizer's
  ``weight_decay``) and a frozen parameter: every parameter within 1e-6 of
  max(1, max |jax|) of the JAX package's after each step (the frozen one
  exactly unchanged).
- ``hapi.Model.train_batch`` (the optimizers' functional path) applies the
  factor too, where the JAX package's jitted step leaves it out: its
  update equals the eager step's to 1e-6.
- Deterministic initializers (Constant, Assign, Dirac) equal JAX's
  exactly; random ones hold their distributions (sample mean and std
  within 5%, bounds exact; Orthogonal's columns orthonormal to 1e-5);
  ``calculate_gain`` equals JAX's.
"""

import math

import jax  # noqa: F401  (JAX on the CPU, as tests/conftest.py sets it)
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as pt
from paddle_tpu_torch import device as pt_device
from paddle_tpu_torch.weights import load_jax_state, state_from_jax_layer
from torch_nn_parity import F, as_np, compare

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def cpu_place():
    prev = pt_device._PLACE
    pt.set_device("cpu")
    yield
    pt_device._PLACE = prev


def _frozen_attr(P):
    return P.ParamAttr(name="frozen", initializer=P.nn.initializer.Constant(
        0.25), learning_rate=0.5, regularizer=P.regularizer.L2Decay(0.1),
        trainable=False)


@pytest.mark.parametrize("make,names", [
    (lambda P, a: P.nn.Linear(3, 4, weight_attr=a), ["weight"]),
    (lambda P, a: P.nn.Linear(3, 4, bias_attr=a), ["bias"]),
    (lambda P, a: P.nn.Embedding(5, 3, weight_attr=a), ["weight"]),
    (lambda P, a: P.nn.Conv2D(2, 4, 3, weight_attr=a, bias_attr=a),
     ["weight", "bias"]),
    (lambda P, a: P.nn.Conv1DTranspose(2, 4, 3, weight_attr=a), ["weight"]),
    (lambda P, a: P.nn.LayerNorm(4, weight_attr=a), ["weight"]),
    (lambda P, a: P.nn.BatchNorm2D(4, bias_attr=a), ["bias"]),
    (lambda P, a: P.nn.GroupNorm(2, 4, weight_attr=a), ["weight"]),
    (lambda P, a: P.nn.InstanceNorm2D(4, weight_attr=a), ["scale"]),
    (lambda P, a: P.nn.RMSNorm(4, weight_attr=a), ["weight"]),
    (lambda P, a: P.nn.PReLU(4, weight_attr=a), ["weight"]),
    (lambda P, a: P.nn.Bilinear(2, 3, 4, weight_attr=a), ["weight"]),
    (lambda P, a: P.nn.LSTM(3, 4, weight_hh_attr=a), ["weight_hh_l0"]),
    (lambda P, a: P.nn.GRU(3, 4, bias_ih_attr=a), ["bias_ih_l0"]),
    (lambda P, a: P.nn.MultiHeadAttention(4, 2, weight_attr=a),
     ["q_proj.weight", "k_proj.weight", "v_proj.weight",
      "out_proj.weight"]),
])
def test_param_attr_reaches_every_layer(make, names):
    """The attr's initializer, factor, regularizer and trainability, in
    the port as in the JAX package; its name on the parameter."""
    jm, tm = make(jp, _frozen_attr(jp)), make(pt, _frozen_attr(pt))
    jps, tps = dict(jm.named_parameters()), dict(tm.named_parameters())
    assert list(tps) == list(jps)
    for n in names:
        j, t = jps[n], tps[n]
        np.testing.assert_array_equal(as_np(t), as_np(j))
        assert not t.trainable and not j.trainable
        assert t.optimize_attr["learning_rate"] == \
            j.optimize_attr["learning_rate"] == 0.5
        assert isinstance(t.regularizer, pt.regularizer.L2Decay)
        assert t.regularizer._coeff == j.regularizer._coeff
        assert t.param_name == j.name == "frozen"
    for n, t in tps.items():
        if n not in names:
            assert t.trainable and t.optimize_attr["learning_rate"] == 1.0


def _model(P):
    P.seed(3)
    I = P.nn.initializer
    return P.nn.Sequential(
        P.nn.Linear(5, 4, weight_attr=P.ParamAttr(
            learning_rate=0.3, regularizer=P.regularizer.L1Decay(0.05))),
        P.nn.Tanh(),
        P.nn.Linear(4, 3, weight_attr=P.ParamAttr(initializer=I.Assign(
            np.linspace(-1, 1, 12, dtype=np.float32).reshape(4, 3))),
            bias_attr=P.ParamAttr(trainable=False,
                                  initializer=I.Constant(0.2))))


def _opt(P, name, params):
    wd = P.regularizer.L2Decay(0.01)
    if name == "SGD":
        return P.optimizer.SGD(0.1, parameters=params, weight_decay=wd)
    if name == "Momentum":
        return P.optimizer.Momentum(0.1, 0.9, parameters=params,
                                    weight_decay=wd)
    return P.optimizer.Adam(0.05, parameters=params, weight_decay=wd)


@pytest.mark.parametrize("opt_name", ["SGD", "Momentum", "Adam"])
def test_three_steps_match_jax(opt_name):
    jm, tm = _model(jp), _model(pt)
    load_jax_state(tm, state_from_jax_layer(jm))
    jo, to = _opt(jp, opt_name, jm.parameters()), _opt(pt, opt_name,
                                                       tm.parameters())
    bias0 = tm[2].bias.detach().clone()
    for step in range(3):
        x, y = F(6, 5), F(6, 3)
        for P, m, o in ((jp, jm, jo), (pt, tm, to)):
            loss = ((m(P.to_tensor(x)) - P.to_tensor(y)) ** 2).mean()
            loss.backward()
            o.step()
            o.clear_grad()
        for (n, t), (_, j) in zip(tm.named_parameters(),
                                  jm.named_parameters()):
            compare(t, j, 1e-6)
    assert torch.equal(tm[2].bias, bias0)


def test_functional_update_applies_the_factor():
    """``hapi.Model.train_batch`` (``_functional_update``) against the
    eager step on the same gradients: equal, factor and regularizer
    included."""
    from paddle_tpu_torch import hapi

    x, y = torch.from_numpy(F(6, 5)), torch.from_numpy(F(6, 3))
    eager, fn = _model(pt), _model(pt)
    fn.set_state_dict(eager.state_dict())
    w0 = eager[0].weight.detach().clone()
    opt = _opt(pt, "Momentum", eager.parameters())
    ((eager(x) - y) ** 2).mean().backward()
    opt.step()
    m = hapi.Model(fn)
    m.prepare(_opt(pt, "Momentum", fn.parameters()),
              lambda out, lab: ((out - lab) ** 2).mean())
    m.train_batch([x], [y])
    for a, b in zip(fn.parameters(), eager.parameters()):
        compare(a, b, 1e-6)
    moved = (eager[0].weight.detach() - w0).abs().max()
    assert moved > 0


def test_hapi_keeps_a_param_attr_name():
    """``hapi.Model`` names parameters by ``named_parameters()`` for
    ``AdamW(apply_decay_param_fun=)``, except one a ``ParamAttr`` named."""
    from paddle_tpu_torch import hapi

    net = pt.nn.Sequential(pt.nn.Linear(3, 4, weight_attr=pt.ParamAttr(
        name="proj_w")), pt.nn.Linear(4, 2))
    hapi.Model(net)
    assert [p.param_name for p in net.parameters()] == [
        "proj_w", "0.bias", "1.weight", "1.bias"]


def test_need_clip_keeps_a_parameter_out_of_the_clip():
    a = pt.nn.Linear(3, 3, weight_attr=pt.ParamAttr(need_clip=False))
    a.weight.grad = torch.full((3, 3), 10.0)
    a.bias.grad = torch.full((3,), 10.0)
    out = dict((id(p), g) for p, g in pt.nn.ClipGradByGlobalNorm(1.0)(
        [(a.weight, a.weight.grad), (a.bias, a.bias.grad)]))
    assert torch.equal(out[id(a.weight)], a.weight.grad)
    assert abs(out[id(a.bias)].norm().item() - 1.0) < 1e-6


def test_deterministic_initializers_equal_jax():
    v = F(2, 3, 3, 3)
    for make, shape in ((lambda I: I.Constant(0.7), (3, 4)),
                        (lambda I: I.Assign(v), (2, 3, 3, 3)),
                        (lambda I: I.Assign(v.tolist()), (6, 9)),
                        (lambda I: I.Dirac(), (4, 2, 3, 3)),
                        (lambda I: I.Dirac(groups=2), (6, 2, 3))):
        ref = make(jp.nn.initializer)(list(shape), "float32")
        out = make(pt.nn.initializer)(list(shape), "float32")
        np.testing.assert_array_equal(as_np(out), as_np(ref))
    for name, param in (("tanh", None), ("relu", None), ("leaky_relu", 0.2),
                        ("leaky_relu", None), ("selu", None),
                        ("linear", None)):
        assert pt.nn.initializer.calculate_gain(name, param) == \
            jp.nn.initializer.calculate_gain(name, param)


@pytest.mark.parametrize("make,mean,std,bound", [
    (lambda I: I.Normal(0.5, 2.0), 0.5, 2.0, None),
    (lambda I: I.Uniform(-0.3, 0.7), 0.2, 1.0 / 12 ** 0.5, (-0.3, 0.7)),
    (lambda I: I.TruncatedNormal(0.0, 0.5), 0.0, None, (-1.0, 1.0)),
    (lambda I: I.XavierNormal(gain=2.0), 0.0, 2.0 * (2 / 700) ** 0.5, None),
    (lambda I: I.XavierUniform(fan_in=100, fan_out=300), 0.0,
     (6 / 400) ** 0.5 / 3 ** 0.5, (-(6 / 400) ** 0.5, (6 / 400) ** 0.5)),
    (lambda I: I.KaimingNormal(negative_slope=0.5), 0.0,
     (2 / (1.25 * 300)) ** 0.5, None),
    (lambda I: I.KaimingUniform(fan_in=50), 0.0, (6 / 50) ** 0.5 / 3 ** 0.5,
     (-(6 / 50) ** 0.5, (6 / 50) ** 0.5)),
])
def test_random_initializers_hold_their_distributions(make, mean, std,
                                                      bound):
    t = make(pt.nn.initializer)([300, 400], "float32",
                                generator=torch.Generator().manual_seed(0))
    assert abs(t.mean().item() - mean) < 0.05 * max(std or 1.0, abs(mean))
    if std is not None:
        assert abs(t.std().item() / std - 1) < 0.05
    if bound is not None:
        assert bound[0] <= t.min().item() and t.max().item() <= bound[1]


@pytest.mark.parametrize("shape", [(6, 4), (4, 6), (3, 2, 5)])
def test_orthogonal_initializer(shape):
    q = pt.nn.initializer.Orthogonal(gain=1.5)(list(shape))
    m = q.reshape(-1, shape[-1]) / 1.5
    small = m.T @ m if m.shape[0] >= m.shape[1] else m @ m.T
    assert torch.allclose(small, torch.eye(small.shape[0]), atol=1e-5)
    assert math.isclose(float(jp.nn.initializer.Orthogonal(1.5)(
        list(shape), "float32").std()), float(q.std()), rel_tol=0.5)
