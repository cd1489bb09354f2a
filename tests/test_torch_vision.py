"""Port vision models (paddle_tpu_torch.vision.models) and the hapi /
optimizer path against the JAX package's on carried weights (fp32, CPU):
LeNet's and the ResNets' forward; 3
``hapi.Model.train_batch`` steps of ResNet-18 (Momentum 0.9) and of LeNet
(SGD with coupled weight decay, Nesterov Momentum, and each gradient clip),
then ``eval_batch`` and ``predict_batch``.

Each train step starts both sides from the same state: before steps 2 and
3 the port takes the JAX model's parameters, BatchNorm statistics and
Momentum velocity. ReLU makes a gradient jump where a pre-activation
crosses 0, and fp32 rounding moves a few pre-activations within ~1e-7 of
0 across it; inside a BatchNorm channel one such element moves the
channel's whole gradient (measured: 9% of a layer's largest gradient, on
both sides of an fp64 run), and free-running steps would compound it.

Tolerances (fp32, the learning rates as stated below):
- logits: max abs error <= 1e-5 x max(1, max |jax|); ResNet-50 1e-4 in
  eval mode and 2e-3 in train mode, where layer4's BatchNorm normalises
  over 4 values a channel (batch 4, 1 x 1 maps) and amplifies rounding:
  JAX and the port each differ from an fp64 run by ~1e-3 of the largest
  logit there (measured: 1.4e-3 and 7.9e-4); the running statistics that
  this train step leaves are held to the same 2e-3 of their largest;
- each step: the loss within 1e-5 relative; every parameter and
  BatchNorm statistic within 1e-4 absolute (ResNet-18 at lr 1e-3, LeNet
  at lr 1e-2: a gradient jump of the size above moves a parameter by at
  most ~2e-5); and the step must move the parameters by more than that
  tolerance, so the check sees the update;
- ``eval_batch``'s loss within 1e-5 relative, ``predict_batch`` as
  logits.
"""

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import autograd_engine
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.hapi.model import Model as JaxModel
from paddle_tpu.jit.api import _collect_state, _Swap
from paddle_tpu.vision import models as JV
from paddle_tpu_torch import hapi, nn, optimizer
from paddle_tpu_torch.vision import models as TV
from paddle_tpu_torch.weights import load_jax_state, state_from_jax_layer

torch.set_num_threads(1)

B = 8


def _pair(name, **kw):
    paddle.seed(7)
    jm = getattr(JV, name)(**kw)
    tm = getattr(TV, name)(device="cpu", seed=7, **kw)
    load_jax_state(tm, state_from_jax_layer(jm))
    return jm, tm


def _jax_forward(jm, x, training=False):
    """The JAX model's forward, jitted (eager JAX dispatch is slow here);
    returns (logits, buffers after the call)."""
    names, tensors = _collect_state(jm)
    jm.train() if training else jm.eval()

    def fwd(arrs, a):
        with autograd_engine.no_grad(), _Swap(tensors, arrs):
            out = jm(Tensor(a))._data
            bufs = {n: t.__dict__.pop("_pending_update", t._data)
                    for n, t in zip(names, tensors) if n.startswith("B:")}
            return out, bufs

    out, bufs = jax.jit(fwd)([t._data for t in tensors], x)
    return np.asarray(out), {n[2:]: np.asarray(v) for n, v in bufs.items()}


def _close(port, ref, tol=1e-5):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = np.abs(port - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), err


def _images(c, size, seed, n=B):
    return np.random.default_rng(seed).standard_normal(
        (n, c, size, size)).astype(np.float32)


def _labels(seed, classes=10):
    return np.random.default_rng(seed + 50).integers(0, classes, B).astype(
        np.int64)


def test_lenet_and_resnet18_logits_match_jax():
    for name, c, size in (("LeNet", 1, 28), ("resnet18", 3, 32)):
        kw = {} if name == "LeNet" else dict(num_classes=10)
        jm, tm = _pair(name, **kw)
        x = _images(c, size, 1)
        for training in (False, True):
            ref, bufs = _jax_forward(jm, x, training)
            tm.train(training)
            with torch.no_grad():
                _close(tm(torch.from_numpy(x)), ref)
            for k, v in bufs.items():
                _close(tm.state_dict()[k], v)


def test_resnet50_bottleneck_forward_matches_jax():
    """Train mode (batch statistics; the running ones updated), then eval
    mode (the updated running ones) on 32 x 32 inputs."""
    jm, tm = _pair("resnet50", num_classes=10)
    x = _images(3, 32, 2, n=4)
    ref, bufs = _jax_forward(jm, x, training=True)
    tm.train()
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)), ref, 2e-3)
    for k, v in bufs.items():
        _close(tm.state_dict()[k], v, 2e-3)
    jm.set_state_dict(bufs)
    ref, _ = _jax_forward(jm, x)
    tm.eval()
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)), ref, 1e-4)


def _velocity(jax_model, jm):
    """The JAX hapi step's Momentum velocity by parameter name."""
    state = getattr(jax_model, "_opt_state", {}) or {}
    by_id = {id(p): n for n, p in jm.named_parameters()}
    return {by_id[k]: np.asarray(v)
            for k, v in state.get("velocity", {}).items()}


def _sync(jm, tm, jax_model, topt):
    """Start the port's next step from the JAX side's state."""
    load_jax_state(tm, state_from_jax_layer(jm))
    params = dict(tm.named_parameters())
    for name, v in _velocity(jax_model, jm).items():
        topt._accumulators["velocity"][params[name]] = torch.from_numpy(
            v.copy())


def _train_steps(jm, tm, jopt, topt, c, size, classes):
    J = JaxModel(jm)
    J.prepare(optimizer=jopt, loss=paddle.nn.CrossEntropyLoss())
    T = hapi.Model(tm)
    T.prepare(optimizer=topt, loss=nn.CrossEntropyLoss())
    for step in range(3):
        if step:
            _sync(jm, tm, J, topt)
        x, y = _images(c, size, 10 + step), _labels(step, classes)
        before = state_from_jax_layer(jm)
        (jl,), _ = J.train_batch(paddle.to_tensor(x), paddle.to_tensor(y))
        (tl,), metrics = T.train_batch(torch.from_numpy(x),
                                       torch.from_numpy(y))
        assert metrics == []
        assert abs(tl - jl) <= 1e-5 * abs(jl), (step, tl, jl)
        after, ours = state_from_jax_layer(jm), tm.state_dict()
        moved = max(np.abs(after[k] - before[k]).max() for k in after)
        assert moved > 1e-4, moved
        for k, v in after.items():
            err = np.abs(ours[k].numpy() - v).max()
            assert err <= 1e-4, (step, k, err)
    assert topt._step_count == jopt._step_count == 3
    _sync(jm, tm, J, topt)
    x, y = _images(c, size, 20), _labels(20, classes)
    (jl,), _ = J.eval_batch(paddle.to_tensor(x), paddle.to_tensor(y))
    (tl,), _ = T.eval_batch(torch.from_numpy(x), torch.from_numpy(y))
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    assert T.eval_batch(torch.from_numpy(x)) == ([], [])
    ref = np.asarray(J.predict_batch(paddle.to_tensor(x))._data)
    _close(T.predict_batch(torch.from_numpy(x)), ref)
    assert not tm.training


def test_resnet18_hapi_train_batch_with_momentum_matches_jax():
    jm, tm = _pair("resnet18", num_classes=10)
    jopt = paddle.optimizer.Momentum(learning_rate=1e-3, momentum=0.9,
                                     parameters=jm.parameters())
    topt = optimizer.Momentum(learning_rate=1e-3, momentum=0.9,
                              parameters=tm.parameters())
    _train_steps(jm, tm, jopt, topt, 3, 32, 10)
    assert len(topt._accumulators["velocity"]) == len(list(tm.parameters()))
    assert all(v.dtype == torch.float32
               for v in topt._accumulators["velocity"].values())


LENET_CASES = {
    "sgd_decay_global_clip": lambda mod, ps: mod.optimizer.SGD(
        learning_rate=1e-2, parameters=ps, weight_decay=1e-2,
        grad_clip=mod.nn.ClipGradByGlobalNorm(0.5)),
    "nesterov_norm_clip": lambda mod, ps: mod.optimizer.Momentum(
        learning_rate=1e-2, momentum=0.9, parameters=ps, use_nesterov=True,
        grad_clip=mod.nn.ClipGradByNorm(0.1)),
    "sgd_value_clip": lambda mod, ps: mod.optimizer.SGD(
        learning_rate=1e-2, parameters=ps,
        grad_clip=mod.nn.ClipGradByValue(0.01)),
}


@pytest.mark.parametrize("case", sorted(LENET_CASES))
def test_lenet_hapi_train_batch_optimizers_match_jax(case):
    import paddle_tpu_torch

    jm, tm = _pair("LeNet")
    make = LENET_CASES[case]
    _train_steps(jm, tm, make(paddle, jm.parameters()),
                 make(paddle_tpu_torch, tm.parameters()), 1, 28, 10)


def test_optimizer_step_and_refusals():
    """``step()`` from ``.grad`` is the hapi update; an LR scheduler, an
    ``L2Decay`` object and parameter groups are taken; ``AdamW``,
    ``prepare(metrics=)``, ``fit`` and ``save`` exist; what the port does not
    take raises naming its slice."""
    import paddle_tpu_torch
    from paddle_tpu_torch import metric, regularizer

    w = torch.nn.Parameter(torch.tensor([1.0, -2.0]))
    for decay in (0.1, regularizer.L2Decay(0.1)):
        w.data = torch.tensor([1.0, -2.0])
        opt = optimizer.Momentum(learning_rate=0.5, momentum=0.5,
                                 parameters=[{"params": [w]}],
                                 weight_decay=decay)
        for expect in ([0.95, -1.9], [0.8775, -1.755]):
            (w * torch.tensor([0.0, 0.0])).sum().backward()  # zero gradient
            opt.step()
            opt.clear_grad()
            assert torch.allclose(w, torch.tensor(expect)), w
            assert w.grad is None
        assert opt._step_count == 2 and opt.get_lr() == 0.5
    sched = optimizer.lr.StepDecay(0.5, step_size=1, gamma=0.5)
    opt = optimizer.SGD(learning_rate=sched, parameters=[w])
    opt._lr_step()
    assert opt.get_lr() == 0.25 and opt.state_dict()["LR_Scheduler"][
        "last_epoch"] == 1
    assert isinstance(optimizer.AdamW(parameters=[w]), optimizer.Adam)
    with pytest.raises(TypeError, match="L2Decay"):
        optimizer.AdamW(parameters=[w], weight_decay=regularizer.L1Decay(1.0))
    net = torch.nn.Linear(2, 2)
    m = hapi.Model(net)
    m.prepare(optimizer=optimizer.SGD(parameters=net.parameters()),
              loss=nn.CrossEntropyLoss(), metrics=metric.Accuracy())
    assert [x.name() for x in m._metrics] == ["acc"]
    # the JAX package takes these and ignores them: the port refuses them
    refused = (lambda: m.train_batch(torch.zeros(1, 2), update=False),
               lambda: m.fit([], accumulate_grad_batches=2),
               lambda: m.prepare(amp_configs={"level": "O1"}))
    for call in refused:
        with pytest.raises(NotImplementedError, match="item 8"):
            call()
    # flops and the breadth transforms are ported
    # (tests/test_torch_flops.py, tests/test_torch_transforms.py)
    assert m.flops([1, 2]) == 2 * 1 * 2 * 2 + 1 * 2
    assert callable(paddle_tpu_torch.vision.transforms.ColorJitter)
    # static minimize is ported (tests/test_torch_static.py); a loss that
    # is neither a Variable nor a tensor fails as in the JAX package
    with pytest.raises(AttributeError, match="backward"):
        optimizer.SGD(parameters=[w]).minimize(object())
    # amp.debugging is ported (tests/test_torch_amp_debugging.py)
    assert callable(paddle_tpu_torch.amp.debugging.compare_accuracy)
    # paddle.linalg is ported (tests/test_torch_linalg.py)
    assert paddle_tpu_torch.linalg.inv is paddle_tpu_torch.inv