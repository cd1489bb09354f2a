"""``hapi.Model.fit`` / ``evaluate`` / ``predict`` / ``save`` / ``load`` /
``summary`` of the port against the JAX package's (fp32, CPU).

Both sides ``fit`` 2 epochs from carried weights with ``Momentum(lr=
CosineAnnealingDecay, weight_decay)``, ``Accuracy(topk=(1, 5))``, the
``LRScheduler`` callback and an eval set, on the same batches (one
``np.random.seed`` before each ``fit``: the shuffle and the random
transforms draw from numpy's global RNG in both): LeNet on ``MNIST`` with
``ToTensor``, ResNet-18 on ``Cifar10`` with ``RandomCrop(32, padding=4)``,
``RandomHorizontalFlip``, ``ToTensor`` and ``Normalize``.

Each port step starts from the JAX step's state (parameters, BatchNorm
statistics, Momentum velocity), loaded by a callback at
``on_train_batch_begin``: through ReLU and BatchNorm one fp32 rounding
that moves a pre-activation across 0 moves a whole channel's gradient
(measured in tests/test_torch_vision.py), and free-running steps would
compound it. Tolerances, as there:
- each step's loss within 1e-5 relative; each step's metrics equal;
- after each step every parameter and BatchNorm statistic within 1e-4
  absolute of the JAX step's (the steps move them by more than that);
- the epoch logs (last loss, accumulated accuracy, eval loss within 1e-5
  relative, eval accuracy equal), the learning rate, the epoch at which
  ``EarlyStopping`` stops and ``ModelCheckpoint``'s file names equal;
- ``evaluate`` / ``predict`` on the same state: loss 1e-5 relative,
  logits 1e-5 of the largest; ``summary`` text and dict equal.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu.hapi import callbacks as JCB
from paddle_tpu.hapi.model import Model as JaxModel
from paddle_tpu.vision import datasets as JD
from paddle_tpu.vision import models as JV
from paddle_tpu.vision import transforms as JT
from paddle_tpu_torch import hapi
from paddle_tpu_torch.hapi import callbacks as TCB
from paddle_tpu_torch.vision import datasets as TD
from paddle_tpu_torch.vision import models as TV
from paddle_tpu_torch.vision import transforms as TT
from paddle_tpu_torch.weights import load_jax_state, state_from_jax_layer

torch.set_num_threads(1)

CIFAR_MEAN, CIFAR_STD = [0.4914, 0.4822, 0.4465], [0.2470, 0.2435, 0.2616]

CONFIGS = {
    # net, dataset, transform, train size, eval size, batch, lr
    "lenet_mnist": ("LeNet", {}, "MNIST", lambda M: M.ToTensor(), 48, 16,
                    16, 0.05),
    "resnet18_cifar10": (
        "resnet18", dict(num_classes=10), "Cifar10",
        lambda M: M.Compose([M.RandomCrop(32, padding=4),
                             M.RandomHorizontalFlip(), M.ToTensor(),
                             M.Normalize(CIFAR_MEAN, CIFAR_STD)]),
        24, 8, 8, 0.01),
}


def _velocity(J, jm):
    state = getattr(J, "_opt_state", {}) or {}
    by_id = {id(p): n for n, p in jm.named_parameters()}
    return {by_id[k]: np.asarray(v)
            for k, v in state.get("velocity", {}).items()}


class _Recorder(JCB.Callback):
    """Records the JAX fit: the state before each step, each step's logs
    and the epoch logs."""

    def __init__(self, jm):
        super().__init__()
        self.jm, self.states, self.steps, self.epochs = jm, [], [], []

    def on_train_batch_begin(self, step, logs=None):
        self.states.append((state_from_jax_layer(self.jm),
                            _velocity(self.model, self.jm)))

    def on_train_batch_end(self, step, logs=None):
        self.steps.append(dict(logs))

    def on_epoch_end(self, epoch, logs=None):
        self.epochs.append(dict(logs))

    def on_train_end(self, logs=None):
        self.final = state_from_jax_layer(self.jm)


class _Replay(TCB.Callback):
    """Starts each port step from the recorded JAX state, and keeps the
    port's state after each step."""

    def __init__(self, tm, rec):
        super().__init__()
        self.tm, self.rec, self.i = tm, rec, 0
        self.after, self.steps, self.epochs = [], [], []

    def on_train_batch_begin(self, step, logs=None):
        params, vel = self.rec.states[self.i]
        load_jax_state(self.tm, params)
        named = dict(self.tm.named_parameters())
        acc = self.model._optimizer._accumulators
        acc["velocity"] = {named[n]: torch.from_numpy(v.copy())
                           for n, v in vel.items()}
        self.i += 1

    def on_train_batch_end(self, step, logs=None):
        self.steps.append(dict(logs))
        self.after.append({k: v.detach().clone()
                           for k, v in self.tm.state_dict().items()})

    def on_epoch_end(self, epoch, logs=None):
        self.epochs.append(dict(logs))


def _models(config):
    net, kw, _, _, _, _, _, lr = CONFIGS[config]
    paddle.seed(7)
    jm = getattr(JV, net)(**kw)
    tm = getattr(TV, net)(device="cpu", seed=7, **kw)
    load_jax_state(tm, state_from_jax_layer(jm))
    models = []
    for mod, m, Model in ((paddle, jm, JaxModel), (pt, tm, hapi.Model)):
        opt = mod.optimizer.Momentum(
            learning_rate=mod.optimizer.lr.CosineAnnealingDecay(
                lr, T_max=20),
            momentum=0.9, weight_decay=5e-4, parameters=m.parameters())
        model = Model(m)
        model.prepare(opt, mod.nn.CrossEntropyLoss(),
                      mod.metric.Accuracy(topk=(1, 5)))
        models.append(model)
    return jm, tm, models[0], models[1]


def _data(config, D, T):
    _, _, name, transform, n_train, n_eval, _, _ = CONFIGS[config]
    cls = getattr(D, name)
    return (cls(mode="train", size=n_train, transform=transform(T)),
            cls(mode="test", size=n_eval, transform=transform(T)))


def _fit_pair(config, tmp_path, epochs=2, early=None):
    jm, tm, J, T = _models(config)
    batch = CONFIGS[config][6]
    rec = _Recorder(jm)
    jcb = [rec, JCB.LRScheduler(), JCB.ModelCheckpoint(
        save_dir=str(tmp_path / "jax"))]
    if early:
        jcb.append(JCB.EarlyStopping(**early))
    np.random.seed(1)
    J.fit(*_data(config, JD, JT), batch_size=batch, epochs=epochs,
          verbose=0, callbacks=jcb)
    rep = _Replay(tm, rec)
    tcb = [rep, TCB.LRScheduler(), TCB.ModelCheckpoint(
        save_dir=str(tmp_path / "port"))]
    if early:
        tcb.append(TCB.EarlyStopping(**early))
    np.random.seed(1)
    T.fit(*_data(config, TD, TT), batch_size=batch, epochs=epochs,
          verbose=0, callbacks=tcb)
    return jm, tm, J, T, rec, rep


def _close_logs(got, ref):
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        if "loss" in k:
            assert abs(got[k] - v) <= 1e-5 * abs(v), (k, got[k], v)
        else:
            assert got[k] == v, (k, got[k], v)


def _close_state(got, ref, what):
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        err = np.abs(got[k].detach().numpy() - v).max()
        assert err <= 1e-4, (what, k, err)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def fitted(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(request.param)
    return (request.param, tmp) + _fit_pair(request.param, tmp)


def test_fit_two_epochs_matches_jax(fitted):
    config, tmp, jm, tm, J, T, rec, rep = fitted
    n_train, batch = CONFIGS[config][4], CONFIGS[config][6]
    assert len(rep.steps) == len(rec.steps) == 2 * n_train // batch
    for i, (got, ref) in enumerate(zip(rep.steps, rec.steps)):
        _close_logs(got, ref)
        nxt = rec.states[i + 1][0] if i + 1 < len(rec.states) else rec.final
        _close_state(rep.after[i], nxt, f"step {i}")
        moved = max(np.abs(nxt[k] - rec.states[i][0][k]).max() for k in nxt)
        assert moved > 1e-4, (i, moved)
    assert len(rep.epochs) == len(rec.epochs) == 2
    for got, ref in zip(rep.epochs, rec.epochs):
        _close_logs(got, ref)
        assert {"eval_loss", "eval_acc", "acc", "loss"} <= set(got)
    assert T._optimizer.get_lr() == J._optimizer.get_lr()
    assert T._optimizer._step_count == J._optimizer._step_count
    assert sorted(p.name for p in (tmp / "port").iterdir()) == \
        sorted(p.name for p in (tmp / "jax").iterdir())


def test_evaluate_and_predict_match_jax(fitted):
    config, tmp, jm, tm, J, T, rec, rep = fitted
    load_jax_state(tm, state_from_jax_layer(jm))
    _, ev = _data(config, TD, TT)
    _, jev = _data(config, JD, JT)
    np.random.seed(2)
    ref = J.evaluate(jev, batch_size=4, verbose=0)
    np.random.seed(2)
    got = T.evaluate(ev, batch_size=4, verbose=0)
    _close_logs(got, ref)
    np.random.seed(3)
    jout = J.predict(jev, batch_size=4)
    np.random.seed(3)
    tout = T.predict(ev, batch_size=4)
    assert len(tout) == len(jout)
    for a, b in zip(tout, jout):
        b = np.asarray(b._data)
        assert np.abs(a.numpy() - b).max() <= 1e-5 * max(1.0,
                                                          np.abs(b).max())


def test_pdparams_and_pdopt_load_across_packages(fitted):
    config, tmp, jm, tm, J, T, rec, rep = fitted
    J.save(str(tmp / "from_jax"))
    T.load(str(tmp / "from_jax"))
    for k, v in state_from_jax_layer(jm).items():
        np.testing.assert_array_equal(tm.state_dict()[k].numpy(), v)
    assert T._optimizer._step_count == J._optimizer._step_count
    with torch.no_grad():
        for p in tm.parameters():
            p.mul_(0.5)
    T.save(str(tmp / "from_port"))
    J.load(str(tmp / "from_port"))
    for k, v in state_from_jax_layer(jm).items():
        np.testing.assert_array_equal(v, tm.state_dict()[k].numpy())
    # the port's .pdopt carries its velocity by position; JAX takes it
    vel = J._optimizer._accumulators.get("velocity", {})
    assert len(vel) == len(T._optimizer._accumulators["velocity"]) > 0
    # and the port reads its own .pdopt back
    _, tm2, _, T2 = _models(config)
    T2.load(str(tmp / "from_port"))
    for p, q in zip(tm2.parameters(), tm.parameters()):
        assert torch.equal(p, q)
    got = T2._optimizer._accumulators["velocity"]
    ref = T._optimizer._accumulators["velocity"]
    for p, q in zip(tm2.parameters(), tm.parameters()):
        assert torch.equal(got[p], ref[q])


def test_early_stopping_stops_at_the_same_epoch(tmp_path):
    early = dict(monitor="loss", patience=0)
    *_, J, T, rec, rep = _fit_pair("lenet_mnist", tmp_path, epochs=6,
                                   early=early)
    assert J.stop_training and T.stop_training
    assert len(rep.epochs) == len(rec.epochs) < 6
    for got, ref in zip(rep.epochs, rec.epochs):
        _close_logs(got, ref)


@pytest.mark.parametrize("net,kw", [("LeNet", {}),
                                    ("resnet18", dict(num_classes=10))])
def test_summary_text_and_dict_match_jax(net, kw, capsys):
    paddle.seed(0)
    ref = JaxModel(getattr(JV, net)(**kw)).summary()
    ref_text = capsys.readouterr().out
    got = hapi.Model(getattr(TV, net)(device="cpu", **kw)).summary()
    assert capsys.readouterr().out == ref_text
    assert got == ref and got["total_params"] > 0
