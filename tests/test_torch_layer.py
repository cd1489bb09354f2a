"""The port's ``nn.Layer`` API (a ``torch.nn.Module`` with Paddle's names)
against the JAX package's ``Layer``, on the CPU: registration, traversal
order, hooks, train / eval, ``state_dict`` / ``set_state_dict`` names and
values, dtype moves that keep each ``Parameter``'s identity, the
containers, and the rebased layers' ``state_dict`` names (Linear, Conv2D,
BatchNorm2D with its ``_mean`` / ``_variance`` buffers, LayerNorm,
Embedding, the Transformer family). Names and orders compare exactly;
values carried across compare exactly (copies)."""

import collections

import jax  # noqa: F401  (JAX on the CPU, as tests/conftest.py sets it)
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn as jnn
import paddle_tpu_torch as pt
from paddle_tpu_torch import device as pt_device
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.core.tensor import Parameter
from paddle_tpu_torch.weights import load_jax_state, state_from_jax_layer

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def cpu_place():
    prev = pt_device._PLACE
    pt.set_device("cpu")
    yield
    pt_device._PLACE = prev


def _tree(nn_mod):
    class Block(nn_mod.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn_mod.Linear(4, 3)
            self.scale = self.create_parameter([3], default_initializer=None,
                                               is_bias=True)
            self.register_buffer("steps", None)
            self.register_buffer("stat", (jp if nn_mod is jnn else pt)
                                 .zeros([3]))
            self.register_buffer("scratch", (jp if nn_mod is jnn else pt)
                                 .ones([3]), persistable=False)

        def forward(self, x):
            return self.fc(x) * self.scale + self.stat

    class Net(nn_mod.Layer):
        def __init__(self):
            super().__init__()
            self.a = Block()
            self.b = nn_mod.LayerList([nn_mod.Linear(3, 3), Block()])
            self.add_sublayer("c", nn_mod.Sequential(
                ("relu", nn_mod.ReLU()), ("out", nn_mod.Linear(3, 2))))
            self.add_parameter("gain", self.create_parameter(
                [2], default_initializer=None))

        def forward(self, x):
            h = self.a(x)
            h = self.b[0](h)
            return self.c(h) * self.gain

    return Net()


def test_traversal_and_state_dict_names_equal_jax():
    jm, tm = _tree(jnn), _tree(pnn)
    assert [n for n, _ in tm.named_parameters()] == \
        [n for n, _ in jm.named_parameters()]
    assert [n for n, _ in tm.named_sublayers()] == \
        [n for n, _ in jm.named_sublayers()]
    assert [n for n, _ in tm.named_sublayers(include_self=True)] == \
        [n for n, _ in jm.named_sublayers(include_self=True)]
    assert len(tm.sublayers()) == len(jm.sublayers())
    assert isinstance(tm.parameters(), list)
    assert len(tm.parameters()) == len(jm.parameters())
    assert list(tm.state_dict()) == list(jm.state_dict())
    assert "a.scratch" not in tm.state_dict()
    assert all(isinstance(p, Parameter) for p in tm.parameters())
    assert tm.full_name().startswith("net_")


def test_state_dict_round_trip_with_jax():
    jm, tm = _tree(jnn), _tree(pnn)
    x = np.random.default_rng(0).standard_normal((5, 4)).astype(np.float32)
    missing, unexpected = tm.set_state_dict(
        {k: np.asarray(v._data) for k, v in jm.state_dict().items()})
    assert missing == [] and unexpected == []
    np.testing.assert_allclose(tm(pt.to_tensor(x)).detach().numpy(),
                               jm(jp.to_tensor(x)).numpy(), rtol=1e-6,
                               atol=1e-6)
    back = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
    jm2 = _tree(jnn)
    jm2.set_state_dict(back)
    for k, v in jm2.state_dict().items():
        np.testing.assert_array_equal(np.asarray(v._data), back[k])
    m2, u2 = tm.set_state_dict({"nope": np.zeros(1), "gain": np.ones(2)})
    assert u2 == ["nope"] and "gain" not in m2
    with pytest.raises(ValueError, match="shape mismatch"):
        tm.set_state_dict({"gain": np.ones(3)})


def test_train_eval_apply_and_hooks():
    for nn_mod, P in ((jnn, jp), (pnn, pt)):
        m = _tree(nn_mod)
        m.eval()
        assert not m.training and not m.a.fc.training
        m.train()
        assert m.b[1].training
        order = []
        m.apply(lambda layer: order.append(type(layer).__name__))
        if nn_mod is jnn:
            ref_order = order
        else:
            assert order == ref_order
        calls = []
        h1 = m.a.register_forward_pre_hook(
            lambda layer, inp: (inp[0] * 2,))
        h2 = m.a.register_forward_post_hook(
            lambda layer, inp, out: calls.append(1) or out * 0)
        out = m(P.to_tensor(np.ones((2, 4), np.float32)))
        assert calls == [1]
        h1.remove()
        h2.remove()
        m(P.to_tensor(np.ones((2, 4), np.float32)))
        assert calls == [1]
        if nn_mod is jnn:
            ref_out = out.numpy()
    # the post hook zeroed the block's output: the rest is the same map
    assert ref_out.shape == (2, 2)


def test_setattr_tensor_into_parameter_and_clear_gradients():
    m = pnn.Linear(2, 2)
    w = m.weight
    m.weight = pt.ones([2, 2])
    assert m.weight is w and torch.equal(w, torch.ones(2, 2))
    m(pt.ones([1, 2])).sum().backward()
    assert w.grad is not None
    m.clear_gradients()
    assert w.grad is None


def test_dtype_moves_keep_parameter_identity():
    m = _tree(pnn)
    params = m.parameters()
    m.to(dtype="bfloat16")
    assert all(a is b for a, b in zip(params, m.parameters()))
    assert all(p.dtype == torch.bfloat16 for p in params)
    assert m.a.stat.dtype == torch.bfloat16
    m.float()
    assert all(p.dtype == torch.float32 for p in params)
    m.astype("float16")
    assert params[0].dtype == torch.float16
    m.to(torch.float32)
    assert params[0].dtype == torch.float32


def test_containers():
    ll = pnn.LayerList([pnn.Linear(2, 2)])
    ll.append(pnn.ReLU())
    ll.insert(0, pnn.Linear(2, 2))
    ll.extend([pnn.ReLU()])
    assert len(ll) == 4 and isinstance(ll[-1], pnn.ReLU)
    assert isinstance(ll[1:], pnn.LayerList) and len(ll[1:]) == 3
    seq = pnn.Sequential(collections.OrderedDict(
        [("l1", pnn.Linear(2, 3)), ("act", pnn.ReLU())]))
    assert [n for n, _ in seq.named_sublayers()] == ["l1", "act"]
    assert list(pnn.Sequential(pnn.ReLU(), pnn.ReLU()).state_dict()) == []
    plist = pnn.ParameterList([Parameter(torch.ones(2)),
                               Parameter(torch.zeros(3))])
    assert [n for n, _ in plist.named_parameters()] == ["0", "1"]
    assert isinstance(plist.parameters(), list)


def test_create_parameter_defaults_and_refusals():
    m = pnn.Layer()
    w = m.create_parameter([300, 200])
    b = m.create_parameter([5], is_bias=True)
    assert isinstance(w, Parameter) and not w.stop_gradient and w.trainable
    assert abs(w.std().item() / np.sqrt(2.0 / 500) - 1) < 0.05
    assert torch.equal(b, torch.zeros(5))
    assert m.create_parameter([2], attr=False, dtype="bfloat16").dtype == \
        torch.bfloat16
    with pytest.raises(TypeError, match="ParamAttr"):
        m.create_parameter([2], attr=object())
    with pytest.raises(TypeError, match="ParamAttr"):
        pnn.LayerNorm(4, weight_attr=object())
    assert pnn.LayerNorm(4, weight_attr=False, bias_attr=False).weight is None
    assert pnn.Linear(2, 2, weight_attr=False).bias is not None
    assert pnn.Linear(2, 2, bias_attr=False).bias is None
    t = m.create_tensor(dtype="int32", persistable=True)
    assert t.dtype == torch.int32 and t.persistable


LAYERS = {
    "linear": lambda nn_mod: nn_mod.Linear(4, 3),
    "conv2d": lambda nn_mod: nn_mod.Conv2D(3, 4, 3, padding=1),
    "batchnorm2d": lambda nn_mod: nn_mod.BatchNorm2D(4),
    "layernorm": lambda nn_mod: nn_mod.LayerNorm([4, 3]),
    "embedding": lambda nn_mod: nn_mod.Embedding(10, 4, padding_idx=2),
    "mha": lambda nn_mod: nn_mod.MultiHeadAttention(8, 2, kdim=6, vdim=5),
    "encoder_layer": lambda nn_mod: nn_mod.TransformerEncoderLayer(8, 2, 16),
    "transformer": lambda nn_mod: nn_mod.Transformer(8, 2, 1, 1, 16),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_rebased_layer_state_dict_names_equal_jax(name):
    jm, tm = LAYERS[name](jnn), LAYERS[name](pnn)
    assert list(tm.state_dict()) == list(jm.state_dict())
    assert isinstance(tm, pnn.Layer)
    load_jax_state(tm, state_from_jax_layer(jm))
    for k, v in tm.state_dict().items():
        np.testing.assert_array_equal(v.detach().numpy(),
                                      np.asarray(jm.state_dict()[k]._data))


def test_embedding_padding_row_is_zero_and_masked():
    e = pnn.Embedding(6, 3, padding_idx=1)
    assert torch.equal(e.weight[1], torch.zeros(3))
    with torch.no_grad():
        e.weight[1] = 5.0          # a trained row: still looked up as zeros
    ids = pt.to_tensor(np.array([[1, 2], [0, 1]]))
    out = e(ids)
    assert torch.equal(out[0, 0], torch.zeros(3))
    out.sum().backward()
    assert torch.equal(e.weight.grad[1], torch.zeros(3))


@pytest.mark.parametrize("make_opt", [
    lambda ps: pt.optimizer.SGD(0.1, parameters=ps),
    lambda ps: pt.optimizer.Momentum(0.1, 0.9, parameters=ps,
                                     weight_decay=1e-2),
    lambda ps: pt.optimizer.AdamW(0.1, parameters=ps, grad_clip=(
        pnn.ClipGradByGlobalNorm(1.0)))], ids=["sgd", "momentum", "adamw"])
def test_updates_of_paddle_parameters_dispatch_no_op(make_opt):
    """The host loops over a Layer's Parameters (the optimizer's step,
    hapi's train_batch update, GradScaler's unscale) run plain torch ops:
    none goes through the op dispatcher (a Momentum update through it
    halved ResNet-18's hapi rate on the card). Only the forward and the
    loss dispatch; the update still moves every parameter."""
    from paddle_tpu_torch import hapi
    from paddle_tpu_torch.core import op_registry

    pt.seed(3)
    net = pnn.Sequential(pnn.Linear(4, 8), pnn.ReLU(), pnn.Linear(8, 3))
    x = torch.randn(5, 4)
    y = torch.tensor([0, 1, 2, 1, 0])
    opt = make_opt(net.parameters())
    loss = pnn.functional.cross_entropy(net(x), y)
    loss.backward()
    before = [p.detach().clone() for p in net.parameters()]
    n0 = op_registry.dispatched
    pt.amp.GradScaler(init_loss_scaling=8.0).step(opt)
    assert op_registry.dispatched == n0
    assert all(not torch.equal(b, p.detach())
               for b, p in zip(before, net.parameters()))
    m = hapi.Model(net)
    m.prepare(optimizer=make_opt(net.parameters()),
              loss=pnn.CrossEntropyLoss())
    n0 = op_registry.dispatched
    m.train_batch(x, y)
    # linear, relu, linear and the loss's cross_entropy
    assert op_registry.dispatched - n0 == 4
