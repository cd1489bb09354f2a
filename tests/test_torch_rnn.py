"""The port's recurrent layers (``SimpleRNN``, ``LSTM``, ``GRU``, their
cells and the ``RNN`` wrapper) against the JAX package's ``lax.scan`` of
``_cell_step`` (CPU, fp32, numpy inputs from a seed).

Every configuration: 2 layers, bidirectional, with and without initial
states, with and without biases, ``time_major`` both ways. The JAX layer's
parameters cross by name (``weight_ih_l0``, ``bias_hh_l1_reverse`` ...).
Outputs and final states within 1e-5 of max(1, max |jax|), gradients of
sum(out * cotangent) over every output (for the input, the initial states
and every parameter) within 1e-5; under ``auto_cast`` O1 bf16 the dtypes
equal JAX's (fp32: no white op inside). The stacked layers run in eval
mode, where the between-layer ``dropout`` (Paddle's, which the JAX layer
drops) is off; in training it is held to its rate.
"""

import jax  # noqa: F401  (JAX on the CPU, as tests/conftest.py sets it)
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as pt
from paddle_tpu_torch import device as pt_device
from paddle_tpu_torch.weights import load_jax_state, state_from_jax_layer
from torch_nn_parity import F, as_np, compare, dtype_name, flat

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def cpu_place():
    prev = pt_device._PLACE
    pt.set_device("cpu")
    yield
    pt_device._PLACE = prev


B, T, IN, H, L = 3, 5, 4, 6, 2


def _pair(make):
    jm, tm = make(jp), make(pt)
    names = [(n, tuple(p.shape)) for n, p in jm.named_parameters()]
    assert [(n, tuple(p.shape)) for n, p in tm.named_parameters()] == names
    load_jax_state(tm, state_from_jax_layer(jm))
    jm.eval()
    tm.eval()
    return jm, tm


def _run(P, m, inputs, nstate):
    ts = [P.to_tensor(x, stop_gradient=False) for x in inputs]
    states = None
    if nstate:
        states = ts[1] if nstate == 1 else (ts[1], ts[2])
    return ts, m(ts[0], states)


def _backward(P, out, cots):
    loss = None
    for o, c in zip(flat(out), cots):
        term = (o * P.to_tensor(c)).sum()
        loss = term if loss is None else loss + term
    loss.backward()


def _check(make, inputs, nstate, tol=1e-5):
    jm, tm = _pair(make)
    jts, jout = _run(jp, jm, inputs, nstate)
    tts, tout = _run(pt, tm, inputs, nstate)
    compare(tout, jout, tol)
    cots = [np.random.default_rng(7).standard_normal(as_np(o).shape)
            .astype(np.float32) for o in flat(jout)]
    _backward(jp, jout, cots)
    _backward(pt, tout, cots)
    compare([t.grad for t in tts], [t.grad for t in jts], tol)
    jg = {n: p.grad for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        compare(p.grad, jg[n], tol)


CLASSES = {"SimpleRNN": 1, "SimpleRNN-relu": 1, "LSTM": 2, "GRU": 1}


def _make(cls, kw):
    name = cls.split("-")[0]
    extra = dict(activation="relu") if cls.endswith("relu") else {}
    return lambda P: getattr(P.nn, name)(IN, H, L, **kw, **extra)


@pytest.mark.parametrize("cls", list(CLASSES))
@pytest.mark.parametrize("direction", ["forward", "bidirect"])
@pytest.mark.parametrize("time_major", [False, True])
@pytest.mark.parametrize("states", [False, True])
def test_stacked_rnn_matches_jax(cls, direction, time_major, states):
    dirs = 2 if direction == "bidirect" else 1
    x = F(T, B, IN) if time_major else F(B, T, IN)
    n = CLASSES[cls] if states else 0
    _check(_make(cls, dict(direction=direction, time_major=time_major)),
           [x] + [F(L * dirs, B, H) for _ in range(n)], n)


@pytest.mark.parametrize("cls", list(CLASSES))
def test_rnn_without_bias_matches_jax(cls):
    """``bias_ih_attr`` / ``bias_hh_attr`` False: no bias parameters."""
    _check(_make(cls, dict(direction="bidirect", bias_ih_attr=False,
                           bias_hh_attr=False)), [F(B, T, IN)], 0)


@pytest.mark.parametrize("cls", list(CLASSES))
def test_rnn_amp_dtypes_match_jax(cls):
    names = []
    for P, m in zip((jp, pt), _pair(_make(cls, {}))):
        with P.amp.auto_cast(level="O1", dtype="bfloat16"):
            out = m(P.to_tensor(F(B, T, IN)))
        names.append([dtype_name(o) for o in flat(out)])
    assert names[1] == names[0]


@pytest.mark.parametrize("cell,nstate", [("SimpleRNNCell", 1),
                                         ("LSTMCell", 2), ("GRUCell", 1)])
@pytest.mark.parametrize("given", [False, True])
def test_cells_match_jax(cell, nstate, given):
    x = F(B, IN)
    states = [F(B, H) for _ in range(nstate)] if given else []
    jm, tm = _pair(lambda P: getattr(P.nn, cell)(IN, H))
    outs = []
    for P, m in ((jp, jm), (pt, tm)):
        ts = [P.to_tensor(a, stop_gradient=False) for a in [x] + states]
        st = None if not given else (ts[1] if nstate == 1
                                     else (ts[1], ts[2]))
        out = m(ts[0], st)
        outs.append((ts, out))
    compare(outs[1][1], outs[0][1], 1e-5)
    cots = [np.random.default_rng(3).standard_normal(as_np(o).shape)
            .astype(np.float32) for o in flat(outs[0][1])]
    _backward(jp, outs[0][1], cots)
    _backward(pt, outs[1][1], cots)
    compare([t.grad for t in outs[1][0]], [t.grad for t in outs[0][0]], 1e-5)
    jg = {n: p.grad for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        compare(p.grad, jg[n], 1e-5)


@pytest.mark.parametrize("cell", ["SimpleRNNCell", "LSTMCell", "GRUCell"])
@pytest.mark.parametrize("is_reverse", [False, True])
def test_rnn_wrapper_matches_jax(cell, is_reverse):
    jm, tm = _pair(lambda P: P.nn.RNN(getattr(P.nn, cell)(IN, H),
                                      is_reverse=is_reverse))
    x = F(B, T, IN)
    jts, jout = _run(jp, jm, [x], 0)
    tts, tout = _run(pt, tm, [x], 0)
    compare(tout, jout, 1e-5)
    cots = [np.random.default_rng(5).standard_normal(as_np(o).shape)
            .astype(np.float32) for o in flat(jout)]
    _backward(jp, jout, cots)
    _backward(pt, tout, cots)
    compare(tts[0].grad, jts[0].grad, 1e-5)
    jg = {n: p.grad for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        compare(p.grad, jg[n], 1e-5)


def test_rnn_defaults_dropout_and_refusals():
    """Uniform(+-1/sqrt(hidden)) parameters; Paddle's between-layer
    dropout in training (the last layer's output never dropped, so a
    one-layer stack ignores it), off in eval; ``sequence_length``
    refused."""
    pt.seed(0)
    m = pt.nn.LSTM(32, 64, 2, dropout=0.5)
    for p in m.parameters():
        assert p.abs().max().item() <= 64 ** -0.5
    x = torch.from_numpy(F(4, 7, 32))
    m.eval()
    ref = m(x)[0]
    torch.manual_seed(0)
    m.train()
    assert not torch.allclose(m(x)[0], ref)
    one = pt.nn.GRU(32, 16, dropout=0.5)
    one.train()
    a = one(x)[0]
    one.eval()
    assert torch.equal(a, one(x)[0])
    # sequence_length (Paddle's; tests/test_torch_rnn_sequence_length.py
    # holds it against JAX row by row): full lengths equal the plain call,
    # a shorter row's outputs stop at its length
    m.eval()
    compare(m(x, sequence_length=torch.tensor([7, 7, 7, 7]))[0], ref, 1e-6)
    short = m(x, sequence_length=torch.tensor([7, 3, 7, 7]))[0]
    assert not short[1, 3:].any() and short[1, :3].abs().sum() > 0
    with pytest.raises(ValueError, match="both False or neither"):
        pt.nn.GRU(3, 4, bias_ih_attr=False)
    cell = pt.nn.LSTMCell(3, 4, bias_ih_attr=False, bias_hh_attr=False)
    assert cell.bias_ih is None and cell.bias_hh is None
    h, (h2, c) = cell(torch.ones(2, 3))
    assert h.shape == c.shape == (2, 4)
