"""``sequence_length`` on the port's recurrent layers (Paddle's meaning; the
JAX package ignores the argument), CPU, fp32.

The JAX package has no lengths, so each batched port call is held against
the JAX layer run on each row alone, cut to its length (the same weights,
carried across by name): outputs within 1e-5 of max(1, max |jax|) on the
valid steps and exactly zero past them, final states (each row's last
valid step; the reverse direction started there) within 1e-5, and the
gradients of sum(out * cotangent) + sum(states * cotangent) for the
input, the initial states and every parameter (the per-row JAX gradients
summed) within 1e-5. When every length equals T the packed call equals
the port's own unpacked call. ``RNN`` and ``BiRNN`` (a cell stepped in
Python) freeze the state past a row's length and output zeros there.
"""

import jax  # noqa: F401  (JAX on the CPU, as tests/conftest.py sets it)
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as pt
from paddle_tpu_torch import device as pt_device
from paddle_tpu_torch.weights import load_jax_state, state_from_jax_layer
from torch_nn_parity import F, as_np, compare, flat

torch.set_num_threads(1)

B, T, IN, H, L = 4, 6, 3, 5, 2
LENS = np.array([6, 2, 4, 1])


@pytest.fixture(autouse=True)
def cpu_place():
    prev = pt_device._PLACE
    pt.set_device("cpu")
    yield
    pt_device._PLACE = prev


def _pair(make):
    jm, tm = make(jp), make(pt)
    load_jax_state(tm, state_from_jax_layer(jm))
    jm.eval()
    tm.eval()
    return jm, tm


def _states(out):
    """The final states of a layer's ``(outputs, states)`` as a list."""
    return flat(out[1])


def _cots(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _check(make, nstate, time_major, with_states, lens=LENS, batch_dim=1,
           n_st=L):
    """The port's batched call with ``sequence_length`` against the JAX
    layer per row. ``batch_dim``: the batch axis of the states (1 for the
    fused layers' [layers x dirs, batch, hidden], 0 for a cell's)."""
    jm, tm = _pair(make)
    x = F(B, T, IN)
    xin = x.transpose(1, 0, 2) if time_major else x
    st = [F(n_st, B, H) if batch_dim == 1 else F(B, H)
          for _ in range(nstate)] if with_states else []

    def pack(ts):
        if not ts:
            return None
        return ts[0] if nstate == 1 else tuple(ts)

    # the port, batched
    tx = pt.to_tensor(xin, stop_gradient=False)
    tst = [pt.to_tensor(s, stop_gradient=False) for s in st]
    tout = tm(tx, pack(tst), sequence_length=pt.to_tensor(lens))
    out_t = as_np(tout[0])
    out_t = out_t.transpose(1, 0, 2) if time_major else out_t
    cot_out = _cots([out_t.shape], 3)[0]
    cot_st = _cots([as_np(s).shape for s in _states(tout)], 4)
    loss = (tout[0] * pt.to_tensor(cot_out.transpose(1, 0, 2) if time_major
                                   else cot_out)).sum()
    for s, c in zip(_states(tout), cot_st):
        loss = loss + (s * pt.to_tensor(c)).sum()
    loss.backward()
    gx = as_np(tx.grad)
    gx = gx.transpose(1, 0, 2) if time_major else gx
    pgrad = {n: as_np(p.grad) for n, p in tm.named_parameters()}
    jgrad = {n: 0.0 for n, _ in jm.named_parameters()}
    for b, n in enumerate(lens):
        xb = x[b:b + 1, :n]
        xb = xb.transpose(1, 0, 2) if time_major else xb
        jx = jp.to_tensor(xb, stop_gradient=False)
        sl = (slice(None), slice(b, b + 1)) if batch_dim == 1 \
            else (slice(b, b + 1),)
        jst = [jp.to_tensor(s[sl], stop_gradient=False) for s in st]
        for p in jm.parameters():
            p.clear_gradient()
        jout = jm(jx, pack(jst))
        o = as_np(jout[0])
        o = o.transpose(1, 0, 2) if time_major else o
        compare(out_t[b:b + 1, :n], o, 1e-5)
        assert not out_t[b, n:].any()
        for s_t, s_j in zip(_states(tout), _states(jout)):
            compare(as_np(s_t)[sl], as_np(s_j), 1e-5)
        jl = (jout[0] * jp.to_tensor(
            cot_out[b:b + 1, :n].transpose(1, 0, 2) if time_major
            else cot_out[b:b + 1, :n])).sum()
        for s, c in zip(_states(jout), cot_st):
            jl = jl + (s * jp.to_tensor(c[sl])).sum()
        jl.backward()
        gjx = as_np(jx.grad)
        gjx = gjx.transpose(1, 0, 2) if time_major else gjx
        compare(gx[b:b + 1, :n], gjx, 1e-5)
        assert not gx[b, n:].any()
        for ts, js in zip(tst, jst):
            compare(as_np(ts.grad)[sl], as_np(js.grad), 1e-5)
        for name, p in jm.named_parameters():
            jgrad[name] = jgrad[name] + as_np(p.grad)
    for name in pgrad:
        compare(pgrad[name], jgrad[name], 1e-5)


CLASSES = {"SimpleRNN": 1, "LSTM": 2, "GRU": 1}


@pytest.mark.parametrize("cls", list(CLASSES))
@pytest.mark.parametrize("direction", ["forward", "bidirect"])
@pytest.mark.parametrize("time_major", [False, True])
@pytest.mark.parametrize("with_states", [False, True])
def test_packed_layer_matches_jax_row_by_row(cls, direction, time_major,
                                             with_states):
    _check(lambda P: getattr(P.nn, cls)(IN, H, L, direction=direction,
                                        time_major=time_major),
           CLASSES[cls], time_major, with_states,
           n_st=L * (2 if direction == "bidirect" else 1))


@pytest.mark.parametrize("cls", list(CLASSES))
def test_full_lengths_equal_the_unpacked_call(cls):
    m = getattr(pt.nn, cls)(IN, H, L, direction="bidirect")
    m.eval()
    x = torch.from_numpy(F(B, T, IN))
    a = m(x)
    b = m(x, sequence_length=torch.full((B,), T))
    compare(flat(b), flat(a), 1e-6)


@pytest.mark.parametrize("cell,nstate", [("SimpleRNNCell", 1),
                                         ("LSTMCell", 2), ("GRUCell", 1)])
@pytest.mark.parametrize("is_reverse", [False, True])
@pytest.mark.parametrize("with_states", [False, True])
def test_rnn_wrapper_freezes_past_the_length(cell, nstate, is_reverse,
                                             with_states):
    _check(lambda P: P.nn.RNN(getattr(P.nn, cell)(IN, H),
                              is_reverse=is_reverse), nstate, False,
           with_states, batch_dim=0)


@pytest.mark.parametrize("cell,nstate", [("GRUCell", 1), ("LSTMCell", 2)])
def test_birnn_matches_jax_row_by_row(cell, nstate):
    """BiRNN's outputs concatenate both directions; its states are the
    pair (forward, backward)."""
    jm, tm = _pair(lambda P: P.nn.BiRNN(getattr(P.nn, cell)(IN, H),
                                        getattr(P.nn, cell)(IN, H)))
    x = F(B, T, IN)
    tx = pt.to_tensor(x, stop_gradient=False)
    tout = tm(tx, sequence_length=pt.to_tensor(LENS))
    out_t = as_np(tout[0])
    cot = _cots([out_t.shape], 5)[0]
    (tout[0] * pt.to_tensor(cot)).sum().backward()
    jgrad = {n: 0.0 for n, _ in jm.named_parameters()}
    for b, n in enumerate(LENS):
        jx = jp.to_tensor(x[b:b + 1, :n], stop_gradient=False)
        for p in jm.parameters():
            p.clear_gradient()
        jout = jm(jx)
        compare(out_t[b:b + 1, :n], as_np(jout[0]), 1e-5)
        assert not out_t[b, n:].any()
        for s_t, s_j in zip(flat(tout[1]), flat(jout[1])):
            compare(as_np(s_t)[b:b + 1], as_np(s_j), 1e-5)
        (jout[0] * jp.to_tensor(cot[b:b + 1, :n])).sum().backward()
        compare(as_np(tx.grad)[b:b + 1, :n], as_np(jx.grad), 1e-5)
        for name, p in jm.named_parameters():
            jgrad[name] = jgrad[name] + as_np(p.grad)
    for name, p in tm.named_parameters():
        compare(as_np(p.grad), jgrad[name], 1e-5)
