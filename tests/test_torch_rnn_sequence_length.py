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

import jax  # (JAX on the CPU, as tests/conftest.py sets it)
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as pt
from paddle_tpu.core import autograd_engine
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.jit.api import _Swap
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


# the JAX per-row references, shared between cases that differ only in
# layout (time_major): the same layer, weights, inputs and cotangents give
# the same rows, kept here in batch-major layout
_JAX_ROWS = {}


def _ref_key(jm, x, st, lens, nstate, batch_dim, cot_out, cot_st):
    import hashlib

    h = hashlib.sha256()
    for _, a in sorted(state_from_jax_layer(jm).items()):
        h.update(np.ascontiguousarray(a).tobytes())
    for a in [x, np.asarray(lens), cot_out, *st, *cot_st]:
        h.update(np.ascontiguousarray(a).tobytes())
    conf = sorted((k, v) for k, v in vars(jm).items()
                  if not k.startswith("_") and k != "time_major"
                  and isinstance(v, (int, float, str, bool, type(None))))
    kinds = tuple(type(m).__name__ for m in jm.sublayers(include_self=True))
    return (kinds, tuple(conf), nstate, batch_dim, len(st), h.hexdigest())


def _jax_rows(jm, x, st, lens, nstate, time_major, batch_dim, cot_out,
              cot_st, pack):
    """The JAX layer run on each row alone, cut to its length: per row its
    outputs, final states and the gradients of sum(out * cot) +
    sum(states * cot) for the input and the initial states (batch-major),
    and the parameters' gradients summed over the rows."""
    key = _ref_key(jm, x, st, lens, nstate, batch_dim, cot_out, cot_st)
    if key in _JAX_ROWS:
        return _JAX_ROWS[key]
    named = list(jm.named_parameters())
    tensors = [p for _, p in named]

    def row_loss(params, xb, sts, cot_o, cot_s):
        # one row through the layer with the parameters swapped in, under
        # jax.jit (the eager tape would dispatch every op of every step)
        with autograd_engine.no_grad(), _Swap(tensors, params):
            jout = jm(Tensor(xb), pack([Tensor(a) for a in sts]))
            o = jout[0]._data
            states = [s._data for s in _states(jout)]
        jl = (o * cot_o).sum()
        for s, c in zip(states, cot_s):
            jl = jl + (s * c).sum()
        return jl, (o, states)

    f = jax.jit(jax.value_and_grad(row_loss, argnums=(0, 1, 2),
                                   has_aux=True))
    params = [p._data for p in tensors]
    rows = []
    jgrad = {n: 0.0 for n, _ in named}
    for b, n in enumerate(lens):
        xb = x[b:b + 1, :n]
        xb = xb.transpose(1, 0, 2) if time_major else xb
        sl = (slice(None), slice(b, b + 1)) if batch_dim == 1 \
            else (slice(b, b + 1),)
        cot_o = cot_out[b:b + 1, :n]
        cot_o = cot_o.transpose(1, 0, 2) if time_major else cot_o
        (_, (o, states)), (gp, gx, gst) = f(
            params, xb, [s[sl] for s in st], cot_o, [c[sl] for c in cot_st])
        o, gjx = np.asarray(o), np.asarray(gx)
        rows.append({"o": o.transpose(1, 0, 2) if time_major else o,
                     "states": [np.asarray(s) for s in states],
                     "gx": gjx.transpose(1, 0, 2) if time_major else gjx,
                     "gst": [np.asarray(g) for g in gst]})
        for (name, _), g in zip(named, gp):
            jgrad[name] = jgrad[name] + np.asarray(g)
    _JAX_ROWS[key] = ref = {"rows": rows, "pgrad": jgrad}
    return ref


def _check(make, nstate, time_major, with_states, lens=LENS, batch_dim=1,
           n_st=L, data_key=None):
    """The port's batched call with ``sequence_length`` against the JAX
    layer per row. ``batch_dim``: the batch axis of the states (1 for the
    fused layers' [layers x dirs, batch, hidden], 0 for a cell's).
    ``data_key``: draw the inputs from a generator seeded by it (the same
    inputs for cases that differ only in layout, so they share the JAX
    rows) instead of the shared stream."""
    jm, tm = _pair(make)
    draw = F
    if data_key is not None:
        import zlib

        rng = np.random.default_rng(zlib.crc32(data_key.encode()))

        def draw(*shape):
            return rng.standard_normal(shape).astype(np.float32)
    x = draw(B, T, IN)
    xin = x.transpose(1, 0, 2) if time_major else x
    st = [draw(n_st, B, H) if batch_dim == 1 else draw(B, H)
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
    ref = _jax_rows(jm, x, st, lens, nstate, time_major, batch_dim, cot_out,
                    cot_st, pack)
    for b, n in enumerate(lens):
        row = ref["rows"][b]
        sl = (slice(None), slice(b, b + 1)) if batch_dim == 1 \
            else (slice(b, b + 1),)
        compare(out_t[b:b + 1, :n], row["o"], 1e-5)
        assert not out_t[b, n:].any()
        for s_t, s_j in zip(_states(tout), row["states"]):
            compare(as_np(s_t)[sl], s_j, 1e-5)
        compare(gx[b:b + 1, :n], row["gx"], 1e-5)
        assert not gx[b, n:].any()
        for ts, g in zip(tst, row["gst"]):
            compare(as_np(ts.grad)[sl], g, 1e-5)
    for name in pgrad:
        compare(pgrad[name], ref["pgrad"][name], 1e-5)


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
           n_st=L * (2 if direction == "bidirect" else 1),
           data_key=f"{cls}-{direction}-{with_states}")


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
