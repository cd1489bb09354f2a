"""The port's ``geometric`` against the JAX package's, on the CPU: the
segment reductions and ``send_u_recv`` / ``send_ue_recv`` / ``send_uv``
(every reduce and message op, empty segments, ``out_size``, gradients),
``reindex_graph`` / ``reindex_heter_graph`` and the neighbour samplers.

Tolerance: sums and means within atol 1e-5 (another summation order);
min, max, reindexing and the samplers byte-equal. The samplers draw from
numpy seeded by ``next_host_seed()``, the JAX package's stream, so after
the same ``paddle.seed`` both packages pick the same neighbours.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.geometric as JG
import paddle_tpu_torch as pt
import paddle_tpu_torch.geometric as TG
from paddle_tpu_torch import device as pt_device

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _cpu():
    prev = pt_device._PLACE
    pt.set_device("cpu")
    yield
    pt_device._PLACE = prev


def N(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x._data if hasattr(x, "_data") else x)


R = np.random.default_rng(0)
X = R.standard_normal((7, 4)).astype(np.float32)
SEG = np.array([0, 0, 1, 3, 3, 3, 5])          # 2 and 4 empty
SRC = R.integers(0, 7, 15)
DST = np.concatenate([R.integers(0, 5, 14), [6]])   # row 5 gets nothing
EDGE = R.standard_normal((15, 4)).astype(np.float32) + 2.0


@pytest.mark.parametrize("op", ["sum", "mean", "min", "max"])
def test_segments(op):
    got = getattr(TG, f"segment_{op}")(torch.from_numpy(X),
                                       torch.from_numpy(SEG))
    ref = getattr(JG, f"segment_{op}")(jp.to_tensor(X), jp.to_tensor(SEG))
    np.testing.assert_allclose(N(got), N(ref), **TOL)
    assert not N(got)[[2, 4]].any()


@pytest.mark.parametrize("op", ["sum", "mean", "min", "max"])
@pytest.mark.parametrize("out_size", [None, 9])
def test_send_u_recv(op, out_size):
    got = TG.send_u_recv(torch.from_numpy(X), SRC, DST, op, out_size)
    ref = JG.send_u_recv(jp.to_tensor(X), SRC, DST, op, out_size)
    assert got.shape == tuple(N(ref).shape)
    np.testing.assert_allclose(N(got), N(ref), **TOL)


@pytest.mark.parametrize("msg", ["add", "sub", "mul", "div"])
@pytest.mark.parametrize("op", ["sum", "max"])
def test_send_ue_recv(msg, op):
    got = TG.send_ue_recv(torch.from_numpy(X), torch.from_numpy(EDGE), SRC,
                          DST, msg, op)
    ref = JG.send_ue_recv(jp.to_tensor(X), jp.to_tensor(EDGE), SRC, DST,
                          msg, op)
    np.testing.assert_allclose(N(got), N(ref), **TOL)


@pytest.mark.parametrize("msg", ["add", "mul"])
def test_send_uv(msg):
    y = R.standard_normal((7, 4)).astype(np.float32)
    got = TG.send_uv(torch.from_numpy(X), torch.from_numpy(y), SRC, DST, msg)
    ref = JG.send_uv(jp.to_tensor(X), jp.to_tensor(y), SRC, DST, msg)
    np.testing.assert_allclose(N(got), N(ref), **TOL)


@pytest.mark.parametrize("op", ["sum", "mean", "max"])
def test_gradients_reach_the_features(op):
    jx = jp.to_tensor(X)
    jx.stop_gradient = False
    tx = torch.from_numpy(X).requires_grad_(True)
    (JG.send_u_recv(jx, SRC, DST, op) ** 2).sum().backward()
    (TG.send_u_recv(tx, SRC, DST, op) ** 2).sum().backward()
    np.testing.assert_allclose(N(tx.grad), N(jx.grad), **TOL)


def test_reindex_graph_and_heter():
    x = np.array([10, 4, 7])
    nb = np.array([4, 11, 10, 2, 11, 7])
    cnt = np.array([2, 3, 1])
    for got, ref in zip(TG.reindex_graph(x, nb, cnt),
                        JG.reindex_graph(x, nb, cnt)):
        np.testing.assert_array_equal(N(got), N(ref))
    nbs, cnts = [nb, np.array([3, 10])], [cnt, np.array([1, 1, 0])]
    for got, ref in zip(TG.reindex_heter_graph(x, nbs, cnts),
                        JG.reindex_heter_graph(x, nbs, cnts)):
        np.testing.assert_array_equal(N(got), N(ref))


def _csc(seed=1, n=30, deg=6):
    rng = np.random.default_rng(seed)
    degs = rng.integers(0, deg + 1, n)
    colptr = np.concatenate([[0], np.cumsum(degs)]).astype(np.int64)
    row = rng.integers(0, n, colptr[-1]).astype(np.int64)
    w = rng.uniform(0.1, 2.0, colptr[-1]).astype(np.float32)
    return row, colptr, w


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("size", [-1, 3])
def test_sample_neighbors_byte_equal_under_seed(weighted, size):
    row, colptr, w = _csc()
    nodes = np.array([0, 5, 9, 17, 29, 3])
    eids = np.arange(len(row)) + 100
    outs = {}
    for name, P, G in (("jax", jp, JG), ("torch", pt, TG)):
        P.seed(123)
        if weighted:
            outs[name] = G.weighted_sample_neighbors(
                row, colptr, w, nodes, size, eids=eids, return_eids=True)
        else:
            outs[name] = G.sample_neighbors(row, colptr, nodes, size,
                                            eids=eids, return_eids=True)
    for got, ref in zip(outs["torch"], outs["jax"]):
        np.testing.assert_array_equal(N(got), N(ref))
    with pytest.raises(ValueError, match="eids"):
        TG.sample_neighbors(row, colptr, nodes, return_eids=True)
