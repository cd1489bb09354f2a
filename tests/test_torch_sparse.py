"""The port's ``sparse`` against the JAX package's, on the CPU, over the
same seeded COO / CSR tensors (with a duplicate index): construction and
``to_dense``, the CSR <-> COO conversions, ``coalesce``, ``transpose``,
``cast``, ``matmul`` (sparse @ dense, dense @ sparse, sparse @ sparse),
``masked_matmul``, the union binaries (``add``, ``subtract``) and the
pattern ones (``multiply``, ``divide``), the unaries, ``softmax`` and
``sparse.nn``; gradients reach the values.

Tolerance: fp32 within atol 1e-5 (sums in another order); structure
(indices, crows, shapes) exact. Where JAX keeps a padded result (the union
binaries), the densified results are compared.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.sparse as JS
import paddle_tpu_torch as pt
import paddle_tpu_torch.sparse as TS
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


def _coo(seed, shape=(6, 5), nnz=9, positive=False):
    rng = np.random.default_rng(seed)
    flat = rng.choice(shape[0] * shape[1], nnz - 1, replace=False)
    flat = np.append(flat, flat[0])   # one duplicate index
    idx = np.stack(np.unravel_index(flat, shape)).astype(np.int64)
    vals = rng.standard_normal(nnz).astype(np.float32)
    if positive:
        vals = np.abs(vals) + 0.5
    return idx, vals, list(shape)


def _both(seed, **kw):
    idx, vals, shape = _coo(seed, **kw)
    return (JS.sparse_coo_tensor(idx, vals, shape),
            TS.sparse_coo_tensor(idx, vals, shape))


def test_construction_dense_and_shape_inference():
    j, t = _both(0)
    np.testing.assert_array_equal(N(t.to_dense()), N(j.to_dense()))
    idx, vals, _ = _coo(0)
    inferred = TS.sparse_coo_tensor(idx, vals)
    assert inferred.shape == JS.sparse_coo_tensor(idx, vals).shape
    assert t.nnz() == j.nnz() and t.is_sparse_coo() and not t.is_sparse_csr()


def test_csr_round_trip_and_coalesce():
    j, t = _both(1)
    jc, tc = j.to_sparse_csr(), t.to_sparse_csr()
    np.testing.assert_array_equal(N(tc.crows), N(jc.crows))
    np.testing.assert_array_equal(N(tc.cols), N(jc.cols))
    np.testing.assert_allclose(N(tc.values), N(jc.values), **TOL)
    np.testing.assert_allclose(N(tc.to_dense()), N(j.to_dense()), **TOL)
    back = tc.to_sparse_coo()
    np.testing.assert_array_equal(N(back.indices),
                                  N(jc.to_sparse_coo().indices))
    tcoal = TS.coalesce(t)
    assert tcoal.nnz() == t.nnz() - 1
    csr = TS.sparse_csr_tensor(N(tc.crows), N(tc.cols), N(tc.values),
                               t.shape)
    np.testing.assert_allclose(N(csr.to_dense()), N(j.to_dense()), **TOL)


def test_transpose_and_cast():
    j, t = _both(2)
    np.testing.assert_array_equal(N(TS.transpose(t, [1, 0]).to_dense()),
                                  N(JS.transpose(j, [1, 0]).to_dense()))
    c = TS.cast(t, index_dtype="int32", value_dtype="float64")
    assert c.indices.dtype == torch.int32 and c.dtype == torch.float64


def test_matmul_all_forms():
    j, t = _both(3)
    rng = np.random.default_rng(3)
    d = rng.standard_normal((5, 4)).astype(np.float32)
    d2 = rng.standard_normal((3, 6)).astype(np.float32)
    np.testing.assert_allclose(N(TS.matmul(t, torch.from_numpy(d))),
                               N(JS.matmul(j, jp.to_tensor(d))), **TOL)
    np.testing.assert_allclose(N(TS.matmul(torch.from_numpy(d2), t)),
                               N(JS.matmul(jp.to_tensor(d2), j)), **TOL)
    j2, t2 = _both(4, shape=(5, 4), nnz=6)
    np.testing.assert_allclose(N(TS.matmul(t, t2)), N(JS.matmul(j, j2)),
                               **TOL)


def test_matmul_gradient_reaches_values_and_dense():
    idx, vals, shape = _coo(5)
    t = TS.sparse_coo_tensor(idx, vals, shape, stop_gradient=False)
    d = torch.randn(5, 3, requires_grad=True)
    TS.matmul(t, d).sum().backward()
    dense_ref = torch.zeros(shape).index_put(
        tuple(torch.from_numpy(idx)), torch.from_numpy(vals),
        accumulate=True)
    np.testing.assert_allclose(N(d.grad), N(dense_ref.t() @ torch.ones(6, 3)),
                               **TOL)
    assert t.values.grad is not None and t.values.grad.shape == (9,)


def test_masked_matmul():
    j, t = _both(6)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((6, 7)).astype(np.float32)
    y = rng.standard_normal((7, 5)).astype(np.float32)
    got = TS.masked_matmul(torch.from_numpy(x), torch.from_numpy(y), t)
    ref = JS.masked_matmul(jp.to_tensor(x), jp.to_tensor(y), j)
    np.testing.assert_allclose(N(got.values), N(ref.values), **TOL)
    np.testing.assert_array_equal(N(got.indices), N(ref.indices))


@pytest.mark.parametrize("op", ["add", "subtract", "multiply", "divide"])
def test_binaries(op):
    j1, t1 = _both(7)
    j2, t2 = _both(8, positive=True)
    np.testing.assert_allclose(N(getattr(TS, op)(t1, t2).to_dense()),
                               N(getattr(JS, op)(j1, j2).to_dense()), **TOL)
    d = np.random.default_rng(8).standard_normal((6, 5)).astype(np.float32)
    np.testing.assert_allclose(
        N(getattr(TS, op)(t1, torch.from_numpy(np.abs(d) + 1))),
        N(getattr(JS, op)(j1, jp.to_tensor(np.abs(d) + 1))), **TOL)


UNARY = ["sin", "tan", "asin", "atan", "sinh", "tanh", "asinh", "atanh",
         "sqrt", "square", "log1p", "abs", "neg", "expm1", "relu", "relu6"]


@pytest.mark.parametrize("op", UNARY)
def test_unaries_on_values(op):
    idx, vals, shape = _coo(9)
    vals = (np.tanh(vals) * 0.9).astype(np.float32)
    if op in ("sqrt", "log1p"):
        vals = np.abs(vals)
    j = JS.sparse_coo_tensor(idx, vals, shape)
    t = TS.sparse_coo_tensor(idx, vals, shape)
    np.testing.assert_allclose(N(getattr(TS, op)(t).values),
                               N(getattr(JS, op)(j).values), **TOL)
    csr = getattr(TS, op)(t.to_sparse_csr())
    assert csr.is_sparse_csr()


def test_parametrised_unaries_softmax_and_nn():
    j, t = _both(10)
    for tf, jf in ((lambda x: TS.leaky_relu(x, 0.2),
                    lambda x: JS.leaky_relu(x, 0.2)),
                   (lambda x: TS.pow(x, 3), lambda x: JS.pow(x, 3)),
                   (TS.nn.ReLU(), JS.nn.ReLU()),
                   (TS.nn.LeakyReLU(0.1), JS.nn.LeakyReLU(0.1))):
        np.testing.assert_allclose(N(tf(t).values), N(jf(j).values), **TOL)
    jc, tc = JS.coalesce(j), TS.coalesce(t)
    np.testing.assert_allclose(N(TS.softmax(tc).to_dense()),
                               N(JS.softmax(jc).to_dense()), **TOL)
    np.testing.assert_allclose(N(TS.nn.Softmax()(tc).values),
                               N(JS.nn.Softmax()(jc).values), **TOL)
    assert TS.is_same_shape(t, tc)
