"""The cases of tests/test_autograd.py on the port's autograd (torch's tape
under Paddle's API): stop_gradient, detach, no_grad, ``paddle.grad``,
hooks, ``PyLayer``, ``backward(grad_tensor)``, ``create_graph`` to the third
derivative, ``create_graph`` through a ``PyLayer`` raising, and dropout's
gradient mask; each also held to the JAX package's result on the same
inputs. Tolerance: 1e-6 relative (fp32, a handful of ops) unless exact."""

import jax  # noqa: F401  (JAX on the CPU, as tests/conftest.py sets it)
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch import device as pt_device
from paddle_tpu_torch.autograd import PyLayer

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def cpu_place():
    prev = pt_device._PLACE
    pt.set_device("cpu")
    yield
    pt_device._PLACE = prev


def _both(fn):
    """fn(P) for the port and the JAX package: (port, jax) numpy results."""
    out = []
    for P in (pt, jp):
        r = fn(P)
        out.append([np.asarray(x.numpy()) for x in r])
    return out


def _assert_same(fn, rtol=1e-6):
    port, ref = _both(fn)
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-7)


def test_simple_backward():
    def f(P):
        x = P.to_tensor([2.0, 3.0], stop_gradient=False)
        (x * x).sum().backward()
        return [x.grad]
    _assert_same(f)
    np.testing.assert_allclose(_both(f)[0][0], [4.0, 6.0])


def test_chain_and_accumulation():
    def f(P):
        x = P.to_tensor([1.0, 2.0], stop_gradient=False)
        y = x.exp()
        y.sum().backward(retain_graph=True)
        g1 = x.grad.numpy().copy()
        y.sum().backward()
        return [P.to_tensor(g1), x.grad]
    (g1, g2), _ = _both(f)
    np.testing.assert_allclose(g2, 2 * g1, rtol=1e-6)
    _assert_same(f)


def test_stop_gradient():
    x = pt.to_tensor([1.0], stop_gradient=False)
    y = pt.to_tensor([2.0], stop_gradient=True)
    (x * y).sum().backward()
    assert x.grad is not None and y.grad is None
    assert y.stop_gradient and not x.stop_gradient
    z = x * 2
    with pytest.raises(RuntimeError, match="detach"):
        z.stop_gradient = True     # torch cannot cut an op output in place
    assert z.detach().stop_gradient


def test_detach():
    def f(P):
        x = P.to_tensor([3.0], stop_gradient=False)
        y = (x * 2).detach()
        assert y.stop_gradient
        (x * 2 + y).sum().backward()
        return [x.grad]
    _assert_same(f)


def test_no_grad():
    x = pt.to_tensor([1.0], stop_gradient=False)
    with pt.no_grad():
        y = x * 3
    assert y.stop_gradient and y.grad_fn is None

    @pt.no_grad()
    def triple(t):
        return t * 3
    assert triple(x).stop_gradient
    with pt.enable_grad():
        assert not (x * 3).stop_gradient
    prev = pt.set_grad_enabled(False)
    assert prev and (x * 3).stop_gradient
    pt.set_grad_enabled(True)
    assert pt.autograd.is_grad_enabled()


def test_double_backward_error():
    x = pt.to_tensor([1.0], stop_gradient=False)
    y = (x * x).sum()
    y.backward()
    with pytest.raises(RuntimeError):
        y.backward()


def test_grad_api():
    def f(P):
        x = P.to_tensor([2.0], stop_gradient=False)
        y = x * x * x
        (g,) = P.autograd.grad(y, x, retain_graph=True)
        assert x.grad is None        # paddle.grad leaves .grad alone
        return [g]
    _assert_same(f)
    z = pt.to_tensor([1.0], stop_gradient=False)
    w = pt.to_tensor([1.0], stop_gradient=False)
    with pytest.raises(RuntimeError):
        pt.grad((z * 2).sum(), [z, w])
    assert pt.grad((z * 2).sum(), [z, w], allow_unused=True)[1] is None


def test_grad_of_an_intermediate_tensor():
    def f(P):
        x = P.to_tensor([1.5, -0.5], stop_gradient=False)
        h = x * x
        y = (h * 3).sum()
        return P.grad(y, [h, x])
    _assert_same(f)


def test_multi_output_op():
    def f(P):
        x = P.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3),
                        stop_gradient=False)
        parts = P.split(x, 3, axis=1)
        (parts[0].sum() * 2 + parts[2].sum()).backward()
        return [x.grad]
    _assert_same(f)


def test_hook():
    def f(P):
        x = P.to_tensor([1.0, 1.0], stop_gradient=False)
        seen = []

        def hook(g):
            seen.append(g.numpy().copy())
            return g * 2

        h = x.register_hook(hook)
        (x * 3).sum().backward()
        assert seen
        h.remove()
        return [x.grad]
    _assert_same(f)
    np.testing.assert_allclose(_both(f)[0][0], [6.0, 6.0])


class Cube(PyLayer):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x * x * x

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensor()
        return dy * 3 * x * x


def test_pylayer():
    x = pt.to_tensor([2.0], stop_gradient=False)
    y = Cube.apply(x)
    assert isinstance(y, pt.Tensor)
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [12.0])


def test_pylayer_two_inputs_and_a_constant():
    class Mul(PyLayer):
        @staticmethod
        def forward(ctx, a, b, k):
            ctx.save_for_backward(a, b)
            return a * b * k

        @staticmethod
        def backward(ctx, dy):
            a, b = ctx.saved_tensor()
            return dy * b * 2.0, dy * a * 2.0

    a = pt.to_tensor([1.0, 2.0], stop_gradient=False)
    b = pt.to_tensor([3.0, 4.0], stop_gradient=False)
    Mul.apply(a, b, 2.0).sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), [6.0, 8.0])
    np.testing.assert_allclose(b.grad.numpy(), [2.0, 4.0])


def test_backward_with_grad_tensor():
    def f(P):
        x = P.to_tensor([1.0, 2.0], stop_gradient=False)
        (x * 2).backward(P.to_tensor([0.5, 0.25]))
        return [x.grad]
    _assert_same(f)
    pt_x = pt.to_tensor([1.0], stop_gradient=False)
    pt.autograd.backward([pt_x * 4], [pt.to_tensor([0.5])])
    np.testing.assert_allclose(pt_x.grad.numpy(), [2.0])


def test_nonfloat_output_not_recorded():
    def f(P):
        x = P.to_tensor([3.0, 1.0], stop_gradient=False)
        idx = P.argmax(x)
        assert idx.stop_gradient or P is jp   # JAX flags it False
        x.max().backward()
        return [x.grad]
    _assert_same(f)


def test_create_graph_second_derivative_quadratic():
    x = pt.to_tensor([3.0], stop_gradient=False)
    (g1,) = pt.grad((x * x).sum(), x, create_graph=True)
    np.testing.assert_allclose(g1.numpy(), [6.0], rtol=1e-6)
    assert not g1.stop_gradient and g1.grad_fn is not None
    (g2,) = pt.grad(g1.sum(), x)
    np.testing.assert_allclose(g2.numpy(), [2.0], rtol=1e-6)


def test_create_graph_third_derivative():
    def f(P):
        x = P.to_tensor([2.0], stop_gradient=False)
        y = (x * x * x * x).sum()
        (g1,) = P.grad(y, x, create_graph=True)
        (g2,) = P.grad(g1.sum(), x, create_graph=True)
        (g3,) = P.grad(g2.sum(), x)
        return [g1, g2, g3]
    (g1, g2, g3), _ = _both(f)
    np.testing.assert_allclose([g1[0], g2[0], g3[0]], [32.0, 48.0, 48.0],
                               rtol=1e-6)
    _assert_same(f)


def test_create_graph_mixed_partials():
    def f(P):
        x = P.to_tensor([3.0], stop_gradient=False)
        yv = P.to_tensor([5.0], stop_gradient=False)
        (gx,) = P.grad((x * x * yv).sum(), x, create_graph=True)
        (gxy,) = P.grad(gx.sum(), yv)
        return [gx, gxy]
    _assert_same(f)


def test_create_graph_backward_into_leaf_grad():
    def f(P):
        x = P.to_tensor([2.0], stop_gradient=False)
        (g1,) = P.grad((x * x * x).sum(), x, create_graph=True)
        g1.sum().backward()
        return [x.grad]
    _assert_same(f)


def test_create_graph_through_pylayer_raises():
    class Square(PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * x

        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensor()
            return dy * 2 * x

    x = pt.to_tensor([2.0], stop_gradient=False)
    y = Square.apply(x).sum()
    with pytest.raises(RuntimeError, match="create_graph"):
        pt.grad(y, x, create_graph=True)


def test_dropout_gradient_is_the_forward_mask():
    pt.seed(42)
    x = pt.to_tensor(np.ones((64, 64), np.float32), stop_gradient=False)
    y = F.dropout(x, p=0.5, training=True)
    mask = y.numpy() != 0.0
    y.sum().backward()
    g = x.grad.numpy()
    np.testing.assert_array_equal(g != 0.0, mask)
    np.testing.assert_allclose(g[mask], 2.0, rtol=1e-6)


def test_dropout_stream_reproducible():
    def run():
        pt.seed(7)
        x = pt.to_tensor(np.ones((16, 16), np.float32), stop_gradient=False)
        a = F.dropout(x, p=0.5, training=True)
        b = F.dropout(x, p=0.5, training=True)
        return a.numpy(), b.numpy()
    a1, b1 = run()
    a2, b2 = run()
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(b1, b2)
    assert (a1 != b1).any()


def test_index_mutated_after_the_forward_keeps_the_gradient():
    def f(P):
        x = P.to_tensor(np.asarray([1., 2., 3., 4.], np.float32),
                        stop_gradient=False)
        idx = P.to_tensor(np.asarray([0, 1], np.int64))
        y = P.gather(x, idx)
        P.assign(P.to_tensor(np.asarray([2, 3], np.int64)), idx)
        y.sum().backward()
        return [x.grad]
    _assert_same(f)


def test_jacobian_matches_jax():
    def f(P):
        x = P.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
        y = x * x * P.to_tensor([1.0, -1.0, 0.5])
        return [P.autograd.jacobian(y, x)]
    _assert_same(f)


def test_saved_tensors_hooks_and_hessian_as_jax():
    with pt.autograd.saved_tensors_hooks(None, None):
        pass
    with pytest.raises(NotImplementedError):
        pt.autograd.hessian(None, None)
