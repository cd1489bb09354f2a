"""``paddle_tpu_torch.jit`` (``to_static`` on ``torch.compile``, ``save`` /
``load`` on ``torch.export``) against the JAX package's ``paddle_tpu.jit``:
every case of tests/test_jit.py has a counterpart here, run by both
packages on the same numpy inputs (and, for layers, the same weights,
``weights.load_jax_state``). CPU, fp32, the ``aot_eager`` backend (no
Inductor compile).

Tolerances: outputs and gradients of the graph-break cases hold exactly
(elementwise arithmetic on a few values) or within 1e-6 relative; a
layer's outputs and gradients within 1e-5 x max(1, max |jax|) (the
packages' matmuls sum in other orders); the 2-layer encoder's 3 AdamW
steps under ``to_static``: losses within 1e-4 relative, the updated
weights as ``torch_slice_encoder.check_updated_weights`` holds them, in
one captured graph for the forward.

The graph-break cases differ in mechanism, not in contract: JAX splits the
AST at the breaking statement (``jit/partial_graph.py``) where the port
resumes compiled execution with Dynamo's graph breaks. Both warn "graph
break"; the port keeps at least one compiled graph wherever JAX's splitter
did, and computes both branches right. A Python counter in the function
counts its traces in JAX, but Dynamo replays such side effects on every
call, so the port's shape-guard case counts the graphs Dynamo captured
(``StaticFunction.traces``).
"""

import warnings

import jax  # noqa: F401  (JAX on the CPU, as tests/conftest.py sets it)
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as pt
from paddle_tpu_torch import device as pt_device
from paddle_tpu_torch.weights import load_jax_state, state_from_jax_layer
from torch_slice_encoder import (ENC_STEPS, adamw, check_updated_weights,
                                 encoder_pair)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def cpu_place():
    prev = pt_device._PLACE
    pt.set_device("cpu")
    yield
    pt_device._PLACE = prev


def _np(t):
    return np.asarray(t.numpy())


def _close(a, b, tol=1e-5):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max() if b.size else 0.0
    assert err <= tol * max(1.0, np.abs(b).max()), err


def _both(make, *arrays, **kwargs):
    """make(P) -> a to_static function; its outputs in both packages on
    ``arrays``, and the port's function."""
    jf, tf = make(jp), make(pt)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j = jf(*[jp.to_tensor(a) for a in arrays], **kwargs)
        t = tf(*[pt.to_tensor(a) for a in arrays], **kwargs)
    return j, t, tf


def _warned(fn, *args, **kwargs):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = fn(*args, **kwargs)
    return out, [str(i.message) for i in w]


def test_graph_break_splits_and_both_branches_run():
    def make(P):
        @P.jit.to_static(full_graph=False)
        def f(x):
            if float(x.sum()) > 0:  # value-dependent python branch
                return x * 2
            return x - 1
        return f

    jf, tf = make(jp), make(pt)
    for arr in (np.ones(3, np.float32), -np.ones(3, np.float32)):
        (j, _), (t, msgs) = _warned(jf, jp.to_tensor(arr)), \
            _warned(tf, pt.to_tensor(arr))
        np.testing.assert_array_equal(_np(t), _np(j))
    out, msgs = _warned(make(pt), pt.to_tensor(np.ones(3, np.float32)))
    assert any("graph break" in m for m in msgs), msgs
    np.testing.assert_allclose(_np(out), 2.0)


def test_full_graph_raises_on_break():
    @pt.jit.to_static(full_graph=True)
    def g(x):
        if float(x.sum()) > 0:
            return x
        return -x

    with pytest.raises(torch._dynamo.exc.TorchDynamoException):
        g(pt.to_tensor(np.ones(3, np.float32)))


def test_compiled_layer_trains_like_jax():
    jl = jp.nn.Linear(4, 2)
    tl = pt.nn.Linear(4, 2)
    load_jax_state(tl, state_from_jax_layer(jl))
    x = np.random.default_rng(0).standard_normal((2, 4)).astype(np.float32)
    outs = []
    for P, lin in ((jp, jl), (pt, tl)):
        sf = P.jit.to_static(lin)
        out = sf(P.to_tensor(x))
        loss = P.mean(out ** 2)
        loss.backward()
        outs.append((out, lin.weight.grad, lin.bias.grad))
    assert list(tl.weight.grad.shape) == [4, 2]
    for t, j in zip(outs[1], outs[0]):
        _close(t, j)
    assert tl.forward.traces == 1


def test_shape_guard_recompiles_and_caches():
    sf = pt.jit.to_static(lambda x: x * 2, full_graph=True)
    a = sf(pt.to_tensor(np.ones((2, 3), np.float32)))
    b = sf(pt.to_tensor(np.ones((4, 3), np.float32)))  # new shape: recompile
    assert list(a.shape) == [2, 3] and list(b.shape) == [4, 3]
    assert sf.traces == 2    # one graph per signature (Dynamo's guards)
    sf(pt.to_tensor(np.ones((2, 3), np.float32)))
    assert sf.traces == 2    # cached
    assert [k[1] for k in sf.cache_keys()] == [
        (((2, 3), "torch.float32"),), (((4, 3), "torch.float32"),)]


def test_amp_state_gets_its_own_graph():
    lin = pt.nn.Linear(4, 4)
    sf = pt.jit.to_static(lin)
    x = pt.to_tensor(np.ones((2, 4), np.float32))
    assert sf(x).dtype == torch.float32
    with pt.amp.auto_cast(level="O1", dtype="bfloat16"):
        assert sf(x).dtype == torch.bfloat16
    assert sf(x).dtype == torch.float32
    assert lin.forward.traces == 2


def test_jit_save_load_matches_jax(tmp_path):
    jl = jp.nn.Linear(3, 2)
    tl = pt.nn.Linear(3, 2)
    load_jax_state(tl, state_from_jax_layer(jl))
    x = np.random.default_rng(1).random((4, 3)).astype(np.float32)
    jp.jit.save(jl, str(tmp_path / "jax"),
                input_spec=[jp.static.InputSpec([4, 3], "float32")])
    pt.jit.save(tl, str(tmp_path / "port"),
                input_spec=[pt.static.InputSpec([4, 3], "float32")])
    j = jp.jit.load(str(tmp_path / "jax"))(jp.to_tensor(x))
    t = pt.jit.load(str(tmp_path / "port"))(pt.to_tensor(x))
    np.testing.assert_allclose(_np(t), _np(tl(pt.to_tensor(x))), rtol=1e-6)
    _close(t, j)


def test_load_without_pdmodel_raises(tmp_path):
    pt.jit.save(pt.nn.Linear(3, 2), str(tmp_path / "m"))
    with pytest.raises(FileNotFoundError, match="input_spec"):
        pt.jit.load(str(tmp_path / "m"))


def test_enable_to_static_off_runs_eagerly():
    sf = pt.jit.to_static(lambda x: x + 1)
    pt.jit.enable_to_static(False)
    try:
        sf(pt.to_tensor(np.ones(2, np.float32)))
    finally:
        pt.jit.enable_to_static(True)
    assert sf.traces == 0


def test_encoder_to_static_training_matches_jax():
    jm, tm, ids, labels = encoder_pair()
    runs = []
    for P, model in ((jp, jm), (pt, tm)):
        P.jit.to_static(model)
        opt = adamw(P, model)
        losses = []
        for _ in range(ENC_STEPS):
            loss = P.nn.functional.cross_entropy(model(P.to_tensor(ids)),
                                                 P.to_tensor(labels))
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.numpy()))
        runs.append(losses)
    jl, tl = runs
    assert tl[-1] < tl[0], tl
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    check_updated_weights(tm, jm)
    assert tm.forward.traces == 1   # one graph for the whole forward


class TestPartialGraph:
    """Counterparts of tests/test_jit.py's SOT-style partial graphs: the
    same functions in both packages, the outputs equal, and the port
    compiled (a graph captured, no eager fallback)."""

    def test_split_halves_are_compiled(self):
        def make(P):
            @P.jit.to_static(full_graph=False)
            def f(x):
                y = x * 2.0
                if (y.sum() > 0):
                    z = y + 1.0
                else:
                    z = y - 1.0
                return z * 3.0
            return f

        for arr in ([1., 2.], [-1., -2.]):
            j, t, tf = _both(make, np.asarray(arr, np.float32))
            np.testing.assert_allclose(_np(t), _np(j))
        assert tf.traces >= 1 and not tf._fallback_eager

    def test_second_break(self):
        def make(P):
            @P.jit.to_static(full_graph=False)
            def g(x):
                y = x + 1.0
                if (y.sum() > 0):
                    w = y * 2.0
                else:
                    w = y * 4.0
                if (w.mean() > 10.0):
                    out = w - 100.0
                else:
                    out = w + 100.0
                return out
            return g

        jg, tg = make(jp), make(pt)
        for arr in ([20., 20.], [1., 1.], [-9., -9.]):
            a = np.asarray(arr, np.float32)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                np.testing.assert_allclose(_np(tg(pt.to_tensor(a))),
                                           _np(jg(jp.to_tensor(a))),
                                           rtol=1e-6)
        assert tg.traces >= 2 and not tg._fallback_eager

    def test_loop_with_break_stays_compiled(self):
        """JAX's splitter refuses a loop body with `break` and runs the
        function eagerly; Dynamo keeps the graph before the loop."""
        def make(P):
            @P.jit.to_static(full_graph=False)
            def h(x):
                n = 0
                while (x.sum() > 0):
                    x = x - 1.0
                    n += 1
                    if n > 100:
                        break
                return x
            return h

        j, t, th = _both(make, np.asarray([2.5], np.float32))
        np.testing.assert_allclose(_np(t), _np(j))
        np.testing.assert_allclose(_np(t), [-0.5])
        assert not th._fallback_eager

    def test_while_on_tensor(self):
        def make(P):
            @P.jit.to_static(full_graph=False)
            def h(x):
                n = x.sum() * 0.0
                while (x.sum() > 0):
                    x = x - 1.0
                    n = n + 1.0
                return x + n * 0.0
            return h

        jh, th = make(jp), make(pt)
        for arr in ([2.5], [1.25]):
            a = np.asarray(arr, np.float32)
            t, msgs = _warned(th, pt.to_tensor(a))
            j, _ = _warned(jh, jp.to_tensor(a))
            np.testing.assert_allclose(_np(t), _np(j))
        np.testing.assert_allclose(_np(t), [-0.75])
        assert th.traces >= 1 and not th._fallback_eager

    def test_while_with_shape_changing_carry(self):
        def make(P):
            @P.jit.to_static(full_graph=False)
            def h(x):
                n = x.sum() * 0.0
                while (x.sum() > 0):
                    x = P.concat([x, x])[:4]
                    x = x - 1.0
                    n = n + 1.0
                return n + x.sum() * 0.0
            return h

        jh, th = make(jp), make(pt)
        for arr, want in (([2.5] * 4, 3.0), ([1.5] * 2, 2.0),
                          ([0.5] * 4, 1.0)):
            a = np.asarray(arr, np.float32)
            t, _ = _warned(th, pt.to_tensor(a))
            j, _ = _warned(jh, jp.to_tensor(a))
            np.testing.assert_allclose(_np(t), _np(j))
            np.testing.assert_allclose(_np(t), want)

    def test_while_with_python_list_carry(self):
        def make(P):
            @P.jit.to_static(full_graph=False)
            def h(x, lst):
                while (x.sum() > 0):
                    x = x - 1.0
                    lst = lst + [1]    # python list append
                return x
            return h

        jh, th = make(jp), make(pt)
        a = np.asarray([2.5], np.float32)
        t, _ = _warned(th, pt.to_tensor(a), [])
        j, _ = _warned(jh, jp.to_tensor(a), [])
        np.testing.assert_allclose(_np(t), _np(j))
        np.testing.assert_allclose(_np(t), [-0.5])

    def test_for_loop_with_inner_break(self):
        def make(P):
            @P.jit.to_static(full_graph=False)
            def h(x):
                acc = x * 0.0
                for i in range(3):
                    if (x.sum() > 0):
                        acc = acc + x
                    else:
                        acc = acc - x
                    x = x - 1.0
                return acc
            return h

        j, t, th = _both(make, np.asarray([1.5], np.float32))
        np.testing.assert_allclose(_np(t), _np(j))
        np.testing.assert_allclose(_np(t), [1.5 + 0.5 + 0.5])

    def test_layer_forward_splits_with_grads(self):
        def make_net(P):
            class Net(P.nn.Layer):
                def __init__(self):
                    super().__init__()
                    self.lin = P.nn.Linear(3, 3)

                def forward(self, x):
                    y = self.lin(x)
                    if (y.sum() > 0):
                        return y * 2.0
                    return y * -1.0
            return Net()

        x = np.asarray([[1., 2., 3.]], np.float32)
        jnet, eager, tnet = make_net(jp), make_net(pt), make_net(pt)
        load_jax_state(eager, state_from_jax_layer(jnet))
        load_jax_state(tnet, state_from_jax_layer(jnet))
        jnet.forward = jp.jit.to_static(jnet.forward, full_graph=False)
        tnet.forward = pt.jit.to_static(tnet.forward, full_graph=False)
        t, msgs = _warned(tnet.forward, pt.to_tensor(x))
        j, _ = _warned(jnet.forward, jp.to_tensor(x))
        assert any("graph break" in m for m in msgs), msgs
        np.testing.assert_allclose(_np(t), _np(eager(pt.to_tensor(x))),
                                   rtol=1e-6)
        _close(t, j)
        tnet.forward(pt.to_tensor(x)).sum().backward()
        eager(pt.to_tensor(x)).sum().backward()
        jnet.forward(jp.to_tensor(x)).sum().backward()
        np.testing.assert_allclose(_np(tnet.lin.weight.grad),
                                   _np(eager.lin.weight.grad), rtol=1e-5)
        _close(tnet.lin.weight.grad, jnet.lin.weight.grad)
        assert tnet.forward.traces >= 1

    def test_kwargs_and_defaults(self):
        def make(P):
            @P.jit.to_static(full_graph=False)
            def h(x, scale=3.0):
                y = x * scale
                if (y.sum() > 0):
                    return y + 1.0
                return y - 1.0
            return h

        a = np.asarray([1., 1.], np.float32)
        j, t, th = _both(make, a)
        np.testing.assert_allclose(_np(t), _np(j))
        np.testing.assert_allclose(_np(t), a * 3 + 1)
        jh = make(jp)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jh(jp.to_tensor(a))
            j2 = jh(x=jp.to_tensor(a), scale=-5.0)
            t2 = th(x=pt.to_tensor(a), scale=-5.0)
        np.testing.assert_allclose(_np(t2), _np(j2))
        np.testing.assert_allclose(_np(t2), a * -5 - 1)
        assert not th._fallback_eager

    def test_reassigned_argument(self):
        def make(P):
            @P.jit.to_static(full_graph=False)
            def k(x):
                x = x * 2.0
                s = x * 0.0
                if (x.sum() > 0):
                    s += x + 1.0
                else:
                    s += x - 1.0
                return s
            return k

        for arr, sign in (([1., 2.], 1), ([-1., -2.], -1)):
            a = np.asarray(arr, np.float32)
            j, t, tk = _both(make, a)
            np.testing.assert_allclose(_np(t), _np(j))
            np.testing.assert_allclose(_np(t), a * 2 + sign)

    def test_early_return_guard(self):
        def make(P):
            @P.jit.to_static(full_graph=False)
            def m(x, flag):
                if flag == 1:        # static python guard, early return
                    return x
                y = x * 2.0
                if (y.sum() > 0):
                    return y + 1.0
                return y - 1.0
            return m

        jm, tm = make(jp), make(pt)
        a = np.asarray([1., 2.], np.float32)
        b = np.asarray([-1., -2.], np.float32)
        for arr, flag, want in ((a, 0, a * 2 + 1), (a, 1, a),
                                (b, 0, b * 2 - 1)):
            t, _ = _warned(tm, pt.to_tensor(arr), flag)
            j, _ = _warned(jm, jp.to_tensor(arr), flag)
            np.testing.assert_allclose(_np(t), _np(j))
            np.testing.assert_allclose(_np(t), want)

    def test_return_in_prefix_before_the_break(self):
        """JAX's try_split refuses a prefix holding a return (the
        function then runs eagerly); the port's graph break keeps both the
        early return and the tensor branch right."""
        def make(P):
            @P.jit.to_static(full_graph=False)
            def q(x, none):
                if none is None:
                    return x * 0.0
                y = x * 2.0
                if (y.sum() > 0):
                    return y
                return -y
            return q

        tq = make(pt)
        a = np.asarray([1., -3.], np.float32)
        t, _ = _warned(tq, pt.to_tensor(a), 1)
        np.testing.assert_allclose(_np(t), -(a * 2))
        t, _ = _warned(tq, pt.to_tensor(a), None)
        np.testing.assert_allclose(_np(t), 0.0)

    def test_while_split_backward(self):
        def make(P):
            @P.jit.to_static(full_graph=False)
            def h(x):
                s = x * 1.0
                while (s.sum() > 1.0):
                    s = s * 0.5
                return s
            return h

        grads = []
        for P in (jp, pt):
            x = P.to_tensor(np.asarray([4.0], np.float32),
                            stop_gradient=False)
            out, _ = _warned(make(P), x)
            np.testing.assert_allclose(_np(out), [1.0])   # 4 -> 2 -> 1
            out.sum().backward()
            grads.append(_np(x.grad))
        np.testing.assert_allclose(grads[1], grads[0], rtol=1e-6)
        np.testing.assert_allclose(grads[1], [0.25], rtol=1e-6)
