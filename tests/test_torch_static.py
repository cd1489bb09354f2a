"""``paddle_tpu_torch.static`` (Program recording through the op
dispatcher, the Executor's compiled replay, the passes, static training
through ``Optimizer.minimize`` / ``append_backward``) against the JAX
package's ``paddle_tpu.static``: every case of tests/test_static.py has a
counterpart, the same program built in both packages and run on the same
numpy feeds (layers on the same weights, ``weights.load_jax_state``).
CPU, fp32, the ``aot_eager`` backend.

Tolerances: fetched values within 1e-5 x max(1, max |jax|) (the packages'
matmuls sum in other orders); the passes' counts and the op counts equal
JAX's exactly; SGD losses step by step within 1e-4 relative (plus 1e-6
absolute as they approach 0); the 2-layer encoder's 3 AdamW steps: losses
within 1e-4 relative and the updated weights as
``torch_slice_encoder.check_updated_weights`` holds them. The dropout cases hold the port to the JAX Executor's guarantees
(a fresh mask every run, the same masks after the same ``paddle.seed``, a
test clone never draws), not to its bits.
"""

import jax  # noqa: F401  (JAX on the CPU, as tests/conftest.py sets it)
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as pt
from paddle_tpu_torch import device as pt_device
from paddle_tpu_torch.weights import load_jax_state, state_from_jax_layer
from torch_slice_encoder import (ENC_BATCH, ENC_SEQ, ENC_STEPS, adamw,
                                 check_updated_weights, encoder_pair)

torch.set_num_threads(1)
BOTH = (jp, pt)


@pytest.fixture(autouse=True)
def _static_mode():
    prev = pt_device._PLACE
    pt.set_device("cpu")
    for P in BOTH:
        P.enable_static()
    yield
    for P in BOTH:
        P.disable_static()
    pt_device._PLACE = prev


def _np(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


def _close(a, b, tol=1e-5):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a.astype(np.float64) - b).max() if b.size else 0.0
    assert err <= tol * max(1.0, np.abs(b).max()), err


def _program(P, body):
    """``body(P)`` recorded into a fresh program of package P; returns
    (program, body's result)."""
    main = P.static.Program()
    with P.static.program_guard(main):
        out = body(P)
    return main, out


def _linear(P, i, o):
    """A Linear of package P; the port's on the JAX one's weights (the
    JAX one is built first)."""
    lin = P.nn.Linear(i, o)
    if P is jp:
        _linear.last = lin
    else:
        load_jax_state(lin, state_from_jax_layer(_linear.last))
    return lin


def test_program_record_and_run():
    xv = np.random.rand(2, 4).astype(np.float32)
    res = []
    for P in BOTH:
        def body(P):
            x = P.static.data("x", [None, 4], "float32")
            y = P.matmul(x, P.ones([4, 3]))
            return y + 1.0
        main, z = _program(P, body)
        assert main.num_ops >= 2 and "matmul" in main.to_string()
        (out,) = P.static.Executor().run(main, feed={"x": xv},
                                         fetch_list=[z])
        res.append((main.num_ops, out))
    assert res[0][0] == res[1][0]
    _close(res[1][1], res[0][1])
    np.testing.assert_allclose(res[1][1], xv @ np.ones((4, 3)) + 1.0,
                               rtol=1e-6)


def test_shape_inference():
    shapes = []
    for P in BOTH:
        def body(P):
            x = P.static.data("x", [8, 16], "float32")
            y = P.nn.functional.relu(x)
            m = P.matmul(x, P.zeros([16, 32]))
            return y, m
        _, (y, m) = _program(P, body)
        shapes.append((y.shape, m.shape))
    assert shapes[1] == shapes[0] == ([8, 16], [8, 32])
    assert y.dtype == torch.float32


def test_dynamic_batch_dim():
    for P in BOTH:
        main, y = _program(P, lambda P: P.static.data(
            "x", [None, 3], "float32") * 2.0)
        exe = P.static.Executor()
        for b in (2, 5):
            (out,) = exe.run(main, feed={"x": np.ones((b, 3), np.float32)},
                             fetch_list=[y])
            assert out.shape == (b, 3)
            np.testing.assert_allclose(out, 2.0)


def test_symbolic_bool_raises():
    main = pt.static.Program()
    with pt.static.program_guard(main):
        x = pt.static.data("x", [2], "float32")
        with pytest.raises(RuntimeError, match="cannot branch"):
            bool(x > 0)
        with pytest.raises(RuntimeError, match="symbolic"):
            (x + 1).numpy()
        with pytest.raises(RuntimeError, match="symbolic"):
            x.item()


def test_torch_op_outside_the_dispatcher_raises():
    """A torch function on a Variable that does not come through the
    dispatcher would compute a meta result silently: it raises."""
    main = pt.static.Program()
    with pt.static.program_guard(main):
        x = pt.static.data("x", [2, 3], "float32")
        with pytest.raises(RuntimeError, match="outside|records only"):
            torch.exp(x)
        with pytest.raises(RuntimeError, match="records only"):
            torch.nn.functional.relu(x)
        # metadata reads are answered
        assert x.dtype == torch.float32 and x.ndim == 2 and len(x) == 2
    assert main.num_ops == 0


def test_layer_in_static_graph():
    xv = np.random.rand(4, 8).astype(np.float32)
    outs = []
    for P in BOTH:
        def body(P):
            x = P.static.data("x", [4, 8], "float32")
            lin = _linear(P, 8, 2)
            return lin, lin(x)
        main, (lin, out) = _program(P, body)
        (o,) = P.static.Executor().run(main, feed={"x": xv},
                                       fetch_list=[out])
        outs.append(o)
    _close(outs[1], outs[0])
    np.testing.assert_allclose(
        outs[1], xv @ _np(lin.weight) + _np(lin.bias), rtol=1e-5)


def test_static_training_minimize_matches_jax_step_by_step():
    w_true = np.array([[1.0], [-2.0], [0.5], [3.0]], np.float32)

    def body(P):
        x = P.static.data("x", [16, 4], "float32")
        label = P.static.data("label", [16, 1], "float32")
        lin = _linear(P, 4, 1)
        loss = P.mean((lin(x) - label) ** 2)
        P.optimizer.SGD(learning_rate=0.1,
                        parameters=list(lin.parameters())).minimize(loss)
        return loss

    built = [_program(P, body) for P in BOTH]   # before either trains
    runs = []
    for P, (main, loss) in zip(BOTH, built):
        exe = P.static.Executor()
        rng = np.random.default_rng(0)
        losses = []
        for _ in range(60):
            xv = rng.standard_normal((16, 4)).astype(np.float32)
            (lv,) = exe.run(main, feed={"x": xv, "label": xv @ w_true},
                            fetch_list=[loss])
            losses.append(float(lv))
        runs.append(losses)
    jl, tl = runs
    assert tl[-1] < tl[0] * 0.1, tl[::10]
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-6)


def test_append_backward_grads():
    grads = []
    for P in BOTH:
        def body(P):
            x = P.static.data("x", [3, 2], "float32")
            lin = _linear(P, 2, 1)
            loss = P.sum(lin(x))
            P.static.append_backward(loss)
            return lin, loss
        main, (lin, loss) = _program(P, body)
        P.static.Executor().run(main, feed={"x": np.ones((3, 2),
                                                         np.float32)},
                                fetch_list=[loss])
        grads.append(_np(lin.weight.grad))
    np.testing.assert_allclose(grads[1], grads[0], rtol=1e-6)
    np.testing.assert_allclose(grads[1], np.full((2, 1), 3.0), rtol=1e-6)


def _dce_body(P):
    x = P.static.data("x", [2, 2], "float32")
    used = x + 1.0
    _unused = P.exp(x) * 5.0  # dead
    return used


def test_dce_pass():
    counts = []
    for P in BOTH:
        main, used = _program(P, _dce_body)
        n_before = main.num_ops
        removed = P.static.passes.DeadCodeEliminationPass([used]).apply(main)
        assert removed >= 2 and main.num_ops < n_before
        (o,) = P.static.Executor().run(
            main, feed={"x": np.zeros((2, 2), np.float32)},
            fetch_list=[used])
        np.testing.assert_allclose(o, 1.0)
        counts.append((n_before, removed, main.num_ops))
    assert counts[1] == counts[0]


def test_constant_folding_pass():
    counts = []
    for P in BOTH:
        def body(P):
            x = P.static.data("x", [2], "float32")
            c = P.ones([2]) * 3.0 + 1.0  # feed-independent subgraph
            return x + c
        main, y = _program(P, body)
        n_before = main.num_ops
        folded = P.static.passes.ConstantFoldingPass().apply(main)
        assert folded >= 1 and main.num_ops < n_before
        (o,) = P.static.Executor().run(
            main, feed={"x": np.zeros(2, np.float32)}, fetch_list=[y])
        np.testing.assert_allclose(o, 4.0)
        counts.append((n_before, folded, main.num_ops))
    assert counts[1] == counts[0]


def test_cse_pass():
    xv = np.random.rand(4).astype(np.float32)
    counts = []
    for P in BOTH:
        def body(P):
            x = P.static.data("x", [4], "float32")
            return P.exp(x) + P.exp(x)  # duplicate
        main, y = _program(P, body)
        merged = P.static.passes.CommonSubexpressionEliminationPass().apply(
            main)
        assert merged >= 1
        (o,) = P.static.Executor().run(main, feed={"x": xv}, fetch_list=[y])
        np.testing.assert_allclose(o, 2 * np.exp(xv), rtol=1e-6)
        counts.append((merged, main.num_ops))
    assert counts[1] == counts[0]


def _ones_sum(P):
    x = P.static.data("x", [2], "float32")
    return x + (P.ones([2]) + P.ones([2]))


def test_compiled_program():
    counts = []
    for P in BOTH:
        main, y = _program(P, _ones_sum)
        cp = P.static.CompiledProgram(main)
        cp._ensure_optimized()
        (o,) = P.static.Executor().run(
            cp, feed={"x": np.zeros(2, np.float32)}, fetch_list=[y])
        np.testing.assert_allclose(o, 2.0)
        counts.append(main.num_ops)
    assert counts[1] == counts[0]


def test_program_clone_and_startup():
    for P in BOTH:
        main = P.static.Program()
        with P.static.program_guard(main, P.static.default_startup_program()):
            x = P.static.data("x", [2], "float32")
            y = x * 2.0
        test_prog = main.clone(for_test=True)
        exe = P.static.Executor()
        exe.run(P.static.default_startup_program())  # eager init: no-op
        (o,) = exe.run(test_prog, feed={"x": np.ones(2, np.float32)},
                       fetch_list=[y])
        np.testing.assert_allclose(o, 2.0)


def test_fetch_cse_aliased_var():
    xv = np.random.rand(4).astype(np.float32)
    for P in BOTH:
        def body(P):
            x = P.static.data("x", [4], "float32")
            _a = P.exp(x)
            return P.exp(x)  # becomes an alias of _a after CSE
        main, b = _program(P, body)
        assert P.static.passes.CommonSubexpressionEliminationPass().apply(
            main) == 1
        (o,) = P.static.Executor().run(main, feed={"x": xv}, fetch_list=[b])
        np.testing.assert_allclose(o, np.exp(xv), rtol=1e-6)


def test_fetch_folded_var():
    for P in BOTH:
        def body(P):
            x = P.static.data("x", [2], "float32")
            c = P.ones([2]) * 3.0 + 1.0
            _y = x + c
            return c
        main, c = _program(P, body)
        P.static.passes.ConstantFoldingPass().apply(main)
        (o,) = P.static.Executor().run(
            main, feed={"x": np.zeros(2, np.float32)}, fetch_list=[c])
        np.testing.assert_allclose(o, 4.0)


def test_cse_no_merge_on_distinct_array_literals():
    for P in BOTH:
        def body(P):
            x = P.static.data("x", [2000], "float32")
            a1 = np.zeros(2000, np.float32)
            a2 = a1.copy()
            a2[1000] = 7.0
            z1 = P.add(x, P.to_tensor(a1))
            z2 = P.add(x, P.to_tensor(a2))
            return z1 + z2
        main, s = _program(P, body)
        P.static.passes.CommonSubexpressionEliminationPass().apply(main)
        (o,) = P.static.Executor().run(
            main, feed={"x": np.zeros(2000, np.float32)}, fetch_list=[s])
        assert o[1000] == 7.0


def test_closure_fingerprint_tells_tensor_literals_apart():
    from paddle_tpu_torch.static.passes import _closure_fingerprint

    a, b = torch.zeros(3), torch.ones(3)
    assert _closure_fingerprint(lambda x: x + a) is None
    assert _closure_fingerprint(lambda x: x + b) is None
    k = 2.0
    assert _closure_fingerprint(lambda x: x * k) is not None


def test_compiled_program_optimizes_via_run():
    for P in BOTH:
        main, y = _program(P, _ones_sum)
        cp = P.static.CompiledProgram(main)
        (o,) = P.static.Executor().run(
            cp, feed={"x": np.zeros(2, np.float32)}, fetch_list=[y])
        assert cp._optimized  # run() triggered the pass pipeline
        np.testing.assert_allclose(o, 2.0)


def test_fc_rejects_dynamic_feature_dim():
    for P in BOTH:
        main = P.static.Program()
        with P.static.program_guard(main):
            x = P.static.data("x", [None, None], "float32")
            with pytest.raises(ValueError, match="must be static"):
                P.static.nn.fc(x, 10)


def test_static_nn_fc_matches_jax():
    xv = np.random.rand(4, 2, 3).astype(np.float32)
    outs = []
    for P in BOTH:
        P.seed(0)
        main, y = _program(P, lambda P: P.static.nn.fc(
            P.static.data("x", [4, 2, 3], "float32"), 5, activation="relu"))
        assert y.shape == [4, 5]
        params = main.all_parameters()
        if P is jp:
            vals = [_np(p) for p in params]
        else:
            for p, v in zip(params, vals):
                p.set_value(v)
        (o,) = P.static.Executor().run(main, feed={"x": xv},
                                       fetch_list=[y])
        outs.append(o)
    _close(outs[1], outs[0])


def _dropout_program(P, n=64, alpha=False):
    def body(P):
        x = P.static.data("x", [n], "float32")
        f = P.nn.functional.alpha_dropout if alpha \
            else P.nn.functional.dropout
        return f(x, p=0.5, training=True)
    return _program(P, body)


def test_static_dropout_fresh_mask_per_run():
    main, y = _dropout_program(pt)
    exe = pt.static.Executor()
    xv = np.ones(64, np.float32)
    (o1,) = exe.run(main, feed={"x": xv}, fetch_list=[y])
    (o2,) = exe.run(main, feed={"x": xv}, fetch_list=[y])
    assert not np.array_equal(o1, o2), "dropout mask frozen across runs"
    assert 0.3 < o1.mean() < 2.0   # upscale_in_train keeps it ~1
    assert set(np.unique(o1)) <= {0.0, 2.0}
    assert len(exe.cache_signatures()) == 1


def test_clone_for_test_disables_dropout():
    for P in BOTH:
        main, d = _dropout_program(P, 32)
        with P.static.program_guard(main):
            y = d + 1.0
        test_prog = main.clone(for_test=True)
        exe = P.static.Executor()
        xv = np.ones(32, np.float32)
        (o,) = exe.run(test_prog, feed={"x": xv}, fetch_list=[y])
        np.testing.assert_allclose(o, 2.0)  # identity + 1, no masking
        (t,) = exe.run(main, feed={"x": xv}, fetch_list=[y])
        assert (t == 1.0).any()   # the original still drops


def test_clone_preserves_pass_state():
    for P in BOTH:
        def body(P):
            x = P.static.data("x", [2], "float32")
            return x + P.ones([2]) * 3.0
        main, y = _program(P, body)
        P.static.passes.ConstantFoldingPass().apply(main)
        t = main.clone(for_test=True)
        (o,) = P.static.Executor().run(
            t, feed={"x": np.zeros(2, np.float32)}, fetch_list=[y])
        np.testing.assert_allclose(o, 3.0)


def test_fetch_from_fully_folded_program():
    for P in BOTH:
        main, c = _program(P, lambda P: P.ones([2]) * 3.0)
        P.static.passes.ConstantFoldingPass().apply(main)
        assert main.num_ops == 0
        (o,) = P.static.Executor().run(main, fetch_list=[c])
        np.testing.assert_allclose(o, 3.0)


def test_test_clone_never_trains():
    def body(P):
        x = P.static.data("x", [8, 4], "float32")
        lin = P.nn.Linear(4, 1)
        pred = lin(x)
        P.optimizer.SGD(learning_rate=1.0, parameters=list(
            lin.parameters())).minimize(P.mean(pred ** 2))
        return pred
    main, pred = _program(pt, body)
    t = main.clone(for_test=True)
    exe = pt.static.Executor()
    xv = np.ones((8, 4), np.float32)
    (o1,) = exe.run(t, feed={"x": xv}, fetch_list=[pred])
    (o2,) = exe.run(t, feed={"x": xv}, fetch_list=[pred])
    np.testing.assert_array_equal(o1, o2)  # eval must not move weights
    (o3,) = exe.run(main, feed={"x": xv}, fetch_list=[pred])
    (o4,) = exe.run(main, feed={"x": xv}, fetch_list=[pred])
    assert not np.array_equal(o3, o4)      # the training program does


def test_static_dropout_reproducible_under_seed():
    main, y = _dropout_program(pt)
    exe = pt.static.Executor()
    xv = np.ones(64, np.float32)
    pt.seed(42)
    (a,) = exe.run(main, feed={"x": xv}, fetch_list=[y])
    (c,) = exe.run(main, feed={"x": xv}, fetch_list=[y])
    pt.seed(42)
    (b,) = exe.run(main, feed={"x": xv}, fetch_list=[y])
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_static_alpha_dropout_fresh_and_clonable():
    main, y = _dropout_program(pt, alpha=True)
    exe = pt.static.Executor()
    xv = np.ones(64, np.float32)
    (o1,) = exe.run(main, feed={"x": xv}, fetch_list=[y])
    (o2,) = exe.run(main, feed={"x": xv}, fetch_list=[y])
    assert not np.array_equal(o1, o2), "alpha_dropout mask frozen"
    t = main.clone(for_test=True)
    (e,) = exe.run(t, feed={"x": xv}, fetch_list=[y])
    np.testing.assert_allclose(e, 1.0)  # identity in the test clone


def test_executor_cache_reuse_after_param_update():
    for P in BOTH:
        def body(P):
            x = P.static.data("x", [1, 2], "float32")
            lin = P.nn.Linear(2, 1)
            return lin, lin(x)
        main, (lin, out) = _program(P, body)
        exe = P.static.Executor()
        xv = np.ones((1, 2), np.float32)
        (o1,) = exe.run(main, feed={"x": xv}, fetch_list=[out])
        lin.weight.set_value(_np(lin.weight) + 1.0)  # late binding
        (o2,) = exe.run(main, feed={"x": xv}, fetch_list=[out])
        np.testing.assert_allclose(o2 - o1, 2.0, rtol=1e-6)
        assert len(exe._cache) == 1  # one compiled plan
    assert exe.cache_signatures()[0][-1] is False


def test_scope_and_the_later_gates():
    sc = pt.static.Scope()
    assert float(sc.var("never")) == 0.0 and sc._lazy_reads == {"never": 1}
    with pytest.raises(KeyError, match="never written"):
        sc.var("other", strict=True)
    main, y = _program(pt, lambda P: P.static.data("x", [2], "float32") * 3)
    pt.static.Executor().run(main, feed={"x": np.ones(2, np.float32)},
                             fetch_list=[y], scope=sc)
    np.testing.assert_allclose(_np(sc.var(y.name, strict=True)), 3.0)
    with pytest.raises(NotImplementedError, match="item 9"):
        main.diagnose()
    for gate in ("analysis", "concurrency", "cost", "comm"):
        with pytest.raises(NotImplementedError, match="item 9"):
            getattr(pt.static, gate)
    assert pt.in_static_mode() and not pt.in_dynamic_mode()


# -- the slice as a whole: the encoder classifier, 2 layers x 32 wide ------

def test_encoder_static_training_matches_jax():
    jm, tm, ids, labels = encoder_pair()
    runs = []
    for P, model in ((jp, jm), (pt, tm)):
        main = P.static.Program()
        with P.static.program_guard(main):
            x = P.static.data("ids", [ENC_BATCH, ENC_SEQ], "int64")
            y = P.static.data("labels", [ENC_BATCH], "int64")
            loss = P.nn.functional.cross_entropy(model(x), y)
            adamw(P, model).minimize(loss)
        exe = P.static.Executor()
        losses = [float(exe.run(main, feed={"ids": ids, "labels": labels},
                                fetch_list=[loss])[0])
                  for _ in range(ENC_STEPS)]
        runs.append((main.num_ops, losses, len(exe.cache_signatures())))
    (jn, jl, _), (tn, tl, tsig) = runs
    assert tn == jn, (tn, jn)
    assert tsig == 1
    assert tl[-1] < tl[0], tl
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    check_updated_weights(tm, jm)
