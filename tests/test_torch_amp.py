"""The port's AMP (``amp.auto_cast``, ``decorate``, ``GradScaler``) and the
dispatcher's nan/inf check against the JAX package's, on the CPU.

What is held, each exactly (dtypes, names, scaler state are discrete):
- the dtype table: each row's output dtype equals the JAX package's under
  O1 and O2, in bf16 and fp16 (layer_norm, exp and sum keep their input
  dtype, softmax gives fp32, linear / matmul / ``@`` of fp32 give the AMP
  dtype, fp32 + low gives fp32, ``custom_white_list=["exp"]`` changes
  nothing, O2 leaves exp of fp32 in fp32);
- only the JAX package's categorised OpDefs are ever cast;
- every sublayer output dtype of a small TransformerEncoderLayer forward
  under O1;
- the parameters ``decorate(level="O2")`` casts, and their identity;
- GradScaler's scale, good / bad steps and state_dict over 6 steps with an
  inf injected at step 3, and the parameters after (SGD, fp32: max abs
  error <= 1e-6 x max(1, max |jax|); the unscale rounds in the last place);
- the nan/inf check: level 0 raises FloatingPointError, level 1 warns, and
  both record the health word's bits.
"""

import warnings

import jax  # noqa: F401  (JAX on the CPU, as tests/conftest.py sets it)
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as F
from paddle_tpu.framework import numeric_guard as jguard
from paddle_tpu_torch import device as pt_device
from paddle_tpu_torch.core import op_registry
from paddle_tpu_torch.framework import numeric_guard as pguard
from paddle_tpu_torch.weights import load_jax_state, state_from_jax_layer

torch.set_num_threads(1)
RNG = np.random.default_rng(19)


@pytest.fixture(autouse=True)
def cpu_place():
    prev = pt_device._PLACE
    pt.set_device("cpu")
    yield
    pt_device._PLACE = prev


def _name(dt):
    s = str(dt)
    return s.split(".")[-1].replace("dtype(", "").replace("'", "").rstrip(
        ")")


def _x(*s):
    return RNG.standard_normal(s).astype(np.float32)


def _low(P, arr, dtype):
    return P.to_tensor(arr).astype(dtype)


# each row: fn(P, F, low dtype) -> tensor whose dtype is compared
ROWS = {
    "layer_norm": lambda P, Fn, d: Fn.layer_norm(_low(P, _x(2, 8), d), 8),
    "exp": lambda P, Fn, d: P.exp(_low(P, _x(4), d)),
    "sum": lambda P, Fn, d: P.sum(_low(P, _x(4), d)),
    "sdpa": lambda P, Fn, d: Fn.scaled_dot_product_attention(
        *[_low(P, _x(1, 4, 2, 8), d) for _ in range(3)]),
    "softmax": lambda P, Fn, d: Fn.softmax(_low(P, _x(2, 4), d)),
    "linear_fp32": lambda P, Fn, d: Fn.linear(P.to_tensor(_x(2, 4)),
                                              P.to_tensor(_x(4, 3))),
    "matmul_fp32": lambda P, Fn, d: P.matmul(P.to_tensor(_x(2, 4)),
                                             P.to_tensor(_x(4, 3))),
    "at_fp32": lambda P, Fn, d: P.to_tensor(_x(2, 4)) @ P.to_tensor(
        _x(4, 3)),
    "fp32_plus_low": lambda P, Fn, d: P.to_tensor(_x(4)) + _low(P, _x(4), d),
    "cross_entropy_low": lambda P, Fn, d: Fn.cross_entropy(
        _low(P, _x(3, 5), d), P.to_tensor(np.array([0, 2, 4]))),
    "logsumexp_low": lambda P, Fn, d: P.logsumexp(_low(P, _x(3, 5), d)),
    "exp_fp32": lambda P, Fn, d: P.exp(P.to_tensor(_x(4))),
}


@pytest.mark.parametrize("row", sorted(ROWS))
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("level", ["O1", "O2"])
def test_dtype_table_equals_jax(row, dtype, level):
    fn = ROWS[row]
    with jp.amp.auto_cast(level=level, dtype=dtype):
        ref = _name(fn(jp, JF, dtype).dtype)
    with pt.amp.auto_cast(level=level, dtype=dtype):
        got = _name(fn(pt, F, dtype).dtype)
    assert got == ref, (row, level, dtype, got, ref)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_custom_white_list_leaves_a_neutral_op_alone(dtype):
    for P, Fn in ((jp, JF), (pt, F)):
        with P.amp.auto_cast(custom_white_list=["exp"], dtype=dtype):
            assert _name(P.exp(P.to_tensor(_x(4))).dtype) == "float32"
        with P.amp.auto_cast(custom_black_list=["linear"], dtype=dtype):
            out = Fn.linear(_low(P, _x(2, 4), dtype),
                            _low(P, _x(4, 3), dtype))
            assert _name(out.dtype) == "float32"   # black: cast to fp32


def test_amp_state_api_equals_jax():
    for P in (jp, pt):
        assert not P.amp.is_auto_cast_enabled()
        assert P.amp.get_amp_dtype() == "float32"
        with P.amp.auto_cast(dtype="float16"):
            assert P.amp.is_auto_cast_enabled()
            assert P.amp.get_amp_dtype() == "float16"
        with P.amp.amp_guard(enable=False):
            assert not P.amp.is_auto_cast_enabled()
    assert pt.amp.is_bfloat16_supported()


def test_only_the_categorised_opdefs_are_cast():
    """The port defines exactly the JAX package's categorised OpDefs (the
    seventh, column_parallel_linear, arrives with ROADMAP item 6), and an
    op without one is never cast, whatever the lists say."""
    import importlib

    found = {}
    for mod in ("tensor.math", "nn.functional.common", "nn.functional.conv",
                "nn.functional.activation", "nn.functional.loss"):
        m = importlib.import_module("paddle_tpu_torch." + mod)
        for v in vars(m).values():
            if isinstance(v, op_registry.OpDef) \
                    and v.amp != op_registry.AMP_NEUTRAL:
                found[v.name] = v.amp
    assert found == {"matmul": "white", "logsumexp": "black",
                     "linear": "white", "conv": "white", "softmax": "black",
                     "cross_entropy": "black"}
    casts = []
    real = op_registry._amp_cast
    try:
        op_registry._amp_cast = lambda a, op: casts.append(op.name) or real(
            a, op)
        with pt.amp.auto_cast(level="O2"):
            x = pt.to_tensor(_x(3, 4))
            pt.exp(x), pt.sum(x), F.layer_norm(x, 4), F.gelu(x), x + x
            F.linear(x, pt.to_tensor(_x(4, 2))), F.softmax(x), x @ x.T
    finally:
        op_registry._amp_cast = real
    assert casts == ["linear", "softmax", "matmul"]


def _small_layer(P, nn_mod):
    P.seed(3)
    return nn_mod.TransformerEncoderLayer(16, 2, 32, dropout=0.0,
                                          activation="gelu")


def _record_dtypes(layer):
    seen = []
    for name, sub in layer.named_sublayers():
        sub.register_forward_post_hook(
            lambda m, i, o, n=name: seen.append((n, _name(o.dtype))))
    return seen


def test_encoder_layer_intermediate_dtypes_equal_jax():
    import paddle_tpu.nn as jnn
    from paddle_tpu_torch import nn as pnn

    jl = _small_layer(jp, jnn)
    tl = _small_layer(pt, pnn)
    load_jax_state(tl, state_from_jax_layer(jl))
    x = _x(2, 5, 16)
    jseen, tseen = _record_dtypes(jl), _record_dtypes(tl)
    with jp.amp.auto_cast(level="O1"):
        jout = jl(jp.to_tensor(x))
    with pt.amp.auto_cast(level="O1"):
        tout = tl(pt.to_tensor(x))
    assert tseen == jseen
    assert _name(tout.dtype) == _name(jout.dtype)
    assert any(d == "bfloat16" for _, d in tseen)


def test_decorate_o2_casts_the_same_parameters():
    import paddle_tpu.nn as jnn
    from paddle_tpu_torch import nn as pnn

    def build(nn_mod):
        return nn_mod.Sequential(nn_mod.Embedding(10, 8),
                                 nn_mod.LayerNorm(8), nn_mod.Linear(8, 4),
                                 nn_mod.Linear(4, 2))

    jm, tm = build(jnn), build(pnn)
    params = list(tm.parameters())
    jopt = jp.optimizer.SGD(parameters=jm.parameters())
    topt = pt.optimizer.SGD(parameters=tm.parameters())
    jm, _ = jp.amp.decorate(jm, jopt, level="O2")
    tm2, opt2 = pt.amp.decorate(tm, topt, level="O2", excluded_layers=[tm[3]])
    assert tm2 is tm and opt2 is topt
    assert all(a is b for a, b in zip(params, tm.parameters()))
    jd = {k: _name(v.dtype) for k, v in jm.state_dict().items()}
    td = {k: _name(v.dtype) for k, v in tm.state_dict().items()}
    jd["3.weight"] = jd["3.bias"] = "float32"   # excluded in the port's call
    assert td == jd
    assert td["0.weight"] == "bfloat16" and td["1.weight"] == "float32"


def _scaler_run(P, nn_mod, opt_mod, weights):
    lin = nn_mod.Linear(3, 1)
    lin.weight.set_value(weights[0])
    lin.bias.set_value(weights[1])
    opt = opt_mod.SGD(learning_rate=0.1, parameters=lin.parameters())
    scaler = P.amp.GradScaler(init_loss_scaling=2.0 ** 10,
                              incr_every_n_steps=2)
    states = []
    for step in range(6):
        x = np.full((2, 3), 0.5, np.float32) * (step + 1)
        if step == 3:
            x[0, 0] = np.inf
        loss = P.mean(lin(P.to_tensor(x)) ** 2)
        scaler.minimize(opt, scaler.scale(loss))
        opt.clear_grad()
        states.append((scaler.state_dict(), scaler._found_inf))
    return states, [np.asarray(lin.weight.numpy()),
                    np.asarray(lin.bias.numpy())]


def test_grad_scaler_sequence_equals_jax():
    import paddle_tpu.nn as jnn
    from paddle_tpu_torch import nn as pnn

    w = [_x(3, 1) * 0.1, np.zeros(1, np.float32)]
    jguard.consume_health()
    pguard.consume_health()
    js, jw = _scaler_run(jp, jnn, jp.optimizer, w)
    ts, tw = _scaler_run(pt, pnn, pt.optimizer, w)
    assert ts == js
    assert [found for _, found in ts] == [False] * 3 + [True] + [False] * 2
    for a, b in zip(tw, jw):
        assert np.abs(a - b).max() <= 1e-6 * max(1.0, np.abs(b).max())
    assert pguard.consume_health() & pguard.OVERFLOW
    assert jguard.consume_health() & jguard.OVERFLOW
    sd = ts[-1][0]
    s2 = pt.amp.GradScaler()
    s2.load_state_dict(sd)                 # crosses: JAX's state loads
    assert s2.get_init_loss_scaling() == js[-1][0]["scale"]
    s3 = jp.amp.GradScaler()
    s3.load_state_dict(sd)
    assert s3.state_dict() == s2.state_dict()


def test_grad_scaler_disabled_and_unscale_():
    from paddle_tpu_torch import nn as pnn

    lin = pnn.Linear(2, 1)
    opt = pt.optimizer.SGD(learning_rate=0.0, parameters=lin.parameters())
    off = pt.amp.GradScaler(enable=False)
    loss = lin(pt.ones([1, 2])).sum()
    assert off.scale(loss) is loss
    sc = pt.amp.GradScaler(init_loss_scaling=8.0)
    sc.scale(lin(pt.ones([1, 2])).sum()).backward()
    sc.unscale_(opt)
    np.testing.assert_allclose(lin.bias.grad.numpy(), [1.0])
    sc.step(opt)
    assert not sc._already_unscaled


@pytest.mark.parametrize("level", [0, 1])
def test_nan_inf_check_raises_or_warns_as_jax(level):
    for P in (jp, pt):
        guard = jguard if P is jp else pguard
        guard.consume_health()
        P.set_flags({"check_nan_inf": True, "check_nan_inf_level": level})
        try:
            x = P.to_tensor(np.array([-1.0, 1.0, 0.0], np.float32))
            if level == 0:
                with pytest.raises(FloatingPointError, match="Operator log"):
                    P.log(x)
            else:
                with warnings.catch_warnings(record=True) as seen:
                    warnings.simplefilter("always")
                    P.log(x)
                assert any("1 nan / 1 inf" in str(w.message) for w in seen)
            assert guard.consume_health() == (guard.NAN_GRAD
                                              | guard.INF_GRAD)
        finally:
            P.set_flags({"check_nan_inf": False, "check_nan_inf_level": 0})
    assert pguard.describe_health(pguard.NAN_GRAD | pguard.OVERFLOW) == \
        jguard.describe_health(jguard.NAN_GRAD | jguard.OVERFLOW)
    assert pguard.health_codes(24) == jguard.health_codes(24)


def test_low_precision_op_list_counts_white_ops():
    pt.set_flags({"low_precision_op_list": 1})
    try:
        with pt.amp.auto_cast():
            pt.matmul(pt.ones([2, 2]), pt.ones([2, 2]))
            F.linear(pt.ones([2, 2]), pt.ones([2, 2]))
            state = op_registry.amp_state
        assert state.low_precision_ops == {"matmul": 1, "linear": 1}
    finally:
        pt.set_flags({"low_precision_op_list": 0})


def test_debugging_waits_for_a_later_slice():
    """``amp.debugging`` was refused here until its slice; it is ported
    now (tests/test_torch_amp_debugging.py holds it against JAX's): the
    module and the names JAX's has are there."""
    import paddle_tpu.amp.debugging as jdbg

    names = {n for n in dir(jdbg) if not n.startswith("__")
             and callable(getattr(jdbg, n))} - {"Tensor", "jnp"}
    assert names <= set(dir(pt.amp.debugging))
    assert pt.amp.debugging.check_numerics(pt.ones([2]))[0].item() == 0


def test_decorated_bf16_parameters_cross_from_jax():
    import paddle_tpu.nn as jnn
    from paddle_tpu_torch import nn as pnn

    jm = jnn.Sequential(jnn.Linear(4, 3), jnn.LayerNorm(3))
    tm = pnn.Sequential(pnn.Linear(4, 3), pnn.LayerNorm(3))
    jp.amp.decorate(jm, level="O2")
    pt.amp.decorate(tm, level="O2")
    state = state_from_jax_layer(jm)
    assert state["0.weight"].dtype.name == "bfloat16"
    load_jax_state(tm, state)
    for k, v in tm.state_dict().items():
        assert _name(v.dtype) == state[k].dtype.name, k
        np.testing.assert_array_equal(v.detach().float().numpy(),
                                      state[k].astype(np.float32))
