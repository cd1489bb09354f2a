"""The long tail of the eager top level — ``paddle_tpu_torch.tensor.extras``,
``tensor.toplevel_extras`` and the in-place family — against the JAX
package's on the CPU, fp32, numpy inputs from a seed
(tests/torch_nn_parity.py).

Outputs within ``tol`` of max(1, max |jax|) (1e-5) and the gradients of
sum(out * cotangent) within ``gtol`` (1e-5; 1e-4 for ``cdist`` / ``pdist``
at p = 3 and ``multigammaln`` / ``polygamma``, whose float32 reductions
and series round in another order). Integer and bool results are compared
by value (JAX's int32 against the port's int64). The random functions are
checked by their moments, not against JAX's draws; ``top_p_sampling`` by
its nucleus: a one-token nucleus gives JAX's index, and on ties the draws
fall in JAX's keep mask.
"""

import jax  # noqa: F401  (JAX on the CPU, as tests/conftest.py sets it)
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as pt
from paddle_tpu_torch import device as pt_device
from paddle_tpu_torch.tensor import toplevel_extras as ptx
from torch_nn_parity import F, INT, POS, PROB, as_np, check, compare

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def cpu_place():
    prev = pt_device._PLACE
    pt.set_device("cpu")
    yield
    pt_device._PLACE = prev


def WELL(n=4):
    return (F(n, n, scale=0.3) + 2 * np.eye(n)).astype(np.float32)


def WITH_INF(*s):
    a = F(*s)
    a.flat[0], a.flat[1], a.flat[2] = np.inf, -np.inf, -0.0
    return a


def WITH_NAN(*s):
    a = F(*s)
    a.flat[::5] = np.nan
    return a


CASES = []


def case(name, fn, inputs, grad=(0,), tol=1e-5, gtol=1e-5):
    CASES.append(pytest.param(fn, inputs, grad, tol, gtol, id=name))


# ---- predicates and elementwise ----
for _n in ("isreal", "isneginf", "isposinf", "signbit"):
    case(_n, lambda P, a, n=_n: getattr(P, n)(a), [WITH_INF(3, 4)], ())
case("addmm", lambda P, i, a, b: P.addmm(i, a, b, beta=0.5, alpha=2.0),
     [F(3, 4), F(3, 5), F(5, 4)], (0, 1, 2))
for _p in (2.0, 1.0, float("inf"), 3.0):
    case(f"cdist-{_p}", lambda P, a, b, p=_p: P.cdist(a, b, p),
         [F(2, 4, 3), F(2, 5, 3)], (0, 1), gtol=1e-4)
for _p in (2, 0, float("inf"), float("-inf"), 1.5):
    case(f"dist-{_p}", lambda P, a, b, p=_p: P.dist(a, b, p),
         [F(3, 4), F(3, 4)], (0, 1) if _p != 0 else ())
case("diff", lambda P, a: P.diff(a), [F(3, 5)])
case("diff-n2-axis0", lambda P, a: P.diff(a, n=2, axis=0), [F(4, 3)])
case("diff-prepend-append", lambda P, a, b, c: P.diff(
    a, axis=1, prepend=b, append=c), [F(3, 4), F(3, 2), F(3, 1)])
case("frexp", lambda P, a: P.frexp(a), [F(3, 4, scale=50)], ())
case("ldexp", lambda P, a, b: P.ldexp(a, b), [F(3, 4), INT(3, 4, lo=-3,
                                                         hi=4)])
case("gammaln", lambda P, a: P.gammaln(a), [POS(3, 4)])
case("gammainc", lambda P, a, b: P.gammainc(a, b), [POS(3, 4), POS(3, 4)],
     (1,))
case("gammaincc", lambda P, a, b: P.gammaincc(a, b),
     [POS(3, 4), POS(3, 4)], (1,))
case("multigammaln", lambda P, a: P.multigammaln(a, 3),
     [POS(3, 4) + 2.0], gtol=1e-4)
for _n in (0, 1, 2):
    case(f"polygamma-{_n}", lambda P, a, n=_n: P.polygamma(a, n),
         [POS(3, 4)], tol=1e-4, gtol=1e-4)
case("i0e", lambda P, a: P.i0e(a), [F(3, 4)])
case("i1e", lambda P, a: P.i1e(a), [F(3, 4)])
case("logit", lambda P, a: P.logit(a), [PROB(3, 4)])
case("logit-eps", lambda P, a: P.logit(a, 0.1), [PROB(3, 4)])
case("logcumsumexp", lambda P, a: P.logcumsumexp(a), [F(3, 4)])
case("logcumsumexp-axis", lambda P, a: P.logcumsumexp(a, axis=1),
     [F(3, 4)])
case("sgn", lambda P, a: P.sgn(a), [F(3, 4)])
case("sinc", lambda P, a: P.sinc(a), [F(3, 4)])
case("isin", lambda P, a, b: P.isin(a, b), [INT(4, 5, hi=9), INT(6, hi=9)],
     ())
case("isin-invert", lambda P, a, b: P.isin(a, b, invert=True),
     [INT(4, 5, hi=9), INT(6, hi=9)], ())
case("trapezoid-dx", lambda P, a: P.trapezoid(a, dx=0.5), [F(3, 6)])
case("trapezoid-x", lambda P, a, x: P.trapezoid(a, x=x, axis=0),
     [F(5, 3), np.sort(F(5))], (0,))
case("cumulative_trapezoid", lambda P, a: P.cumulative_trapezoid(
    a, dx=0.5), [F(3, 6)])
case("cumulative_trapezoid-x", lambda P, a, x: P.cumulative_trapezoid(
    a, x=x), [F(3, 6), np.sort(F(6))], (0,))
case("nanquantile", lambda P, a: P.nanquantile(a, 0.3, axis=1,
                                                keepdim=True),
     [WITH_NAN(4, 7)], ())
case("nanquantile-q-tensor", lambda P, a: P.nanquantile(a, P.to_tensor(
    np.array([0.25, 0.5, 0.9], np.float32))), [WITH_NAN(4, 7)], ())
for _m in ("lower", "higher", "midpoint", "nearest"):
    case(f"nanquantile-{_m}", lambda P, a, m=_m: P.nanquantile(
        a, 0.4, axis=0, interpolation=m), [WITH_NAN(6, 3)], ())
case("reduce_as", lambda P, a, t: P.reduce_as(a, t), [F(2, 3, 4), F(3, 1)])
case("renorm", lambda P, a: P.renorm(a, 2.0, 1, 1.0), [F(3, 4, 5)])
case("renorm-p1", lambda P, a: P.renorm(a, 1.0, 0, 2.0), [F(3, 4)])
case("vander", lambda P, a: P.vander(a), [F(4)])
case("vander-n-inc", lambda P, a: P.vander(a, 5, True), [F(4)])
# ---- linalg and manipulation ----
case("inverse", lambda P, a: P.inverse(a), [WELL()])
case("block_diag", lambda P, a, b: P.block_diag([a, b]),
     [F(2, 3), F(1, 2)], (0, 1))
for _n, _ax in (("hsplit", 1), ("vsplit", 0), ("dsplit", 2)):
    case(_n, lambda P, a, n=_n: getattr(P, n)(a, 2), [F(4, 6, 4)])
    case(f"{_n}-indices", lambda P, a, n=_n: getattr(P, n)(a, [1, 3]),
         [F(4, 6, 4)])
case("tensor_split", lambda P, a: P.tensor_split(a, 3, axis=1), [F(2, 7)])
case("tensor_split-indices", lambda P, a: P.tensor_split(a, [1, 4]),
     [F(6, 2)])
case("reverse", lambda P, a: P.reverse(a, [0, 2]), [F(2, 3, 4)])
case("unflatten", lambda P, a: P.unflatten(a, 1, [2, 3]), [F(4, 6, 2)])
case("unfold", lambda P, a: P.unfold(a, 1, 3, 2), [F(2, 8, 3)])
case("as_strided", lambda P, a: P.as_strided(a, [3, 3], [2, 1], 1),
     [F(4, 3)])
case("as_strided-view", lambda P, a: P.as_strided(
    P.transpose(a, [1, 0]), [2, 4], [1, 2]), [F(4, 3)])
case("index_fill", lambda P, a, i: P.index_fill(a, i, 1, 2.5),
     [F(4, 5), np.array([0, 3])])
case("masked_scatter", lambda P, a, m, v: P.masked_scatter(a, m, v),
     [F(3, 4), F(3, 4) > 0, F(12)], (0, 2))
for _off in (0, 1, -1):
    case(f"diagonal_scatter-{_off}", lambda P, a, b, o=_off:
         P.diagonal_scatter(a, b, o), [F(4, 4), F(4 - abs(_off))], (0, 1))
case("select_scatter", lambda P, a, b: P.select_scatter(a, b, 1, 2),
     [F(3, 4, 2), F(3, 2)], (0, 1))
case("slice_scatter", lambda P, a, b: P.slice_scatter(
    a, b, [0, 1], [1, 0], [4, 6], [2, 3]), [F(5, 6), F(2, 2)], (0, 1))
case("histogram_bin_edges", lambda P, a: P.histogram_bin_edges(a, 7),
     [F(50)], ())
case("histogram_bin_edges-range", lambda P, a: P.histogram_bin_edges(
    a, 5, -1.0, 2.0), [F(50)], ())


def _hist(out):
    """(hist, each dim's edges): the port returns the edges as a list
    (Paddle's API), the JAX package stacks them into one tensor."""
    hist, edges = out
    return [hist] + [edges[i] for i in range(len(edges))]


case("histogramdd", lambda P, a: _hist(P.histogramdd(a, bins=4)),
     [F(40, 2)], ())
case("histogramdd-ranges-density", lambda P, a: _hist(P.histogramdd(
    a, bins=[4, 4], ranges=[-1.0, 1.0, -2.0, 2.0], density=True)),
     [F(40, 2)], ())
case("histogramdd-weights", lambda P, a, w: _hist(P.histogramdd(
    a, bins=3, weights=w)), [F(30, 3), POS(30)], ())
# the edges exactly: data on JAX's edges of [0, 1] in 10 bins
case("histogramdd-on-edges", lambda P, a: _hist(P.histogramdd(
    a, bins=10, ranges=[0.0, 1.0])),
     [np.linspace(0, 1, 21, dtype=np.float32)[:, None]], ())
# ---- toplevel_extras ----
case("mm", lambda P, a, b: P.mm(a, b), [F(3, 4), F(4, 2)], (0, 1))
for _p in (2.0, 1.0, float("inf"), 3.0):
    case(f"pdist-{_p}", lambda P, a, p=_p: P.pdist(a, p), [F(5, 3)], ())
for _n in ("hstack", "vstack", "dstack", "column_stack", "row_stack"):
    case(_n, lambda P, a, b, n=_n: getattr(P, n)([a, b]),
         [F(3, 2), F(3, 2)], (0, 1))
case("cartesian_prod", lambda P, a, b: P.cartesian_prod([a, b]),
     [F(3), F(2)], (0, 1))
case("cartesian_prod-one", lambda P, a: P.cartesian_prod([a]), [F(3)])
case("combinations", lambda P, a: P.combinations(a), [F(5)])
case("combinations-3-repl", lambda P, a: P.combinations(
    a, 3, with_replacement=True), [F(4)])
case("shape", lambda P, a: P.shape(a), [F(2, 3, 4)], ())
case("rank", lambda P, a: P.rank(a), [F(2, 3, 4)], ())


@pytest.mark.parametrize("fn,inputs,grad,tol,gtol", CASES)
def test_against_jax(fn, inputs, grad, tol, gtol):
    check(fn, inputs, grad, tol, gtol)


@pytest.mark.parametrize("p", [2.0, 1.0, float("inf"), 3.0])
def test_pdist_gradient_against_torch(p):
    """At p = 2 and 3 the JAX function's pdist gradients are all nan (the
    norms of the full matrix, zero diagonal included): the port's are held
    against torch.nn.functional.pdist's, and against JAX's where those are
    finite."""
    x = F(5, 3)
    a = pt.to_tensor(x, stop_gradient=False)
    b = torch.tensor(x, requires_grad=True)
    pt.pdist(a, p).sum().backward()
    torch.nn.functional.pdist(b, p).sum().backward()
    compare(a.grad, b.grad.numpy(), 1e-5)
    jgrad = as_np(_jax_pdist_grad(x, p))
    if p in (2.0, 3.0):
        assert np.isnan(jgrad).all()
    else:
        compare(a.grad, jgrad, 1e-5)


def _jax_pdist_grad(x, p):
    t = jp.to_tensor(x, stop_gradient=False)
    jp.pdist(t, p).sum().backward()
    return t.grad


def test_predicates_and_host_helpers():
    x = F(2, 3)
    for P in (jp, pt):
        t = P.to_tensor(x)
        i = P.to_tensor(INT(3))
        assert P.is_tensor(t) and not P.is_tensor(x)
        assert P.is_floating_point(t) and not P.is_floating_point(i)
        assert P.is_integer(i) and not P.is_integer(t)
        assert not P.is_complex(t) and P.is_complex(P.to_tensor(
            x.astype(np.complex64)))
        assert P.is_empty(P.zeros([0, 3])) and not P.is_empty(t)
        assert P.tolist(t) == x.tolist()
        assert P.check_shape(t, [2, -1]) and P.check_shape(t, [None, 3])
        with pytest.raises(ValueError):
            P.check_shape(t, [3, 3])
        with P.LazyGuard():
            pass
        assert list(P.batch(lambda: iter(range(5)), 2)()) == \
            [[0, 1], [2, 3], [4]]
        assert list(P.batch(lambda: iter(range(5)), 2, True)()) == \
            [[0, 1], [2, 3]]
        assert P.is_grad_enabled()
        P.disable_signal_handler()
    for dt in ("int8", "int32", "int64", "uint8"):
        a, b = jp.iinfo(dt), pt.iinfo(dt)
        assert (a.bits, int(a.min), int(a.max)) == (b.bits, b.min, b.max)
    for dt in ("float16", "bfloat16", "float32"):
        a, b = jp.finfo(dt), pt.finfo(dt)
        assert a.bits == b.bits
        for f in ("eps", "max", "min", "tiny"):
            assert float(getattr(a, f)) == float(getattr(b, f)), (dt, f)
        # numpy rounds resolution (10 ** -precision) to the dtype
        assert abs(float(a.resolution) - b.resolution) <= 1e-3 * \
            b.resolution
    assert pt.float8_e4m3fn is torch.float8_e4m3fn
    assert pt.float8_e5m2 is torch.float8_e5m2
    assert pt.dtype is torch.dtype and isinstance(pt.float32, pt.dtype)
    assert pt.get_cuda_rng_state() == [] or torch.cuda.is_available()
    pinned = pt.to_tensor(x, place=pt.CUDAPinnedPlace())
    assert pinned.device.type == "cpu"
    assert pt.to_tensor(x, place=pt.CPUPlace()).device.type == "cpu"


def test_methods_installed_or_torch_kept():
    """Every extras function torch's Tensor lacks is a Paddle method; a
    name torch has stays torch's (the top-level function is Paddle's)."""
    from paddle_tpu_torch.tensor import extras

    t = pt.to_tensor(POS(3, 3))
    for name in extras.__all__:
        if name in ("is_tensor", "block_diag"):
            continue
        if hasattr(torch.Tensor, name):
            assert getattr(pt.Tensor, name) is getattr(torch.Tensor, name)
        else:
            assert getattr(pt.Tensor, name) is getattr(extras, name), name
    compare(t.gammaln(), jp.to_tensor(t.numpy()).gammaln(), 1e-5)
    assert pt.Tensor.stft is torch.Tensor.stft
    # torch's diff keeps dim=; paddle.diff takes axis=
    compare(t.diff(dim=0), pt.diff(t, axis=0), 0)


# ---- the in-place family ----

def _bases():
    """(base, inputs, extra args) for every INPLACE_BASES entry."""
    b = {}
    for n in ("cos", "tan", "sin", "abs", "acos", "expm1", "sinh", "sinc",
              "neg", "lgamma", "square", "gammaln", "atan", "erf", "tanh",
              "trunc", "frac", "digamma", "i0", "log", "log2", "log10",
              "logit"):
        x = PROB(3, 4) if n in ("acos", "logit") else POS(3, 4)
        b[n] = ([x], ())
    for n in ("floor_divide", "remainder", "mod", "floor_mod", "pow",
              "divide", "multiply", "copysign", "hypot", "equal",
              "less_than", "less_equal", "greater_equal", "greater_than"):
        b[n] = ([POS(3, 4), POS(3, 4)], ())
    for n in ("gammainc", "gammaincc"):
        b[n] = ([POS(3, 4), POS(3, 4)], ())
    for n in ("logical_and", "logical_or"):
        b[n] = ([F(3, 4) > 0, F(3, 4) > 0], ())
    b["logical_not"] = ([F(3, 4) > 0], ())
    for n in ("bitwise_and", "bitwise_or", "bitwise_xor", "gcd", "lcm",
              "bitwise_left_shift", "bitwise_right_shift"):
        b[n] = ([INT(3, 4, lo=1, hi=9), INT(3, 4, lo=1, hi=4)], ())
    b["bitwise_not"] = ([INT(3, 4, hi=9)], ())
    b["addmm"] = ([F(3, 3), F(3, 4), F(4, 3)], ())
    b["t"] = ([F(3, 4)], ())
    b["cumsum"] = ([F(3, 4)], (1,))
    b["cumprod"] = ([F(3, 4)], (1,))
    b["unsqueeze"] = ([F(3, 4)], (0,))
    b["squeeze"] = ([F(3, 1, 4)], (1,))
    b["triu"] = ([F(4, 4)], (1,))
    b["tril"] = ([F(4, 4)], (-1,))
    b["cast"] = ([F(3, 4)], ("float64",))
    b["transpose"] = ([F(2, 3, 4)], ([2, 0, 1],))
    b["flatten"] = ([F(2, 3, 4)], ())
    b["renorm"] = ([F(3, 4)], (2.0, 0, 1.0))
    b["multigammaln"] = ([POS(3, 4) + 2], (2,))
    b["nan_to_num"] = ([WITH_INF(3, 4)], ())
    b["ldexp"] = ([F(3, 4), INT(3, 4, lo=-2, hi=3)], ())
    b["polygamma"] = ([POS(3, 4)], (1,))
    b["masked_fill"] = ([F(3, 4), F(3, 4) > 0], (0.5,))
    b["masked_scatter"] = ([F(3, 4), F(3, 4) > 0, F(12)], ())
    return b


_BASES = _bases()


def test_inplace_table_is_jax():
    from paddle_tpu.tensor import toplevel_extras as jtx

    assert ptx.INPLACE_BASES == jtx.INPLACE_BASES
    assert sorted(_BASES) == sorted(jtx.INPLACE_BASES)


@pytest.mark.parametrize("base", sorted(_BASES))
def test_inplace_variant_writes_x(base):
    """``paddle.<base>_(x, ...)`` and ``x.<base>_(...)`` give x the
    functional result (JAX's ``<base>_``), and return x."""
    inputs, extra = _BASES[base]
    outs = []
    for P in (jp, pt):
        ts = [P.to_tensor(a) for a in inputs]
        ret = getattr(P, base + "_")(*ts, *extra)
        assert ret is ts[0]
        outs.append(ts[0])
    compare(outs[1], outs[0], 1e-4 if base in ("polygamma", "multigammaln")
            else 1e-5)
    t = pt.to_tensor(inputs[0])
    method = getattr(t, base + "_")(*[pt.to_tensor(a) for a in inputs[1:]],
                                    *extra)
    assert method is t
    compare(t, outs[0], 1e-4)


def test_inplace_keeps_autograd():
    x = pt.to_tensor(F(3, 4), stop_gradient=False)
    y = x * 1.0
    pt.sin_(y)
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.cos(x.detach().numpy()),
                               rtol=1e-6)


def test_where_writes_x_not_the_condition():
    c, x, y = F(3, 4) > 0, F(3, 4), F(3, 4)
    outs = []
    for P in (jp, pt):
        tc, tx, ty = P.to_tensor(c), P.to_tensor(x), P.to_tensor(y)
        ret = P.where_(tc, tx, ty)
        assert ret is tx
        compare(tc, c, 0)
        outs.append(tx)
    compare(outs[1], outs[0], 0)
    assert not hasattr(pt.Tensor, "where_")


def test_random_fills_and_samplers_by_moments():
    pt.seed(3)
    n = 200_000
    x = pt.zeros([n])
    assert x.log_normal_(0.5, 0.25) is x
    logs = np.log(x.numpy())
    assert abs(logs.mean() - 0.5) < 0.01 and abs(logs.std() - 0.25) < 0.01
    pt.log_normal_(x, 0.0, 1.0)
    assert abs(np.log(x.numpy()).std() - 1.0) < 0.01
    pt.cauchy_(x, 1.0, 2.0)
    q = np.quantile(x.numpy(), [0.25, 0.5, 0.75])
    assert abs(q[1] - 1.0) < 0.05 and abs((q[2] - q[0]) / 2 - 2.0) < 0.05
    pt.geometric_(x, 0.3)
    g = x.numpy()
    assert abs(g.mean() - 1 / -np.log1p(-0.3)) < 0.02   # continuous
    assert (g != np.floor(g)).mean() > 0.99 and g.min() >= 0
    w = pt.log_normal(1.0, 0.5, [n])
    assert abs(np.log(w.numpy()).mean() - 1.0) < 0.01
    assert w.dtype == torch.float32
    s = pt.standard_gamma(pt.full([n], 3.0))
    assert abs(s.numpy().mean() - 3.0) < 0.03
    assert abs(s.numpy().var() - 3.0) < 0.1
    # the same seed, the same draws
    pt.seed(5)
    a = pt.standard_gamma(pt.full([8], 2.0)).numpy()
    pt.seed(5)
    assert np.array_equal(a, pt.standard_gamma(pt.full([8], 2.0)).numpy())
    # the fills drop the history
    v = pt.to_tensor(F(4), stop_gradient=False) * 2
    pt.cauchy_(v)
    assert not v.requires_grad or v.grad_fn is not None


def test_top_p_sampling_nucleus():
    logits = F(4, 30)
    logits[:, 7] = 40.0                 # a one-token nucleus
    jv, ji = jp.top_p_sampling(jp.to_tensor(logits), 0.5, seed=1)
    pv, pi = pt.top_p_sampling(pt.to_tensor(logits), 0.5, seed=1)
    compare(pi, ji, 0)
    compare(pv, jv, 1e-6)
    assert list(pi.shape) == [4, 1]
    # ties: three equal tokens lead; JAX keeps the first two by index
    tied = np.array([[0.0, 3.0, 3.0, 3.0, 1.0, -2.0]], np.float32)
    seen = {"jax": set(), "port": set()}
    for s in range(40):
        seen["jax"].add(int(np.asarray(jp.top_p_sampling(
            jp.to_tensor(tied), 0.4, seed=s)[1]._data)[0, 0]))
        seen["port"].add(int(pt.top_p_sampling(
            pt.to_tensor(tied), 0.4, seed=s)[1][0, 0]))
    assert seen["jax"] == seen["port"] == {1, 2}
    # per-row ps, and the same seed the same draw
    big = pt.to_tensor(F(3, 50))
    ps = pt.to_tensor(np.array([0.1, 0.5, 0.9], np.float32))
    a = pt.top_p_sampling(big, ps, seed=7)[1]
    assert torch.equal(a, pt.top_p_sampling(big, ps, seed=7)[1])
    probs = torch.softmax(big, -1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    for row in range(3):
        rank = int((order.indices[row] == a[row, 0]).nonzero())
        assert float(order.values[row, :rank].sum()) <= float(ps[row])


def test_nanquantile_matches_numpy_on_a_row_of_nans():
    a = WITH_NAN(3, 5)
    a[1] = np.nan
    out = pt.nanquantile(pt.to_tensor(a), 0.5, axis=1).numpy()
    ref = np.asarray(jp.nanquantile(jp.to_tensor(a), 0.5, axis=1)._data)
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    np.testing.assert_allclose(out[~np.isnan(ref)], ref[~np.isnan(ref)],
                               rtol=1e-6)


def test_dispatched_under_the_jax_op_names():
    from paddle_tpu_torch.core import op_registry

    seen = []

    class Rec:
        def record(self, name, outs):
            seen.append(name)

    prev, op_registry.stats_recorder = op_registry.stats_recorder, Rec()
    try:
        x = pt.to_tensor(POS(3, 4))
        pt.gammaln(x)
        pt.tensor_split(x, 2)
        pt.hstack([x, x])
        pt.top_p_sampling(x, 0.5, seed=0)
    finally:
        op_registry.stats_recorder = prev
    assert seen == ["gammaln", "tensor_split", "hstack", "top_p_sampling"]
    assert as_np(x).shape == (3, 4)
