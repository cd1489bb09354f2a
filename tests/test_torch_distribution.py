"""The port's ``distribution`` against the JAX package's, on the CPU:
``log_prob``, ``prob``, ``entropy``, ``mean``, ``variance``, ``cdf`` /
``icdf`` and ``kl_divergence`` (built-in and ``register_kl`` rules) of
every class, on the same seeded parameters and values; ``sample`` held to
its distribution's moments.

Tolerance: the formulas are JAX's in fp32: within rtol 1e-5 + atol 1e-5
(lgamma and the transcendental functions round differently by a few
ulps). Samples: the port's bits differ from ``jax.random``'s, so each
sample mean (and variance where it is finite) of n = 20000 draws must lie
within 6 standard errors of the true one (se = sd / sqrt(n); the
variance's se is var x sqrt((kurtosis - 1) / n), bounded by
3 x var x sqrt(2 / n) for every case here, whose kurtosis is at most
9.3) — a false failure has probability < 1e-8.
"""

import math

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.distribution as JD
import paddle_tpu_torch as pt
import paddle_tpu_torch.distribution as TD
from paddle_tpu_torch import device as pt_device

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu():
    prev = pt_device._PLACE
    pt.set_device("cpu")
    pt.seed(0)
    yield
    pt_device._PLACE = prev


def N(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x._data if hasattr(x, "_data") else x)


R = np.random.default_rng(0)
POS = (R.uniform(0.5, 2.5, 5)).astype(np.float32)
POS2 = (R.uniform(0.5, 2.5, 5)).astype(np.float32)
LOC = R.standard_normal(5).astype(np.float32)
PROB = R.uniform(0.1, 0.9, 5).astype(np.float32)
UNIT = R.uniform(0.05, 0.95, 5).astype(np.float32)
REAL = R.standard_normal(5).astype(np.float32)
COUNTS = np.array([0, 1, 3, 2, 5], np.float32)
L3 = np.array([[1.0, 0, 0], [0.5, 1.2, 0], [-0.3, 0.4, 0.8]], np.float32)

# name -> (constructor args, a value for log_prob, methods to compare)
CASES = {
    "Normal": ((LOC, POS), REAL, ("mean", "variance", "stddev", "entropy",
                                  "cdf")),
    "Uniform": ((LOC, LOC + POS), LOC + 0.3, ("mean", "variance",
                                             "entropy")),
    "Bernoulli": ((PROB,), np.array([0, 1, 1, 0, 1], np.float32),
                  ("mean", "variance", "entropy")),
    "Exponential": ((POS,), POS2, ("mean", "variance", "entropy")),
    "Beta": ((POS, POS2), UNIT, ("mean",)),
    "Gamma": ((POS, POS2), POS2, ("mean",)),
    "Cauchy": ((LOC, POS), REAL, ("entropy", "cdf")),
    "Laplace": ((LOC, POS), REAL, ("mean", "variance", "entropy", "cdf")),
    "LogNormal": ((LOC, POS * 0.3), POS2, ("mean", "variance", "entropy")),
    "Gumbel": ((LOC, POS), REAL, ("mean", "variance", "entropy")),
    "Geometric": ((PROB,), COUNTS, ("mean", "variance", "entropy")),
    "Poisson": ((POS * 3,), COUNTS, ("mean", "variance")),
    "Binomial": ((np.full(5, 6, np.float32), PROB), COUNTS,
                 ("mean", "variance")),
    "Chi2": ((POS * 3,), POS2, ("mean", "variance")),
    "StudentT": ((POS * 3, LOC, POS), REAL, ("mean", "variance")),
    "ContinuousBernoulli": ((np.array([0.2, 0.4999, 0.5, 0.7, 0.95],
                                      np.float32),), UNIT, ()),
}


def _make(mod, name, args):
    wrap = jp.to_tensor if mod is JD else torch.from_numpy
    return getattr(mod, name)(*[wrap(a) for a in args])


@pytest.mark.parametrize("name", sorted(CASES))
def test_formulas_match_jax(name):
    args, value, methods = CASES[name]
    jd, td = _make(JD, name, args), _make(TD, name, args)
    assert td.batch_shape == jd.batch_shape
    np.testing.assert_allclose(N(td.log_prob(torch.from_numpy(value))),
                               N(jd.log_prob(jp.to_tensor(value))), **TOL)
    np.testing.assert_allclose(N(td.prob(torch.from_numpy(value))),
                               N(jd.prob(jp.to_tensor(value))), **TOL)
    for m in methods:
        if m == "cdf":
            got, ref = td.cdf(torch.from_numpy(value)), jd.cdf(
                jp.to_tensor(value))
        elif m == "entropy":
            got, ref = td.entropy(), jd.entropy()
        else:
            got, ref = getattr(td, m), getattr(jd, m)
        np.testing.assert_allclose(N(got), N(ref), **TOL, err_msg=m)


def test_laplace_icdf_categorical_dirichlet_mvn_lkj_independent():
    q = jp.to_tensor(UNIT), torch.from_numpy(UNIT)
    np.testing.assert_allclose(
        N(TD.Laplace(torch.from_numpy(LOC), torch.from_numpy(POS)).icdf(
            q[1])),
        N(JD.Laplace(jp.to_tensor(LOC), jp.to_tensor(POS)).icdf(q[0])),
        **TOL)
    logits = R.standard_normal((3, 4)).astype(np.float32)
    jc, tc = JD.Categorical(jp.to_tensor(logits)), TD.Categorical(
        torch.from_numpy(logits))
    v = np.array([0, 3, 2])
    np.testing.assert_allclose(N(tc.log_prob(torch.from_numpy(v))),
                               N(jc.log_prob(jp.to_tensor(v))), **TOL)
    np.testing.assert_allclose(N(tc.entropy()), N(jc.entropy()), **TOL)
    np.testing.assert_allclose(N(tc.probs), N(jc.probs), **TOL)
    conc = POS[:4]
    x = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    np.testing.assert_allclose(
        N(TD.Dirichlet(torch.from_numpy(conc)).log_prob(
            torch.from_numpy(x))),
        N(JD.Dirichlet(jp.to_tensor(conc)).log_prob(jp.to_tensor(x))),
        **TOL)
    cov = L3 @ L3.T
    for kw in ({"covariance_matrix": cov}, {"scale_tril": L3}):
        jm = JD.MultivariateNormal(jp.to_tensor(LOC[:3]),
                                   **{k: jp.to_tensor(v)
                                      for k, v in kw.items()})
        tm = TD.MultivariateNormal(torch.from_numpy(LOC[:3]),
                                   **{k: torch.from_numpy(v)
                                      for k, v in kw.items()})
        val = REAL[:3]
        np.testing.assert_allclose(N(tm.log_prob(torch.from_numpy(val))),
                                   N(jm.log_prob(jp.to_tensor(val))),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(N(tm.entropy()), N(jm.entropy()),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(N(tm.variance), N(jm.variance),
                                   rtol=1e-4, atol=1e-5)
    lkj_val = np.linalg.cholesky(np.array(
        [[1, 0.3, 0.1], [0.3, 1, -0.2], [0.1, -0.2, 1]], np.float32))
    np.testing.assert_allclose(
        N(TD.LKJCholesky(3, 2.0).log_prob(torch.from_numpy(lkj_val))),
        N(JD.LKJCholesky(3, 2.0).log_prob(jp.to_tensor(lkj_val))), **TOL)
    base = (JD.Normal(jp.to_tensor(np.zeros((2, 3), np.float32)), 1.0),
            TD.Normal(torch.zeros(2, 3), 1.0))
    ji, ti = JD.Independent(base[0], 1), TD.Independent(base[1], 1)
    assert ti.event_shape == ji.event_shape == [3]
    val = R.standard_normal((2, 3)).astype(np.float32)
    np.testing.assert_allclose(N(ti.log_prob(torch.from_numpy(val))),
                               N(ji.log_prob(jp.to_tensor(val))), **TOL)
    np.testing.assert_allclose(N(ti.entropy()), N(ji.entropy()), **TOL)


KL = [("Normal", (LOC, POS), (REAL, POS2)),
      ("Uniform", (LOC, LOC + 3 * POS), (LOC - 1, LOC + 4 * POS)),
      ("Laplace", (LOC, POS), (REAL, POS2)),
      ("Poisson", (POS,), (POS2,)),
      ("Geometric", (PROB,), (UNIT,))]


@pytest.mark.parametrize("name,p,q", KL)
def test_kl_divergence_matches_jax(name, p, q):
    got = TD.kl_divergence(_make(TD, name, p), _make(TD, name, q))
    ref = JD.kl_divergence(_make(JD, name, p), _make(JD, name, q))
    np.testing.assert_allclose(N(got), N(ref), **TOL)
    logits = R.standard_normal((2, 4)).astype(np.float32)
    a, b = TD.Categorical(torch.from_numpy(logits)), TD.Categorical(
        torch.from_numpy(logits[::-1].copy()))
    ja, jb = JD.Categorical(jp.to_tensor(logits)), JD.Categorical(
        jp.to_tensor(logits[::-1].copy()))
    np.testing.assert_allclose(N(a.kl_divergence(b)),
                               N(ja.kl_divergence(jb)), **TOL)


def test_register_kl_most_derived_wins():
    class MyNormal(TD.Normal):
        pass

    @TD.register_kl(MyNormal, TD.Normal)
    def _kl(p, q):
        return torch.tensor(-1.0)

    try:
        assert float(TD.kl_divergence(MyNormal(0.0, 1.0),
                                      TD.Normal(0.0, 1.0))) == -1.0
        assert float(TD.kl_divergence(TD.Normal(0.0, 1.0),
                                      TD.Normal(0.0, 1.0))) == 0.0
    finally:
        from paddle_tpu_torch.distribution import extras

        extras._KL_REGISTRY.pop((MyNormal, TD.Normal))


n = 20000
# name -> (args, true mean, true variance or None)
MOMENTS = {
    "Normal": ((1.5, 2.0), 1.5, 4.0),
    "Uniform": ((-1.0, 3.0), 1.0, 16 / 12),
    "Bernoulli": ((0.3,), 0.3, 0.21),
    "Exponential": ((2.0,), 0.5, 0.25),
    "Beta": ((2.0, 3.0), 0.4, 6 / (25 * 6)),
    "Gamma": ((3.0, 2.0), 1.5, 0.75),
    "Laplace": ((0.5, 1.5), 0.5, 4.5),
    "LogNormal": ((0.0, 0.25), math.exp(0.03125),
                  math.expm1(0.0625) * math.exp(0.0625)),
    "Gumbel": ((1.0, 2.0), 1.0 + 2.0 * 0.5772156649015329,
               math.pi ** 2 / 6 * 4),
    "Geometric": ((0.4,), 1.5, 0.6 / 0.16),
    "Poisson": ((3.5,), 3.5, 3.5),
    "Binomial": ((10.0, 0.3), 3.0, 2.1),
    "Chi2": ((4.0,), 4.0, 8.0),
    "StudentT": ((8.0, 1.0, 2.0), 1.0, 4 * 8 / 6),
    "ContinuousBernoulli": ((0.5,), 0.5, 1 / 12),
}


@pytest.mark.parametrize("name", sorted(MOMENTS))
def test_sample_moments(name):
    args, mean, var = MOMENTS[name]
    d = getattr(TD, name)(*args)
    s = N(d.sample([n])).astype(np.float64)
    assert s.shape == (n,)
    se = math.sqrt(var / n)
    assert abs(s.mean() - mean) <= 6 * se, (s.mean(), mean)
    if name not in ("StudentT",):   # heavy tails: the mean check only
        assert abs(s.var() - var) <= 6 * 3 * var * math.sqrt(2 / n), \
            (s.var(), var)


def test_multivariate_categorical_dirichlet_multinomial_lkj_samples():
    cov = L3 @ L3.T
    s = N(TD.MultivariateNormal(torch.zeros(3),
                                torch.from_numpy(cov)).sample([n]))
    assert np.abs(np.cov(s.T) - cov).max() < 0.1
    c = N(TD.Categorical(torch.log(torch.tensor([0.2, 0.5, 0.3]))).sample(
        [n]))
    assert np.abs(np.bincount(c, minlength=3) / n - [0.2, 0.5, 0.3]).max() \
        < 6 * math.sqrt(0.25 / n)
    dsum = N(TD.Dirichlet(torch.tensor([1.0, 2.0, 3.0])).sample([10]))
    np.testing.assert_allclose(dsum.sum(-1), 1.0, rtol=1e-5)
    m = N(TD.Multinomial(7, torch.tensor([0.2, 0.8])).sample([50]))
    assert (m.sum(-1) == 7).all() and m.shape == (50, 2)
    L = N(TD.LKJCholesky(4, 1.5).sample([20]))
    np.testing.assert_allclose((L ** 2).sum(-1), 1.0, rtol=1e-5)
    assert np.allclose(np.triu(L, 1), 0)


def test_sampling_is_reproducible_under_seed():
    pt.seed(11)
    a = N(TD.Normal(0.0, 1.0).sample([5]))
    pt.seed(11)
    b = N(TD.Normal(0.0, 1.0).sample([5]))
    np.testing.assert_array_equal(a, b)
