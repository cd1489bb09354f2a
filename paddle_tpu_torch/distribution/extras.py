"""The remaining distributions and ``register_kl`` — port of
``paddle_tpu/distribution/extras.py`` (see the package for devices and
sampling)."""

from __future__ import annotations

import math

import torch

from ..core.tensor import unwrap
from ..framework.random import generator
from . import (Distribution, Normal, _arr, _device, _gamma, _normal, _shape,
               _t, _uniform)

__all__ = [
    "Cauchy", "Chi2", "ContinuousBernoulli", "ExponentialFamily",
    "MultivariateNormal", "Independent", "Laplace", "LogNormal",
    "LKJCholesky", "Gumbel", "Geometric", "Binomial", "Poisson", "StudentT",
    "register_kl",
]

np_euler = 0.5772156649015329


def _pair(a, b):
    dev = _device(a, b)
    return _arr(a, dev), _arr(b, dev)


class ExponentialFamily(Distribution):
    """Marks the exponential-family members."""

    @property
    def _natural_parameters(self):
        raise NotImplementedError

    def _log_normalizer(self, *natural):
        raise NotImplementedError


class Cauchy(Distribution):
    def __init__(self, loc, scale, name=None):
        self.loc, self.scale = _pair(loc, scale)
        super().__init__(torch.broadcast_shapes(self.loc.shape,
                                                self.scale.shape))

    def sample(self, shape=()):
        shp = _shape(shape, self._batch_shape)
        c = torch.empty(shp, dtype=torch.float32,
                        device=self.loc.device).cauchy_(
            generator=generator(self.loc.device))
        return _t(self.loc + self.scale * c)

    def log_prob(self, value):
        z = (_arr(value, self.loc.device) - self.loc) / self.scale
        return _t(-torch.log(math.pi * self.scale * (1 + z * z)))

    def entropy(self):
        return _t(torch.broadcast_to(torch.log(4 * math.pi * self.scale),
                                     self._batch_shape))

    def cdf(self, value):
        z = (_arr(value, self.loc.device) - self.loc) / self.scale
        return _t(torch.atan(z) / math.pi + 0.5)


class Laplace(Distribution):
    def __init__(self, loc, scale, name=None):
        self.loc, self.scale = _pair(loc, scale)
        super().__init__(torch.broadcast_shapes(self.loc.shape,
                                                self.scale.shape))

    @property
    def mean(self):
        return _t(torch.broadcast_to(self.loc, self._batch_shape))

    @property
    def variance(self):
        return _t(torch.broadcast_to(2 * self.scale ** 2,
                                     self._batch_shape))

    def sample(self, shape=()):
        shp = _shape(shape, self._batch_shape)
        u = _uniform(shp, self.loc.device, -1.0, 1.0)
        lap = -torch.sign(u) * torch.log1p(-u.abs())
        return _t(self.loc + self.scale * lap)

    rsample = sample

    def log_prob(self, value):
        v = _arr(value, self.loc.device)
        return _t(-(v - self.loc).abs() / self.scale
                  - torch.log(2 * self.scale))

    def entropy(self):
        return _t(torch.broadcast_to(1 + torch.log(2 * self.scale),
                                     self._batch_shape))

    def cdf(self, value):
        z = (_arr(value, self.loc.device) - self.loc) / self.scale
        return _t(0.5 - 0.5 * torch.sign(z) * torch.expm1(-z.abs()))

    def icdf(self, q):
        qv = _arr(q, self.loc.device)
        return _t(self.loc - self.scale * torch.sign(qv - 0.5)
                  * torch.log1p(-2 * (qv - 0.5).abs()))


class LogNormal(Distribution):
    def __init__(self, loc, scale, name=None):
        self.loc, self.scale = _pair(loc, scale)
        self._normal = Normal(self.loc, self.scale)
        super().__init__(torch.broadcast_shapes(self.loc.shape,
                                                self.scale.shape))

    @property
    def mean(self):
        return _t(torch.exp(self.loc + self.scale ** 2 / 2))

    @property
    def variance(self):
        s2 = self.scale ** 2
        return _t(torch.expm1(s2) * torch.exp(2 * self.loc + s2))

    def sample(self, shape=()):
        return _t(torch.exp(unwrap(self._normal.sample(shape))))

    rsample = sample

    def log_prob(self, value):
        lv = torch.log(_arr(value, self.loc.device))
        return _t(unwrap(self._normal.log_prob(lv)) - lv)

    def entropy(self):
        return _t(unwrap(self._normal.entropy()) + self.loc)


class Gumbel(Distribution):
    def __init__(self, loc, scale, name=None):
        self.loc, self.scale = _pair(loc, scale)
        super().__init__(torch.broadcast_shapes(self.loc.shape,
                                                self.scale.shape))

    @property
    def mean(self):
        return _t(self.loc + self.scale * np_euler)

    @property
    def variance(self):
        return _t((math.pi ** 2 / 6) * self.scale ** 2)

    def sample(self, shape=()):
        shp = _shape(shape, self._batch_shape)
        u = _uniform(shp, self.loc.device, torch.finfo(torch.float32).tiny,
                     1.0)
        return _t(self.loc - self.scale * torch.log(-torch.log(u)))

    rsample = sample

    def log_prob(self, value):
        z = (_arr(value, self.loc.device) - self.loc) / self.scale
        return _t(-(z + torch.exp(-z)) - torch.log(self.scale))

    def entropy(self):
        return _t(torch.broadcast_to(torch.log(self.scale) + 1 + np_euler,
                                     self._batch_shape))


class Geometric(Distribution):
    """P(X = k) = (1 - p)^k p, k = 0, 1, ... (failures before the first
    success)."""

    def __init__(self, probs=None, logits=None, name=None):
        if probs is None:
            probs = torch.sigmoid(_arr(logits))
        self.probs_arr = _arr(probs)
        super().__init__(self.probs_arr.shape)

    @property
    def mean(self):
        return _t((1 - self.probs_arr) / self.probs_arr)

    @property
    def variance(self):
        return _t((1 - self.probs_arr) / self.probs_arr ** 2)

    def sample(self, shape=()):
        shp = _shape(shape, self._batch_shape)
        u = _uniform(shp, self.probs_arr.device, 1e-7, 1.0)
        return _t(torch.floor(torch.log(u) / torch.log1p(-self.probs_arr)))

    def log_prob(self, value):
        k = _arr(value, self.probs_arr.device)
        return _t(k * torch.log1p(-self.probs_arr)
                  + torch.log(self.probs_arr))

    def entropy(self):
        p = self.probs_arr
        return _t(-((1 - p) * torch.log1p(-p) + p * torch.log(p)) / p)


class Poisson(Distribution):
    def __init__(self, rate, name=None):
        self.rate = _arr(rate)
        super().__init__(self.rate.shape)

    @property
    def mean(self):
        return _t(self.rate)

    @property
    def variance(self):
        return _t(self.rate)

    def sample(self, shape=()):
        shp = _shape(shape, self._batch_shape)
        rates = torch.broadcast_to(self.rate, shp).contiguous()
        return _t(torch.poisson(rates, generator=generator(self.rate.device)))

    def log_prob(self, value):
        k = _arr(value, self.rate.device)
        return _t(k * torch.log(self.rate) - self.rate - torch.lgamma(k + 1))


class Binomial(Distribution):
    def __init__(self, total_count, probs, name=None):
        self.total_count, self.probs_arr = _pair(total_count, probs)
        super().__init__(torch.broadcast_shapes(self.total_count.shape,
                                                self.probs_arr.shape))

    @property
    def mean(self):
        return _t(self.total_count * self.probs_arr)

    @property
    def variance(self):
        return _t(self.total_count * self.probs_arr * (1 - self.probs_arr))

    def sample(self, shape=()):
        shp = _shape(shape, self._batch_shape)
        n = int(self.total_count.max())
        dev = self.probs_arr.device
        u = _uniform(shp + (n,), dev)
        counts = ((u < self.probs_arr[..., None])
                  & (torch.arange(n, device=dev)
                     < self.total_count[..., None])).sum(-1)
        return _t(counts.float())

    def log_prob(self, value):
        k, n, p = (_arr(value, self.probs_arr.device), self.total_count,
                   self.probs_arr)
        logc = (torch.lgamma(n + 1) - torch.lgamma(k + 1)
                - torch.lgamma(n - k + 1))
        return _t(logc + k * torch.log(p) + (n - k) * torch.log1p(-p))


class Chi2(Distribution):
    def __init__(self, df, name=None):
        self.df = _arr(df)
        super().__init__(self.df.shape)

    @property
    def mean(self):
        return _t(self.df)

    @property
    def variance(self):
        return _t(2 * self.df)

    def sample(self, shape=()):
        shp = _shape(shape, self._batch_shape)
        return _t(2 * _gamma(self.df / 2, shp, self.df.device))

    def log_prob(self, value):
        v, k = _arr(value, self.df.device), self.df
        return _t((k / 2 - 1) * torch.log(v) - v / 2
                  - (k / 2) * math.log(2.0) - torch.lgamma(k / 2))


class StudentT(Distribution):
    def __init__(self, df, loc=0.0, scale=1.0, name=None):
        dev = _device(df, loc, scale)
        self.df, self.loc, self.scale = (_arr(df, dev), _arr(loc, dev),
                                         _arr(scale, dev))
        super().__init__(torch.broadcast_shapes(
            self.df.shape, self.loc.shape, self.scale.shape))

    @property
    def mean(self):
        return _t(torch.where(self.df > 1, self.loc, float("nan")))

    @property
    def variance(self):
        v = self.scale ** 2 * self.df / (self.df - 2)
        return _t(torch.where(self.df > 2, v, float("nan")))

    def sample(self, shape=()):
        shp = _shape(shape, self._batch_shape)
        dev = self.df.device
        chi2 = 2 * _gamma(self.df / 2, shp, dev)
        t = _normal(shp, dev) * torch.rsqrt(chi2 / self.df)
        return _t(self.loc + self.scale * t)

    def log_prob(self, value):
        z = (_arr(value, self.df.device) - self.loc) / self.scale
        nu = self.df
        return _t(torch.lgamma((nu + 1) / 2) - torch.lgamma(nu / 2)
                  - 0.5 * torch.log(nu * math.pi) - torch.log(self.scale)
                  - (nu + 1) / 2 * torch.log1p(z * z / nu))


class ContinuousBernoulli(ExponentialFamily):
    def __init__(self, probs, lims=(0.499, 0.501), name=None):
        self.probs_arr = _arr(probs)
        self._lims = lims
        super().__init__(self.probs_arr.shape)

    def _log_norm_const(self):
        # C(p) = 2 atanh(1 - 2p) / (1 - 2p), 2 at p = 1/2
        safe = self.probs_arr.clamp(1e-6, 1 - 1e-6)
        cut = (safe < self._lims[0]) | (safe > self._lims[1])
        x = torch.where(cut, safe, 0.25)
        c = 2 * torch.atanh(1 - 2 * x) / (1 - 2 * x)
        return torch.log(torch.where(cut, c, 2.0))

    def log_prob(self, value):
        v = _arr(value, self.probs_arr.device)
        p = self.probs_arr.clamp(1e-6, 1 - 1e-6)
        return _t(v * torch.log(p) + (1 - v) * torch.log1p(-p)
                  + self._log_norm_const())

    def sample(self, shape=()):
        shp = _shape(shape, self._batch_shape)
        p = self.probs_arr.clamp(1e-6, 1 - 1e-6)
        u = _uniform(shp, p.device, 1e-6, 1 - 1e-6)
        icdf = torch.log1p((2 * p - 1) * u / (1 - p)) / torch.log(p / (1 - p))
        mid = (p > self._lims[0]) & (p < self._lims[1])
        return _t(torch.where(mid, u, icdf))

    rsample = sample


class MultivariateNormal(Distribution):
    def __init__(self, loc, covariance_matrix=None, scale_tril=None,
                 name=None):
        self.loc = _arr(loc)
        dev = self.loc.device
        if scale_tril is not None:
            self.scale_tril = _arr(scale_tril, dev)
        else:
            self.scale_tril = torch.linalg.cholesky(
                _arr(covariance_matrix, dev))
        super().__init__(self.loc.shape[:-1], self.loc.shape[-1:])

    @property
    def mean(self):
        return _t(self.loc)

    @property
    def variance(self):
        return _t((self.scale_tril ** 2).sum(-1))

    def sample(self, shape=()):
        shp = _shape(shape, self._batch_shape) + self._event_shape
        eps = _normal(shp, self.loc.device)
        return _t(self.loc + torch.einsum("...ij,...j->...i",
                                          self.scale_tril, eps))

    rsample = sample

    def _logdet(self):
        return 2 * torch.log(torch.diagonal(
            self.scale_tril, dim1=-2, dim2=-1)).sum(-1)

    def log_prob(self, value):
        d = self.loc.shape[-1]
        diff = _arr(value, self.loc.device) - self.loc
        L = torch.broadcast_to(self.scale_tril,
                               diff.shape[:-1] + self.scale_tril.shape[-2:])
        sol = torch.linalg.solve_triangular(L, diff[..., None],
                                            upper=False)[..., 0]
        maha = (sol ** 2).sum(-1)
        return _t(-0.5 * (maha + d * math.log(2 * math.pi) + self._logdet()))

    def entropy(self):
        d = self.loc.shape[-1]
        return _t(0.5 * (d * (1 + math.log(2 * math.pi)) + self._logdet()))


class Independent(Distribution):
    """Reinterpret the last batch dims as event dims."""

    def __init__(self, base, reinterpreted_batch_rank):
        self.base = base
        self.k = int(reinterpreted_batch_rank)
        bs = tuple(base._batch_shape)
        super().__init__(bs[:len(bs) - self.k],
                         bs[len(bs) - self.k:] + tuple(base._event_shape))

    @property
    def mean(self):
        return self.base.mean

    @property
    def variance(self):
        return self.base.variance

    def sample(self, shape=()):
        return self.base.sample(shape)

    rsample = sample

    def log_prob(self, value):
        lp = unwrap(self.base.log_prob(value))
        return _t(lp.sum(dim=tuple(range(-self.k, 0))))

    def entropy(self):
        e = unwrap(self.base.entropy())
        return _t(e.sum(dim=tuple(range(-self.k, 0))))


class LKJCholesky(Distribution):
    """LKJ prior over the Cholesky factors of correlation matrices; the
    onion method samples row by row."""

    def __init__(self, dim, concentration=1.0, sample_method="onion",
                 name=None):
        if sample_method != "onion":
            raise NotImplementedError(
                f"LKJCholesky(sample_method={sample_method!r}): the JAX "
                f"package samples by the onion method only")
        self.dim = int(dim)
        self.concentration = _arr(concentration)
        super().__init__(self.concentration.shape, (self.dim, self.dim))

    def sample(self, shape=()):
        d = self.dim
        eta = self.concentration
        dev = eta.device
        shp = _shape(shape, self._batch_shape)
        L = torch.zeros(shp + (d, d), dtype=torch.float32, device=dev)
        L[..., 0, 0] = 1.0
        for i in range(1, d):
            beta_a = torch.broadcast_to(eta + (d - 1 - i) / 2.0, shp)
            beta_b = torch.full(shp, i / 2.0, device=dev)
            x = _gamma(beta_b, shp, dev)
            r2 = x / (x + _gamma(beta_a, shp, dev))
            u = _normal(shp + (i,), dev)
            u = u / torch.linalg.norm(u, dim=-1, keepdim=True)
            L[..., i, :i] = torch.sqrt(r2)[..., None] * u
            L[..., i, i] = torch.sqrt((1 - r2).clamp_min(1e-12))
        return _t(L)

    def log_prob(self, value):
        L = _arr(value, self.concentration.device)
        d, eta = self.dim, self.concentration
        diags = torch.diagonal(L, dim1=-2, dim2=-1)[..., 1:]
        orders = torch.arange(d - 1, 0, -1, dtype=torch.float32,
                              device=L.device)
        expo = 2 * (eta[..., None] - 1) + orders
        unnorm = (expo * torch.log(diags)).sum(-1)
        i = torch.arange(1, d, dtype=torch.float32, device=L.device)
        alpha = eta[..., None] + (d - 1 - i) / 2
        norm = (i / 2 * math.log(math.pi) + torch.lgamma(alpha)
                - torch.lgamma(alpha + i / 2)).sum(-1)
        return _t(unnorm - norm)


# ---------------------------------------------------------------------------
# register_kl
# ---------------------------------------------------------------------------

_KL_REGISTRY = {}


def register_kl(p_cls, q_cls):
    """Decorator registering KL(p || q) for the pair of classes;
    ``kl_divergence`` takes the most derived match."""

    def deco(fn):
        _KL_REGISTRY[(p_cls, q_cls)] = fn
        return fn

    return deco


def _lookup_kl(p, q):
    best, best_fn = None, None
    for (pc, qc), fn in _KL_REGISTRY.items():
        if isinstance(p, pc) and isinstance(q, qc):
            score = (len(type(p).__mro__) - len(pc.__mro__),
                     len(type(q).__mro__) - len(qc.__mro__))
            if best is None or score < best:
                best, best_fn = score, fn
    return best_fn


@register_kl(Laplace, Laplace)
def _kl_laplace(p, q):
    d = (p.loc - q.loc).abs()
    return _t(torch.log(q.scale / p.scale) + d / q.scale
              + (p.scale / q.scale) * torch.exp(-d / p.scale) - 1)


@register_kl(Poisson, Poisson)
def _kl_poisson(p, q):
    return _t(p.rate * (torch.log(p.rate) - torch.log(q.rate)) - p.rate
              + q.rate)


@register_kl(Geometric, Geometric)
def _kl_geometric(p, q):
    pp, qq = p.probs_arr, q.probs_arr
    return _t(torch.log(pp / qq)
              + (1 - pp) / pp * torch.log((1 - pp) / (1 - qq)))
