"""Probability distributions — port of ``paddle_tpu/distribution``
(``__init__.py`` and ``extras.py``).

Parameters become float32 tensors on the device of the first tensor among
them, else the current place. ``log_prob``, ``entropy``, ``mean``,
``variance``, ``cdf`` / ``icdf`` and the KL divergences are the JAX
package's formulas. ``sample`` draws from the port's generator of that
device (``framework.random``): reproducible under ``paddle.seed``, but not
the same numbers as ``jax.random``'s. Results are Paddle ``Tensor``s.
"""

from __future__ import annotations

import math

import torch

from ..core.tensor import Tensor, unwrap
from ..device import resolve_device
from ..framework.random import generator

__all__ = [
    "Distribution", "Normal", "Uniform", "Categorical", "Bernoulli",
    "Exponential", "Beta", "Gamma", "Dirichlet", "Multinomial",
    "TransformedDistribution", "kl_divergence", "register_kl",
    "Binomial", "Cauchy", "Chi2", "ContinuousBernoulli", "ExponentialFamily",
    "Geometric", "Gumbel", "Independent", "LKJCholesky", "Laplace",
    "LogNormal", "MultivariateNormal", "Poisson", "StudentT",
]


def _t(x):
    """A result as a Paddle Tensor (the computations run on plain
    tensors)."""
    return x if isinstance(x, Tensor) else x.as_subclass(Tensor)


def _device(*xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return resolve_device()


def _arr(x, device=None):
    """``x`` as a plain float32 tensor (on ``device``, else its own or the
    current place)."""
    dev = device if device is not None else _device(x)
    return torch.as_tensor(unwrap(x), dtype=torch.float32, device=dev)


def _val(x, device):
    """A value argument as a plain tensor on ``device``: a tensor in its
    own dtype, array data as ``to_tensor`` takes it (float64 becomes
    float32)."""
    x = unwrap(x)
    if isinstance(x, torch.Tensor):
        return x.to(device)
    from ..tensor.creation import to_tensor

    return unwrap(to_tensor(x, place=device))


def _shape(shape, batch):
    return tuple(int(s) for s in shape) + tuple(batch)


def _uniform(shape, device, low=0.0, high=1.0):
    return torch.empty(shape, dtype=torch.float32, device=device).uniform_(
        low, high, generator=generator(device))


def _normal(shape, device):
    return torch.empty(shape, dtype=torch.float32, device=device).normal_(
        generator=generator(device))


def _gamma(alpha, shape, device):
    """Gamma(alpha, 1) samples of ``shape`` (``alpha`` broadcast to it)."""
    a = torch.broadcast_to(alpha, shape).contiguous()
    return torch._standard_gamma(a, generator=generator(device))


def _categorical(logits, shape, device):
    """Draws of ``shape`` (= sample shape + the logits' batch shape) from
    the rows of ``logits`` [*batch, n]."""
    n = logits.shape[-1]
    batch = tuple(logits.shape[:-1])
    k = math.prod(shape[:len(shape) - len(batch)])
    probs = torch.softmax(logits.reshape(-1, n), -1)
    draws = torch.multinomial(probs, max(k, 1), replacement=True,
                              generator=generator(device))[:, :k]   # [B, k]
    return draws.t().reshape(shape)


class Distribution:
    def __init__(self, batch_shape=(), event_shape=()):
        self._batch_shape = tuple(batch_shape)
        self._event_shape = tuple(event_shape)

    @property
    def batch_shape(self):
        return list(self._batch_shape)

    @property
    def event_shape(self):
        return list(self._event_shape)

    @property
    def mean(self):
        raise NotImplementedError

    @property
    def variance(self):
        raise NotImplementedError

    def sample(self, shape=()):
        raise NotImplementedError

    def rsample(self, shape=()):
        return self.sample(shape)

    def log_prob(self, value):
        raise NotImplementedError

    def prob(self, value):
        return _t(torch.exp(unwrap(self.log_prob(value))))

    def entropy(self):
        raise NotImplementedError

    def kl_divergence(self, other):
        return kl_divergence(self, other)


class Normal(Distribution):
    def __init__(self, loc, scale, name=None):
        dev = _device(loc, scale)
        self.loc, self.scale = _arr(loc, dev), _arr(scale, dev)
        super().__init__(torch.broadcast_shapes(self.loc.shape,
                                                self.scale.shape))

    @property
    def mean(self):
        return _t(torch.broadcast_to(self.loc, self._batch_shape))

    @property
    def variance(self):
        return _t(torch.broadcast_to(self.scale ** 2, self._batch_shape))

    @property
    def stddev(self):
        return _t(torch.broadcast_to(self.scale, self._batch_shape))

    def sample(self, shape=()):
        shp = _shape(shape, self._batch_shape)
        return _t(self.loc + self.scale * _normal(shp, self.loc.device))

    def log_prob(self, value):
        v = _val(value, self.loc.device)
        var = self.scale ** 2
        return _t(-((v - self.loc) ** 2) / (2 * var) - torch.log(self.scale)
                  - 0.5 * math.log(2 * math.pi))

    def entropy(self):
        return _t(torch.broadcast_to(
            0.5 + 0.5 * math.log(2 * math.pi) + torch.log(self.scale),
            self._batch_shape))

    def cdf(self, value):
        v = _val(value, self.loc.device)
        return _t(0.5 * (1 + torch.special.erf(
            (v - self.loc) / (self.scale * math.sqrt(2)))))


class Uniform(Distribution):
    def __init__(self, low, high, name=None):
        dev = _device(low, high)
        self.low, self.high = _arr(low, dev), _arr(high, dev)
        super().__init__(torch.broadcast_shapes(self.low.shape,
                                                self.high.shape))

    @property
    def mean(self):
        return _t((self.low + self.high) / 2)

    @property
    def variance(self):
        return _t((self.high - self.low) ** 2 / 12)

    def sample(self, shape=()):
        shp = _shape(shape, self._batch_shape)
        return _t(_uniform(shp, self.low.device) * (self.high - self.low)
                  + self.low)

    def log_prob(self, value):
        v = _val(value, self.low.device)
        inside = (v >= self.low) & (v < self.high)
        return _t(torch.where(inside, -torch.log(self.high - self.low),
                              float("-inf")))

    def entropy(self):
        return _t(torch.log(self.high - self.low))


class Categorical(Distribution):
    def __init__(self, logits, name=None):
        self.logits = _arr(logits)
        super().__init__(self.logits.shape[:-1])

    @property
    def probs(self):
        return _t(torch.softmax(self.logits, -1))

    def sample(self, shape=()):
        shp = _shape(shape, self._batch_shape)
        return _t(_categorical(self.logits, shp, self.logits.device))

    def log_prob(self, value):
        lp = torch.log_softmax(self.logits, -1)
        v = _val(value, self.logits.device).long()
        lp = torch.broadcast_to(lp, v.shape + lp.shape[-1:])
        return _t(torch.take_along_dim(lp, v[..., None], -1)[..., 0])

    def entropy(self):
        lp = torch.log_softmax(self.logits, -1)
        return _t(-(torch.exp(lp) * lp).sum(-1))


class Bernoulli(Distribution):
    def __init__(self, probs, name=None):
        self.probs_arr = _arr(probs)
        super().__init__(self.probs_arr.shape)

    @property
    def mean(self):
        return _t(self.probs_arr)

    @property
    def variance(self):
        return _t(self.probs_arr * (1 - self.probs_arr))

    def sample(self, shape=()):
        shp = _shape(shape, self._batch_shape)
        u = _uniform(shp, self.probs_arr.device)
        return _t((u < self.probs_arr).float())

    def log_prob(self, value):
        v = _val(value, self.probs_arr.device)
        p = self.probs_arr
        return _t(v * torch.log(p.clamp_min(1e-12))
                  + (1 - v) * torch.log((1 - p).clamp_min(1e-12)))

    def entropy(self):
        p = self.probs_arr
        return _t(-(p * torch.log(p.clamp_min(1e-12))
                    + (1 - p) * torch.log((1 - p).clamp_min(1e-12))))


class Exponential(Distribution):
    def __init__(self, rate, name=None):
        self.rate = _arr(rate)
        super().__init__(self.rate.shape)

    @property
    def mean(self):
        return _t(1.0 / self.rate)

    @property
    def variance(self):
        return _t(self.rate ** -2)

    def sample(self, shape=()):
        shp = _shape(shape, self._batch_shape)
        e = torch.empty(shp, dtype=torch.float32,
                        device=self.rate.device).exponential_(
            generator=generator(self.rate.device))
        return _t(e / self.rate)

    def log_prob(self, value):
        v = _val(value, self.rate.device)
        return _t(torch.log(self.rate) - self.rate * v)

    def entropy(self):
        return _t(1 - torch.log(self.rate))


def _betaln(a, b):
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


class Beta(Distribution):
    def __init__(self, alpha, beta, name=None):
        dev = _device(alpha, beta)
        self.alpha, self.beta = _arr(alpha, dev), _arr(beta, dev)
        super().__init__(torch.broadcast_shapes(self.alpha.shape,
                                                self.beta.shape))

    @property
    def mean(self):
        return _t(self.alpha / (self.alpha + self.beta))

    def sample(self, shape=()):
        shp = _shape(shape, self._batch_shape)
        x = _gamma(self.alpha, shp, self.alpha.device)
        y = _gamma(self.beta, shp, self.alpha.device)
        return _t(x / (x + y))

    def log_prob(self, value):
        v = _val(value, self.alpha.device)
        return _t((self.alpha - 1) * torch.log(v)
                  + (self.beta - 1) * torch.log1p(-v)
                  - _betaln(self.alpha, self.beta))


class Gamma(Distribution):
    def __init__(self, concentration, rate, name=None):
        dev = _device(concentration, rate)
        self.concentration = _arr(concentration, dev)
        self.rate = _arr(rate, dev)
        super().__init__(torch.broadcast_shapes(self.concentration.shape,
                                                self.rate.shape))

    @property
    def mean(self):
        return _t(self.concentration / self.rate)

    def sample(self, shape=()):
        shp = _shape(shape, self._batch_shape)
        return _t(_gamma(self.concentration, shp, self.rate.device)
                  / self.rate)

    def log_prob(self, value):
        v = _val(value, self.rate.device)
        a, r = self.concentration, self.rate
        return _t(a * torch.log(r) + (a - 1) * torch.log(v) - r * v
                  - torch.lgamma(a))


class Dirichlet(Distribution):
    def __init__(self, concentration, name=None):
        self.concentration = _arr(concentration)
        super().__init__(self.concentration.shape[:-1],
                         self.concentration.shape[-1:])

    def sample(self, shape=()):
        shp = _shape(shape, self._batch_shape) + self._event_shape
        g = _gamma(self.concentration, shp, self.concentration.device)
        return _t(g / g.sum(-1, keepdim=True))

    def log_prob(self, value):
        v = _val(value, self.concentration.device)
        a = self.concentration
        return _t(((a - 1) * torch.log(v)).sum(-1)
                  + torch.lgamma(a.sum(-1)) - torch.lgamma(a).sum(-1))


class Multinomial(Distribution):
    def __init__(self, total_count, probs, name=None):
        self.total_count = total_count
        self.probs_arr = _arr(probs)
        super().__init__(self.probs_arr.shape[:-1],
                         self.probs_arr.shape[-1:])

    def sample(self, shape=()):
        n = self.probs_arr.shape[-1]
        shp = tuple(int(s) for s in shape)
        draws = _categorical(torch.log(self.probs_arr),
                             shp + (self.total_count,) + self._batch_shape,
                             self.probs_arr.device)
        return _t(torch.nn.functional.one_hot(draws, n).sum(
            dim=len(shp)).float())


def _builtin_kl(p, q):
    if isinstance(p, Normal) and isinstance(q, Normal):
        var_ratio = (p.scale / q.scale) ** 2
        t1 = ((p.loc - q.loc) / q.scale) ** 2
        return _t(0.5 * (var_ratio + t1 - 1 - torch.log(var_ratio)))
    if isinstance(p, Categorical) and isinstance(q, Categorical):
        lp = torch.log_softmax(p.logits, -1)
        lq = torch.log_softmax(q.logits, -1)
        return _t((torch.exp(lp) * (lp - lq)).sum(-1))
    if isinstance(p, Uniform) and isinstance(q, Uniform):
        return _t(torch.log((q.high - q.low) / (p.high - p.low)))
    raise NotImplementedError(
        f"kl_divergence({type(p).__name__}, {type(q).__name__})")


class TransformedDistribution(Distribution):
    def __init__(self, base, transforms):
        self.base = base
        self.transforms = (transforms if isinstance(transforms, (list, tuple))
                           else [transforms])
        super().__init__(base._batch_shape, base._event_shape)

    def sample(self, shape=()):
        x = unwrap(self.base.sample(shape))
        for t in self.transforms:
            x = t.forward(x)
        return _t(x)


from .extras import (  # noqa: E402,F401
    Binomial, Cauchy, Chi2, ContinuousBernoulli, ExponentialFamily,
    Geometric, Gumbel, Independent, LKJCholesky, Laplace, LogNormal,
    MultivariateNormal, Poisson, StudentT, _lookup_kl, register_kl)


def kl_divergence(p, q):
    """KL(p || q): a registered rule (``register_kl``, most derived
    classes first), else the built-in Normal, Categorical and Uniform
    ones."""
    fn = _lookup_kl(p, q)
    if fn is not None:
        return fn(p, q)
    return _builtin_kl(p, q)
