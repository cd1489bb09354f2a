"""Random ops — port of ``paddle_tpu/tensor/random.py``.

Every draw comes from the global ``torch.Generator`` of its result's
device (``framework/random.py``: ``paddle_tpu_torch.seed`` seeds it, its
state round-trips through ``get_rng_state`` / ``set_rng_state``). The bits
cannot equal ``jax.random``'s: the distributions are the JAX package's
(uniform on [min, max), standard normal scaled and shifted, Bernoulli,
Poisson, exponential, binomial, multinomial), the numbers are not.
A result with no tensor argument lies on the current place.
"""

from __future__ import annotations

import torch

from ..core import dtype as dtype_mod
from ..core.tensor import Tensor, unwrap
from ..device import resolve_place
from ..framework.random import generator


def _dt(dtype, default=None):
    return dtype_mod.convert_dtype(dtype) or default \
        or dtype_mod.get_default_dtype()


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        return tuple(int(v) for v in shape.tolist())
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(unwrap(s)) for s in shape)


def _new(t):
    return t.as_subclass(Tensor)


def _empty(shape, dtype, device=None):
    dev = resolve_place(device)
    return torch.empty(_shape(shape), dtype=dtype, device=dev)


def rand(shape, dtype=None, name=None):
    t = _empty(shape, _dt(dtype))
    return _new(t.uniform_(0.0, 1.0, generator=generator(t.device)))


def randn(shape, dtype=None, name=None):
    t = _empty(shape, _dt(dtype))
    return _new(t.normal_(0.0, 1.0, generator=generator(t.device)))


def standard_normal(shape, dtype=None, name=None):
    return randn(shape, dtype)


def normal(mean=0.0, std=1.0, shape=None, name=None):
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        m, s = unwrap(mean), unwrap(std)
        like = m if isinstance(m, torch.Tensor) else s
        shp = torch.broadcast_shapes(tuple(getattr(m, "shape", ())),
                                     tuple(getattr(s, "shape", ())))
        z = torch.empty(shp, dtype=like.dtype, device=like.device).normal_(
            generator=generator(like.device))
        return _new(z * s + m)
    return _new(randn(shape or [1]) * std + mean)


def gaussian(shape, mean=0.0, std=1.0, seed=0, dtype=None, name=None):
    t = _empty(shape, _dt(dtype))
    return _new(t.normal_(mean, std, generator=generator(t.device)))


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    t = _empty(shape, _dt(dtype))
    return _new(t.uniform_(float(unwrap(min)), float(unwrap(max)),
                           generator=generator(t.device)))


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    with torch.no_grad():
        x.uniform_(min, max, generator=generator(x.device))
    return x


def randint(low=0, high=None, shape=[1], dtype=None, name=None):
    if high is None:
        low, high = 0, low
    dev = resolve_place()
    return _new(torch.randint(int(low), int(high), _shape(shape),
                              dtype=_dt(dtype, torch.int64), device=dev,
                              generator=generator(dev)))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    if high is None:
        low, high = 0, low
    return _new(torch.randint(int(low), int(high), tuple(x.shape),
                              dtype=_dt(dtype, x.dtype), device=x.device,
                              generator=generator(x.device)))


def randperm(n, dtype="int64", name=None):
    dev = resolve_place()
    return _new(torch.randperm(int(n), dtype=_dt(dtype, torch.int64),
                               device=dev, generator=generator(dev)))


def multinomial(x, num_samples=1, replacement=False, name=None):
    a = unwrap(x)
    return _new(torch.multinomial(a, num_samples, replacement,
                                  generator=generator(a.device)))


def bernoulli(x, name=None):
    a = unwrap(x)
    return _new(torch.bernoulli(a, generator=generator(a.device)))


def bernoulli_(x, p=0.5, name=None):
    with torch.no_grad():
        x.bernoulli_(p, generator=generator(x.device))
    return x


def poisson(x, name=None):
    a = unwrap(x)
    return _new(torch.poisson(a, generator=generator(a.device)))


def exponential_(x, lam=1.0, name=None):
    with torch.no_grad():
        x.exponential_(lam, generator=generator(x.device))
    return x


def binomial(count, prob, name=None):
    c, p = unwrap(count), unwrap(prob)
    out = torch.binomial(c.float(), p.float().broadcast_to(c.shape),
                         generator=generator(c.device))
    return _new(out.long())


def normal_(x, mean=0.0, std=1.0, name=None):
    with torch.no_grad():
        x.normal_(mean, std, generator=generator(x.device))
    return x


def rand_like(x, dtype=None, name=None):
    t = torch.empty(tuple(x.shape), dtype=_dt(dtype, x.dtype),
                    device=x.device)
    return _new(t.uniform_(generator=generator(x.device)))


def randn_like(x, dtype=None, name=None):
    t = torch.empty(tuple(x.shape), dtype=_dt(dtype, x.dtype),
                    device=x.device)
    return _new(t.normal_(generator=generator(x.device)))
