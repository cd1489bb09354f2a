"""Shared harness of the ``nn`` parity tests (tests/test_torch_nn_*.py,
test_torch_rnn.py): one function ``fn(P, *tensors)`` run on the JAX
package (``P = paddle_tpu``) and on the port (``P = paddle_tpu_torch``,
CPU place) over the same numpy inputs, outputs and gradients compared.

Gradients are those of ``sum(out * cotangent)`` over every float output,
with a fixed random cotangent, through each package's own autograd (the
JAX eager tape, which differentiates ``jax.vjp`` of the same formulas, and
torch's). Integer outputs are compared by value: with 64-bit mode off the
JAX package's integers are int32 where the port may give int64.
"""

import numpy as np
import torch

import paddle_tpu as jp
import paddle_tpu_torch as pt

RNG = np.random.default_rng(20261018)


def F(*s, scale=1.0):
    return (RNG.standard_normal(s) * scale).astype(np.float32)


def POS(*s):
    return (np.abs(RNG.standard_normal(s)) + 0.5).astype(np.float32)


def PROB(*s):
    return RNG.uniform(0.05, 0.95, s).astype(np.float32)


def INT(*s, hi=5, lo=0):
    return RNG.integers(lo, hi, s).astype(np.int64)


def SIGN(*s):
    return np.where(RNG.standard_normal(s) >= 0, 1.0, -1.0).astype(
        np.float32)


def as_np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(getattr(x, "_data", x))


def flat(out):
    if isinstance(out, (list, tuple)):
        return [y for o in out for y in flat(o)]
    return [out]


def is_float(x):
    return as_np(x).dtype.kind in "fc" or getattr(x, "dtype", None) in (
        torch.bfloat16,)


def compare(port, ref, tol):
    """Float arrays: max |port - ref| <= tol x max(1, max |ref|), same
    shape; others equal."""
    ps, rs = flat(port), flat(ref)
    assert len(ps) == len(rs), (len(ps), len(rs))
    for p, r in zip(ps, rs):
        a, b = as_np(p), as_np(r)
        if b.dtype.name == "bfloat16":
            b = b.astype(np.float32)
        assert a.shape == b.shape, (a.shape, b.shape)
        if b.dtype.kind not in "fc":
            np.testing.assert_array_equal(a.astype(np.int64),
                                          b.astype(np.int64))
            continue
        err = float(np.abs(a - b).max()) if b.size else 0.0
        assert err <= tol * max(1.0, float(np.abs(b).max())), err


def run(P, fn, inputs, grad):
    ts = [P.to_tensor(x, stop_gradient=i not in grad)
          for i, x in enumerate(inputs)]
    return ts, fn(P, *ts)


def grads(P, ts, out, grad, cots):
    loss = None
    for o, c in zip([o for o in flat(out) if is_float(o)], cots):
        term = (o * P.to_tensor(c)).sum()
        loss = term if loss is None else loss + term
    loss.backward()
    return [ts[i].grad for i in grad]


def check(fn, inputs, grad, tol, gtol):
    """Forward within ``tol``, gradients of the inputs in ``grad`` within
    ``gtol``; returns the port's outputs."""
    jts, jout = run(jp, fn, inputs, grad)
    tts, tout = run(pt, fn, inputs, grad)
    compare(tout, jout, tol)
    if grad:
        cots = [np.random.default_rng(7).standard_normal(
            as_np(o).shape).astype(np.float32)
            for o in flat(jout) if is_float(o)]
        compare(grads(pt, tts, tout, grad, cots),
                grads(jp, jts, jout, grad, cots), gtol)
    return tout


def dtype_name(x):
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return np.dtype(getattr(x, "dtype", as_np(x).dtype)).name


def amp_dtypes(fn, inputs):
    """Each output's dtype name under ``auto_cast`` O1 bf16, in the JAX
    package and the port (integers as their kind: int32 in JAX is the
    port's int32 or int64)."""
    names = []
    for P in (jp, pt):
        ts = [P.to_tensor(x) for x in inputs]
        with P.amp.auto_cast(level="O1", dtype="bfloat16"):
            out = fn(P, *ts)
        names.append(["int" if n.startswith("int") else n
                       for n in map(dtype_name, flat(out))])
    return names
