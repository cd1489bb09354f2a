"""The port's masked and lse-differentiable flash variants against the JAX
package's: ``flash_attention_varlen`` (segment ids), ``flash_attention_
rowmask`` (per-kv-column row bounds, flashmask) and ``flash_attention_with_
lse`` (the lse cotangent), values and gradients.

On the CPU the port runs its plain versions (the masked forward with lse and
the kernels' backward formulas); they are held against the Pallas kernels
in interpret mode (blocks 128, each JAX function jitted once) and against
the JAX fallbacks, on the same numpy inputs: b 2, s 256, 4 q / 2 kv heads,
head_dim 64, fp32. Tolerances: atol 2e-5 on outputs (both sides compute in
fp32, only the summation order differs, as tests/test_torch_ops.py) and
5e-5 on gradients (sums of 256-term products of O(1) values, the JAX
package's own gradient tolerance in tests/test_flash_attention.py). Masks
leave every row a visible key, except in the test of rows that see none.
The CUDA kernels are held against these plain versions on the card by
tests/test_torch_cuda.py.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import (flash_attention_reference_lse,
                                  flash_attention_rowmask,
                                  flash_attention_rowmask_reference,
                                  flash_attention_varlen,
                                  flash_attention_varlen_reference,
                                  flash_attention_with_lse)

# the modules (the packages' attributes of that name are the functions)
jfa = importlib.import_module("paddle_tpu.ops.flash_attention")
fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")

torch.set_num_threads(1)

ATOL = 2e-5
GRAD_ATOL = 5e-5
B, S, HQ, HKV, D = 2, 256, 4, 2, 64
BLOCK = 128
SCALE = D ** -0.5
NEG_INF = -1e30


def _inputs(seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, HQ, D)).astype(np.float32)
    k = rng.standard_normal((B, S, HKV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, HKV, D)).astype(np.float32)
    g = rng.standard_normal((B, S, HQ, D)).astype(np.float32)
    return q, k, v, g


def _segments():
    """Documents of 100, 28 and 128 tokens in row 0, 64 and 192 in row 1."""
    seg = np.zeros((B, S), np.int32)
    seg[0, 100:] = 1
    seg[0, 128:] = 2
    seg[1, 64:] = 1
    return seg


def _bounds(hm, nidx, seed):
    """Row bounds [B, hm, S] with start[c] in (c, c + 64]: every row keeps
    its diagonal. 1-index form: end = s_q + s_kv (the functional's);
    2-index: end = start + 32 (+ 32 per bounds row)."""
    rng = np.random.default_rng(seed)
    cols = np.arange(S, dtype=np.int32)
    start = (cols + 1 + rng.integers(0, 64, (B, hm, S))).astype(np.int32)
    if nidx == 1:
        end = np.full_like(start, 2 * S)
    else:
        end = (start + 32 + 32 * np.arange(hm)[None, :, None]).astype(
            np.int32)
    return start, end


def _port_vjp(fn, q, k, v, g, *args):
    """The port's output and (dq, dk, dv) of sum(out * g)."""
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fn(tq, tk, tv, *args)
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(),
                                (tq, tk, tv))
    return out.detach().numpy(), [x.numpy() for x in grads]


def _jax_vjp(fn, q, k, v, g):
    """A JAX function's output and (dq, dk, dv) of sum(out * g), jitted."""
    @jax.jit
    def run(q, k, v, g):
        out, vjp = jax.vjp(fn, q, k, v)
        return out, vjp(g)
    out, grads = run(*map(jnp.asarray, (q, k, v, g)))
    return np.asarray(out), [np.asarray(x) for x in grads]


def _close(port, ref, grads=None, ref_grads=None):
    np.testing.assert_allclose(port, ref, atol=ATOL)
    for name, a, b in zip(("dq", "dk", "dv"), grads or (), ref_grads or ()):
        np.testing.assert_allclose(a, b, atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_varlen_matches_jax_kernel_and_fallback(causal):
    q, k, v, g = _inputs(1)
    seg = _segments()
    js = jnp.asarray(seg)
    kernel, kgrads = _jax_vjp(
        lambda a, b, c: jfa.flash_attention_varlen(
            a, b, c, js, js, causal, None, BLOCK, BLOCK, True), q, k, v, g)
    fallback, fgrads = _jax_vjp(
        lambda a, b, c: jfa._xla_varlen_reference(a, b, c, js, js, causal,
                                                  SCALE), q, k, v, g)
    ts = torch.from_numpy(seg)
    out, grads = _port_vjp(flash_attention_varlen, q, k, v, g, ts, ts,
                           causal)
    _close(out, kernel, grads, kgrads)
    _close(out, fallback, grads, fgrads)
    plain = flash_attention_varlen_reference(
        *map(torch.from_numpy, (q, k, v)), ts, ts, causal).numpy()
    np.testing.assert_allclose(plain, fallback, atol=ATOL)
    with torch.no_grad():     # the primal path (no lse kept)
        primal = flash_attention_varlen(*map(torch.from_numpy, (q, k, v)),
                                        ts, ts, causal)
    np.testing.assert_array_equal(primal.numpy(), out)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("nidx", [1, 2])
@pytest.mark.parametrize("hm", [1, HKV])
def test_rowmask_matches_jax_kernel_and_fallback(hm, nidx, causal):
    q, k, v, g = _inputs(2)
    start, end = _bounds(hm, nidx, 10 * hm + nidx)
    jst, jen = jnp.asarray(start), jnp.asarray(end)
    kernel, kgrads = _jax_vjp(
        lambda a, b, c: jfa.flash_attention_rowmask(
            a, b, c, jst, jen, causal, None, BLOCK, BLOCK, True), q, k, v, g)
    fallback = np.asarray(jfa._xla_rowmask_reference(
        *map(jnp.asarray, (q, k, v)), jst, jen, causal, SCALE))
    tst, ten = torch.from_numpy(start), torch.from_numpy(end)
    out, grads = _port_vjp(flash_attention_rowmask, q, k, v, g, tst, ten,
                           causal)
    _close(out, kernel, grads, kgrads)
    plain = flash_attention_rowmask_reference(
        *map(torch.from_numpy, (q, k, v)), tst, ten, causal).numpy()
    np.testing.assert_allclose(plain, fallback, atol=ATOL)
    np.testing.assert_allclose(out, fallback, atol=ATOL)


def test_with_lse_gradients_include_the_lse_cotangent():
    # tests/test_flash_attention.py:260's loss: ring attention's merge
    # differentiates through lse; the backward folds l-bar into delta
    q, k, v, _ = _inputs(3)

    def jloss(fn):
        def f(a, b, c):
            out, lse = fn(a, b, c)
            return (out ** 2).sum() + (jnp.sin(lse) * 0.3).sum()
        return jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2)))

    jq, jk, jv = map(jnp.asarray, (q, k, v))
    kl, kgrads = jloss(lambda a, b, c: jfa.flash_attention_with_lse(
        a, b, c, True, SCALE, BLOCK, BLOCK, True))(jq, jk, jv)
    rl, rgrads = jloss(lambda a, b, c: jfa._xla_reference_lse(
        a, b, c, True, SCALE))(jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = flash_attention_with_lse(tq, tk, tv, True)
    assert lse.shape == (B, HQ, S) and lse.dtype == torch.float32
    loss = (out ** 2).sum() + (torch.sin(lse) * 0.3).sum()
    grads = torch.autograd.grad(loss, (tq, tk, tv))
    np.testing.assert_allclose(loss.item(), float(kl), rtol=1e-6)
    for name, a, b, c in zip(("dq", "dk", "dv"), grads, kgrads, rgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=GRAD_ATOL, err_msg=name)
        np.testing.assert_allclose(a.numpy(), np.asarray(c),
                                   atol=GRAD_ATOL, err_msg=name)
    # lse alone (no cotangent on out) and out alone (none on lse)
    for use in ("lse", "out"):
        tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
        out, lse = flash_attention_with_lse(tq, tk, tv, True)
        part = lse.sum() if use == "lse" else (out ** 2).sum()
        got = torch.autograd.grad(part, (tq, tk), allow_unused=True)
        qr, kr = (torch.from_numpy(x).requires_grad_() for x in (q, k))
        ro, rlse = flash_attention_reference_lse(qr, kr, torch.from_numpy(v),
                                                 True)
        want = torch.autograd.grad(rlse.sum() if use == "lse"
                                   else (ro ** 2).sum(), (qr, kr))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(),
                                       atol=GRAD_ATOL)


def test_rows_without_keys_are_finite_with_no_gradient():
    # q rows 100-139 of row 0 carry a segment id no kv column has: they see
    # no key. The port's plain forward gives them the JAX fallback's value
    # (the mean of v over all columns) and lse NEG_INF; the backward gives
    # them zero gradient, as the JAX kernel's does (its forward value there
    # depends on its block size and is not compared).
    q, k, v, g = _inputs(4)
    q_seg = np.zeros((B, S), np.int32)
    q_seg[0, 100:140] = 7
    kv_seg = np.zeros((B, S), np.int32)
    jq_seg, jkv_seg = jnp.asarray(q_seg), jnp.asarray(kv_seg)
    _, kgrads = _jax_vjp(
        lambda a, b, c: jfa.flash_attention_varlen(
            a, b, c, jq_seg, jkv_seg, True, None, BLOCK, BLOCK, True),
        q, k, v, g)
    fallback = np.asarray(jfa._xla_varlen_reference(
        *map(jnp.asarray, (q, k, v)), jq_seg, jkv_seg, True, SCALE))
    tq_seg, tkv_seg = torch.from_numpy(q_seg), torch.from_numpy(kv_seg)
    out, grads = _port_vjp(flash_attention_varlen, q, k, v, g, tq_seg,
                           tkv_seg, True)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, fallback, atol=ATOL)
    assert not grads[0][0, 100:140].any()
    for name, a, b in zip(("dq", "dk", "dv"), grads, kgrads):
        np.testing.assert_allclose(a, b, atol=GRAD_ATOL, err_msg=name)
    _, lse = torch.ops.paddle_tpu_torch.flash_fwd_lse_seg(
        *map(torch.from_numpy, (q, k, v)), tq_seg, tkv_seg, True, SCALE)
    assert (lse[0, :, 100:140] == NEG_INF).all()
    assert (lse[0, :, :100] > NEG_INF / 2).all()
    assert fa.NEG_INF == NEG_INF


def test_masked_wrappers_refuse_bad_operands():
    q, k, v, _ = map(torch.from_numpy, _inputs(5))
    seg = torch.zeros(B, S, dtype=torch.int32)
    with pytest.raises(ValueError, match="segment ids"):
        flash_attention_varlen(q, k, v, seg[:, :10], seg)
    with pytest.raises(TypeError, match="integer"):
        flash_attention_varlen(q, k, v, seg.float(), seg)
    bounds = torch.zeros(B, 3, S, dtype=torch.int32)   # hm 3: not 1 or 2
    with pytest.raises(ValueError, match="hm 1 or the kv heads"):
        flash_attention_rowmask(q, k, v, bounds, bounds)
