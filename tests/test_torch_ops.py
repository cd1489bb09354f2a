"""Port kernels (paddle_tpu_torch.ops) against the JAX package's kernels.

On the CPU the port's wrappers run their plain PyTorch versions; they are
held against the Pallas kernels in interpret mode and the JAX references on
the same numpy inputs (fp32, atol 2e-5: both sides compute in fp32, only
the summation order differs). The CUDA kernels themselves are held against
these plain versions on the card by tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu.ops.flash_attention import (_pallas_backward, _pallas_forward,
                                            _xla_reference)
from paddle_tpu.ops.flash_attention import flash_attention as jax_flash
from paddle_tpu.ops.fused_ce import (
    fused_linear_cross_entropy as jax_fused_ce)
from paddle_tpu_torch.ops import (append_paged_kv, flash_attention,
                                  flash_attention_backward,
                                  flash_attention_forward,
                                  flash_attention_reference,
                                  fused_linear_cross_entropy,
                                  paged_decode_attention,
                                  paged_decode_reference)

torch.set_num_threads(1)

ATOL = 2e-5


def _np(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("s_q,s_kv,hq,hkv,causal", [
    (32, 32, 4, 4, True),     # MHA causal
    (32, 32, 4, 2, True),     # GQA causal
    (32, 32, 4, 1, False),    # GQA non-causal
    (16, 48, 4, 2, True),     # end-aligned: s_kv > s_q
])
def test_flash_attention_matches_jax(s_q, s_kv, hq, hkv, causal):
    rng = np.random.default_rng(s_q + s_kv + hq + hkv)
    d = 16
    q, k, v = (_np(rng, (2, s_q, hq, d)), _np(rng, (2, s_kv, hkv, d)),
               _np(rng, (2, s_kv, hkv, d)))
    scale = d ** -0.5
    kernel = np.asarray(jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        interpret=True))
    ref = np.asarray(_xla_reference(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal, scale))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out = flash_attention(tq, tk, tv, causal=causal).numpy()
    plain = flash_attention_reference(tq, tk, tv, causal, scale).numpy()
    np.testing.assert_allclose(out, kernel, atol=ATOL)
    np.testing.assert_allclose(plain, ref, atol=ATOL)


def _paged_inputs(rng, group):
    b, hkv, d, page, maxp, npages = 4, 2, 32, 8, 6, 32
    q = _np(rng, (b, hkv * group, d))
    kc = _np(rng, (npages, hkv, page, d))
    vc = _np(rng, (npages, hkv, page, d))
    tables = rng.permutation(npages)[: b * maxp].reshape(b, maxp)
    tables = tables.astype(np.int32)
    tables[0, 3:] = -1                       # unassigned tail, clamped to 0
    lens = np.asarray([19, 0, 1, 48], np.int32)  # multi-chunk, empty, one
    return q, kc, vc, tables, lens


@pytest.mark.parametrize("group", [1, 4])
def test_paged_decode_matches_jax(group):
    rng = np.random.default_rng(group)
    q, kc, vc, tables, lens = _paged_inputs(rng, group)
    jargs = [jnp.asarray(a) for a in (q, kc, vc, tables, lens)]
    kernel = np.asarray(jpa.paged_decode_attention(*jargs, interpret=True,
                                                   pages_per_chunk=2))
    ref = np.asarray(jpa.paged_decode_reference(*jargs))
    targs = [torch.from_numpy(a) for a in (q, kc, vc, tables, lens)]
    out = paged_decode_attention(*targs).numpy()
    plain = paged_decode_reference(*targs).numpy()
    np.testing.assert_allclose(out, kernel, atol=ATOL)
    np.testing.assert_allclose(plain, ref, atol=ATOL)
    assert not out[1].any()                 # length-0 row writes zeros


def test_append_paged_kv_matches_jax_exactly():
    rng = np.random.default_rng(5)
    npages, hkv, page, d, b, maxp = 12, 2, 4, 8, 3, 4
    kc, vc = _np(rng, (npages, hkv, page, d)), _np(rng, (npages, hkv, page, d))
    tables = rng.permutation(npages).reshape(b, maxp).astype(np.int32)
    seq_ids = np.asarray([0, 0, 1, 2, 2, 2], np.int32)
    positions = np.asarray([3, 4, 0, 7, 8, 15], np.int32)
    kn, vn = _np(rng, (6, hkv, d)), _np(rng, (6, hkv, d))
    jk, jv = jpa.append_paged_kv(*(jnp.asarray(a) for a in (
        kc, vc, kn, vn, tables, positions, seq_ids)))
    tk, tv = append_paged_kv(*(torch.from_numpy(a.copy()) for a in (
        kc, vc, kn, vn, tables, positions, seq_ids)))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # decode form: one token per row, default seq_ids
    jk, _ = jpa.append_paged_kv(*(jnp.asarray(a) for a in (
        kc, vc, kn[:b], vn[:b], tables, positions[:b])))
    tk, _ = append_paged_kv(*(torch.from_numpy(a.copy()) for a in (
        kc, vc, kn[:b], vn[:b], tables, positions[:b])))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


def test_wrappers_refuse_what_this_slice_does_not_port():
    # inputs that require grad now take the differentiable path
    x = torch.zeros(1, 4, 2, 16, requires_grad=True)
    out = flash_attention(x, x, x, causal=True)
    assert out.grad_fn is not None
    (g,) = torch.autograd.grad(out.sum(), x)
    assert g.shape == x.shape and torch.isfinite(g).all()
    pool = torch.zeros(4, 2, 8, 16, dtype=torch.int8)
    with pytest.raises(NotImplementedError, match="int8"):
        paged_decode_attention(torch.zeros(1, 2, 16), pool, pool,
                               torch.zeros(1, 2, dtype=torch.int32),
                               torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="multiple of kv heads"):
        flash_attention(torch.zeros(1, 4, 3, 16), torch.zeros(1, 4, 2, 16),
                        torch.zeros(1, 4, 2, 16))
    with pytest.raises(ValueError, match="lse"):
        flash_attention_backward(x, x, x, x, torch.zeros(1, 2, 3), x)


# (s_q, s_kv, hq, hkv, causal): MHA and GQA 4/2, causal and not, s_kv > s_q
_BWD_CASES = [
    (32, 32, 4, 4, True),
    (32, 32, 4, 2, True),
    (32, 32, 4, 2, False),
    (16, 48, 4, 2, True),
]


@pytest.mark.parametrize("s_q,s_kv,hq,hkv,causal", _BWD_CASES)
def test_plain_lse_and_backward_match_pallas(s_q, s_kv, hq, hkv, causal):
    rng = np.random.default_rng(100 + s_q + s_kv + hkv + causal)
    d = 16
    q, k, v = (_np(rng, (2, s_q, hq, d)), _np(rng, (2, s_kv, hkv, d)),
               _np(rng, (2, s_kv, hkv, d)))
    do = _np(rng, (2, s_q, hq, d))
    scale = d ** -0.5
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jout, jlse4 = _pallas_forward(jq, jk, jv, causal, scale, s_q, 16, True)
    jlse = np.asarray(jlse4)[:, :, 0, :]
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = flash_attention_forward(tq, tk, tv, causal=causal)
    assert lse.shape == (2, hq, s_q) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), jlse, atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)
    # the backward on the same (q, k, v, o, lse, do): the Pallas kernels'
    jgrads = _pallas_backward(jq, jk, jv, jout, jlse4, jdo, causal, scale,
                              s_q, 16, True)
    grads = flash_attention_backward(
        tq, tk, tv, torch.from_numpy(np.array(jout)),
        torch.from_numpy(np.ascontiguousarray(jlse)), tdo, causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), grads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("s_q,s_kv,hq,hkv", [
    (32, 32, 4, 4),      # MHA
    (32, 32, 4, 2),      # GQA
    (16, 48, 4, 2),      # end-aligned: s_kv > s_q
    (48, 32, 4, 2),      # q longer than kv: early rows see no key
])
def test_flash_gradients_match_jax_kernel(s_q, s_kv, hq, hkv):
    # reference: jax.grad through the Pallas kernels in interpret mode. On
    # the q-longer-than-kv edge the kernel's forward differs from the XLA
    # fallback on rows that see no key, and its backward gives them zero
    # gradient; the port's plain backward must do the same.
    rng = np.random.default_rng(200 + s_q + s_kv + hkv)
    d = 16
    q, k, v = (_np(rng, (2, s_q, hq, d)), _np(rng, (2, s_kv, hkv, d)),
               _np(rng, (2, s_kv, hkv, d)))

    def f(a, b, c):
        return (jax_flash(a, b, c, causal=True, interpret=True) ** 2).sum()

    jgrads = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    loss = (flash_attention(tq, tk, tv, causal=True) ** 2).sum()
    grads = torch.autograd.grad(loss, (tq, tk, tv))
    for name, a, b in zip(("dq", "dk", "dv"), grads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-5,
                                   err_msg=name)
    if s_q > s_kv:
        assert not grads[0][:, : s_q - s_kv].any()


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_fused_ce_matches_jax(tied):
    # chunk 5 does not divide s - 1 = 12; labels include ignore_index
    rng = np.random.default_rng(7 + tied)
    b, s, h, V = 2, 13, 16, 40
    hidden = _np(rng, (b, s, h))
    w = _np(rng, (V, h) if tied else (h, V))
    labels = rng.integers(0, V, (b, s)).astype(np.int32)
    labels[0, 3] = labels[1, 9] = -100

    def jloss(hh, ww):
        return jax_fused_ce(hh, ww.T if tied else ww, jnp.asarray(labels),
                            chunk=5)

    jl, (jdh, jdw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(w))
    th = torch.from_numpy(hidden).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    loss = fused_linear_cross_entropy(th, tw.T if tied else tw,
                                      torch.from_numpy(labels), chunk=5)
    dh, dw = torch.autograd.grad(loss, (th, tw))
    assert loss.dtype == torch.float32 and loss.ndim == 0
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(dh.numpy(), np.asarray(jdh), atol=1e-6)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), atol=1e-6)
    assert not dh[:, -1].any()       # the shifted-out last position
