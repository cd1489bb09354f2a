"""Port kernels (paddle_tpu_torch.ops) against the JAX package's kernels.

On the CPU the port's wrappers run their plain PyTorch versions; they are
held against the Pallas kernels in interpret mode and the JAX references on
the same numpy inputs (fp32, atol 2e-5: both sides compute in fp32, only
the summation order differs). The CUDA kernels themselves are held against
these plain versions on the card by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu.ops.flash_attention import _xla_reference
from paddle_tpu.ops.flash_attention import flash_attention as jax_flash
from paddle_tpu_torch.ops import (append_paged_kv, flash_attention,
                                  flash_attention_reference,
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
    x = torch.zeros(1, 4, 2, 16, requires_grad=True)
    with pytest.raises(NotImplementedError, match="training slice"):
        flash_attention(x, x, x, causal=True)
    pool = torch.zeros(4, 2, 8, 16, dtype=torch.int8)
    with pytest.raises(NotImplementedError, match="int8"):
        paged_decode_attention(torch.zeros(1, 2, 16), pool, pool,
                               torch.zeros(1, 2, dtype=torch.int32),
                               torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="multiple of kv heads"):
        flash_attention(torch.zeros(1, 4, 3, 16), torch.zeros(1, 4, 2, 16),
                        torch.zeros(1, 4, 2, 16))
