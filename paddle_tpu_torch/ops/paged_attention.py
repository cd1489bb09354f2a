"""Paged (block) KV-cache attention: the hand-written CUDA decode kernel,
its plain version, and the page-pool scatter.

Port of ``paddle_tpu/ops/paged_attention.py``. Layouts are the JAX
package's:

  k_cache/v_cache: [num_pages, kv_heads, page_size, head_dim]
  block_tables:    [batch, pages_per_seq] int32 (negative = unassigned)
  context_lens:    [batch] int32 — tokens in cache (incl. the current one)

:func:`paged_decode_attention` (:271) launches ``csrc/paged_decode.cu`` (the
port of the Pallas kernel ``_paged_decode_kernel``, :174) on CUDA tensors
for every row whatever its length, and runs :func:`paged_decode_reference`
(:142) on CPU tensors. :func:`append_paged_kv` (:681) is a plain scatter,
as in the JAX package, and writes the pools IN PLACE (the JAX version
returns new arrays; the port returns the same tensors it was given).

Only floating-point pools are ported: the int8 block format
(``QuantizedKVPool``, :50) arrives with the int8-KV serving slice.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (64, 128)
_INT8_MSG = ("int8 paged-KV pools (QuantizedKVPool) are not ported yet: they "
             "arrive with the int8-KV serving slice (ROADMAP Queue 1)")


def _reject_int8(*pools):
    if any(p.dtype == torch.int8 for p in pools):
        raise NotImplementedError(_INT8_MSG)


def paged_decode_reference(q, k_cache, v_cache, block_tables, context_lens,
                           scale=None):
    """Dense-gather paged decode: q [b, hq, d] -> out [b, hq, d]."""
    _reject_int8(k_cache, v_cache)
    b, hq, d = q.shape
    _, hkv, page, _ = k_cache.shape
    group = hq // hkv
    if scale is None:
        scale = d ** -0.5
    max_pages = block_tables.shape[1]
    safe = block_tables.clamp_min(0).long()
    # [b, max_pages, hkv, page, d] -> [b, hkv, L, d]
    kg = k_cache[safe].transpose(2, 3).reshape(b, max_pages * page, hkv, d)
    vg = v_cache[safe].transpose(2, 3).reshape(b, max_pages * page, hkv, d)
    kg = kg.transpose(1, 2).float()
    vg = vg.transpose(1, 2).float()
    qf = q.reshape(b, hkv, group, d).float()
    s = torch.einsum("bhgd,bhld->bhgl", qf, kg) * scale
    pos = torch.arange(max_pages * page, device=q.device)
    lens = context_lens.to(q.device).reshape(b, 1, 1, 1)
    s = torch.where(pos < lens, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgl,bhld->bhgd", p, vg)
    # zero-length rows (freed/parked slots) return zeros, not garbage
    out = torch.where(lens > 0, out, 0.0)
    return out.reshape(b, hq, d).to(q.dtype)


def paged_decode_attention(q, k_cache, v_cache, block_tables, context_lens,
                           scale=None):
    """One-token-per-row paged decode: q [batch, q_heads, head_dim] ->
    [batch, q_heads, head_dim]. ``context_lens`` counts the row's cached
    tokens including the current one (already appended); rows of length 0
    return zeros. CUDA tensors launch the kernel (bf16 or fp32, head_dim 64
    or 128, contiguous); CPU tensors run :func:`paged_decode_reference`."""
    _reject_int8(k_cache, v_cache)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return paged_decode_reference(q, k_cache, v_cache, block_tables,
                                      context_lens, scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cuda or cpu, "
                         f"not {q.device}")
    tensors = (q, k_cache, v_cache, block_tables, context_lens)
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_decode_attention: all tensors must be on "
                         f"{q.device}")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"q is on {q.device}, the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if q.dtype not in _KERNEL_DTYPES or not (
            q.dtype == k_cache.dtype == v_cache.dtype):
        raise TypeError(f"paged decode kernel takes bf16 or fp32 (one "
                        f"dtype), got {q.dtype}/{k_cache.dtype}/"
                        f"{v_cache.dtype}")
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise TypeError("block_tables and context_lens must be int32")
    if q.ndim != 3 or k_cache.ndim != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"shapes: q {tuple(q.shape)}, pools "
                         f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}")
    b, hq, d = q.shape
    _, hkv, page, _ = k_cache.shape
    if k_cache.shape[3] != d or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit pools "
                         f"{tuple(k_cache.shape)}")
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"paged decode kernel takes head_dim in "
                         f"{_KERNEL_HEAD_DIMS}, got {d}")
    if block_tables.ndim != 2 or block_tables.shape[0] != b \
            or tuple(context_lens.shape) != (b,):
        raise ValueError(f"tables {tuple(block_tables.shape)} / lens "
                         f"{tuple(context_lens.shape)} do not match batch {b}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged decode kernel needs contiguous tensors")
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError("paged decode kernel reads q and the pools as "
                         "16-byte vectors: their storage must be 16-byte "
                         "aligned")
    if page * d * q.element_size() % 16:
        raise ValueError(f"paged decode kernel bulk-copies pages of "
                         f"page * head_dim * itemsize bytes, which must be a "
                         f"multiple of 16 (page {page}, head_dim {d})")
    if b > 65535:
        raise ValueError(f"paged decode kernel grid limit: batch {b}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    err = _paged_lib().paddle_paged_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
        _KERNEL_DTYPES[q.dtype], b, hq, hkv, d, page, block_tables.shape[1],
        float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_decode kernel launch failed: CUDA error "
                           f"{err}")
    paged_decode_attention.launches += 1
    return out


#: launches of the CUDA kernel (a plain count; callers reset it to 0)
paged_decode_attention.launches = 0


def _paged_lib():
    lib = _build.load("paged_decode")
    fn = lib.paddle_paged_decode
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def append_paged_kv(k_cache, v_cache, k_new, v_new, block_tables, positions,
                    seq_ids=None):
    """Scatter new tokens into the page pools, in place.

    k_new/v_new: [n_tokens, kv_heads, d]; positions [n_tokens] absolute
    position of each token in its sequence; seq_ids [n_tokens] row of
    block_tables per token (default: one token per row, the decode step).
    Returns (k_cache, v_cache) — the same tensors, updated."""
    _reject_int8(k_cache, v_cache)
    page = k_cache.shape[2]
    positions = positions.long()
    if seq_ids is None:
        seq_ids = torch.arange(k_new.shape[0], device=k_cache.device)
    page_idx = block_tables[seq_ids.long(), positions // page].long()
    offs = positions % page
    k_cache[page_idx, :, offs, :] = k_new.to(k_cache.dtype)
    v_cache[page_idx, :, offs, :] = v_new.to(v_cache.dtype)
    return k_cache, v_cache
