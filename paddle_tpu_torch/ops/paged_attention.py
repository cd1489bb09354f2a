"""Paged (block) KV-cache attention: the hand-written CUDA decode kernel,
its plain version, the page-pool scatter and the int8 block format.

Port of ``paddle_tpu/ops/paged_attention.py``. Layouts are the JAX
package's:

  k_cache/v_cache: [num_pages, kv_heads, page_size, head_dim], or a
                   :class:`QuantizedKVPool` (int8 pages + [num_pages,
                   kv_heads] fp32 scales, :50)
  block_tables:    [batch, pages_per_seq] int32 (negative = unassigned)
  context_lens:    [batch] int32 — tokens in cache (incl. the current one)

:func:`paged_decode_attention` (:271) launches ``csrc/paged_decode.cu`` (the
port of the Pallas kernel ``_paged_decode_kernel``, :174) on CUDA tensors
for every row whatever its length, on floating-point pools and on int8
pools alike (the kernel dequantizes the pages it reads), and runs
:func:`paged_decode_reference` (:142) on CPU tensors. :func:`append_paged_kv`
(:681) is a plain scatter, as in the JAX package, and writes the pools IN
PLACE (the JAX version returns new arrays; the port returns the same
tensors it was given); on int8 pools it quantizes on append.
:func:`gather_paged_kv` (:798) is the dense gather of each row's pages.

The prefix-cache path adds :func:`paged_prefill_attention` (:359), which
the JAX package computes outside any Pallas kernel (gather + einsum), so
the port computes it with plain tensor ops on both devices, and its named
delegation :func:`paged_verify_attention` (:413), the speculative verify
window; :func:`copy_pages` (:445), the copy-on-write primitive, in place;
and the host-side page bookkeeping :class:`BlockAllocator` (:472) and
:class:`RadixPrefixCache` (:583), copied from the JAX package.

KV-chain migration (inference/disagg.py) moves a finished prefill's pages
between engines: :func:`gather_chain_pages` / :func:`gather_chain_scales`
(:732, :758) copy a chain to the host, :func:`scatter_chain_pages` (:770)
writes one into fresh pages IN PLACE (the JAX version returns new arrays).
"""

from __future__ import annotations

import collections
import ctypes
from typing import Callable, Dict, List, Optional, Sequence

import torch

from . import _build

NEG_INF = -1e30
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (64, 128)

#: int8 KV block format: symmetric absmax quantization, q = round(x / step)
#: with step = scale / KV_QMAX, one scale per (page, kv_head) block
KV_QMAX = 127


# ---------------------------------------------------------------------------
# int8 paged-KV block format (serving.KVCacheConfig(dtype="int8"))
# ---------------------------------------------------------------------------

class QuantizedKVPool:
    """One side (k or v) of a paged-KV pool in the int8 block format.

    ``data`` [num_pages, kv_heads, page, head_dim] int8 and ``scale``
    [num_pages, kv_heads] float32: one absmax scale per (page, kv_head)
    block (scale == absmax of everything written there, stored value =
    round(x / (scale / KV_QMAX))). ``.shape``/``.dtype``/``.device``
    delegate to ``data``, so pool-geometry probes work unchanged. Both
    tensors change only in place (a captured CUDA graph holds their
    pointers).

    Write paths quantize on append (:func:`append_paged_kv`): the block
    scale grows by scatter-max with the incoming tokens' absmax, and the
    stored values of the pages written to are requantized under the grown
    scale (the ratio is exactly 1.0 where a scale did not grow, so their
    bytes are stable). Read paths dequantize: the gather of
    :func:`paged_decode_reference` / :func:`paged_prefill_attention`, and
    the CUDA decode kernel inside its own loop."""

    __slots__ = ("data", "scale")

    def __init__(self, data, scale):
        self.data = data
        self.scale = scale

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    def __repr__(self):
        return (f"QuantizedKVPool(shape={tuple(self.data.shape)}, "
                f"dtype={self.data.dtype})")


def kv_absmax(x):
    """Per-(token, kv_head) absmax of new k/v rows ``x`` [n, kv_heads, d]
    (fp32), the input of the per-block scatter-max on append."""
    return x.float().abs().amax(dim=-1)


def quantize_kv(x, scale):
    """Symmetric int8 quantization of ``x`` with ``scale`` (broadcast
    against ``x``): round(x / (scale / KV_QMAX)), half to even, clipped to
    +-KV_QMAX. A ``scale == 0`` block holds only zeros."""
    step = scale.float() / KV_QMAX
    safe = torch.where(step > 0, step, 1.0)
    q = torch.round(x.float() / safe)
    return q.clamp(-KV_QMAX, KV_QMAX).to(torch.int8)


def dequantize_kv(q, scale):
    """Inverse of :func:`quantize_kv` (fp32): q * (scale / KV_QMAX)."""
    return q.float() * (scale.float() / KV_QMAX)


def _gather_pages(cache, tables):
    """Dense page gather, dequantizing int8 pools: [*tables.shape,
    kv_heads, page, d], fp32 when quantized, the pool dtype otherwise."""
    if isinstance(cache, QuantizedKVPool):
        pages = cache.data[tables].float()
        s = cache.scale[tables]                       # [..., kv_heads]
        return pages * (s[..., None, None] / KV_QMAX)
    if cache.dtype == torch.int8:
        raise TypeError("an int8 pool needs its block scales: pass a "
                        "QuantizedKVPool")
    return cache[tables]


def _pool_tensors(cache):
    """The tensors a pool side is made of: (data, scale) or (pool,)."""
    if isinstance(cache, QuantizedKVPool):
        return cache.data, cache.scale
    return (cache,)


def paged_decode_reference(q, k_cache, v_cache, block_tables, context_lens,
                           scale=None):
    """Dense-gather paged decode: q [b, hq, d] -> out [b, hq, d]. int8
    pools dequantize in the gather."""
    b, hq, d = q.shape
    _, hkv, page, _ = k_cache.shape
    group = hq // hkv
    if scale is None:
        scale = d ** -0.5
    max_pages = block_tables.shape[1]
    safe = block_tables.clamp_min(0).long()
    # [b, max_pages, hkv, page, d] -> [b, hkv, L, d]
    kg = _gather_pages(k_cache, safe).transpose(2, 3).reshape(
        b, max_pages * page, hkv, d)
    vg = _gather_pages(v_cache, safe).transpose(2, 3).reshape(
        b, max_pages * page, hkv, d)
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
    return zeros. CUDA tensors launch the kernel (q bf16 or fp32, pools of
    q's dtype or both :class:`QuantizedKVPool`, head_dim 64 or 128,
    contiguous); CPU tensors run :func:`paged_decode_reference`."""
    quant = isinstance(k_cache, QuantizedKVPool)
    if quant != isinstance(v_cache, QuantizedKVPool):
        raise TypeError("paged_decode_attention: k and v pools must both "
                        "be QuantizedKVPool or both plain tensors")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return paged_decode_reference(q, k_cache, v_cache, block_tables,
                                      context_lens, scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cuda or cpu, "
                         f"not {q.device}")
    pages = (k_cache.data, v_cache.data) if quant else (k_cache, v_cache)
    tensors = (q, *_pool_tensors(k_cache), *_pool_tensors(v_cache),
               block_tables, context_lens)
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_decode_attention: all tensors must be on "
                         f"{q.device}")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"q is on {q.device}, the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"paged decode kernel takes q in bf16 or fp32, got "
                        f"{q.dtype}")
    if quant:
        if not (k_cache.dtype == v_cache.dtype == torch.int8
                and k_cache.scale.dtype == v_cache.scale.dtype
                == torch.float32):
            raise TypeError(f"int8 pools: pages {k_cache.dtype}/"
                            f"{v_cache.dtype} must be int8, scales "
                            f"{k_cache.scale.dtype}/{v_cache.scale.dtype} "
                            "float32")
        if tuple(k_cache.scale.shape) != tuple(k_cache.shape[:2]) or \
                tuple(v_cache.scale.shape) != tuple(v_cache.shape[:2]):
            raise ValueError(f"int8 pool scales {tuple(k_cache.scale.shape)}"
                             f"/{tuple(v_cache.scale.shape)} must be [pages, "
                             f"kv_heads] = {tuple(k_cache.shape[:2])}")
    elif not q.dtype == k_cache.dtype == v_cache.dtype:
        raise TypeError(f"paged decode kernel takes bf16 or fp32 (one "
                        f"dtype), got {q.dtype}/{k_cache.dtype}/"
                        f"{v_cache.dtype}")
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise TypeError("block_tables and context_lens must be int32")
    if q.ndim != 3 or len(k_cache.shape) != 4 \
            or k_cache.shape != v_cache.shape:
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
    if any(t.data_ptr() % 16 for t in (q, *pages)):
        raise ValueError("paged decode kernel reads q and the pools as "
                         "vectors: their storage must be 16-byte aligned")
    pool_item = 1 if quant else q.element_size()
    if page * d * pool_item % 16:
        raise ValueError(f"paged decode kernel bulk-copies pages of "
                         f"page * head_dim * itemsize bytes, which must be a "
                         f"multiple of 16 (page {page}, head_dim {d})")
    if b > 65535:
        raise ValueError(f"paged decode kernel grid limit: batch {b}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = _paged_lib()
    if quant:
        err = lib.paddle_paged_decode_int8(
            q.data_ptr(), k_cache.data.data_ptr(), v_cache.data.data_ptr(),
            k_cache.scale.data_ptr(), v_cache.scale.data_ptr(),
            block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
            _KERNEL_DTYPES[q.dtype], b, hq, hkv, d, page,
            block_tables.shape[1], float(scale), stream)
    else:
        err = lib.paddle_paged_decode(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
            _KERNEL_DTYPES[q.dtype], b, hq, hkv, d, page,
            block_tables.shape[1], float(scale), stream)
    if err != 0:
        raise RuntimeError(f"paged_decode kernel launch failed: CUDA error "
                           f"{err}")
    paged_decode_attention.launches += 1
    if quant:
        paged_decode_attention.int8_launches += 1
    return out


#: launches of the CUDA kernel, on any pool (a plain count; callers reset
#: it to 0), and of those the launches on int8 pools
paged_decode_attention.launches = 0
paged_decode_attention.int8_launches = 0


def _paged_lib():
    lib = _build.load("paged_decode")
    fn = lib.paddle_paged_decode
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fn8 = lib.paddle_paged_decode_int8
        fn8.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                        + [ctypes.c_float, ctypes.c_void_p])
        fn8.restype = ctypes.c_int
    return lib


def gather_paged_kv(k_cache, v_cache, block_tables, max_len):
    """Dense [b, max_len, hkv, d] copies of each row's pages (``gather_paged_
    kv`` :798; the prefill path of ``block_multihead_attention``).
    ``max_len`` must be a multiple of the page size; negative table entries
    read page 0. :class:`QuantizedKVPool` pools come back dequantized fp32;
    plain pools, raw int8 ones included, in their own dtype."""
    b = block_tables.shape[0]
    _, hkv, page, d = k_cache.shape
    tables = block_tables[:, :max_len // page].clamp_min(0).long()

    def gather(cache):
        pages = (_gather_pages(cache, tables)
                 if isinstance(cache, QuantizedKVPool) else cache[tables])
        return pages.transpose(2, 3).reshape(b, max_len, hkv, d)

    return gather(k_cache), gather(v_cache)


def append_paged_kv(k_cache, v_cache, k_new, v_new, block_tables, positions,
                    seq_ids=None):
    """Scatter new tokens into the page pools, in place.

    k_new/v_new: [n_tokens, kv_heads, d]; positions [n_tokens] absolute
    position of each token in its sequence; seq_ids [n_tokens] row of
    block_tables per token (default: one token per row, the decode step).
    int8 pools quantize on append (:func:`_append_quantized`). Returns
    (k_cache, v_cache) — the same objects, updated."""
    page = k_cache.shape[2]
    positions = positions.long()
    if seq_ids is None:
        seq_ids = torch.arange(k_new.shape[0], device=k_cache.device)
    page_idx = block_tables[seq_ids.long(), positions // page].long()
    offs = positions % page
    if isinstance(k_cache, QuantizedKVPool):
        _append_quantized(k_cache, k_new, page_idx, offs)
        _append_quantized(v_cache, v_new, page_idx, offs)
        return k_cache, v_cache
    k_cache[page_idx, :, offs, :] = k_new.to(k_cache.dtype)
    v_cache[page_idx, :, offs, :] = v_new.to(v_cache.dtype)
    return k_cache, v_cache


def _append_quantized(pool: QuantizedKVPool, x_new, page_idx, offs):
    """Quantize-on-append into the int8 block format (one pool side), in
    place, with the JAX package's arithmetic in its order:

    1. scatter-MAX the per-(page, head) scales with the incoming tokens'
       absmax (right under duplicate page indices: several tokens of a
       chunk landing in one page);
    2. requantize the stored values of the pages written to at ratio
       old_scale / new_scale. The JAX package runs this pass over the whole
       pool, but the ratio is exactly 1.0 on every other page and
       round(q * 1.0) == q, so touching only ``page_idx`` gives the same
       bytes at a cost in tokens, not in pool size. A page listed twice is
       written twice with the same bytes;
    3. write the new tokens quantized under the grown scale."""
    s_tok = kv_absmax(x_new)                                  # [n, h]
    old = pool.scale[page_idx]                                # [n, h]
    pool.scale.scatter_reduce_(0, page_idx[:, None].expand_as(s_tok), s_tok,
                               "amax")
    new = pool.scale[page_idx]
    ratio = torch.where(new > 0, old / torch.where(new > 0, new, 1.0), 1.0)
    data = torch.round(pool.data[page_idx].float()
                       * ratio[:, :, None, None]).clamp(-KV_QMAX, KV_QMAX)
    pool.data.index_copy_(0, page_idx, data.to(torch.int8))
    pool.data[page_idx, :, offs, :] = quantize_kv(x_new, new[:, :, None])


def paged_prefill_attention(q, k_cache, v_cache, block_tables, chunk_starts,
                            scale=None):
    """Attention for a prefill CHUNK whose rows sit at per-row absolute
    offsets inside partially filled paged caches: q [b, s, hq, d] for the
    tokens at positions ``chunk_starts[b] + i`` -> [b, s, hq, d].

    The chunk's own k/v must already be appended (append-then-gather). Keys
    are gathered over the table's full ``max_pages * page`` extent
    (dequantized on int8 pools) and masked by ABSOLUTE position (query p
    attends keys <= p, the finite ``NEG_INF``), softmax in fp32: given the
    same cached bytes a token's output does not depend on how its prompt
    was chunked or how much of it came from the prefix cache, which is
    what the serving engine's warm == cold guarantee rests on. Rows are
    independent, so several rows may share one sequence's table at
    different starts (packed prefill)."""
    b, s, hq, d = q.shape
    _, hkv, page, _ = k_cache.shape
    group = hq // hkv
    if scale is None:
        scale = d ** -0.5
    max_pages = block_tables.shape[1]
    L = max_pages * page
    safe = block_tables.clamp_min(0).long()
    # [b, max_pages, hkv, page, d] -> [b, hkv, L, d]
    kg = _gather_pages(k_cache, safe).transpose(2, 3).reshape(b, L, hkv, d)
    vg = _gather_pages(v_cache, safe).transpose(2, 3).reshape(b, L, hkv, d)
    kg = kg.transpose(1, 2).float()
    vg = vg.transpose(1, 2).float()
    qf = q.reshape(b, s, hkv, group, d).float().permute(0, 2, 3, 1, 4)
    sc = torch.einsum("bhgsd,bhld->bhgsl", qf, kg) * scale
    q_pos = (chunk_starts.to(q.device).long()[:, None]
             + torch.arange(s, device=q.device))            # [b, s]
    keep = torch.arange(L, device=q.device)[None, None, :] <= q_pos[:, :, None]
    sc = torch.where(keep[:, None, None], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhgsl,bhld->bhgsd", p, vg)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, hq, d).to(q.dtype)


def paged_verify_attention(q, k_cache, v_cache, block_tables, row_starts,
                           scale=None):
    """Speculative-decode VERIFY attention: a K+1-token window per row
    ([last_token, draft_1..draft_K] at positions ``row_starts[b] + i``)
    scored in one pass, its k/v already appended. A named delegation to
    :func:`paged_prefill_attention`, as in the JAX package: the absolute-
    position mask makes window position i attend the cached prefix plus
    drafts 0..i, so its logits are what a sequential token step at that
    position computes from the same cache bytes. The serving verify step
    (``paged_verify_step`` -> the layers' ``paged_prefill_chunk``) calls
    the shared body directly: verify and chunk prefill are one
    implementation."""
    return paged_prefill_attention(q, k_cache, v_cache, block_tables,
                                   row_starts, scale)


def copy_pages(k_cache, v_cache, src, dst):
    """Copy page(s) ``src`` -> ``dst`` in a (k, v) pool pair, in place: the
    copy-on-write primitive for shared prefix blocks. ``src``/``dst`` are a
    scalar pair or equal-length index vectors (a whole admission wave's
    copies in one call; padding entries copy the parking page onto itself).
    int8 pools copy each block's scales with its bytes. Returns the same
    (k_cache, v_cache)."""
    dev = k_cache.device
    src = torch.as_tensor(src, device=dev).long().reshape(-1)
    dst = torch.as_tensor(dst, device=dev).long().reshape(-1)
    if src.shape != dst.shape:
        raise ValueError(f"copy_pages: src {tuple(src.shape)} and dst "
                         f"{tuple(dst.shape)} differ in length")
    for t in _pool_tensors(k_cache) + _pool_tensors(v_cache):
        t.index_copy_(0, dst, t.index_select(0, src))
    return k_cache, v_cache


# ---------------------------------------------------------------------------
# KV-chain migration: a finished prefill's pages between engines' pools
# (inference/disagg.py)
# ---------------------------------------------------------------------------

#: pool dtypes by the names the JAX package writes into a chain artifact's
#: header (numpy's names). numpy has no bfloat16 without ml_dtypes, so the
#: port moves page bytes as torch tensors and reads the item size here.
CHAIN_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                "float16": torch.float16, "int8": torch.int8}


def chain_dtype_name(dtype) -> str:
    """The artifact header's name of a pool dtype (``"bfloat16"``, never
    ``"torch.bfloat16"``)."""
    for name, dt in CHAIN_DTYPES.items():
        if dt == dtype:
            return name
    raise ValueError(f"no KV-chain dtype name for {dtype}")


def _page_data(pool):
    return pool.data if isinstance(pool, QuantizedKVPool) else pool


def gather_chain_pages(kv, blocks):
    """Host copies of a block chain's page bytes from every layer's (k, v)
    pool pair: the EXPORT half of KV-block migration (JAX :732). ``kv`` is
    the engine's per-layer ``[(k_pages, v_pages), ...]``, ``blocks`` the
    chain's page ids in block-table order. Returns ``[(k, v), ...]`` CPU
    tensors of shape ``[len(blocks), kv_heads, page, head_dim]`` in the
    pool dtype (views of one host buffer, layer by layer, k then v); int8
    pools give their RAW int8 bytes (the scales travel apart:
    :func:`gather_chain_scales`).

    One gather per pool and one device-to-host copy, issued on the current
    stream: the stream every engine call runs its prefill, first-token
    step and graph replays on, so the copy reads the pages after every
    write queued before it (the JAX package's ``np.asarray`` fence)."""
    dev = kv[0][0].device
    idx = torch.as_tensor(list(blocks), dtype=torch.long).to(dev)
    host = torch.stack([_page_data(pool).index_select(0, idx)
                        for pair in kv for pool in pair]).cpu()
    return [(host[2 * i], host[2 * i + 1]) for i in range(len(kv))]


def gather_chain_scales(kv, blocks):
    """Per-layer (k_scales, v_scales) CPU fp32 tensors ``[len(blocks),
    kv_heads]`` for a chain's blocks: the scale half of an int8 chain
    export (JAX :758). None for floating-point pools."""
    if not kv or not isinstance(kv[0][0], QuantizedKVPool):
        return None
    idx = torch.as_tensor(list(blocks), dtype=torch.long).to(
        kv[0][0].device)
    host = torch.stack([pool.scale.index_select(0, idx)
                        for pair in kv for pool in pair]).cpu()
    return [(host[2 * i], host[2 * i + 1]) for i in range(len(kv))]


def _upload(src, like):
    """``src`` (a host tensor or array) as ``like``'s dtype on its device;
    pinned host tensors upload without stalling the stream."""
    t = torch.as_tensor(src)
    if t.dtype != like.dtype:
        t = t.to(like.dtype)
    return t.to(like.device, non_blocking=True)


def scatter_chain_pages(kv, blocks, pages, scales=None):
    """Write exported chain bytes into freshly allocated pool pages: the
    IMPORT half of KV-block migration (JAX :770). ``pages`` is
    :func:`gather_chain_pages` output (or the codec's unpacked payload);
    int8 pools take the per-block ``scales`` with the raw int8 bytes.

    Writes IN PLACE (``index_copy_``) and returns the same ``kv`` list: a
    captured CUDA graph holds the pool pointers, so pools rebound to new
    tensors would leave the next replay attending the old ones (the JAX
    version returns new arrays and the codec rebinds ``engine.caches``).
    An int8 pool without ``scales`` raises before any page is written."""
    quant = bool(kv) and isinstance(kv[0][0], QuantizedKVPool)
    if quant and scales is None:
        raise ValueError("int8 pool import needs per-block scales")
    dev = kv[0][0].device
    idx = torch.as_tensor(list(blocks), dtype=torch.long).to(dev)
    for li, ((k, v), (pk, pv)) in enumerate(zip(kv, pages)):
        if quant:
            ks, vs = scales[li]
            for pool, src, s in ((k, pk, ks), (v, pv, vs)):
                pool.data.index_copy_(0, idx, _upload(src, pool.data))
                pool.scale.index_copy_(0, idx, _upload(s, pool.scale))
        else:
            k.index_copy_(0, idx, _upload(pk, k))
            v.index_copy_(0, idx, _upload(pv, v))
    return kv


# ---------------------------------------------------------------------------
# refcounted block allocator + radix prefix cache (host-side bookkeeping,
# copied from the JAX package)
# ---------------------------------------------------------------------------

class BlockAllocator:
    """Refcounted allocator over the paged-KV pool's page ids.

    Page states: FREE (in the free list), ACTIVE (refcount >= 1: mapped
    into at least one request's block table), CACHED-IDLE (refcount 0 but
    still registered in a :class:`RadixPrefixCache`, reclaimed lazily by
    LRU eviction), or HELD (``hold()``: pool exhaustion on demand).

    Refcounts count REQUEST references only: ``alloc`` hands out blocks at
    refcount 1, each further request sharing a block calls ``incref``, and
    ``decref`` returns a block to the free list only when nothing else
    references it and no prefix cache retains it."""

    def __init__(self, num_blocks: int):
        self.num_blocks = int(num_blocks)
        self._free = collections.deque(range(self.num_blocks))
        self._ref: Dict[int, int] = {}
        self._held: List[int] = []
        # wired by RadixPrefixCache: keeps refcount-0 blocks out of the free
        # list while the cache still maps them
        self.is_cached: Callable[[int], bool] = lambda b: False

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def hold(self, n: int) -> int:
        """Remove up to ``n`` free blocks from circulation; returns how many
        were held."""
        took = 0
        while took < n and self._free:
            self._held.append(self._free.popleft())
            took += 1
        return took

    def release_held(self) -> int:
        n = len(self._held)
        self._free.extend(self._held)
        self._held.clear()
        return n

    def alloc(self, n: int,
              evict: Optional[Callable[[int], int]] = None,
              ) -> Optional[List[int]]:
        """Allocate ``n`` blocks at refcount 1. When the free list is short,
        ``evict(shortfall)`` (the radix cache's LRU reclaimer) may free
        cached-idle blocks first. Returns None when the pool cannot serve
        the request: callers defer, they never overcommit."""
        if n <= 0:
            return []
        if len(self._free) < n and evict is not None:
            evict(n - len(self._free))
        if len(self._free) < n:
            return None
        out = [self._free.popleft() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        return out

    def incref(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            rc = self._ref.get(b, 0)
            if rc == 0 and not self.is_cached(b):
                raise RuntimeError(
                    f"incref of free block {b} — a prefix-cache hit mapped "
                    "a block the allocator does not consider live")
            self._ref[b] = rc + 1

    def decref(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            rc = self._ref.get(b, 0)
            if rc <= 0:
                raise RuntimeError(f"decref of free block {b} (double free)")
            if rc == 1:
                del self._ref[b]
                if not self.is_cached(b):
                    self._free.append(b)
            else:
                self._ref[b] = rc - 1

    def free_cached(self, block: int) -> None:
        """Return a CACHED-IDLE block to the free list; only the radix
        cache's eviction calls this, after unregistering the block."""
        if self._ref.get(block, 0):
            raise RuntimeError(
                f"evicting block {block} with refcount "
                f"{self._ref[block]} — still mapped by a live request")
        self._free.append(block)


class _RadixNode:
    __slots__ = ("children", "block", "parent", "key", "last_used")

    def __init__(self, parent=None, key=None, block=None):
        self.children: Dict[tuple, "_RadixNode"] = {}
        self.parent = parent
        self.key = key
        self.block = block
        self.last_used = 0


class RadixPrefixCache:
    """Radix trie over page-sized prompt-token chunks -> filled KV blocks.

    Each node maps ONE full block of ``page_size`` prompt tokens to the page
    holding its k/v (one page id covers every layer's pool). ``match`` walks
    the longest fully cached prefix; ``insert`` registers a request's full
    prompt blocks (first writer wins: a duplicate chain stays private to
    its request). Eviction is LRU over refcount-0 leaves, cascading upward,
    so a cached chain never breaks in the middle."""

    def __init__(self, page_size: int, allocator: BlockAllocator):
        self.page_size = int(page_size)
        self.allocator = allocator
        self.root = _RadixNode()
        self._by_block: Dict[int, _RadixNode] = {}
        self._tick = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        allocator.is_cached = self.has_block

    def __len__(self) -> int:
        return len(self._by_block)

    def has_block(self, block: int) -> bool:
        return block in self._by_block

    def _chunks(self, tokens) -> List[tuple]:
        p = self.page_size
        n = len(tokens) // p
        return [tuple(int(t) for t in tokens[i * p:(i + 1) * p])
                for i in range(n)]

    def match(self, tokens) -> List[int]:
        """Longest-prefix match over FULL blocks: the cached block ids in
        order (possibly none). Bumps LRU recency along the path; the caller
        increfs before mapping them into a table."""
        self._tick += 1
        node = self.root
        out: List[int] = []
        for key in self._chunks(tokens):
            child = node.children.get(key)
            if child is None:
                break
            child.last_used = self._tick
            out.append(child.block)
            node = child
        if out:
            self.hits += 1
        else:
            self.misses += 1
        return out

    def insert(self, tokens, blocks: Sequence[int]) -> List[int]:
        """Register ``blocks[i]`` for the i-th full block of ``tokens``.
        Existing nodes keep their block. Returns the block ids newly
        registered."""
        self._tick += 1
        node = self.root
        registered: List[int] = []
        for key, block in zip(self._chunks(tokens), blocks):
            child = node.children.get(key)
            if child is None:
                child = _RadixNode(parent=node, key=key, block=int(block))
                node.children[key] = child
                self._by_block[child.block] = child
                registered.append(child.block)
            child.last_used = self._tick
            node = child
        return registered

    def evict_lru(self, n: int) -> int:
        """Evict up to ``n`` blocks, LRU over refcount-0 leaves, cascading
        to parents as they become leaves. Returns how many blocks went back
        to the free list."""
        freed = 0
        while freed < n:
            victims = [nd for nd in self._by_block.values()
                       if not nd.children
                       and self.allocator.refcount(nd.block) == 0]
            if not victims:
                break
            victim = min(victims, key=lambda nd: nd.last_used)
            victim.parent.children.pop(victim.key)
            del self._by_block[victim.block]
            self.allocator.free_cached(victim.block)
            self.evictions += 1
            freed += 1
        return freed
