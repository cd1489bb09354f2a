"""Fused serving and MoE functionals — port of two functions of
``paddle_tpu/incubate/nn/functional/__init__.py`` on ``torch.Tensor``s:

- :func:`block_multihead_attention` (:561): paged-KV attention for batched
  serving. Decode rows take one batched call of the paged decode kernel
  (K4, :func:`paddle_tpu_torch.ops.paged_decode_attention`), prefill and
  multi-token rows one flash kernel call (K1, causal) each over their
  gathered prefix; on CPU tensors both run their plain versions.
- :func:`fused_moe` (:152): top-k routing, the experts' FFN as batched
  einsums (the JAX package's XLA products, no Pallas kernel there) and the
  combine, through the port's ``routed_ffn``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ....ops import (KV_QMAX, QuantizedKVPool, append_paged_kv,
                     flash_attention, gather_paged_kv,
                     paged_decode_attention)
from ...distributed.models.moe.moe_layer import routed_ffn


def fused_moe(x, gate_weight, ffn1_weight, ffn2_weight, ffn1_bias=None,
              ffn1_scale=None, ffn2_bias=None, ffn2_scale=None,
              quant_method="None", moe_topk=2, norm_topk_prob=True,
              capacity_factor=None):
    """Reference: incubate/nn/functional/fused_moe.py:22 — same signature.

    x [bsz, seq, d_model]; gate_weight: the per-token gate logits [bsz, seq,
    num_experts]; ffn1_weight [E, d_model, 2 d_ff] (gated: swiglu on its two
    halves) or [E, d_model, d_ff] (plain: tanh gelu, ``jax.nn.gelu``'s
    default); ffn2_weight [E, d_ff, d_model]; biases [E, 1, d] or [E, d].
    ``capacity_factor=None`` gives capacity = tokens (no token is dropped);
    a factor bounds each expert's slots to ceil(tokens k factor / E), at
    least k. Quantized weights raise ``NotImplementedError``. x and the
    weights share one dtype."""
    if (quant_method != "None" or ffn1_scale is not None
            or ffn2_scale is not None):
        raise NotImplementedError("fused_moe quantization is not supported")
    orig = x.shape
    tokens = x.reshape(-1, orig[-1])
    n, e = tokens.shape[0], ffn1_weight.shape[0]
    probs = torch.softmax(gate_weight.reshape(-1, e).float(), dim=-1)
    if capacity_factor is None:
        cap = n
    else:
        cap = max(int(math.ceil(n * moe_topk * capacity_factor / e)),
                  moe_topk)
    gated = ffn1_weight.shape[-1] == 2 * ffn2_weight.shape[-2]

    def expert_fn(expert_in):
        h = torch.einsum("ecd,edm->ecm", expert_in, ffn1_weight)
        if ffn1_bias is not None:
            h = h + ffn1_bias.reshape(e, 1, -1)
        if gated:
            half = h.shape[-1] // 2
            h = F.silu(h[..., :half]) * h[..., half:]
        else:
            h = F.gelu(h, approximate="tanh")
        out = torch.einsum("ecm,emd->ecd", h, ffn2_weight)
        if ffn2_bias is not None:
            out = out + ffn2_bias.reshape(e, 1, -1)
        return out

    y, _ = routed_ffn(tokens, probs, expert_fn, moe_topk, cap,
                      renormalize=norm_topk_prob)
    return y.to(x.dtype).reshape(orig)


def _rope_one(t, cos, sin, neox):
    """The rotation (``_rope_one`` :407) with full-head_dim tables:
    half-rotation (neox) or interleaved rotate-every-two."""
    if neox:
        h = t.shape[-1] // 2
        rot = torch.cat([-t[..., h:], t[..., :h]], -1)
    else:
        rot = torch.stack([-t[..., 1::2], t[..., 0::2]], -1).reshape(t.shape)
    return t * cos + rot * sin


def _rope_pair(q, k, cos, sin, neox):
    return _rope_one(q, cos, sin, neox), _rope_one(k, cos, sin, neox)


def _expand_rope_tables(cos_h, sin_h, hd, neox):
    """Half-size ([..., hd // 2]) tables -> full head_dim, per style."""
    if cos_h.shape[-1] == hd:
        return cos_h, sin_h
    if neox:
        return torch.cat([cos_h, cos_h], -1), torch.cat([sin_h, sin_h], -1)
    return (cos_h.repeat_interleave(2, -1), sin_h.repeat_interleave(2, -1))


def _quant_cache(x, scales, round_type, qmax, qmin):
    """Per-kv-head static cache quantization: int8 = clip(round(x *
    scale[head]), qmin, qmax); round_type 0 rounds half to even, else half
    away from zero."""
    s = x.float() * scales.reshape(1, -1, 1)
    if round_type == 0:
        r = torch.round(s)
    else:
        r = torch.sign(s) * torch.floor(s.abs() + 0.5)
    return r.clamp(qmin, qmax).to(torch.int8)


def _host(t):
    """A [b] or [b, 1] length tensor as a host numpy vector (a CUDA tensor
    costs a synchronisation, as the JAX package's ``np.asarray`` does)."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy().reshape(-1)
    return np.asarray(t).reshape(-1)


def block_multihead_attention(qkv, key_cache, value_cache, seq_lens_encoder,
                              seq_lens_decoder, seq_lens_this_time,
                              padding_offsets, cum_offsets, cu_seqlens_q,
                              cu_seqlens_k, block_tables, pre_key_cache=None,
                              pre_value_cache=None, cache_k_quant_scales=None,
                              cache_v_quant_scales=None,
                              cache_k_dequant_scales=None,
                              cache_v_dequant_scales=None, qkv_out_scale=None,
                              qkv_bias=None, out_shift=None, out_smooth=None,
                              max_enc_len_this_time=None,
                              max_dec_len_this_time=None, rope_emb=None,
                              mask=None, tgt_mask=None, max_seq_len=-1,
                              block_size=64, use_neox_style=False,
                              use_dynamic_cachekv_quant=False,
                              quant_round_type=1, quant_max_bound=127.0,
                              quant_min_bound=-127.0, out_scale=-1,
                              compute_dtype="default"):
    """Paged (block) KV-cache attention for batched serving (reference:
    incubate/nn/functional/block_multihead_attention.py:30).

    qkv [token_num, (nh + 2 kv_nh) hd], the rows' new tokens back to back;
    caches [max_block_num, kv_nh, block_size, hd]; block_tables [b,
    pages_per_seq]. ``seq_lens_*`` are read on the host (one
    synchronisation for CUDA tensors, as the JAX package's ``np.asarray``).
    Every new token's K/V goes into its row's pages first (in place: the
    caches are updated where they lie, the reference's contract). Then
    encoder rows (seq_lens_encoder > 0) and multi-token continuations run
    causal attention over their prefix and chunk: K1, one call a row, or the
    dense path with ``mask`` ([b, heads, s, ctx] additive); decoder rows
    (one token this time) run one batched K4 call over their pages.

    ``rope_emb`` [2, batch or 1, max_seq, 1, hd // 2] (cos; sin) rotates q
    and the new k at each token's position before the append, neox or
    interleaved. Int8 caches: raw ``int8`` cache tensors with the four
    static per-kv-head scales [kv_nh]; new K/V quantize on append; decode
    folds the K dequant scale into q and the V one into the output (exact:
    per-head scales commute with the softmax) and runs K4 on the int8 pages
    through a unit block-scale table (every (page, kv head) scale KV_QMAX,
    so the kernel's per-block dequant multiplies by 1); prefill rows with a
    prefix dequantize their gathered pages. Returns (out [token_num, nh
    hd], qkv, key_cache, value_cache)."""
    if any(t is not None for t in (qkv_out_scale, out_shift, out_smooth,
                                   pre_key_cache, pre_value_cache)):
        raise NotImplementedError(
            "block_multihead_attention: qkv/out smooth-quant and pre-cache")
    all_scales = (cache_k_quant_scales, cache_v_quant_scales,
                  cache_k_dequant_scales, cache_v_dequant_scales)
    quant = any(t is not None for t in all_scales)
    if use_dynamic_cachekv_quant:
        raise NotImplementedError(
            "block_multihead_attention: dynamic (per-batch) cache-kv quant — "
            "use static per-head scales")
    if quant and any(t is None for t in all_scales):
        raise ValueError("cache quant needs all four k/v quant/dequant scales")

    kc, vc = key_cache, value_cache
    dev = qkv.device
    tables = block_tables.to(torch.int32)
    enc = _host(seq_lens_encoder)
    dec = _host(seq_lens_decoder)
    this_time = _host(seq_lens_this_time)
    b = enc.shape[0]
    kv_nh, hd = kc.shape[1], kc.shape[3]
    nh = qkv.shape[-1] // hd - 2 * kv_nh
    group = nh // kv_nh

    starts = np.concatenate([[0], np.cumsum(this_time)]).astype(np.int64)
    qkv3 = qkv.reshape(-1, nh + 2 * kv_nh, hd)
    if qkv_bias is not None:
        qkv3 = qkv3 + qkv_bias.reshape(1, nh + 2 * kv_nh, hd)
    q_tok = qkv3[:, :nh]                   # [tokens, nh, hd]
    k_tok = qkv3[:, nh:nh + kv_nh]
    v_tok = qkv3[:, nh + kv_nh:]

    seq_ids = np.repeat(np.arange(b), this_time).astype(np.int32)
    pos_in_seq = (np.concatenate(
        [np.arange(t) + (dec[i] if dec[i] > 0 else 0)
         for i, t in enumerate(this_time)]).astype(np.int32)
        if len(seq_ids) else np.zeros(0, np.int32))
    sid = torch.from_numpy(seq_ids).to(dev)
    pos = torch.from_numpy(pos_in_seq).to(dev)

    if rope_emb is not None:
        rot = rope_emb.float()
        if rot.shape[0] != 2 or rot.shape[1] not in (1, b):
            raise ValueError(
                "rope_emb must be [2, batch (or 1), max_seq, 1, head//2] "
                f"(cos;sin), got shape {tuple(rot.shape)}")
        if rot.shape[1] == 1 and b > 1:
            rot = rot.expand((2, b) + tuple(rot.shape[2:]))
        rot = rot.reshape(2, rot.shape[1], -1, rot.shape[-1])
        if len(pos_in_seq) and int(pos_in_seq.max()) >= rot.shape[2]:
            raise ValueError(
                f"rope_emb covers {rot.shape[2]} positions but a token sits "
                f"at position {int(pos_in_seq.max())} — fancy-index clamping "
                "would silently reuse the last row's rotation")
        cos_t, sin_t = rot[0][sid.long(), pos.long()], \
            rot[1][sid.long(), pos.long()]
        cos_t, sin_t = _expand_rope_tables(cos_t, sin_t, hd, use_neox_style)
        qf, kf = _rope_pair(q_tok.float(), k_tok.float(), cos_t[:, None, :],
                            sin_t[:, None, :], use_neox_style)
        q_tok, k_tok = qf.to(q_tok.dtype), kf.to(k_tok.dtype)

    if quant:
        k_store = _quant_cache(k_tok, cache_k_quant_scales.float(),
                               quant_round_type, quant_max_bound,
                               quant_min_bound)
        v_store = _quant_cache(v_tok, cache_v_quant_scales.float(),
                               quant_round_type, quant_max_bound,
                               quant_min_bound)
        ks_d = cache_k_dequant_scales.float()
        vs_d = cache_v_dequant_scales.float()
    else:
        k_store, v_store = k_tok.to(kc.dtype), v_tok.to(vc.dtype)
    append_paged_kv(kc, vc, k_store, v_store, tables, pos, sid)

    out = torch.zeros((qkv3.shape[0], nh, hd), dtype=qkv.dtype, device=dev)

    # decode rows: ONE batched paged-kernel call
    dec_rows = np.nonzero((dec > 0) & (this_time == 1))[0]
    if len(dec_rows):
        ridx = torch.from_numpy(dec_rows.astype(np.int64)).to(dev)
        tok_idx = torch.from_numpy(starts[dec_rows]).to(dev)
        qd = q_tok[tok_idx]                             # [n, nh, hd]
        ctx = torch.from_numpy((dec[dec_rows] + 1).astype(np.int32)).to(dev)
        if quant:
            qd = qd * ks_d.repeat_interleave(group)[None, :, None].to(
                qd.dtype)
            unit = torch.full(tuple(kc.shape[:2]), float(KV_QMAX),
                              dtype=torch.float32, device=dev)
            od = paged_decode_attention(qd, QuantizedKVPool(kc, unit),
                                        QuantizedKVPool(vc, unit),
                                        tables[ridx], ctx)
            od = od * vs_d.repeat_interleave(group)[None, :, None].to(
                od.dtype)
        else:
            od = paged_decode_attention(qd, kc, vc, tables[ridx], ctx)
        out[tok_idx] = od.to(out.dtype)

    # prefill rows and multi-token continuations: the chunk attends the
    # row's cached prefix and itself, end-aligned causal
    page = kc.shape[2]
    chunk_rows = np.nonzero((enc > 0) | ((dec > 0) & (this_time > 1)))[0]
    for i in chunk_rows:
        s0, s1 = int(starts[i]), int(starts[i + 1])
        n_new = s1 - s0
        prefix = int(dec[i]) if dec[i] > 0 else 0
        ctx = prefix + n_new
        qp = q_tok[s0:s1][None]                          # [1, s, nh, hd]
        if prefix:
            kg, vg = gather_paged_kv(kc, vc, tables[i:i + 1],
                                     tables.shape[1] * page)
            kp, vp = kg[:, :ctx], vg[:, :ctx]
            if quant:
                kp = (kp.float() * ks_d.reshape(1, 1, -1, 1)).to(q_tok.dtype)
                vp = (vp.float() * vs_d.reshape(1, 1, -1, 1)).to(q_tok.dtype)
        else:
            kp, vp = k_tok[s0:s1][None], v_tok[s0:s1][None]
        if mask is not None:
            m = mask[i, :, :n_new, :ctx][None]
            logits = torch.einsum(
                "bqnh,bknh->bnqk", qp.float(),
                kp.repeat_interleave(group, 2).float())
            probs = torch.softmax(logits * (hd ** -0.5) + m.float(), -1)
            op = torch.einsum("bnqk,bknh->bqnh", probs,
                              vp.repeat_interleave(group, 2).float())[0]
        else:
            op = flash_attention(qp, kp, vp, causal=True)[0]
        out[s0:s1] = op.to(out.dtype)

    return out.reshape(-1, nh * hd), qkv, key_cache, value_cache
