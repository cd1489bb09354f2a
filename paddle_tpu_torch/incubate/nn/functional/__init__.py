"""Fused functionals — port of ``paddle_tpu/incubate/nn/functional/
__init__.py`` on ``torch.Tensor``s, each through the op dispatcher under the
JAX package's op name where the JAX function dispatches one:

- :func:`block_multihead_attention` (:561): paged-KV attention for batched
  serving. Decode rows take one batched call of the paged decode kernel
  (K4, :func:`paddle_tpu_torch.ops.paged_decode_attention`), prefill and
  multi-token rows one flash kernel call (K1, causal) each over their
  gathered prefix; on CPU tensors both run their plain versions.
- :func:`fused_moe` (:152): top-k routing, the experts' FFN as batched
  einsums (the JAX package's XLA products, no Pallas kernel there) and the
  combine, through the port's ``routed_ffn``.
- the norms, ``swiglu``, the rotary embedding, the bias/activation and
  linear fusions, ``fused_dropout_add`` and
  ``fused_bias_dropout_residual_layer_norm`` (:19-140, :212, :752-785):
  the same arithmetic as the JAX functions, torch ops where XLA fuses.
- :func:`fused_multi_head_attention` (:216), :func:`fused_feedforward`
  (:335) and :func:`masked_multihead_attention` (:447): dense attention
  with their own fp32 softmax, as in JAX (no kernel there either); the
  cache tensors they are given are written in place.
- :func:`fused_multi_transformer` (:787) and
  :func:`variable_length_memory_efficient_attention` (:557) attend through
  the port's ``nn.functional.scaled_dot_product_attention``: without a mask
  that is the flash kernel (K1) on CUDA tensors, causal and end-aligned, in
  the prefill and in every cached decode step, exactly where the JAX
  functions reach ``pallas_call``.

Dropout draws from the port's generator of the tensor's device (its bits
cannot equal ``jax.random``'s). Arguments the JAX functions take and ignore
(``fused_rms_norm``'s ``bias``, a ``scale`` or ``seq_lens`` that would
change the result) raise here. A public name of the JAX module that the
port lacks raises ``later_slice``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ...._later import later_slice
from ....core.op_registry import apply_fn
from ....core.tensor import unwrap
from ....nn import functional as PF
from ....nn.functional.common import dropout_train_kernel
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


# ---------------------------------------------------------------------------
# norms, swiglu, rotary embedding (:19-120)
# ---------------------------------------------------------------------------

def _refuse_ignored(fname, **given):
    """Raise for an argument the JAX function takes and ignores."""
    for arg, val in given.items():
        if val:
            raise NotImplementedError(
                f"{fname}({arg}=...) is not supported: the JAX package "
                f"takes the argument and ignores it")


def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1, bias=None, residual=None,
                   quant_scale=-1, **kw):
    """(:19) ``x (+ residual)`` normalised over the last axis in fp32, cast
    back, times ``norm_weight`` (+ ``norm_bias``)."""
    _refuse_ignored("fused_rms_norm", bias=bias is not None,
                    quant_scale=quant_scale != -1,
                    begin_norm_axis=begin_norm_axis not in (-1, x.ndim - 1))

    def fn(a, w, *rest):
        i = 0
        if residual is not None:
            a = a + rest[0]
            i = 1
        af = a.float()
        ms = af.square().mean(-1, keepdim=True)
        out = (af * torch.rsqrt(ms + epsilon)).to(a.dtype) * w
        if norm_bias is not None:
            out = out + rest[i]
        return out

    args = [x, norm_weight] + [t for t in (residual, norm_bias)
                               if t is not None]
    return apply_fn("fused_rms_norm", fn, *args)


def fused_layer_norm(x, norm_weight, norm_bias, epsilon=1e-5,
                     begin_norm_axis=-1, bias=None, residual=None, **kw):
    """(:43) layer norm of ``x (+ residual)`` over the axes from
    ``begin_norm_axis``."""
    _refuse_ignored("fused_layer_norm", bias=bias is not None)
    if residual is not None:
        x = x + residual
    shape = (x.shape[begin_norm_axis:] if begin_norm_axis != -1
             else [x.shape[-1]])
    return PF.layer_norm(x, list(shape), norm_weight, norm_bias, epsilon)


def swiglu(x, y=None, name=None):
    """(:51) ``silu(x) * y``; without ``y`` the two halves of ``x``."""
    if y is None:
        def fn(a):
            a1, a2 = torch.chunk(a, 2, dim=-1)
            return F.silu(a1) * a2

        return apply_fn("swiglu", fn, x)
    return apply_fn("swiglu", lambda a, b: F.silu(a) * b, x, y)


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True,
                                    time_major=False,
                                    rotary_emb_base=10000.0):
    """(:62) q/k/v ``[batch, seq, heads, head_dim]``; ``sin``/``cos`` given
    ([seq, dim] or [1, seq, 1, dim]) or made from ``rotary_emb_base`` in
    fp32 and cast to q's dtype; ``position_ids`` [b, s] pick their rows.
    Returns a triple with None where an input was None."""
    _refuse_ignored("fused_rotary_position_embedding", time_major=time_major)
    tensors = [t for t in (q, k, v) if t is not None]

    def make_sincos(seq_len, dim, dtype, device):
        inv = 1.0 / (rotary_emb_base ** (torch.arange(
            0, dim, 2, dtype=torch.float32, device=device) / dim))
        tpos = torch.arange(seq_len, dtype=torch.float32, device=device)
        freqs = torch.outer(tpos, inv)
        emb = (torch.cat([freqs, freqs], -1) if use_neox_rotary_style
               else freqs.repeat_interleave(2, -1))
        return (emb.sin().to(dtype)[None, :, None, :],
                emb.cos().to(dtype)[None, :, None, :])

    def fn(*arrs):
        n_t = len(tensors)
        main, extra = arrs[:n_t], arrs[n_t:]
        if sin is not None:
            s, c = extra[0], extra[1]
            if s.ndim == 2:
                s, c = s[None, :, None, :], c[None, :, None, :]
        else:
            s, c = make_sincos(main[0].shape[1], main[0].shape[-1],
                               main[0].dtype, main[0].device)
        if position_ids is not None:
            pid = extra[-1].long()
            s = s[0, :, 0, :][pid][:, :, None, :]
            c = c[0, :, 0, :][pid][:, :, None, :]
        return tuple(_rope_one(t, c, s, use_neox_rotary_style)
                     for t in main)

    args = tensors + [t for t in (sin, cos) if t is not None]
    if position_ids is not None:
        args = args + [position_ids]
    res = apply_fn("fused_rope", fn, *args)
    res = iter(res if isinstance(res, (tuple, list)) else [res])
    return tuple(next(res) if t is not None else None for t in (q, k, v))


# ---------------------------------------------------------------------------
# bias / activation / linear fusions (:122-140, :212, :752-785)
# ---------------------------------------------------------------------------

def _hard_sigmoid(a):
    return F.relu6(a + 3.0) / 6.0


# ``jax.nn``'s activations by name (``fused_linear_activation`` and
# ``fused_feedforward`` look theirs up there): gelu is the tanh form,
# leaky_relu's slope 0.01, celu's alpha 1
_JAX_NN = {
    "relu": F.relu, "relu6": F.relu6, "silu": F.silu, "swish": F.silu,
    "gelu": lambda a: F.gelu(a, approximate="tanh"),
    "sigmoid": torch.sigmoid, "tanh": torch.tanh, "softplus": F.softplus,
    "elu": F.elu, "selu": F.selu, "celu": F.celu, "mish": F.mish,
    "leaky_relu": lambda a: F.leaky_relu(a, 0.01),
    "hard_tanh": lambda a: a.clamp(-1.0, 1.0),
    "hard_sigmoid": _hard_sigmoid,
    "hard_swish": lambda a: a * _hard_sigmoid(a),
    "hard_silu": lambda a: a * _hard_sigmoid(a),
    "log_sigmoid": F.logsigmoid, "soft_sign": F.softsign,
    "identity": lambda a: a,
}


def _jax_nn_act(name, fname):
    act = _JAX_NN.get(name)
    if act is None:
        raise ValueError(f"{fname}: unknown activation {name!r} (one of "
                         f"{sorted(_JAX_NN)})")
    return act


def fused_bias_act(x, bias=None, act_method="gelu", **kw):
    """(:122) the Paddle activation ``act_method`` of ``x (+ bias)``."""
    if bias is not None:
        x = x + bias
    return getattr(PF, act_method)(x)


def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    """(:128) ``x @ weight (+ bias)``, weight [in, out] or, transposed,
    [out, in]."""
    def fn(a, w, *b):
        out = torch.matmul(a, w.t() if transpose_weight else w)
        return out + b[0] if b else out

    args = [x, weight] + ([bias] if bias is not None else [])
    return apply_fn("fused_linear", fn, *args)


def fused_linear_activation(x, y, bias, trans_x=False, trans_y=False,
                            activation="gelu"):
    """(:140) ``act(x @ y + bias)`` with ``jax.nn``'s activation of that
    name ("none" the identity)."""
    act = _jax_nn_act("identity" if activation == "none" else activation,
                      "fused_linear_activation")

    def fn(a, w, b):
        a = a.t() if trans_x else a
        w = w.t() if trans_y else w
        return act(torch.matmul(a, w) + b)

    return apply_fn("fused_linear_activation", fn, x, y, bias)


def fused_dropout_add(x, y, p=0.5, training=True, mode="upscale_in_train",
                      name=None):
    """(:212) ``dropout(x) + y``."""
    return PF.dropout(x, p, training=training, mode=mode) + y


def fused_matmul_bias(x, y, bias=None, transpose_x=False, transpose_y=False,
                      name=None):
    """(:752) ``x @ y (+ bias)``, either operand transposed on its last two
    axes."""
    def fn(a, w, *b):
        if transpose_x:
            a = a.transpose(-1, -2)
        if transpose_y:
            w = w.transpose(-1, -2)
        out = torch.matmul(a, w)
        return out + b[0] if b else out

    args = [x, y] + ([bias] if bias is not None else [])
    return apply_fn("fused_matmul_bias", fn, *args)


def fused_bias_dropout_residual_layer_norm(x, residual, bias=None,
                                           ln_scale=None, ln_bias=None,
                                           dropout_rate=0.5, ln_epsilon=1e-5,
                                           training=True,
                                           mode="upscale_in_train",
                                           name=None):
    """(:770) ``layer_norm(dropout(x + bias) + residual)``."""
    h = x if bias is None else apply_fn("bias_add", lambda a, b: a + b, x,
                                        bias)
    h = PF.dropout(h, p=dropout_rate, training=training, mode=mode)
    h = h + residual
    return PF.layer_norm(h, list(h.shape[-1:]), weight=ln_scale, bias=ln_bias,
                         epsilon=ln_epsilon)


# ---------------------------------------------------------------------------
# attention blocks with their own softmax (:216, :335, :447)
# ---------------------------------------------------------------------------

def _ln_plain(t, scale, bias, eps):
    """The JAX blocks' inline layer norm: (t - mean) rsqrt(var + eps) in
    t's dtype, then ``* scale + bias``."""
    var, mean = torch.var_mean(t, -1, correction=0, keepdim=True)
    out = (t - mean) * torch.rsqrt(var + eps)
    return out * scale + bias if scale is not None else out


def _drop(t, rate, training):
    return dropout_train_kernel(t, rate) if rate and training else t


def _additive_mask(m):
    """A bool (keep) or integer (nonzero keeps) mask as 0 / -1e9; a float
    one as it is."""
    if m.dtype == torch.bool:
        return torch.where(m, 0.0, -1e9)
    if not m.dtype.is_floating_point:
        return torch.where(m != 0, 0.0, -1e9)
    return m


def fused_multi_head_attention(x, qkv_weight, linear_weight,
                               pre_layer_norm=False, pre_ln_scale=None,
                               pre_ln_bias=None, ln_scale=None, ln_bias=None,
                               pre_ln_epsilon=1e-5, qkv_bias=None,
                               linear_bias=None, cache_kv=None,
                               attn_mask=None, dropout_rate=0.5,
                               attn_dropout_rate=0.5, ln_epsilon=1e-5,
                               training=True, mode="upscale_in_train",
                               ring_id=-1, add_residual=True, num_heads=-1,
                               transpose_qkv_wb=False, name=None):
    """(:216) x [b, s, dim]; qkv_weight [3, nh, hd, dim] (or [dim, 3 dim]
    with ``transpose_qkv_wb`` and ``num_heads``). A ``cache_kv`` [2, b, nh,
    cache_len, hd] gets this call's K/V appended: the tensor is rebound to
    the longer cache (the reference's in-place contract) and returned with
    the output. Logits in fp32 scaled by hd^-0.5, plus the mask, softmax
    cast to x's dtype, attention dropout, projection, dropout, residual,
    post-LN unless ``pre_layer_norm``."""
    dim0 = x.shape[-1]
    dev = x.device

    def zeros():
        return torch.zeros((dim0,), dtype=torch.float32, device=dev)

    opt = []
    if pre_layer_norm and pre_ln_scale is not None:
        opt += [("pls", pre_ln_scale),
                ("plb", pre_ln_bias if pre_ln_bias is not None
                 else zeros())]
    if qkv_bias is not None:
        opt += [("qb", qkv_bias)]
    if linear_bias is not None:
        opt += [("lb", linear_bias)]
    if cache_kv is not None:
        opt += [("cache", cache_kv)]
    if attn_mask is not None:
        opt += [("mask", attn_mask)]
    if not pre_layer_norm and ln_scale is not None:
        opt += [("lns", ln_scale),
                ("lnb", ln_bias if ln_bias is not None else zeros())]
    names = [n for n, _ in opt]

    def fn(xx, qkvw, lw, *rest):
        r = dict(zip(names, rest))
        b, s, dim = xx.shape
        h = xx
        if pre_layer_norm:
            h = _ln_plain(h, r.get("pls"), r.get("plb"), pre_ln_epsilon)
        if transpose_qkv_wb:
            if num_heads is None or num_heads <= 0:
                raise ValueError(
                    "fused_multi_head_attention(transpose_qkv_wb=True) "
                    "requires num_heads (the 2-D qkv weight cannot infer it)")
            nh = num_heads
            qkv = torch.matmul(h, qkvw)
            if "qb" in r:
                qkv = qkv + r["qb"]
            qkv = qkv.reshape(b, s, 3, nh, dim // nh)
        else:
            nh, hd = qkvw.shape[1], qkvw.shape[2]
            qkv = torch.einsum("bsd,tnhd->bstnh", h, qkvw)
            if "qb" in r:
                qkv = qkv + r["qb"][None, None]
        hd = qkv.shape[-1]
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        new_cache = None
        if "cache" in r:
            k = torch.cat([r["cache"][0], k], dim=2)
            v = torch.cat([r["cache"][1], v], dim=2)
            new_cache = torch.stack([k, v])
        logits = torch.einsum("bnqh,bnkh->bnqk", q, k).float() * hd ** -0.5
        if "mask" in r:
            logits = logits + _additive_mask(r["mask"]).float()
        probs = torch.softmax(logits, -1).to(xx.dtype)
        probs = _drop(probs, attn_dropout_rate, training)
        ctx = torch.einsum("bnqk,bnkh->bnqh", probs, v)
        out = torch.matmul(ctx.transpose(1, 2).reshape(b, s, dim), lw)
        if "lb" in r:
            out = out + r["lb"]
        out = _drop(out, dropout_rate, training)
        if add_residual:
            out = xx + out
        if not pre_layer_norm:
            out = _ln_plain(out, r.get("lns"), r.get("lnb"), ln_epsilon)
        return (out, new_cache) if new_cache is not None else out

    res = apply_fn("fused_multi_head_attention", fn,
                   x, qkv_weight, linear_weight, *[t for _, t in opt])
    if cache_kv is None:
        return res
    out, new_cache = res
    cache_kv.data = unwrap(new_cache).detach()   # the in-place contract
    return out, cache_kv


def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu", ln1_epsilon=1e-5,
                      ln2_epsilon=1e-5, pre_layer_norm=False, training=True,
                      mode="upscale_in_train", ring_id=-1, add_residual=True,
                      name=None):
    """(:335) [LN ->] linear1 -> ``jax.nn``'s ``activation`` -> dropout1 ->
    linear2 -> dropout2 -> + residual [-> LN]."""
    act = _jax_nn_act(activation, "fused_feedforward")
    dim0 = x.shape[-1]
    dev = x.device

    def zeros():
        return torch.zeros((dim0,), dtype=torch.float32, device=dev)

    opt = []
    if linear1_bias is not None:
        opt += [("b1", linear1_bias)]
    if linear2_bias is not None:
        opt += [("b2", linear2_bias)]
    if ln1_scale is not None:
        opt += [("s1", ln1_scale),
                ("bb1", ln1_bias if ln1_bias is not None else zeros())]
    if ln2_scale is not None:
        opt += [("s2", ln2_scale),
                ("bb2", ln2_bias if ln2_bias is not None else zeros())]
    names = [n for n, _ in opt]

    def fn(xx, w1, w2, *rest):
        r = dict(zip(names, rest))
        h = xx
        if pre_layer_norm:
            h = _ln_plain(h, r.get("s1"), r.get("bb1"), ln1_epsilon)
        h = torch.matmul(h, w1)
        if "b1" in r:
            h = h + r["b1"]
        h = _drop(act(h), dropout1_rate, training)
        h = torch.matmul(h, w2)
        if "b2" in r:
            h = h + r["b2"]
        h = _drop(h, dropout2_rate, training)
        if add_residual:
            h = xx + h
        if not pre_layer_norm:
            h = _ln_plain(h, r.get("s2"), r.get("bb2"), ln2_epsilon)
        return h

    return apply_fn("fused_feedforward", fn, x, linear1_weight,
                    linear2_weight, *[t for _, t in opt])


def masked_multihead_attention(x, cache_kv=None, bias=None, src_mask=None,
                               cum_offsets=None, sequence_lengths=None,
                               rotary_tensor=None, beam_cache_offset=None,
                               qkv_out_scale=None, out_shift=None,
                               out_smooth=None, seq_len=1, rotary_emb_dims=0,
                               use_neox_rotary_style=False,
                               compute_dtype="default", out_scale=-1,
                               quant_round_type=1, quant_max_bound=127.0,
                               quant_min_bound=-127.0):
    """(:447) one new token a row over a dense cache: x [b, 3 nh hd];
    cache_kv [2, b, nh, max_seq, hd] (written in place at each row's
    position); ``sequence_lengths`` [b] or [b, 1] the positions; attention
    over 0..len inclusive in fp32, ``src_mask`` added, rope
    (``rotary_emb_dims=1``, ``rotary_tensor`` [2, b or 1, seq, 1, hd or
    hd / 2], cos then sin) on q and the new k. Returns (out [b, nh hd],
    cache_kv[, beam_cache_offset]). Quantization and ``rotary_emb_dims=2``
    raise, as in JAX."""
    if qkv_out_scale is not None or out_scale != -1:
        raise NotImplementedError("masked_multihead_attention quantization")
    if rotary_emb_dims not in (0, 1):
        raise NotImplementedError(
            "masked_multihead_attention rotary_emb_dims=2 (pos_ids_extra "
            "2-section rope) is not supported")
    if rotary_emb_dims and rotary_tensor is None:
        raise ValueError("rotary_emb_dims=1 requires rotary_tensor")
    if sequence_lengths is None:
        raise ValueError(
            "masked_multihead_attention requires sequence_lengths (each "
            "row's current cache length / write position)")
    if rotary_emb_dims and cache_kv is not None:
        rshape = rotary_tensor.shape
        seq_axis = int(np.prod(rshape[2:-1]))
        max_seq_c = cache_kv.shape[3]
        if 1 < seq_axis < max_seq_c:
            raise ValueError(
                f"rotary_tensor covers {seq_axis} positions but the cache "
                f"holds up to {max_seq_c} — decode positions past the table "
                "would silently clamp to the last row's rotation")
    opt = []
    if bias is not None:
        opt += [("bias", bias)]
    if src_mask is not None:
        opt += [("mask", src_mask)]
    if rotary_emb_dims:
        opt += [("rope", rotary_tensor)]
    names = [n for n, _ in opt]

    def fn(xx, cache, lens, *rest):
        r = dict(zip(names, rest))
        _, b, nh, max_seq, hd = cache.shape
        qkv = xx.reshape(b, 3, nh, hd)
        if "bias" in r:
            qkv = qkv + r["bias"].reshape(1, 3, nh, hd)
        q, k_new, v_new = qkv[:, 0], qkv[:, 1], qkv[:, 2]
        pos = lens.reshape(b).long()
        bidx = torch.arange(b, device=xx.device)
        if "rope" in r:
            rot = r["rope"]
            if rot.shape[0] != 2 or rot.shape[1] not in (1, b):
                raise ValueError(
                    "rotary_tensor must be [2, batch (or 1), seq, 1, "
                    f"head_dim] (cos;sin), got shape {tuple(rot.shape)}")
            if rot.shape[1] == 1 and b > 1:
                rot = rot.expand((2, b) + tuple(rot.shape[2:]))
            rot = rot.reshape(2, b, -1, rot.shape[-1]).float()
            if rot.shape[2] > 1:
                cos_t, sin_t = rot[0][bidx, pos], rot[1][bidx, pos]
            else:
                cos_t, sin_t = rot[0][:, 0], rot[1][:, 0]
            cos_t, sin_t = _expand_rope_tables(cos_t, sin_t, hd,
                                               use_neox_rotary_style)
            qf, kf = _rope_pair(q.float(), k_new.float(), cos_t[:, None, :],
                                sin_t[:, None, :], use_neox_rotary_style)
            q, k_new = qf.to(q.dtype), kf.to(k_new.dtype)
        # the new token's K/V into the cache where it lies
        cache[0][bidx, :, pos] = k_new.to(cache.dtype)
        cache[1][bidx, :, pos] = v_new.to(cache.dtype)
        kc, vc = cache[0], cache[1]
        logits = torch.einsum("bnh,bnsh->bns", q.float(),
                              kc.float()) * hd ** -0.5
        valid = (torch.arange(max_seq, device=xx.device)[None, None, :]
                 <= pos[:, None, None])
        logits = torch.where(valid, logits, -1e30)
        if "mask" in r:
            m = r["mask"].reshape(b, 1, -1).float()
            logits = logits + F.pad(m, (0, max_seq - m.shape[-1]))
        probs = torch.softmax(logits, -1)
        out = torch.einsum("bns,bnsh->bnh", probs, vc.float())
        return out.reshape(b, nh * hd).to(xx.dtype)

    out = apply_fn("masked_multihead_attention", fn, x, cache_kv,
                   sequence_lengths, *[t for _, t in opt])
    if beam_cache_offset is not None:
        return out, cache_kv, beam_cache_offset
    return out, cache_kv


# ---------------------------------------------------------------------------
# attention through scaled_dot_product_attention (:557, :787)
# ---------------------------------------------------------------------------

def _full_lengths(lens, n):
    """Do the per-row lengths ``lens`` (a host read) all equal ``n``?"""
    a = lens.detach().cpu().numpy() if isinstance(lens, torch.Tensor) \
        else np.asarray(lens)
    return bool((a.reshape(-1) == n).all())


def variable_length_memory_efficient_attention(q, k, v, seq_lens=None,
                                               kv_seq_lens=None, mask=None,
                                               scale=None, causal=False):
    """(:557) ``scaled_dot_product_attention(q, k, v, mask, causal)`` over
    [b, s, heads, head_dim]: the flash kernel (K1) without a mask. The JAX
    function ignores ``seq_lens``, ``kv_seq_lens`` and ``scale``; here
    lengths shorter than the sequence (a host read) and a scale other than
    head_dim^-0.5 raise."""
    if scale is not None and not math.isclose(float(scale),
                                              q.shape[-1] ** -0.5):
        raise NotImplementedError(
            "variable_length_memory_efficient_attention(scale=...) other "
            "than head_dim^-0.5: the JAX package ignores it")
    for name, lens, n in (("seq_lens", seq_lens, q.shape[1]),
                          ("kv_seq_lens", kv_seq_lens, k.shape[1])):
        if lens is not None and not _full_lengths(lens, n):
            raise NotImplementedError(
                f"variable_length_memory_efficient_attention({name}=...) "
                f"shorter than the sequence: the JAX package ignores it")
    return PF.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                           is_causal=causal)


def fused_multi_transformer(x, ln_scales, ln_biases, qkv_weights,
                            qkv_biases, linear_weights, linear_biases,
                            ffn_ln_scales, ffn_ln_biases, ffn1_weights,
                            ffn1_biases, ffn2_weights, ffn2_biases,
                            pre_layer_norm=True, epsilon=1e-5,
                            cache_kvs=None, time_step=None, attn_mask=None,
                            dropout_rate=0.0, activation="gelu",
                            training=False, mode="upscale_in_train",
                            trans_qkvw=True, ring_id=-1, num_heads=None,
                            name=None):
    """(:787) stacked transformer layers (the GPT inference megakernel's
    API): LN -> qkv -> attention -> projection -> + residual -> LN -> FFN
    (Paddle's exact gelu, or relu) -> + residual, pre- or post-LN.
    ``num_heads`` is required. Attention is
    ``scaled_dot_product_attention``, causal when ``attn_mask`` is None:
    K1 on CUDA tensors.

    ``cache_kvs``: per-layer dense caches [2, b, nh, max_seq, hd], written
    in place. ``time_step=None`` prefills positions 0..s-1; a step (an int
    or a tensor, read on the host) writes this chunk there and attends over
    the cache prefix through it (end-aligned causal: one query row over
    the longer key)."""
    if num_heads is None:
        raise ValueError("fused_multi_transformer requires num_heads")
    pos0 = 0
    if time_step is not None:
        pos0 = (time_step if isinstance(time_step, int)
                else int(np.asarray(
                    time_step.detach().cpu() if isinstance(
                        time_step, torch.Tensor) else time_step
                ).reshape(-1)[0]))

    def drop(t):
        if dropout_rate and training:
            return PF.dropout(t, p=dropout_rate, training=True, mode=mode)
        return t

    def ln(t, w, b):
        return PF.layer_norm(t, list(t.shape[-1:]), weight=w, bias=b,
                             epsilon=epsilon)

    h = x
    for i in range(len(qkv_weights)):
        res = h
        a_in = ln(h, ln_scales[i], ln_biases[i]) if pre_layer_norm else h
        qkv = fused_matmul_bias(a_in, qkv_weights[i], qkv_biases[i],
                                transpose_y=trans_qkvw)
        d = qkv.shape[-1] // 3
        nh = num_heads
        hd = d // nh
        q, k, v = unwrap(qkv).split(d, dim=-1)
        b, s = q.shape[0], q.shape[1]
        q4, k4, v4 = (t.reshape(b, s, nh, hd) for t in (q, k, v))
        if cache_kvs is not None:
            # this chunk into positions pos0..pos0+s-1, in place
            cache = unwrap(cache_kvs[i])
            cache[0, :, :, pos0:pos0 + s] = k4.transpose(1, 2).to(
                cache.dtype)
            cache[1, :, :, pos0:pos0 + s] = v4.transpose(1, 2).to(
                cache.dtype)
            k4 = cache[0, :, :, :pos0 + s].transpose(1, 2)
            v4 = cache[1, :, :, :pos0 + s].transpose(1, 2)
        attn = PF.scaled_dot_product_attention(q4, k4, v4,
                                               attn_mask=attn_mask,
                                               is_causal=attn_mask is None)
        out = drop(fused_matmul_bias(unwrap(attn).reshape(b, s, d),
                                     linear_weights[i], linear_biases[i]))
        h = res + out
        if not pre_layer_norm:
            h = ln(h, ln_scales[i], ln_biases[i])
        res2 = h
        f_in = (ln(h, ffn_ln_scales[i], ffn_ln_biases[i]) if pre_layer_norm
                else h)
        f1 = fused_matmul_bias(f_in, ffn1_weights[i], ffn1_biases[i])
        f1 = PF.gelu(f1) if activation == "gelu" else PF.relu(f1)
        h = res2 + drop(fused_matmul_bias(f1, ffn2_weights[i],
                                          ffn2_biases[i]))
        if not pre_layer_norm:
            h = ln(h, ffn_ln_scales[i], ffn_ln_biases[i])
    return h


# every public name of the JAX module (tests/test_torch_surface.py holds
# the list); one the port lacks raises, naming its slice
_LATER = {}


def __getattr__(name):
    if name in _LATER:
        raise later_slice(f"paddle_tpu_torch.incubate.nn.functional.{name}",
                          *_LATER[name])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
