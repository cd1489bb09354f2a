"""Packed-qkv attention functionals — port of the two in
``paddle_tpu/nn/functional/extras.py`` (:785, :797)."""

from __future__ import annotations

import numpy as np
import torch

from ...ops import flash_attention_varlen
from .flash_attention import flash_attention


def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False, return_softmax=False,
                         name=None, generator=None):
    """Packed-qkv flash attention (reference flash_attention.py
    flash_attn_qkvpacked). qkv: [b, s, 3, h, d]; returns ``(out, None)``."""
    q, k, v = qkv.unbind(2)
    return flash_attention(q, k, v, dropout=dropout, causal=causal,
                           return_softmax=return_softmax,
                           generator=generator)


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
                                max_seqlen_k, scale=None, dropout=0.0,
                                causal=False, return_softmax=False,
                                name=None):
    """Varlen packed flash attention (reference flash_attention.py:792). qkv:
    [total_tokens, 3, h, d], the sequences back to back as ``cu_seqlens_q``
    (prefix sums, [n + 1]) cuts them. One call of the segment-masked kernels
    over the whole packed buffer (:func:`paddle_tpu_torch.ops.
    flash_attention_varlen`): token i belongs to sequence
    ``searchsorted(cu_seqlens_q, i, 'right') - 1``, computed on the host with
    numpy as the JAX package does, so a CUDA ``cu_seqlens_q`` costs one copy
    to the host (a synchronisation). ``cu_seqlens_k``, ``max_seqlen_*`` and
    ``dropout`` are ignored, as there. Returns ``(out [total_tokens, h, d],
    None)``."""
    cu = (cu_seqlens_q.detach().cpu().numpy()
          if isinstance(cu_seqlens_q, torch.Tensor)
          else np.asarray(cu_seqlens_q)).reshape(-1)
    total = qkv.shape[0]
    seg = np.searchsorted(cu, np.arange(total), side="right") - 1
    seg = torch.from_numpy(seg.astype(np.int32)).to(qkv.device)[None]
    q, k, v = qkv[None, :, 0], qkv[None, :, 1], qkv[None, :, 2]
    out = flash_attention_varlen(q, k, v, seg, seg, causal,
                                 None if scale is None else float(scale))
    return out[0], None
