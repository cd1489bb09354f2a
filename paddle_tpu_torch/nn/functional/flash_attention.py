"""Attention functionals — port of ``paddle_tpu/nn/functional/
flash_attention.py`` on ``torch.Tensor``s in the reference layout, q/k/v
``[batch, seq, num_heads, head_dim]``.

With the ``use_pallas_attention`` flag set (:mod:`paddle_tpu_torch.flags`)
and neither a mask nor dropout, attention runs the port's flash kernel (K1,
and K2/K3 for gradients) through :func:`paddle_tpu_torch.ops.
flash_attention`: on CUDA tensors the kernel, which raises on what it
cannot take (there is no fallback to the plain path, unlike the JAX
module's ``try``), on CPU tensors its plain version. Otherwise the dense
composite ``_xla_attention`` runs, as in the JAX package. ``flashmask_
attention``'s causal LT encodings run the kernels in their row-bound mode
(:func:`paddle_tpu_torch.ops.flash_attention_rowmask`).

Dropout draws its keep mask from ``generator`` (a ``torch.Generator`` on
the tensors' device) or the global generator of that device; its bits
cannot equal ``jax.random``'s. ``scaled_dot_product_attention`` goes
through the op dispatcher as a neutral op, as in the JAX package: under
AMP it runs in the dtype its q/k/v arrive in (the white projections make
them bf16 or fp16), which the kernels take.
"""

from __future__ import annotations

import contextlib

import torch

from ... import flags
from ...core.op_registry import apply_fn
from ...ops import flash_attention as _flash
from ...ops import flash_attention_rowmask
from .common import dropout_train_kernel

_MASKED = -1e9  # the dense path's mask value (the JAX module's)


def _xla_attention(q, k, v, bias=None, causal=False, scale=None,
                   dropout=0.0, generator=None):
    """Dense attention (``_xla_attention`` :19): logits in q's dtype, then
    fp32 with the additive ``bias`` and the end-aligned causal mask at -1e9,
    softmax, probabilities cast to q's dtype, dropout, P V. GQA repeats the
    kv heads."""
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    s = scale if scale is not None else q.shape[-1] ** -0.5
    if kh.shape[1] != qh.shape[1]:
        rep = qh.shape[1] // kh.shape[1]
        kh = kh.repeat_interleave(rep, dim=1)
        vh = vh.repeat_interleave(rep, dim=1)
    logits = (torch.einsum("bhqd,bhkd->bhqk", qh, kh) * s).float()
    if bias is not None:
        logits = logits + bias.float()
    if causal:
        ql, kl = logits.shape[-2], logits.shape[-1]
        mask = torch.ones(ql, kl, dtype=torch.bool,
                          device=q.device).tril(kl - ql)
        logits = torch.where(mask, logits, _MASKED)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout > 0.0:
        probs = dropout_train_kernel(probs, dropout, generator=generator)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vh)
    return out.transpose(1, 2)


def _attention_impl(q, k, v, bias, causal, scale, dropout, generator):
    """The kernel when the flag is set and there is no bias and no dropout,
    else the dense path (``_attention_impl`` :47, without its ``except``:
    a kernel that cannot take its inputs raises)."""
    if flags.get_flag("use_pallas_attention") and bias is None \
            and dropout == 0.0:
        return _flash(q, k, v, causal=causal, scale=scale)
    return _xla_attention(q, k, v, bias, causal, scale, dropout, generator)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None, generator=None):
    """Reference: nn/functional/flash_attention.py:976 (``:59`` in the JAX
    package). A bool ``attn_mask`` keeps True pairs (False -> -1e9); another
    is an additive bias, broadcast against [b, heads, s_q, s_kv]. Dropout
    applies only when ``training``."""
    drop = dropout_p if training else 0.0

    def fn(q, k, v, *mask):
        bias = mask[0] if mask else None
        if bias is not None and bias.dtype == torch.bool:
            bias = torch.where(bias, 0.0, _MASKED)
        return _attention_impl(q, k, v, bias, is_causal, None, drop,
                               generator)

    args = [query, key, value] + ([attn_mask] if attn_mask is not None
                                  else [])
    return apply_fn("scaled_dot_product_attention", fn, *args)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None, rng_name="",
                    training=True, name=None, generator=None):
    """Reference: nn/functional/flash_attention.py:195 (``:75``). Returns
    ``(out, None)``: the softmax is never returned."""
    out = scaled_dot_product_attention(query, key, value, None, dropout,
                                       causal, training, generator=generator)
    return out, None


def flashmask_attention(query, key, value, startend_row_indices=None,
                        dropout=0.0, causal=False, window_size=None,
                        return_softmax_lse=False, return_seed_offset=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None, generator=None):
    """Sparse-mask attention (reference :1098, ``:82`` in the JAX package).
    ``startend_row_indices`` [b, hm, kv_len, {1, 2, 4}] (integers, hm 1 or
    the kv heads):

    - causal, 1 or 2 indices, no dropout: the kernels' row-bound mode, q
      rows in [LT_start, LT_end) hidden from each kv column (LT_end =
      q_len + kv_len for the 1-index form);
    - causal 4-index [LTS, LTE, UTS, UTE] (two bands), non-causal 2-index
      [LTS, UTE] (rows >= LTS or < UTE) and non-causal 4-index (two bands):
      a dense -1e9 bias through :func:`scaled_dot_product_attention`, as in
      the JAX package, which has no kernel for them either;
    - None: :func:`scaled_dot_product_attention`.

    A row whose every column is hidden follows the kernel's or the dense
    path's convention (:func:`paddle_tpu_torch.ops.flash_attention_varlen`).
    """
    if startend_row_indices is None:
        return scaled_dot_product_attention(query, key, value, None, dropout,
                                            causal, training,
                                            generator=generator)
    idx = startend_row_indices
    b, hm, kv_len, nidx = idx.shape
    q_len = query.shape[1]
    if causal and nidx <= 2 and dropout == 0.0:
        start = idx[..., 0]
        end = (idx[..., 1] if nidx >= 2
               else torch.full_like(start, q_len + kv_len))
        return flash_attention_rowmask(query, key, value, start, end, causal)
    if not causal and nidx == 1:
        raise ValueError("flashmask_attention: a non-causal mask takes 2 or "
                         "4 indices per column, got 1")
    rows = torch.arange(q_len, device=idx.device)[None, None, :, None]
    lts = idx[..., 0][:, :, None, :]
    if causal:
        mask = rows >= lts
        if nidx >= 2:
            mask = mask & (rows < idx[..., 1][:, :, None, :])
    elif nidx == 2:
        mask = (rows >= lts) | (rows < idx[..., 1][:, :, None, :])
    else:
        lte = idx[..., 1][:, :, None, :]
        uts = idx[..., 2][:, :, None, :]
        ute = idx[..., 3][:, :, None, :]
        mask = ((rows >= lts) & (rows < lte)) | ((rows >= uts) & (rows < ute))
    bias = torch.where(mask, _MASKED, 0.0)
    return scaled_dot_product_attention(query, key, value, bias, dropout,
                                        causal, training,
                                        generator=generator)


@contextlib.contextmanager
def sdp_kernel(enable_math=True, enable_flash=True, enable_mem_efficient=True):
    """Choose attention's backend inside the block (JAX :138 returns a
    null context): ``enable_flash=False`` turns the ``use_pallas_attention``
    flag off, so attention takes the dense path; with ``enable_math`` also
    off no backend is left, which raises. The port has no third
    ("memory-efficient") backend: the flash kernels are the one that saves
    memory, so ``enable_mem_efficient`` alone selects nothing."""
    if not (enable_flash or enable_math):
        raise ValueError("sdp_kernel: enable_flash and enable_math are both "
                         "off, which leaves no attention backend")
    saved = flags.get_flag("use_pallas_attention")
    if not enable_flash:
        flags.set_flags({"use_pallas_attention": False})
    try:
        yield
    finally:
        flags.set_flags({"use_pallas_attention": saved})
