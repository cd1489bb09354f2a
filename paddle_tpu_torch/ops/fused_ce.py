"""Fused (chunked) linear + softmax cross-entropy for causal-LM training —
port of ``paddle_tpu/ops/fused_ce.py``.

The ``[b, s, V]`` logits are never materialised whole: the sequence is cut
into chunks, and per chunk the lm-head product runs with fp32 output, the
fp32 log-sum-exp reduces it at once, and only the per-position log-sum-exp
``[n, b, c]`` is kept for the backward. The backward recomputes each chunk's
logits (a product is cheaper than keeping them) and forms

    dlogits = (softmax(logits) - onehot(labels)) * valid * g

in fp32, casts it to the hidden dtype, runs ``dhidden = dlogits @ w^T`` in
the model dtype and accumulates ``dW`` across chunks in an fp32 buffer,
cast to ``w.dtype`` once at the end — the JAX package's ``_scan_fwd`` /
``_scan_bwd`` (:66-98). The JAX version is an XLA scan, not a Pallas
kernel, so a Python loop of ``torch.mm`` calls is a full port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _mm_f32(a, b):
    """``a @ b`` of 2-D operands with an fp32 result: the JAX package's
    ``matmul(..., preferred_element_type=float32)``. bf16 operands go
    through ``torch.mm(..., out_dtype=float32)`` (fp32 accumulation and
    output, no bf16 rounding of the result)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    return torch.mm(a, b, out_dtype=torch.float32)


class _ChunkedNLL(torch.autograd.Function):
    """Masked-NLL total over all chunks (``_nll_sum_scan``, :46).

    hidden [b, n*c, h] (already shifted and padded), w [h, V], labels and
    valid [b, n*c]. The Function spans the whole chunk loop so its backward
    owns the fp32 dW accumulator."""

    @staticmethod
    def forward(ctx, hidden, w, labels, valid, chunk):
        b, s, h = hidden.shape
        n = s // chunk
        safe = torch.where(valid > 0, labels, 0).long()
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        logzs = []
        for i in range(n):
            sl = slice(i * chunk, (i + 1) * chunk)
            lg = _mm_f32(hidden[:, sl].reshape(b * chunk, h), w)
            logz = torch.logsumexp(lg, dim=-1)
            picked = lg.gather(1, safe[:, sl].reshape(-1, 1))[:, 0]
            total = total + ((logz - picked) * valid[:, sl].reshape(-1)).sum()
            logzs.append(logz)
        ctx.save_for_backward(hidden, w, safe, valid, torch.stack(logzs))
        ctx.chunk = chunk
        return total

    @staticmethod
    def backward(ctx, g):
        hidden, w, safe, valid, logzs = ctx.saved_tensors
        chunk = ctx.chunk
        b, s, h = hidden.shape
        dhidden = torch.empty_like(hidden)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        for i, logz in enumerate(logzs):
            sl = slice(i * chunk, (i + 1) * chunk)
            hc = hidden[:, sl].reshape(b * chunk, h)
            lg = _mm_f32(hc, w)
            # softmax - onehot, in place: p, then p - 1 at each label
            dlg = lg.sub_(logz[:, None]).exp_()
            dlg.scatter_add_(1, safe[:, sl].reshape(-1, 1),
                             torch.full((b * chunk, 1), -1.0,
                                        dtype=torch.float32,
                                        device=dlg.device))
            dlg.mul_((valid[:, sl].reshape(-1) * g)[:, None])
            dlg = dlg.to(hidden.dtype)
            dhidden[:, sl] = (dlg @ w.T).reshape(b, chunk, h)
            dw += _mm_f32(hc.T, dlg)
        return dhidden, dw.to(w.dtype), None, None, None


def fused_linear_cross_entropy(hidden, w, labels, ignore_index: int = -100,
                               chunk: int = 1024, shift: bool = True):
    """Causal-LM loss ``mean(CE(hidden @ w, labels))`` without materialising
    the ``[b, s, V]`` logits. ``shift=True`` applies the next-token shift
    (logits[:, :-1] against labels[:, 1:]) like
    ``LlamaPretrainingCriterion``. Returns the mean NLL over the positions
    whose label is not ``ignore_index`` (fp32 scalar tensor)."""
    if shift:
        hidden = hidden[:, :-1]
        labels = labels[:, 1:]
    b, s, h = hidden.shape
    chunk = min(int(chunk), s)
    pad = (-s) % chunk
    labels = labels.long()
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=ignore_index)
    valid = (labels != ignore_index).float()
    total = _ChunkedNLL.apply(hidden, w, labels, valid, chunk)
    return total / valid.sum().clamp_min(1.0)
