"""The long tail of ``nn.functional`` — port of ``paddle_tpu/nn/functional/
extras.py``: max pooling with its mask and the unpools, the fractional
pools, the long-tail losses (soft-margin, multi-margin, Poisson and
Gaussian NLL, pairwise distance and the triplet loss over it, n-pair,
margin cross entropy), the CTC and RNN-T losses, hierarchical sigmoid,
the adaptive softmax, ``affine_grid`` / ``grid_sample``, ``gather_tree``,
``temporal_shift``, ``class_center_sample``, ``sparse_attention``,
``sequence_mask``, the in-place activations, and the packed-qkv flash
attention entry points (PR 11).

None of these reaches a Pallas kernel in the JAX package (the CTC and RNN-T
recursions are ``lax.scan``s, sparse attention a dense masked softmax);
the port runs torch's own ops: ``F.ctc_loss`` (cuDNN or ATen's kernels)
behind JAX's log-softmax, the RNN-T lattice one anti-diagonal a step, and
gathers for the samplers and pools. Each function goes through the op
dispatcher under the JAX package's op name, neutral under AMP as there.

Where the JAX package ignores an argument the port gives Paddle's meaning
when torch has it in one call (``ctc_loss(norm_by_times=)``, the
fractional pools' ``return_mask``, ``affine_grid`` on 5-D shapes) and
raises ``later_slice`` otherwise (the fractional pools' ``kernel_size``,
a process ``group``). Random draws (``feature_alpha_dropout``,
``class_center_sample``, a fractional pool's ``random_u`` when not given)
come from the port's ``torch.Generator``s, never ``jax.random``'s bits.
Departures from the JAX values are listed with each function.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..._later import later_slice
from ...core.op_registry import apply_fn
from ...core.tensor import Tensor, unwrap
from ...framework.random import generator as global_generator
from ...ops import flash_attention_varlen
from .flash_attention import flash_attention

__all__ = [
    "max_pool2d_with_mask", "max_unpool1d", "max_unpool2d", "max_unpool3d",
    "soft_margin_loss", "multi_label_soft_margin_loss", "multi_margin_loss",
    "poisson_nll_loss", "gaussian_nll_loss",
    "triplet_margin_with_distance_loss", "pairwise_distance", "ctc_loss",
    "rnnt_loss", "hsigmoid_loss", "softmax_2d", "feature_alpha_dropout",
    "sequence_mask", "zeropad2d", "fractional_max_pool2d",
    "fractional_max_pool3d", "npair_loss", "margin_cross_entropy",
    "affine_grid", "grid_sample", "gather_tree", "temporal_shift",
    "class_center_sample", "sparse_attention",
    "adaptive_log_softmax_with_loss", "flash_attn_qkvpacked",
    "flash_attn_varlen_qkvpacked",
    "elu_", "hardtanh_", "leaky_relu_", "tanh_", "thresholded_relu_",
]

NEG = -1e30   # the JAX recursions' finite log zero


def _tup(v, n):
    return tuple(int(u) for u in v) if isinstance(v, (tuple, list)) \
        else (int(v),) * n


def _reduce(v, reduction):
    if reduction == "mean":
        return v.mean()
    if reduction == "sum":
        return v.sum()
    return v


def _host(v):
    """``v`` (a tensor, Paddle's or plain, or array-like) in numpy."""
    if isinstance(v, torch.Tensor):
        return unwrap(v).detach().cpu().numpy()
    return np.asarray(v)


def _no_group(group, what):
    if group not in (None, False):
        raise later_slice(f"{what}(group=...) over several processes",
                          "distributed training", "6")


# ---------------------------------------------------------------------------
# max pool with indices, unpool (:41-131)
# ---------------------------------------------------------------------------

def max_pool2d_with_mask(x, kernel_size, stride=None, padding=0):
    """``(out, mask)``: the max pool and the int32 flat index of each
    window's maximum in its (sample, channel) map (unpadded coordinates,
    the first maximum of a window, as JAX's argmax)."""
    kernel = _tup(kernel_size, 2)
    stride = _tup(stride or kernel, 2)
    pad = _tup(padding, 2)

    def fn(a):
        out, idx = F.max_pool2d(a, kernel, stride, pad, return_indices=True)
        return out, idx.int()

    return apply_fn("max_pool_with_mask", fn, x)


def _unpool(x, indices, n, kernel, stride, padding, output_size,
            data_format):
    layout = ("NCL", "NCHW", "NCDHW")[n - 1]
    if data_format != layout:
        raise ValueError(f"max_unpool{n}d takes {layout} only, not "
                         f"{data_format!r}")
    kernel = _tup(kernel, n)
    stride = _tup(stride or kernel, n)
    pad = _tup(padding, n)

    def fn(a, idx):
        N, C = a.shape[:2]
        if output_size is not None:
            out_sp = tuple(int(s) for s in output_size)[-n:]
        else:
            out_sp = tuple((a.shape[2 + d] - 1) * stride[d] - 2 * pad[d]
                           + kernel[d] for d in range(n))
        flat = a.new_zeros(N, C, int(np.prod(out_sp)))
        # a scatter as JAX's .set: duplicate indices keep one of their
        # values, which one undefined in both packages
        flat = flat.scatter(2, idx.reshape(N, C, -1).long(),
                            a.reshape(N, C, -1))
        return flat.reshape((N, C) + out_sp)

    return apply_fn("max_unpool", fn, x, indices)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCL", name=None):
    return _unpool(x, indices, 1, kernel_size, stride, padding, output_size,
                   data_format)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCHW", name=None):
    return _unpool(x, indices, 2, kernel_size, stride, padding, output_size,
                   data_format)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCDHW", name=None):
    return _unpool(x, indices, 3, kernel_size, stride, padding, output_size,
                   data_format)


def _fractional_bounds(in_size, out_size, u):
    """JAX's interval boundaries (``FractionalMaxPool2D._boundaries``,
    nn/layer/extras.py:199-214): ``ceil(alpha (i + u))``, alpha = in /
    out, clamped so every interval is non-empty."""
    alpha = in_size / out_size
    b = [0]
    for i in range(1, out_size):
        v = int(math.ceil(alpha * (i + u)))
        b.append(min(max(v, i), in_size - (out_size - i)))
    b.append(in_size)
    return b


def _fractional_pool(x, output_size, kernel_size, random_u, return_mask, n):
    if kernel_size is not None:
        raise later_slice("fractional_max_pool with kernel_size "
                          "(overlapping windows)", "Paddle API surface", "8")
    out_size = _tup(output_size, n)
    spatial = tuple(x.shape[2:])
    if any(o > i or o < 1 for o, i in zip(out_size, spatial)):
        raise ValueError(f"fractional_max_pool: output size {out_size} "
                         f"must lie in [1, input size {spatial}]")
    gen = global_generator(torch.device("cpu"))
    us = [float(random_u) if random_u is not None
          else float(torch.rand((), generator=gen)) for _ in range(n)]
    # each output cell's window as input indices, padded to the longest
    # window by repeating the window's last index (the max is unchanged)
    idx = []
    for d in range(n):
        b = _fractional_bounds(spatial[d], out_size[d], us[d])
        longest = max(hi - lo for lo, hi in zip(b[:-1], b[1:]))
        idx.append(np.asarray([[min(lo + j, hi - 1) for j in range(longest)]
                               for lo, hi in zip(b[:-1], b[1:])], np.int64))

    def fn(a):
        dev = a.device
        sel = []
        for d in range(n):
            shape = [1] * (2 * n)
            shape[2 * d:2 * d + 2] = idx[d].shape
            sel.append(torch.from_numpy(idx[d]).to(dev).reshape(shape))
        win = a[(slice(None), slice(None)) + tuple(sel)]  # N C o0 L0 o1 L1..
        perm = [0, 1] + [2 + 2 * d for d in range(n)] \
            + [3 + 2 * d for d in range(n)]
        win = win.permute(perm).flatten(2 + n)      # N C o0 o1.. L
        out = win.amax(-1)
        if not return_mask:
            return out
        arg = win.argmax(-1)
        lens = [idx[d].shape[1] for d in range(n)]
        flat = torch.zeros_like(arg)
        mult = 1
        for d in reversed(range(n)):
            # the window offset along dim d, then its input coordinate
            local = arg // int(np.prod(lens[d + 1:])) % lens[d]
            view = [1] * (2 + n)
            view[2 + d] = idx[d].shape[0]
            pos = torch.arange(idx[d].shape[0], device=dev).reshape(view)
            coord = torch.from_numpy(idx[d]).to(dev)[pos, local]
            flat = flat + coord * mult
            mult *= spatial[d]
        return out, flat.int()

    return apply_fn("fractional_max_pool", fn, x)


def fractional_max_pool2d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, name=None):
    """Max over JAX's pseudo-random intervals (``_fractional_bounds``), one
    ``random_u`` for both dims when given, else one draw a dim from the
    port's CPU generator. ``return_mask`` (which JAX drops) is Paddle's:
    ``(out, mask)``, the int32 flat index of each maximum."""
    return _fractional_pool(x, output_size, kernel_size, random_u,
                            return_mask, 2)


def fractional_max_pool3d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, name=None):
    return _fractional_pool(x, output_size, kernel_size, random_u,
                            return_mask, 3)


def zeropad2d(x, padding, data_format="NCHW", name=None):
    from .common import pad

    return pad(x, padding, mode="constant", value=0.0,
               data_format=data_format)


# ---------------------------------------------------------------------------
# losses (:138-232, :544-580)
# ---------------------------------------------------------------------------

def soft_margin_loss(input, label, reduction="mean", name=None):
    return apply_fn("soft_margin_loss", lambda x, y: _reduce(
        torch.log1p(torch.exp(-y * x)), reduction), input, label)


def multi_label_soft_margin_loss(input, label, weight=None, reduction="mean",
                                 name=None):
    def fn(x, y, *w):
        loss = -(y * F.logsigmoid(x) + (1 - y) * F.logsigmoid(-x))
        if w:
            loss = loss * w[0]
        return _reduce(loss.mean(-1), reduction)

    extra = [weight] if weight is not None else []
    return apply_fn("multi_label_soft_margin_loss", fn, input, label, *extra)


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean", name=None):
    """``sum_{j != y} max(0, margin - x_y + x_j)^p / C`` a row, scaled by
    ``weight[y]``."""
    def fn(x, y, *w):
        c = x.shape[1]
        yl = y.long()
        xy = x.gather(1, yl[:, None])
        m = torch.clamp_min(margin - xy + x, 0.0) ** p
        m = m.masked_fill(F.one_hot(yl, c).bool(), 0.0)
        if w:
            m = m * w[0][yl][:, None]
        return _reduce(m.sum(-1) / c, reduction)

    extra = [weight] if weight is not None else []
    return apply_fn("multi_margin_loss", fn, input, label, *extra)


def poisson_nll_loss(input, label, log_input=True, full=False, epsilon=1e-8,
                     reduction="mean", name=None):
    def fn(x, y):
        if log_input:
            loss = torch.exp(x) - y * x
        else:
            loss = x - y * torch.log(x + epsilon)
        if full:
            stirling = y * torch.log(y + epsilon) - y + 0.5 * torch.log(
                2 * math.pi * torch.clamp_min(y, 1.0))
            loss = loss + torch.where(y > 1, stirling, 0.0)
        return _reduce(loss, reduction)

    return apply_fn("poisson_nll_loss", fn, input, label)


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean", name=None):
    def fn(mu, y, var):
        var = torch.clamp_min(var, epsilon)
        loss = 0.5 * (torch.log(var) + (y - mu) ** 2 / var)
        if full:
            loss = loss + 0.5 * math.log(2 * math.pi)
        return _reduce(loss, reduction)

    return apply_fn("gaussian_nll_loss", fn, input, label, variance)


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    """``sum(|x - y + epsilon|^p)^(1/p)`` over the last axis."""
    return apply_fn("pairwise_distance", lambda a, b: torch.sum(
        torch.abs(a - b + epsilon) ** p, -1, keepdim=keepdim) ** (1.0 / p),
        x, y)


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    """``max(0, d(a, p) - d(a, n) + margin)``, ``d`` the
    ``distance_function`` (default :func:`pairwise_distance`) called on
    Paddle tensors; ``swap`` takes ``min(d(a, n), d(p, n))``."""
    dist = distance_function or pairwise_distance

    def fn(a, p_, n_):
        a, p_, n_ = (t.as_subclass(Tensor) for t in (a, p_, n_))
        dp, dn = unwrap(dist(a, p_)), unwrap(dist(a, n_))
        if swap:
            dn = torch.minimum(dn, unwrap(dist(p_, n_)))
        return _reduce(torch.clamp_min(dp - dn + margin, 0.0), reduction)

    return apply_fn("triplet_margin_with_distance_loss", fn, input, positive,
                    negative)


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """N-pair loss: cross entropy of ``anchor @ positive.T`` against the
    same-label rows, plus ``l2_reg / 4`` of the mean squared norms."""
    def fn(a, p, y):
        reg = (a * a).sum(-1).mean() + (p * p).sum(-1).mean()
        sim = a @ p.T
        same = (y[:, None] == y[None, :]).to(sim.dtype)
        same = same / same.sum(-1, keepdim=True).clamp_min(1.0)
        ce = -(same * torch.log_softmax(sim, -1)).sum(-1).mean()
        return ce + l2_reg * reg * 0.25

    return apply_fn("npair_loss", fn, anchor, positive, labels)


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5, margin3=0.0,
                         scale=64.0, group=None, return_softmax=False,
                         reduction="mean"):
    """ArcFace-family margin softmax: the target logit (a cosine, clipped
    inside (-1, 1)) becomes ``cos(m1 theta + m2) - m3``, every logit times
    ``scale``, then cross entropy; one process group."""
    _no_group(group, "margin_cross_entropy")

    def fn(lg, y):
        lgf = lg.float().clamp(-1.0 + 1e-6, 1.0 - 1e-6)
        yl = y.long()
        theta = torch.arccos(lgf.gather(1, yl[:, None])[:, 0])
        target = torch.cos(margin1 * theta + margin2) - margin3
        out = lgf.scatter(1, yl[:, None], target[:, None]) * scale
        nll = -torch.log_softmax(out, -1).gather(1, yl[:, None])[:, 0]
        loss = _reduce(nll, reduction)
        if return_softmax:
            return loss, torch.softmax(out, -1)
        return loss

    return apply_fn("margin_cross_entropy", fn, logits, label)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False, name=None):
    """CTC's negative log likelihood a row (:263-317). ``log_probs`` [T, B,
    C] (log-probabilities or raw logits: JAX log-softmaxes them in fp32
    every time, and so does the port, which makes torch's CTC gradient the
    whole chain's), ``labels`` [B, S]. ``"mean"`` divides each row by
    ``max(label_length, 1)``, then averages.

    The recursion is torch's ``F.ctc_loss`` (cuDNN or ATen's CUDA kernel
    on the card). A row whose labels cannot fit its input is infeasible:
    JAX's finite log zero (-1e30) gives it a loss of 1e30, torch's gives
    inf; the port keeps JAX's 1e30 and gives that row a zero gradient
    (torch's ``zero_infinity``) where JAX differentiates its clamped
    recursion. ``norm_by_times`` (which JAX ignores) is Paddle's: each
    row's gradient is divided by its input length, the loss unchanged."""
    def fn(lp, lab, in_len, lab_len):
        logp = torch.log_softmax(lp.float(), -1)
        il, ll = in_len.long(), lab_len.long()
        nll = F.ctc_loss(logp, lab.long(), il, ll, blank, reduction="none",
                         zero_infinity=True)
        # the infeasible rows (inf without zero_infinity; a forward only,
        # so no host read) take JAX's value
        with torch.no_grad():
            raw = F.ctc_loss(logp, lab.long(), il, ll, blank,
                             reduction="none")
        nll = torch.where(torch.isinf(raw), -NEG, nll)
        if norm_by_times:
            scale = 1.0 / il.to(nll.dtype).clamp_min(1)
            nll = nll.detach() + (nll - nll.detach()) * scale
        if reduction == "mean":
            return (nll / ll.to(nll.dtype).clamp_min(1)).mean()
        if reduction == "sum":
            return nll.sum()
        return nll

    return apply_fn("ctc_loss", fn, log_probs, labels, input_lengths,
                    label_lengths)


def _skew(x, T, U1, fill, shift=0):
    """``x`` [B, T, W] laid along the lattice's anti-diagonals: out[b, d,
    u] = x[b, d - u, u - shift] where that exists, else ``fill``; [B, T +
    U1 - 1, U1]."""
    B, dev = x.shape[0], x.device
    d = torch.arange(T + U1 - 1, device=dev)[:, None]
    u = torch.arange(U1, device=dev)[None, :]
    t, w = d - u, u - shift
    ok = (t >= 0) & (t < T) & (w >= 0) & (w < x.shape[2])
    flat = (t.clamp(0, T - 1) * x.shape[2] + w.clamp(0, x.shape[2] - 1))
    g = x.reshape(B, -1)[:, flat.reshape(-1)].reshape(B, *flat.shape)
    return torch.where(ok, g, fill)


def rnnt_loss(logits, labels, input_lengths, label_lengths, blank=0,
              fastemit_lambda=0.0, reduction="mean", name=None):
    """RNN-T's negative log likelihood a row (:320-392). ``logits`` [B, T,
    U + 1, C], ``labels`` [B, U]. torch has no op for it: the lattice's
    forward variable ``alpha[t, u] = logaddexp(alpha[t - 1, u] + blank[t -
    1, u], alpha[t, u - 1] + label[t, u - 1])`` runs one anti-diagonal (t
    + u = d) a step, T + U - 1 vector steps, in JAX's fp32 and its finite
    log zero. The loss is ``-(alpha[t_len - 1, u_len] + blank[t_len - 1,
    u_len])``, JAX's terminal blank; FastEmit (``fastemit_lambda``) scales
    the label log-probabilities by ``1 + lambda`` as JAX does."""
    def fn(lg, lab, t_len, u_len):
        lp = torch.log_softmax(lg.float(), -1)
        B, T, U1, _ = lp.shape
        blank_lp = lp[..., blank]                                 # B T U+1
        lab_lp = lp[:, :, :U1 - 1, :].gather(
            -1, lab.long()[:, None, :, None].expand(B, T, U1 - 1, 1))[..., 0]
        if fastemit_lambda:
            lab_lp = lab_lp * (1.0 + fastemit_lambda)
        # skewed: blank_sk[:, d] at u is blank[d - u, u]; lab_sk[:, d] at u
        # is label[d - u, u - 1]
        blank_sk = _skew(blank_lp, T, U1, NEG)
        lab_sk = _skew(lab_lp, T, U1, NEG, shift=1)
        ul = u_len.long()
        first = torch.full((B, U1), NEG, device=lp.device)
        first[:, 0] = 0.0
        diags = [first]
        neg_col = torch.full((B, 1), NEG, device=lp.device)
        for d in range(1, T + U1 - 1):
            prev = diags[-1]
            from_t = prev + blank_sk[:, d - 1]
            from_u = torch.cat([neg_col, prev[:, :-1]], 1) + lab_sk[:, d]
            t_idx = d - torch.arange(U1, device=lp.device)
            new = torch.logaddexp(from_t, from_u)
            # t = d - u past the lattice: log zero, as no path reaches it
            new = torch.where((t_idx >= 0) & (t_idx < T), new, NEG)
            diags.append(new)
        alpha = torch.stack(diags, 1)                             # B D U+1
        last_t = t_len.long() - 1
        final = alpha[torch.arange(B, device=lp.device), last_t + ul, ul]
        term = blank_lp[torch.arange(B, device=lp.device), last_t, ul]
        nll = -(final + term)
        return _reduce(nll, reduction)

    return apply_fn("rnnt_loss", fn, logits, labels, input_lengths,
                    label_lengths)


def _tree_paths(num_classes):
    """Path (node ids, codes, valid) a class in the complete binary tree
    with ``num_classes`` leaves in heap layout — the JAX package's
    ``_tree_paths`` (:395-424), on the host in numpy."""
    depth = int(np.ceil(np.log2(max(num_classes, 2))))
    paths, codes, valid = [], [], []
    for c in range(num_classes):
        node = c + num_classes - 1
        p, k = [], []
        while node > 0:
            parent = (node - 1) // 2
            p.append(parent)
            k.append(node == 2 * parent + 2)     # right child: code 1
            node = parent
        n_valid = len(p)
        p, k = p[::-1], k[::-1]
        p += [0] * (depth - len(p))
        k += [False] * (depth - len(k))
        paths.append(p[:depth])
        codes.append(k[:depth])
        valid.append([i < n_valid for i in range(depth)])
    return (np.asarray(paths, np.int64), np.asarray(codes, np.float32),
            np.asarray(valid, bool))


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid (:427-454), the batch mean of each row's summed
    ``-log sigmoid(+-(w_node . x + b_node))`` along its class's path: the
    default complete binary tree, or a custom ``path_table`` [classes,
    depth] (-1 padding) and ``path_code``. ``is_sparse`` only picks
    Paddle's gradient storage; the values are the same."""
    if path_table is not None:
        table = _host(path_table)
        paths = np.maximum(table, 0).astype(np.int64)
        codes = _host(path_code).astype(np.float32)
        valid = table >= 0
    else:
        paths, codes, valid = _tree_paths(int(num_classes))

    def fn(x, y, w, *b):
        dev, yl = x.device, y.long().reshape(-1)
        p = torch.from_numpy(paths).to(dev)[yl]
        c = torch.from_numpy(codes).to(dev)[yl]
        v = torch.from_numpy(valid).to(dev)[yl]
        logits = torch.einsum("bdf,bf->bd", w[p], x)
        if b:
            logits = logits + b[0][p]
        lp = F.logsigmoid((1.0 - 2.0 * c) * logits)
        return -torch.where(v, lp, 0.0).sum(-1).mean()

    extra = [bias] if bias is not None else []
    return apply_fn("hsigmoid_loss", fn, input, label, weight, *extra)


def _adaptive_logp(x, y, head_w, head_b, tails, cut):
    """Each row's log-probability of its label and the loss ``-mean``."""
    shortlist = cut[0]
    x = x.float()           # the weights promote to fp32 with it, as in JAX
    logits = x @ head_w.float()
    if head_b is not None:
        logits = logits + head_b.float()
    head_logp = torch.log_softmax(logits, -1)
    yl = y.long()
    out = torch.where(yl < shortlist, head_logp.gather(
        1, yl.clamp(0, shortlist - 1)[:, None])[:, 0], 0.0)
    for i, (w1, w2) in enumerate(tails):
        lo, hi = cut[i], cut[i + 1]
        tail_logp = torch.log_softmax((x @ w1.float()) @ w2.float(), -1)
        rel = (yl - lo).clamp(0, hi - lo - 1)
        lp = head_logp[:, shortlist + i] + tail_logp.gather(
            1, rel[:, None])[:, 0]
        out = torch.where((yl >= lo) & (yl < hi), lp, out)
    return out, -out.mean()


def _check_adaptive_labels(label, n_classes):
    y = unwrap(label)
    if bool(((y < 0) | (y >= n_classes)).any()):
        raise ValueError(f"labels must be in [0, {n_classes}) for these "
                         f"cutoffs")


def adaptive_log_softmax_with_loss(input, label, head_weight, tail_weights,
                                   cutoffs, head_bias=None, name=None):
    """``(per-row log-probability, loss)`` of the cluster-factored softmax
    (:735-782): ``head_weight`` [in, shortlist + clusters], ``tail_weights``
    a list of (proj, out) pairs, ``cutoffs`` ending with the class count.
    The label range check reads the labels on the host, as JAX's eager
    check does."""
    cut = list(cutoffs)
    if len(cut) - 1 != len(tail_weights):
        raise ValueError(
            f"cutoffs must have len(tail_weights)+1 entries (the last one is "
            f"n_classes): got {len(cut)} cutoffs for {len(tail_weights)} "
            f"tails")
    _check_adaptive_labels(label, cut[-1])
    flat = [w for pair in tail_weights for w in pair]
    has_b = head_bias is not None

    def fn(x, y, hw, *rest):
        hb = rest[0] if has_b else None
        rest = rest[1:] if has_b else rest
        tails = [(rest[2 * i], rest[2 * i + 1])
                 for i in range(len(tail_weights))]
        return _adaptive_logp(x, y, hw, hb, tails, cut)

    args = [input, label, head_weight] + ([head_bias] if has_b else []) \
        + flat
    return apply_fn("adaptive_log_softmax_with_loss_fn", fn, *args)


# ---------------------------------------------------------------------------
# sampling, beams, shifts (:583-733)
# ---------------------------------------------------------------------------

def affine_grid(theta, out_shape, align_corners=True, name=None):
    """The sampling grid [n, h, w, 2] of ``theta`` [n, 2, 3] (JAX's
    ``base @ theta^T`` in fp32, ``align_corners`` defaulting to True as
    there). A 5-D ``out_shape`` (which JAX's cannot take) is Paddle's 3-D
    grid [n, d, h, w, 3] of ``theta`` [n, 3, 4]."""
    shape = [int(v) for v in _host(out_shape).reshape(-1)]
    return apply_fn("affine_grid", lambda th: F.affine_grid(
        th.float(), shape, align_corners=align_corners), theta)


_PADDING_MODES = ("zeros", "border", "reflection")


def _fix_index(idx, size, padding_mode):
    """JAX ``map_coordinates``' index fixers: ``constant`` (validity
    masked by the caller), ``nearest`` (clip), ``mirror`` (reflect about
    the edge samples)."""
    if padding_mode == "border":
        return idx.clamp(0, size - 1)
    if padding_mode == "reflection":
        s = size - 1
        return torch.abs(torch.remainder(idx + s, 2 * s) - s) if s else \
            torch.zeros_like(idx)
    return idx.clamp(0, size - 1)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """NCHW ``x`` sampled at ``grid`` [n, h, w, 2] (x then y, in [-1, 1]):
    JAX's ``jax.scipy.ndimage.map_coordinates`` of order 1 (``bilinear``)
    or 0 (``nearest``, rounding half away from zero), padding ``zeros``
    (constant 0), ``border`` (its ``nearest``: indices clipped) or
    ``reflection`` (its ``mirror`` at every ``align_corners``, which
    torch's ``grid_sample`` reflects about the half-pixel edge instead).
    ``align_corners`` defaults to True, as in JAX. Each corner is one
    gather; its weights are JAX's, summed in its order."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"unknown grid_sample mode {mode!r}")
    if padding_mode not in _PADDING_MODES:
        raise ValueError(f"unknown padding_mode {padding_mode!r}")

    def fn(a, g):
        n, c, h, w = a.shape
        gx, gy = g[..., 0], g[..., 1]
        if align_corners:
            fx, fy = (gx + 1) * (w - 1) / 2, (gy + 1) * (h - 1) / 2
        else:
            fx, fy = ((gx + 1) * w - 1) / 2, ((gy + 1) * h - 1) / 2
        nodes = []
        for coord in (fy, fx):
            if mode == "nearest":
                idx = torch.sign(coord) * torch.floor(coord.abs() + 0.5)
                nodes.append([(idx.long(), None)])
            else:
                lower = torch.floor(coord)
                upper_w = coord - lower
                lo = lower.long()
                nodes.append([(lo, 1 - upper_w), (lo + 1, upper_w)])
        flat = a.reshape(n, c, h * w)
        out = None
        for iy, wy in nodes[0]:
            for ix, wx in nodes[1]:
                fy_, fx_ = (_fix_index(iy, h, padding_mode),
                            _fix_index(ix, w, padding_mode))
                pos = (fy_ * w + fx_).reshape(n, 1, -1).expand(n, c, -1)
                val = flat.gather(2, pos).reshape(n, c, *iy.shape[1:])
                if padding_mode == "zeros":
                    ok = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
                    val = torch.where(ok[:, None], val, 0.0)
                if wy is not None:
                    val = (wy * wx)[:, None] * val
                out = val if out is None else out + val
        return out.to(a.dtype)

    return apply_fn("grid_sample", fn, x, grid)


def gather_tree(ids, parents):
    """Beam-search backtrace (:633-650): ``ids`` / ``parents`` [time, batch,
    beam]; each final beam followed back through its parents, the tokens
    of its hypothesis returned [time, batch, beam]."""
    def fn(i, p):
        T = i.shape[0]
        beams = torch.arange(i.shape[2], device=i.device).expand(
            i.shape[1:]).contiguous()
        toks = [None] * T
        for t in range(T - 1, -1, -1):
            toks[t] = i[t].gather(-1, beams)
            beams = p[t].long().gather(-1, beams)
        return torch.stack(toks, 0)

    return apply_fn("gather_tree", fn, ids, parents)


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    """TSM: of each segment's channels, the first ``shift_ratio`` take the
    next frame's values, the next ``shift_ratio`` the previous frame's
    (zeros at the ends)."""
    def fn(a):
        if data_format == "NHWC":
            a = a.permute(0, 3, 1, 2)
        nt, c, h, w = a.shape
        v = a.reshape(nt // seg_num, seg_num, c, h, w)
        fold = int(c * shift_ratio)
        left = torch.cat([v[:, 1:, :fold],
                          torch.zeros_like(v[:, :1, :fold])], 1)
        right = torch.cat([torch.zeros_like(v[:, :1, fold:2 * fold]),
                           v[:, :-1, fold:2 * fold]], 1)
        out = torch.cat([left, right, v[:, :, 2 * fold:]], 2).reshape(
            nt, c, h, w)
        return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out

    return apply_fn("temporal_shift", fn, x)


def class_center_sample(label, num_classes, num_samples, group=None):
    """PartialFC's sampling (:677-694): every positive class plus random
    negatives, ``num_samples`` in all, sorted; returns ``(label remapped to
    its index among them, the sampled classes)``. The negatives' noise is
    drawn from the port's generator of the label's device."""
    _no_group(group, "class_center_sample")

    def fn(y):
        yl = y.long()
        pos = torch.zeros(num_classes, dtype=torch.bool, device=y.device)
        pos[yl] = True
        noise = torch.rand(num_classes, device=y.device,
                           generator=global_generator(y.device))
        chosen = torch.topk(torch.where(pos, 2.0, noise),
                            num_samples).indices.sort().values
        remap = torch.zeros(num_classes, dtype=torch.int64, device=y.device)
        remap[chosen] = torch.arange(num_samples, device=y.device)
        return remap[yl], chosen

    return apply_fn("class_center_sample", fn, label)


def sparse_attention(query, key, value, sparse_csr_offset, sparse_csr_columns,
                     key_padding_mask=None, attn_mask=None, name=None):
    """Attention under a CSR pattern (:697-733): the pattern [b, h] (offsets
    [s + 1], columns [nnz]) becomes a dense boolean mask, the logits
    outside it -1e9, as JAX's; ``key_padding_mask`` [b, s] keeps 1/True,
    ``attn_mask`` adds. fp32 inside, the query's dtype out."""
    has_kpm, has_am = key_padding_mask is not None, attn_mask is not None

    def fn(q, k, v, off, cols, *masks):
        b, h, s, d = q.shape
        nnz = cols.shape[-1]
        j = torch.arange(nnz, device=q.device).expand(b, h, nnz)
        rows = torch.searchsorted(off[..., 1:].contiguous().long(),
                                  j.contiguous(), right=True).clamp_max(s - 1)
        valid = j < off[..., -1:].long()
        cell = rows * s + cols.long().clamp(0, s - 1)
        mask = torch.zeros(b, h, s * s, dtype=torch.int32, device=q.device)
        mask = mask.scatter_reduce(2, cell, valid.int(), "amax").reshape(
            b, h, s, s).bool()
        logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
            / math.sqrt(float(d))
        logits = torch.where(mask, logits, -1e9)
        it = iter(masks)
        if has_kpm:
            keep = next(it).bool()[:, None, None, :]
            logits = torch.where(keep, logits, -1e9)
        if has_am:
            logits = logits + next(it).float()
        probs = torch.softmax(logits, -1)
        return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)

    extra = [m for m in (key_padding_mask, attn_mask) if m is not None]
    return apply_fn("sparse_attention", fn, query, key, value,
                    sparse_csr_offset, sparse_csr_columns, *extra)


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """Lengths -> [*, maxlen] mask (``maxlen`` default: the longest length,
    read on the host)."""
    from ...core import dtype as dtype_mod

    if maxlen is None:
        maxlen = int(unwrap(x).max())
    n, dt = int(maxlen), dtype_mod.convert_dtype(dtype)
    return apply_fn("sequence_mask", lambda lens: (torch.arange(
        n, device=lens.device) < lens[..., None]).to(dt), x)


def softmax_2d(x, name=None):
    """Softmax over the channels of [(N,) C, H, W] (axis -3)."""
    return apply_fn("softmax_2d", lambda a: torch.softmax(a, -3), x)


def feature_alpha_dropout(x, p=0.5, training=True, name=None,
                          generator=None):
    """Alpha dropout of whole channels (SELU-preserving: dropped channels
    take alpha' = -1.7581, then the affine correction); the keep mask [N,
    C, 1, ...] drawn from ``generator`` or the port's generator of x's
    device."""
    if not training or p == 0.0:
        return x

    def fn(a):
        alpha_p = -1.7580993408473766
        shape = (a.shape[0], a.shape[1]) + (1,) * (a.ndim - 2)
        gen = generator if generator is not None \
            else global_generator(a.device)
        keep = torch.rand(shape, device=a.device, generator=gen) < 1.0 - p
        q = 1.0 - p
        a_coef = (q + alpha_p ** 2 * q * p) ** -0.5
        b_coef = -a_coef * alpha_p * p
        return a_coef * torch.where(keep, a, alpha_p) + b_coef

    return apply_fn("feature_alpha_dropout", fn, x)


# ---------------------------------------------------------------------------
# in-place activations (:461-497)
# ---------------------------------------------------------------------------

def _inplace(name, fn, x):
    """``fn`` (torch's in-place form, whose backward reads its result)
    applied to x itself through the dispatcher; returns x."""
    apply_fn(name, fn, x)
    return x


def elu_(x, alpha=1.0, name=None):
    return _inplace("elu_", lambda a: F.elu_(a, alpha), x)


def hardtanh_(x, min=-1.0, max=1.0, name=None):
    return _inplace("hardtanh_", lambda a: F.hardtanh_(a, min, max), x)


def leaky_relu_(x, negative_slope=0.01, name=None):
    return _inplace("leaky_relu_", lambda a: F.leaky_relu_(a, negative_slope),
                    x)


def tanh_(x, name=None):
    return _inplace("tanh_", torch.tanh_, x)


def thresholded_relu_(x, threshold=1.0, value=0.0, name=None):
    from .activation import _in_dtype

    return _inplace("thresholded_relu_", lambda a: F.threshold_(
        a, _in_dtype(threshold, a), value), x)


# ---------------------------------------------------------------------------
# packed-qkv flash attention (:785-818; PR 11)
# ---------------------------------------------------------------------------

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
