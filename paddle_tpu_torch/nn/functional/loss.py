"""Loss functionals — port of ``paddle_tpu/nn/functional/loss.py``, each
through the op dispatcher under the JAX package's op name.

``cross_entropy``, ``binary_cross_entropy`` and
``binary_cross_entropy_with_logits`` go under the JAX package's black
``OpDef("cross_entropy")`` (bf16/fp16 inputs run in fp32 under AMP) and
compute in fp32; the others are neutral. Each is the JAX function's
formula: the same clamps (1e-12, 1e-30), the same means (over the kept
labels, or their summed weights), the same class axis.

Two departures: ``nll_loss`` takes the classes on axis 1 of an input of
any rank (Paddle's layout; the JAX package gathers along the last axis
when the input has more than two dims), and ``cross_entropy`` with soft
labels and a ``weight`` is Paddle's (the JAX package drops the weight
there): each row's loss times ``label @ weight``, ``"mean"`` divided by
the sum of those row weights.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core.op_registry import AMP_BLACK, OpDef, apply_fn

_XENT = OpDef("cross_entropy", None, amp=AMP_BLACK)
_REDUCTIONS = ("mean", "sum", "none")


def _reduce(out, reduction):
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    return out


def _check(reduction, extra=()):
    if reduction not in _REDUCTIONS + tuple(extra):
        raise ValueError(f"unknown reduction {reduction!r}")


def _opt(*tensors):
    """The given tensors, without the Nones (the dispatcher's positional
    arguments)."""
    return [t for t in tensors if t is not None]


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Cross entropy of ``input`` against labels along ``axis`` (:22-53),
    in fp32: log-softmax (``use_softmax``) or the log of the input taken
    as probabilities (clamped at 1e-30). Hard labels (the input's shape
    without ``axis``, or with it of size 1): a label equal to
    ``ignore_index`` counts zero, ``weight`` [C] scales each label's loss,
    ``label_smoothing`` mixes the one-hot with the uniform distribution,
    and ``"mean"`` divides the sum by the number of kept labels (with
    ``weight``: by their summed weights). Soft labels: the
    (smoothed) distributions themselves; ``"mean"`` is over the rows, and
    a ``weight`` scales each row by ``label @ weight`` (the smoothed
    label), ``"mean"`` then dividing by the summed row weights (1 where
    they sum to 0), Paddle's rule."""
    _check(reduction)

    def fn(logits, lab, *w):
        ax = axis % logits.ndim
        lf = logits.float()
        lp = (torch.log_softmax(lf, ax) if use_softmax
              else torch.log(lf.clamp_min(1e-30))).movedim(ax, -1)
        n_class = lp.shape[-1]
        if soft_label:
            soft = lab.movedim(ax, -1)
            if label_smoothing > 0:
                soft = soft * (1 - label_smoothing) + label_smoothing / n_class
            loss = -(soft * lp).sum(-1)
            if w:
                row_w = soft.to(w[0].dtype) @ w[0]
                loss = loss * row_w
                if reduction == "mean":
                    total = row_w.sum()
                    return loss.sum() / (total + (total == 0).to(total.dtype))
            return _reduce(loss, reduction)
        li = lab.long()
        if li.ndim == logits.ndim:
            li = li.squeeze(ax)
        valid = li != ignore_index
        safe = torch.where(valid, li, 0)
        loss = -lp.gather(-1, safe[..., None])[..., 0]
        if label_smoothing > 0:
            loss = (1 - label_smoothing) * loss \
                - label_smoothing / n_class * lp.sum(-1)
        loss = torch.where(valid, loss, 0.0)
        if w:
            wt = w[0][safe]
            loss = loss * wt
            if reduction == "mean":
                return loss.sum() / (wt * valid).sum().clamp_min(1e-12)
        if reduction == "mean":
            return loss.sum() / valid.sum().clamp_min(1)
        return _reduce(loss, reduction)

    return apply_fn("cross_entropy", fn, input, label, *_opt(weight),
                    _opdef=_XENT)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """Unreduced :func:`cross_entropy` keeping ``axis`` (size 1), and the
    softmax with ``return_softmax``."""
    from .activation import softmax

    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    if loss.ndim == logits.ndim - 1:
        loss = loss.unsqueeze(axis)
    if return_softmax:
        return loss, softmax(logits, axis=axis)
    return loss


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """``-input[n, label[n], ...]`` (``input`` holds log-probabilities,
    classes on axis 1), with ``weight`` and ``ignore_index`` as in
    :func:`cross_entropy`."""
    _check(reduction)

    def fn(lp, lab, *w):
        li = lab.long()
        squeeze = li.ndim == lp.ndim - 1
        idx = li.unsqueeze(1) if squeeze else li
        valid = idx != ignore_index
        safe = torch.where(valid, idx, 0)
        loss = torch.where(valid, -lp.gather(1, safe), 0.0)
        if squeeze:
            loss, valid, safe = loss[:, 0], valid[:, 0], safe[:, 0]
        if w:
            wt = w[0][safe]
            loss = loss * wt
            if reduction == "mean":
                return loss.sum() / (wt * valid).sum().clamp_min(1e-12)
        if reduction == "mean":
            return loss.sum() / valid.sum().clamp_min(1)
        return _reduce(loss, reduction)

    return apply_fn("nll_loss", fn, input, label, *_opt(weight))


def mse_loss(input, label, reduction="mean", name=None):
    _check(reduction)
    return apply_fn("mse_loss", lambda a, b: _reduce(torch.square(a - b),
                                                     reduction), input, label)


def l1_loss(input, label, reduction="mean", name=None):
    _check(reduction)
    return apply_fn("l1_loss", lambda a, b: _reduce(torch.abs(a - b),
                                                    reduction), input, label)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    """``delta x`` (0.5 d^2 / delta below delta, d - 0.5 delta above), the
    JAX package's form (:96-102)."""
    _check(reduction)

    def fn(a, b):
        d = torch.abs(a - b)
        loss = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
        return _reduce(loss * delta, reduction)

    return apply_fn("smooth_l1_loss", fn, input, label)


def huber_loss(input, label, delta=1.0, reduction="mean", name=None):
    _check(reduction)

    def fn(a, b):
        d = torch.abs(a - b)
        return _reduce(torch.where(d <= delta, 0.5 * d * d,
                                   delta * (d - 0.5 * delta)), reduction)

    return apply_fn("huber_loss", fn, input, label)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    _check(reduction)

    def fn(p, lab, *w):
        p32 = p.float()
        loss = -(lab * torch.log(p32.clamp_min(1e-12))
                 + (1 - lab) * torch.log((1 - p32).clamp_min(1e-12)))
        if w:
            loss = loss * w[0]
        return _reduce(loss, reduction)

    return apply_fn("binary_cross_entropy", fn, input, label, *_opt(weight),
                    _opdef=_XENT)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    _check(reduction)

    def fn(z, lab, *rest):
        rest = list(rest)
        w = rest.pop(0) if weight is not None else None
        pw = rest.pop(0) if pos_weight is not None else None
        z32 = z.float()
        pos = lab * F.logsigmoid(z32)
        if pw is not None:
            pos = pw * pos
        loss = -(pos + (1 - lab) * F.logsigmoid(-z32))
        if w is not None:
            loss = loss * w
        return _reduce(loss, reduction)

    return apply_fn("bce_with_logits", fn, logit, label,
                    *_opt(weight, pos_weight), _opdef=_XENT)


def kl_div(input, label, reduction="mean", log_target=False, name=None):
    _check(reduction, ("batchmean",))

    def fn(lp, t):
        if log_target:
            loss = torch.exp(t) * (t - lp)
        else:
            loss = t * (torch.log(t.clamp_min(1e-12)) - lp)
        if reduction == "batchmean":
            return loss.sum() / lp.shape[0]
        return _reduce(loss, reduction)

    return apply_fn("kl_div", fn, input, label)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    _check(reduction)
    return apply_fn("margin_ranking_loss", lambda a, b, lab: _reduce(
        torch.clamp_min(-lab * (a - b) + margin, 0.0), reduction),
        input, other, label)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    _check(reduction)
    return apply_fn("hinge_embedding_loss", lambda a, lab: _reduce(
        torch.where(lab == 1, a, torch.clamp_min(margin - a, 0.0)),
        reduction), input, label)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    _check(reduction)

    def fn(a, b, lab):
        cos = (a * b).sum(-1) / (torch.linalg.vector_norm(a, dim=-1)
                                 * torch.linalg.vector_norm(b, dim=-1)
                                 ).clamp_min(1e-12)
        return _reduce(torch.where(lab == 1, 1 - cos,
                                   torch.clamp_min(cos - margin, 0.0)),
                       reduction)

    return apply_fn("cosine_embedding_loss", fn, input1, input2, label)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    _check(reduction)

    def fn(a, pos, neg):
        def dist(u, v):
            return torch.linalg.vector_norm(u - v + epsilon, ord=p, dim=-1)

        dp, dn = dist(a, pos), dist(a, neg)
        if swap:
            dn = torch.minimum(dn, dist(pos, neg))
        return _reduce(torch.clamp_min(dp - dn + margin, 0.0), reduction)

    return apply_fn("triplet_margin_loss", fn, input, positive, negative)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    _check(reduction)

    def fn(z, lab, *nrm):
        p = torch.sigmoid(z)
        ce = -(lab * F.logsigmoid(z) + (1 - lab) * F.logsigmoid(-z))
        p_t = p * lab + (1 - p) * (1 - lab)
        loss = ce * (1 - p_t) ** gamma
        if alpha >= 0:
            loss = (alpha * lab + (1 - alpha) * (1 - lab)) * loss
        if nrm:
            loss = loss / nrm[0]
        return _reduce(loss, reduction)

    return apply_fn("sigmoid_focal_loss", fn, logit, label,
                    *_opt(normalizer))


def log_loss(input, label, epsilon=1e-4, name=None):
    return apply_fn("log_loss", lambda p, lab: -lab * torch.log(p + epsilon)
                    - (1 - lab) * torch.log(1 - p + epsilon), input, label)


def square_error_cost(input, label):
    return apply_fn("square_error_cost", lambda a, b: torch.square(a - b),
                    input, label)


def dice_loss(input, label, epsilon=1e-5, name=None):
    """Mean over the batch of 1 - (2 |p . onehot| + eps) / (|p| + |onehot|
    + eps), the classes on the last axis and ``label`` [..., 1]."""
    def fn(p, lab):
        onehot = (lab.squeeze(-1).long()[..., None] == torch.arange(
            p.shape[-1], device=p.device)).to(p.dtype)
        dims = tuple(range(1, p.ndim))
        inter = (p * onehot).sum(dims)
        union = p.sum(dims) + onehot.sum(dims)
        return (1 - (2 * inter + epsilon) / (union + epsilon)).mean()

    return apply_fn("dice_loss", fn, input, label)
