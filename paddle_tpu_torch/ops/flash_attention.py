"""Flash attention, forward and backward: the hand-written CUDA kernels and
their plain versions.

Port of ``paddle_tpu/ops/flash_attention.py`` on the ``[batch, seq, heads,
head_dim]`` layout:

- :func:`flash_attention` is the public entry (``flash_attention`` :831).
  Without gradients it runs the primal forward (``_flash`` :700, no lse
  written); when grad is enabled and an input requires grad it runs the
  custom op ``paddle_tpu_torch::flash_fwd_lse``, whose autograd formula
  mirrors the custom VJP ``_flash_fwd`` / ``_flash_bwd`` (:709-733): the
  forward with lse, then the op ``paddle_tpu_torch::flash_bwd``.
- :func:`flash_attention_forward` returns ``(out, lse)``, lse ``[b, hq,
  s_q]`` fp32 of the scaled logits (``_pallas_forward`` :221 with lse; the
  TPU kernel's 8-lane axis is dropped).
- :func:`flash_attention_backward` returns ``(dq, dk, dv)`` from the saved
  ``(q, k, v, out, lse)`` and ``dout`` (``_pallas_backward`` :497).

The training forward and the backward are registered ``torch.library``
custom ops so that a selective-checkpoint policy sees the forward as one
op and can save its outputs (the JAX package names them ``flash_out`` /
``flash_lse`` for its remat policies, :711-718): a saved forward is not run
again in the backward, and its launch is counted once. Each op has a CUDA
implementation, which launches ``csrc/flash_fwd.cu`` (K1,
``_fa_fwd_kernel`` :117) or ``csrc/flash_bwd.cu`` (K2 ``_fa_bwd_dq_kernel``
:337, K3 ``_fa_bwd_dkv_kernel`` :420) or raises, and a CPU implementation,
which runs the plain versions :func:`flash_attention_reference_lse`
(``_xla_reference_lse`` :736) and :func:`flash_attention_backward_reference`
(the kernels' formulas: P from the saved lse, delta from the stored
output, not autograd through the forward). The no-lse primal forward is
the op ``paddle_tpu_torch::flash_fwd``, so a compiled or exported graph
holds it as one node: its CUDA implementation launches K1 without the lse
and counts ``flash_attention.launches``; its CPU implementation runs
:func:`flash_attention_reference`.

Three variants take the kernels' other operands: :func:`flash_attention_
varlen` (segment ids, :891) and :func:`flash_attention_rowmask` (per-kv-
column row bounds, :982) run K1-K3 in a masked mode (``csrc/flash_mask.
cuh``), through the ops ``paddle_tpu_torch::flash_fwd_lse_seg`` /
``flash_bwd_seg`` and ``..._rowmask`` for gradients; :func:`flash_attention_
with_lse` (:757) returns a differentiable lse, whose cotangent K2 takes
(``paddle_tpu_torch::flash_fwd_with_lse`` / ``flash_bwd_glse``). Their
plain versions are :func:`flash_attention_varlen_reference`,
:func:`flash_attention_rowmask_reference` and the backward reference's
``g_lse`` and mask arguments.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from . import _build

NEG_INF = -1e30
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_KERNEL_HEAD_DIMS = (64, 128)


def _heads_first(q, k, v):
    """[b, s, h, d] -> fp32 [b, h, s, d], kv heads repeated over their q
    heads (GQA)."""
    qh = q.transpose(1, 2).float()
    kh = k.transpose(1, 2).float()
    vh = v.transpose(1, 2).float()
    if kh.shape[1] != qh.shape[1]:
        rep = qh.shape[1] // kh.shape[1]
        kh = kh.repeat_interleave(rep, dim=1)
        vh = vh.repeat_interleave(rep, dim=1)
    return qh, kh, vh


def _scaled_logits(qh, kh, causal, scale):
    """Scaled fp32 logits [b, h, s_q, s_kv] with the end-aligned causal mask
    ``tril(k=s_kv - s_q)`` at the finite mask value."""
    logits = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * scale
    if causal:
        ql, kl = logits.shape[-2], logits.shape[-1]
        mask = torch.ones(ql, kl, dtype=torch.bool,
                          device=qh.device).tril(kl - ql)
        logits = torch.where(mask, logits, NEG_INF)
    return logits


def flash_attention_reference(q, k, v, causal: bool = False, scale=None):
    """Plain attention with the same semantics as the kernel: fp32 math,
    GQA by repeating each kv head over its q heads, end-aligned causal mask
    ``tril(k=s_kv - s_q)`` with the finite mask value. q [b, s_q, hq, d],
    k/v [b, s_kv, hkv, d]; returns q's shape and dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qh, kh, vh = _heads_first(q, k, v)
    probs = torch.softmax(_scaled_logits(qh, kh, causal, scale), dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vh)
    return out.transpose(1, 2).to(q.dtype)


def flash_attention_reference_lse(q, k, v, causal: bool = False, scale=None):
    """Plain forward with the logsumexp (``_xla_reference_lse``): returns
    (out in q's shape and dtype, lse [b, hq, s_q] fp32 of the scaled
    logits)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qh, kh, vh = _heads_first(q, k, v)
    logits = _scaled_logits(qh, kh, causal, scale)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None])
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vh)
    return out.transpose(1, 2).to(q.dtype), lse


def _seg_keep(q_seg, kv_seg):
    """Visible (q, k) pairs of segment ids q_seg [b, s_q], kv_seg [b, s_kv]:
    [b, 1, s_q, s_kv], equal ids."""
    return q_seg[:, None, :, None] == kv_seg[:, None, None, :]


def _row_keep(row_start, row_end, hq, s_q):
    """Visible (q, k) pairs of per-kv-column row bounds [b, hm, s_kv]: q row
    r is hidden from column c iff ``start[c] <= r < end[c]``. [b, hm', s_q,
    s_kv], hm' = 1 or hq (each bounds row repeated over the q heads of its
    kv head), as ``_xla_rowmask_reference`` (:952) broadcasts them."""
    hm = row_start.shape[1]
    if hm != 1:
        row_start = row_start.repeat_interleave(hq // hm, dim=1)
        row_end = row_end.repeat_interleave(hq // hm, dim=1)
    rows = torch.arange(s_q, device=row_start.device)[None, None, :, None]
    return ~((rows >= row_start[:, :, None, :])
             & (rows < row_end[:, :, None, :]))


def _mask_keep(q, mask):
    """The visible pairs of a :class:`_Mask` (None: every pair)."""
    if mask is None:
        return None
    if mask.kind == "seg":
        return _seg_keep(mask.a, mask.b)
    return _row_keep(mask.a, mask.b, q.shape[2], q.shape[1])


def _masked_reference_lse(q, k, v, keep, causal, scale):
    """Plain masked forward: the causal mask and ``keep`` at NEG_INF, then
    the max-shifted softmax of ``_xla_varlen_reference`` (:861) /
    ``_xla_rowmask_reference`` (:952). A row that sees no key gets the mean
    of v over ALL columns (every logit is NEG_INF, so each weighs exp(0))
    and lse NEG_INF. Returns (out in q's shape and dtype, lse [b, hq, s_q]
    fp32)."""
    qh, kh, vh = _heads_first(q, k, v)
    logits = torch.where(keep, _scaled_logits(qh, kh, causal, scale),
                         NEG_INF)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    del logits
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p / l.clamp_min(1e-30), vh)
    lse = torch.where(m > NEG_INF / 2, m + torch.log(l), NEG_INF)[..., 0]
    return out.transpose(1, 2).to(q.dtype), lse


def flash_attention_varlen_reference(q, k, v, q_seg, kv_seg,
                                     causal: bool = True, scale=None):
    """Plain segment-masked attention (``_xla_varlen_reference`` :861): q
    row i sees kv column j iff ``q_seg[b, i] == kv_seg[b, j]`` (and the
    end-aligned causal mask). A row that sees no key gets the mean of v
    over all columns (the fallback's convention; the kernel's differs, see
    :func:`flash_attention_varlen`)."""
    scale = _default_scale(q, scale)
    return _masked_reference_lse(q, k, v, _seg_keep(q_seg, kv_seg), causal,
                                 scale)[0]


def flash_attention_rowmask_reference(q, k, v, row_start, row_end,
                                      causal: bool = True, scale=None):
    """Plain flashmask attention (``_xla_rowmask_reference`` :952): q row r
    is hidden from kv column c iff ``start[b, h, c] <= r < end[b, h, c]``,
    bounds [b, hm, s_kv] with hm 1 or the kv heads. Rows that see no key as
    in :func:`flash_attention_varlen_reference`."""
    scale = _default_scale(q, scale)
    keep = _row_keep(row_start, row_end, q.shape[2], q.shape[1])
    return _masked_reference_lse(q, k, v, keep, causal, scale)[0]


def flash_attention_backward_reference(q, k, v, o, lse, dout,
                                       causal: bool = False, scale=None,
                                       g_lse=None, q_seg=None, kv_seg=None,
                                       row_start=None, row_end=None):
    """Plain backward with the kernels' formulas: ``P = exp(s - lse)`` (0
    where ``lse <= NEG_INF / 2``, and where the segment ids or row bounds
    hide the pair), ``delta = rowsum(dout * o) - g_lse`` from the stored
    output and the lse cotangent ``g_lse`` [b, hq, s_q] (if given), ``dS =
    P (dP - delta) scale``; dK and dV summed over each kv head's q heads in
    fp32. Returns (dq, dk, dv) in q's/k's/v's shapes and dtypes."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    b, s_q, hq, d = q.shape
    s_kv, hkv = k.shape[1], k.shape[2]
    qh, kh, vh = _heads_first(q, k, v)
    doh = dout.transpose(1, 2).float()
    lse = lse.float()[..., None]
    s = _scaled_logits(qh, kh, causal, scale)
    keep = _mask_keep(q, _make_mask(q_seg, kv_seg, row_start, row_end))
    if keep is not None:
        s = torch.where(keep, s, NEG_INF)
    p = torch.where(lse > NEG_INF / 2, torch.exp(s - lse), 0.0)
    del s
    delta = (doh * o.transpose(1, 2).float()).sum(-1, keepdim=True)
    if g_lse is not None:
        delta = delta - g_lse.float()[..., None]
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", doh, vh) - delta) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kh)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qh)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, doh)
    group = hq // hkv
    dk = dk.reshape(b, hkv, group, s_kv, d).sum(2)
    dv = dv.reshape(b, hkv, group, s_kv, d).sum(2)
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


def _check(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention takes [batch, seq, heads, "
                         "head_dim] tensors")
    if k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"q heads {q.shape[2]} not a multiple of kv heads "
                         f"{k.shape[2]}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")


def _check_kernel(q, *others):
    """What the CUDA kernels take: one bf16/fp16/fp32 dtype, head_dim 64 or
    128, a contiguous head_dim, 16-byte rows for bf16 and fp16, the grid
    limits and the current device. Raises otherwise."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, "
                         f"not {q.device}")
    if q.dtype not in _KERNEL_DTYPES or any(t.dtype != q.dtype
                                            for t in others):
        raise TypeError(f"flash kernels take bf16, fp16 or fp32 (one dtype), "
                        f"got "
                        f"{[str(t.dtype) for t in (q, *others)]}")
    d = q.shape[3]
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernels take head_dim in "
                         f"{_KERNEL_HEAD_DIMS}, got {d}")
    if any(t.stride(3) != 1 for t in (q, *others)):
        raise ValueError("flash kernels need a contiguous head_dim")
    if q.dtype != torch.float32 and any(
            t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])
            for t in (q, *others)):
        raise ValueError("bf16/fp16 flash kernels read rows as 16-byte "
                         "vectors: "
                         "operands need 16-byte aligned storage and batch/"
                         "seq/head strides that are multiples of 8")
    if q.shape[0] > 65535 or q.shape[2] > 65535:
        raise ValueError(f"flash kernel grid limit: batch {q.shape[0]}, "
                         f"heads {q.shape[2]}")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"q is on {q.device}, the current device is "
                         f"cuda:{torch.cuda.current_device()}")


class _Mask(NamedTuple):
    """A score mask beyond the causal one: ``kind`` "seg" (a, b = q_seg
    [b, s_q], kv_seg [b, s_kv]) or "rowmask" (a, b = row_start, row_end
    [b, hm, s_kv]); int32 contiguous once checked. The kind names the
    launch counters of its mode."""
    kind: str
    a: torch.Tensor
    b: torch.Tensor

    def pointers(self):
        """(q_seg, kv_seg, start, end, hm) for the kernels' C interface."""
        if self.kind == "seg":
            return self.a.data_ptr(), self.b.data_ptr(), None, None, 0
        return None, None, self.a.data_ptr(), self.b.data_ptr(), \
            self.a.shape[1]


_NO_MASK = (None, None, None, None, 0)


def _make_mask(q_seg=None, kv_seg=None, row_start=None, row_end=None):
    if q_seg is not None or kv_seg is not None:
        return _Mask("seg", q_seg, kv_seg)
    if row_start is not None or row_end is not None:
        return _Mask("rowmask", row_start, row_end)
    return None


def _bump(fn, counter, mask=None):
    """Add one to ``fn.<counter>`` (``fn.<counter>_<kind>`` in a masked
    mode)."""
    name = counter if mask is None else f"{counter}_{mask.kind}"
    setattr(fn, name, getattr(fn, name) + 1)


def _check_mask(q, k, mask: Optional[_Mask]) -> Optional[_Mask]:
    """Shapes and device of a mask's operands; returns it with int32
    contiguous tensors (a device-side cast, no host read)."""
    if mask is None:
        return None
    a, b_ = mask.a, mask.b
    if a is None or b_ is None:
        raise ValueError("a mask needs both q_seg and kv_seg, or both "
                         "row_start and row_end")
    b, s_q, _, _ = q.shape
    s_kv, hkv = k.shape[1], k.shape[2]
    if mask.kind == "seg":
        if tuple(a.shape) != (b, s_q) or tuple(b_.shape) != (b, s_kv):
            raise ValueError(f"segment ids q_seg {tuple(a.shape)} / kv_seg "
                             f"{tuple(b_.shape)} must be [b, s_q] = "
                             f"{(b, s_q)} / [b, s_kv] = {(b, s_kv)}")
    else:
        hm = a.shape[1] if a.ndim == 3 else -1
        if a.ndim != 3 or a.shape[0] != b or a.shape[2] != s_kv \
                or a.shape != b_.shape or hm not in (1, hkv):
            raise ValueError(f"row bounds {tuple(a.shape)} / "
                             f"{tuple(b_.shape)} must be [b, hm, s_kv] with "
                             f"hm 1 or the kv heads {hkv} (b {b}, s_kv "
                             f"{s_kv})")
    if a.dtype.is_floating_point or b_.dtype.is_floating_point:
        raise TypeError(f"mask operands are integer tensors, got "
                        f"{a.dtype}/{b_.dtype}")
    if a.device != q.device or b_.device != q.device:
        raise ValueError(f"mask operands must be on {q.device}")
    return _Mask(mask.kind, a.to(torch.int32).contiguous(),
                 b_.to(torch.int32).contiguous())


def _launch_forward(q, k, v, causal, scale, with_lse, mask=None):
    """K1 on CUDA tensors: (out, lse [b, hq, s_q] fp32 or None); ``mask`` a
    checked :class:`_Mask` or None (the dense kernel)."""
    _check_kernel(q, k, v)
    b, s_q, hq, d = q.shape
    s_kv, hkv = k.shape[1], k.shape[2]
    out = torch.empty((b, s_q, hq, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, hq, s_q), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return out, lse
    err = _flash_lib().paddle_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None,
        *(_NO_MASK if mask is None else mask.pointers()),
        _KERNEL_DTYPES[q.dtype], b, s_q, s_kv, hq, hkv, d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        float(scale), int(bool(causal)),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error "
                           f"{err}")
    return out, lse


def _default_scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def flash_attention(q, k, v, causal: bool = False, scale=None):
    """Attention over ``[batch, seq, heads, head_dim]`` tensors (GQA when k/v
    have fewer heads; end-aligned causal mask when ``causal``). Returns q's
    shape and dtype. CUDA tensors run the kernels (bf16 and fp16 on the
    tensor cores or fp32 on FMAs, head_dim 64 or 128, any sequence lengths;
    another dtype raises); CPU tensors
    run the plain versions. Differentiable: with grad enabled and an input
    that requires grad, the forward keeps its lse and the backward runs
    :func:`flash_attention_backward`."""
    _check(q, k, v)
    scale = _default_scale(q, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return torch.ops.paddle_tpu_torch.flash_fwd_lse(q, k, v, bool(causal),
                                                        scale)[0]
    return torch.ops.paddle_tpu_torch.flash_fwd(q, k, v, bool(causal), scale)


#: launches of the primal (no-lse) forward kernel (counted inside the op's
#: CUDA implementation); callers reset it to 0
flash_attention.launches = 0


@torch.library.custom_op("paddle_tpu_torch::flash_fwd", mutates_args=(),
                         device_types="cuda")
def _flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool, scale: float) -> torch.Tensor:
    """K1 without its lse output on CUDA tensors (the primal forward, as
    a graph of ``to_static``, ``jit.save`` or the ``Predictor`` holds it)."""
    out, _ = _launch_forward(q, k, v, causal, scale, with_lse=False)
    flash_attention.launches += 1
    return out


@_flash_fwd.register_kernel("cpu")
def _flash_fwd_cpu(q, k, v, causal, scale):
    return flash_attention_reference(q, k, v, causal, scale).contiguous()


@_flash_fwd.register_fake
def _flash_fwd_fake(q, k, v, causal, scale):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


def flash_attention_forward(q, k, v, causal: bool = False, scale=None):
    """The training forward: (out in q's shape and dtype, lse [b, hq, s_q]
    fp32 of the scaled logits, NEG_INF for a row that sees no key). Runs the
    op ``paddle_tpu_torch::flash_fwd_lse``: CUDA tensors launch K1 with its
    lse output; CPU tensors run :func:`flash_attention_reference_lse`."""
    _check(q, k, v)
    return torch.ops.paddle_tpu_torch.flash_fwd_lse(
        q, k, v, bool(causal), _default_scale(q, scale))


#: launches of the forward kernel with its lse output (counted inside the
#: op's CUDA implementation, so a forward that a checkpoint policy saves is
#: counted once)
flash_attention_forward.launches = 0


@torch.library.custom_op("paddle_tpu_torch::flash_fwd_lse", mutates_args=(),
                         device_types="cuda")
def _flash_fwd_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool, scale: float
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 with its lse output on CUDA tensors."""
    out, lse = _launch_forward(q, k, v, causal, scale, with_lse=True)
    flash_attention_forward.launches += 1
    return out, lse


@_flash_fwd_lse.register_kernel("cpu")
def _flash_fwd_lse_cpu(q, k, v, causal, scale):
    # contiguous, as the CUDA implementation's and the fake's outputs: a
    # compiled graph plans its views on the fake's strides
    out, lse = flash_attention_reference_lse(q, k, v, causal, scale)
    return out.contiguous(), lse.contiguous()


@_flash_fwd_lse.register_fake
def _flash_fwd_lse_fake(q, k, v, causal, scale):
    b, s_q, hq, _ = q.shape
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty((b, hq, s_q), dtype=torch.float32))


def _check_backward(q, k, v, o, lse, dout):
    _check(q, k, v)
    if o.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and dout {tuple(dout.shape)} "
                         f"must have q's shape {tuple(q.shape)}")
    b, s_q, hq, _ = q.shape
    if tuple(lse.shape) != (b, hq, s_q):
        raise ValueError(f"lse {tuple(lse.shape)} must be [b, hq, s_q] = "
                         f"{(b, hq, s_q)}")
    if not (q.device == o.device == lse.device == dout.device):
        raise ValueError("all operands must be on one device")


def _bwd_strides(*ts):
    flat = [st for t in ts for st in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _launch_dq(q, k, v, o, lse, dout, causal, scale, mask=None,
               g_lse=None):
    """K2 on CUDA tensors: (dq, delta [b, hq, s_q] fp32). ``mask``: a checked
    :class:`_Mask` or None; ``g_lse``: the lse cotangent (contiguous fp32
    [b, hq, s_q]) or None, which passes a null pointer."""
    b, s_q, hq, d = q.shape
    s_kv, hkv = k.shape[1], k.shape[2]
    dq = torch.empty((b, s_q, hq, d), dtype=q.dtype, device=q.device)
    delta = torch.empty((b, hq, s_q), dtype=torch.float32, device=q.device)
    err = _flash_bwd_lib().paddle_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), delta.data_ptr(),
        None if g_lse is None else g_lse.data_ptr(),
        *(_NO_MASK if mask is None else mask.pointers()),
        _KERNEL_DTYPES[q.dtype], b, s_q, s_kv, hq, hkv, d,
        _bwd_strides(q, k, v, o, dout), float(scale), int(bool(causal)),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd dq kernel launch failed: CUDA error "
                           f"{err}")
    _bump(flash_attention_backward,
          "launches_dq" if g_lse is None else "launches_glse", mask)
    return dq, delta


def _launch_dkv(q, k, v, dout, lse, delta, causal, scale, mask=None):
    """K3 on CUDA tensors (after K2, whose delta it reads): (dk, dv)."""
    b, s_q, hq, d = q.shape
    s_kv, hkv = k.shape[1], k.shape[2]
    dk = torch.empty((b, s_kv, hkv, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, s_kv, hkv, d), dtype=v.dtype, device=v.device)
    err = _flash_bwd_lib().paddle_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *(_NO_MASK if mask is None else mask.pointers()),
        _KERNEL_DTYPES[q.dtype], b, s_q, s_kv, hq, hkv, d,
        _bwd_strides(q, k, v, dout, dout), float(scale), int(bool(causal)),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd dkv kernel launch failed: CUDA error "
                           f"{err}")
    _bump(flash_attention_backward, "launches_dkv", mask)
    return dk, dv


def flash_attention_backward(q, k, v, o, lse, dout, causal: bool = False,
                             scale=None):
    """(dq, dk, dv) of :func:`flash_attention` from the forward's ``o`` and
    ``lse`` (:func:`flash_attention_forward`) and the output gradient
    ``dout``. Runs the op ``paddle_tpu_torch::flash_bwd``: CUDA tensors
    launch K2 then K3 on the current stream; CPU tensors run
    :func:`flash_attention_backward_reference`."""
    _check_backward(q, k, v, o, lse, dout)
    return torch.ops.paddle_tpu_torch.flash_bwd(
        q, k, v, o, lse, dout, bool(causal), _default_scale(q, scale))


#: launches of K2 (dq) and K3 (dk/dv) of the dense backward; of each in the
#: segment and row-bound modes; and of K2 with an lse cotangent (K3 after it
#: counts as dense)
flash_attention_backward.launches_dq = 0
flash_attention_backward.launches_dkv = 0
flash_attention_backward.launches_dq_seg = 0
flash_attention_backward.launches_dkv_seg = 0
flash_attention_backward.launches_dq_rowmask = 0
flash_attention_backward.launches_dkv_rowmask = 0
flash_attention_backward.launches_glse = 0


@torch.library.custom_op("paddle_tpu_torch::flash_bwd", mutates_args=(),
                         device_types="cuda")
def _flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               o: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
               causal: bool, scale: float
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 then K3 on CUDA tensors."""
    _check_kernel(q, k, v, o, dout)
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("lse must be a contiguous fp32 [b, hq, s_q] tensor")
    if q.numel() == 0 or k.shape[1] == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dq, delta = _launch_dq(q, k, v, o, lse, dout, causal, scale)
    dk, dv = _launch_dkv(q, k, v, dout, lse, delta, causal, scale)
    return dq, dk, dv


@_flash_bwd.register_kernel("cpu")
def _flash_bwd_cpu(q, k, v, o, lse, dout, causal, scale):
    return tuple(g.contiguous() for g in flash_attention_backward_reference(
        q, k, v, o, lse, dout, causal, scale))


@_flash_bwd.register_fake
def _flash_bwd_fake(q, k, v, o, lse, dout, causal, scale):
    return tuple(torch.empty_like(t, memory_format=torch.contiguous_format)
                 for t in (q, k, v))


def _flash_fwd_lse_setup(ctx, inputs, output):
    q, k, v, causal, scale = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.causal, ctx.scale = causal, scale
    ctx.mark_non_differentiable(lse)
    ctx.set_materialize_grads(False)


def _flash_fwd_lse_backward(ctx, dout, _dlse):
    """The custom VJP of ``_flash`` (:709-733): the forward keeps (q, k, v,
    out, lse); the backward runs :func:`flash_attention_backward`."""
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = torch.ops.paddle_tpu_torch.flash_bwd(
        q, k, v, out, lse, dout.contiguous(), ctx.causal, ctx.scale)
    return dq, dk, dv, None, None


_flash_fwd_lse.register_autograd(_flash_fwd_lse_backward,
                                 setup_context=_flash_fwd_lse_setup)


# ---------------------------------------------------------------------------
# masked variants: varlen (segment ids) and flashmask (per-column row bounds)
# ---------------------------------------------------------------------------

def _masked_attention(q, k, v, mask, causal, scale, fwd_op):
    """The entry of both masked variants: the training op (forward with lse,
    backward through K2/K3 in the same mode) when an input requires grad,
    else the primal forward: K1 in the mask's mode without lse on CUDA
    tensors, the plain version on CPU tensors."""
    _check(q, k, v)
    mask = _check_mask(q, k, mask)
    scale = _default_scale(q, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return fwd_op(q, k, v, mask.a, mask.b, bool(causal), scale)[0]
    if q.device.type == "cpu":
        return _masked_reference_lse(q, k, v, _mask_keep(q, mask), causal,
                                     scale)[0]
    out, _ = _launch_forward(q, k, v, causal, scale, with_lse=False,
                             mask=mask)
    _bump(flash_attention, "launches", mask)
    return out


def flash_attention_varlen(q, k, v, q_seg, kv_seg, causal: bool = True,
                           scale=None):
    """Packed variable-length attention (``flash_attention_varlen`` :891):
    q [b, s_q, hq, d], k/v [b, s_kv, hkv, d], segment ids q_seg [b, s_q] and
    kv_seg [b, s_kv] (integers); q row i sees kv column j iff their ids are
    equal (and, when ``causal``, j <= i + s_kv - s_q). CUDA tensors run K1
    (and, for gradients, K2/K3) in segment mode; CPU tensors the plain
    versions. The ids get no gradient.

    A row that sees no key (no equal id at or before it) comes out finite
    with lse NEG_INF and zero gradient; its value is the mean of v over the
    64-column tiles the kernel visited (the plain version: over all
    columns; the TPU kernel: over its 128-512 blocks), so no two agree
    there."""
    return _masked_attention(q, k, v, _Mask("seg", q_seg, kv_seg), causal,
                             scale, torch.ops.paddle_tpu_torch.flash_fwd_lse_seg)


def flash_attention_rowmask(q, k, v, row_start, row_end,
                            causal: bool = True, scale=None):
    """Flashmask attention (``flash_attention_rowmask`` :982): per-kv-column
    row bounds row_start/row_end [b, hm, s_kv] (integers, hm 1 or the kv
    heads; q head h reads bounds row (h / group) % hm) hide q rows r with
    ``start[c] <= r < end[c]`` from column c, on top of the causal mask.
    CUDA tensors run K1 (and K2/K3) in row-bound mode; CPU tensors the plain
    versions. The bounds get no gradient. Rows that see no key as in
    :func:`flash_attention_varlen`."""
    return _masked_attention(q, k, v, _Mask("rowmask", row_start, row_end),
                             causal, scale,
                             torch.ops.paddle_tpu_torch.flash_fwd_lse_rowmask)


#: launches of the primal (no-lse) forward in the segment and row-bound
#: modes
flash_attention.launches_seg = 0
flash_attention.launches_rowmask = 0
#: launches of the forward with lse in those modes (the training ops)
flash_attention_forward.launches_seg = 0
flash_attention_forward.launches_rowmask = 0


def _register_masked(kind):
    """The forward-with-lse and backward ops of one mask kind
    (``paddle_tpu_torch::flash_fwd_lse_<kind>`` / ``flash_bwd_<kind>``),
    whose autograd formula mirrors the custom VJPs ``_fav_*`` (:912-950) and
    ``_far_*`` (:1003-1035): the forward keeps (q, k, v, a, b, out, lse), the
    backward runs K2/K3 in the same mode; a and b get no gradient."""
    def keep(q, a, b):
        return _mask_keep(q, _Mask(kind, a, b))

    @torch.library.custom_op(f"paddle_tpu_torch::flash_fwd_lse_{kind}",
                             mutates_args=(), device_types="cuda")
    def fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            a: torch.Tensor, b: torch.Tensor, causal: bool, scale: float
            ) -> tuple[torch.Tensor, torch.Tensor]:
        mask = _Mask(kind, a, b)
        out, lse = _launch_forward(q, k, v, causal, scale, with_lse=True,
                                   mask=mask)
        _bump(flash_attention_forward, "launches", mask)
        return out, lse

    @fwd.register_kernel("cpu")
    def _(q, k, v, a, b, causal, scale):
        return _masked_reference_lse(q, k, v, keep(q, a, b), causal, scale)

    @fwd.register_fake
    def _(q, k, v, a, b, causal, scale):
        return _flash_fwd_lse_fake(q, k, v, causal, scale)

    @torch.library.custom_op(f"paddle_tpu_torch::flash_bwd_{kind}",
                             mutates_args=(), device_types="cuda")
    def bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            o: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
            a: torch.Tensor, b: torch.Tensor, causal: bool, scale: float
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        _check_kernel(q, k, v, o, dout)
        mask = _Mask(kind, a, b)
        if q.numel() == 0 or k.shape[1] == 0:
            return (torch.zeros_like(q), torch.zeros_like(k),
                    torch.zeros_like(v))
        dq, delta = _launch_dq(q, k, v, o, lse, dout, causal, scale, mask)
        dk, dv = _launch_dkv(q, k, v, dout, lse, delta, causal, scale, mask)
        return dq, dk, dv

    @bwd.register_kernel("cpu")
    def _(q, k, v, o, lse, dout, a, b, causal, scale):
        kw = (dict(q_seg=a, kv_seg=b) if kind == "seg"
              else dict(row_start=a, row_end=b))
        return flash_attention_backward_reference(q, k, v, o, lse, dout,
                                                  causal, scale, **kw)

    @bwd.register_fake
    def _(q, k, v, o, lse, dout, a, b, causal, scale):
        return (torch.empty_like(q), torch.empty_like(k),
                torch.empty_like(v))

    def setup(ctx, inputs, output):
        q, k, v, a, b, causal, scale = inputs
        out, lse = output
        ctx.save_for_backward(q, k, v, a, b, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)
        ctx.set_materialize_grads(False)

    def backward(ctx, dout, _dlse):
        q, k, v, a, b, out, lse = ctx.saved_tensors
        dq, dk, dv = bwd(q, k, v, out, lse, dout.contiguous(), a, b,
                         ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None, None

    fwd.register_autograd(backward, setup_context=setup)
    return fwd, bwd


_flash_fwd_lse_seg, _flash_bwd_seg = _register_masked("seg")
_flash_fwd_lse_rowmask, _flash_bwd_rowmask = _register_masked("rowmask")


# ---------------------------------------------------------------------------
# forward with a differentiable lse (the lse cotangent into K2)
# ---------------------------------------------------------------------------

def flash_attention_with_lse(q, k, v, causal: bool = False, scale=None):
    """(out, lse [b, hq, s_q] fp32) with lse differentiable
    (``flash_attention_with_lse`` :757, which ring attention's merge
    differentiates through): the backward folds the lse cotangent l-bar
    into K2's delta, ``dS = P (dP - delta + l-bar)``. Runs the op
    ``paddle_tpu_torch::flash_fwd_with_lse`` (K1 with lse, counted in
    ``flash_attention_forward.launches``) and, for gradients,
    ``paddle_tpu_torch::flash_bwd_glse`` (K2 with l-bar, then K3); CPU
    tensors run the plain versions."""
    _check(q, k, v)
    return torch.ops.paddle_tpu_torch.flash_fwd_with_lse(
        q, k, v, bool(causal), _default_scale(q, scale))


@torch.library.custom_op("paddle_tpu_torch::flash_fwd_with_lse",
                         mutates_args=(), device_types="cuda")
def _flash_fwd_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, scale: float
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    out, lse = _launch_forward(q, k, v, causal, scale, with_lse=True)
    flash_attention_forward.launches += 1
    return out, lse


@_flash_fwd_with_lse.register_kernel("cpu")
def _flash_fwd_with_lse_cpu(q, k, v, causal, scale):
    return flash_attention_reference_lse(q, k, v, causal, scale)


@_flash_fwd_with_lse.register_fake
def _flash_fwd_with_lse_fake(q, k, v, causal, scale):
    return _flash_fwd_lse_fake(q, k, v, causal, scale)


@torch.library.custom_op("paddle_tpu_torch::flash_bwd_glse", mutates_args=(),
                         device_types="cuda")
def _flash_bwd_glse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    o: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                    g_lse: Optional[torch.Tensor], causal: bool, scale: float
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 with the lse cotangent (None: a null pointer, the dense K2), then
    K3, on CUDA tensors."""
    _check_kernel(q, k, v, o, dout)
    if q.numel() == 0 or k.shape[1] == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dq, delta = _launch_dq(q, k, v, o, lse, dout, causal, scale,
                           g_lse=g_lse)
    dk, dv = _launch_dkv(q, k, v, dout, lse, delta, causal, scale)
    return dq, dk, dv


@_flash_bwd_glse.register_kernel("cpu")
def _flash_bwd_glse_cpu(q, k, v, o, lse, dout, g_lse, causal, scale):
    return flash_attention_backward_reference(q, k, v, o, lse, dout, causal,
                                              scale, g_lse=g_lse)


@_flash_bwd_glse.register_fake
def _flash_bwd_glse_fake(q, k, v, o, lse, dout, g_lse, causal, scale):
    return (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))


def _flash_fwd_with_lse_setup(ctx, inputs, output):
    q, k, v, causal, scale = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.causal, ctx.scale = causal, scale
    ctx.set_materialize_grads(False)


def _flash_fwd_with_lse_backward(ctx, dout, dlse):
    """The custom VJP ``_fwl_fwd`` / ``_fwl_bwd`` (:769-787). Autograd gives
    no cotangent for an output the loss does not use: a missing dout is
    zeros, a missing l-bar stays None (no operand)."""
    if dout is None and dlse is None:
        return None, None, None, None, None
    q, k, v, out, lse = ctx.saved_tensors
    dout = torch.zeros_like(out) if dout is None else dout.contiguous()
    g_lse = None if dlse is None else dlse.float().contiguous()
    dq, dk, dv = torch.ops.paddle_tpu_torch.flash_bwd_glse(
        q, k, v, out, lse, dout, g_lse, ctx.causal, ctx.scale)
    return dq, dk, dv, None, None


_flash_fwd_with_lse.register_autograd(_flash_fwd_with_lse_backward,
                                      setup_context=_flash_fwd_with_lse_setup)


# the mask operands of the C interfaces: q_seg, kv_seg, start, end, hm
_MASK_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int]


def _flash_lib():
    lib = _build.load("flash_fwd")
    fn = lib.paddle_flash_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + _MASK_ARGTYPES
                       + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _flash_bwd_lib():
    lib = _build.load("flash_bwd")
    # dq also takes g_lse before the mask operands
    for name, ptrs in (("paddle_flash_bwd_dq", 9),
                       ("paddle_flash_bwd_dkv", 8)):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = ([ctypes.c_void_p] * ptrs + _MASK_ARGTYPES
                           + [ctypes.c_int] * 7
                           + [ctypes.POINTER(ctypes.c_longlong),
                              ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
    return lib
