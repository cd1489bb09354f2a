"""Flash attention, forward and backward: the hand-written CUDA kernels and
their plain versions.

Port of ``paddle_tpu/ops/flash_attention.py`` on the ``[batch, seq, heads,
head_dim]`` layout:

- :func:`flash_attention` is the public entry (``flash_attention`` :831).
  Without gradients it runs the primal forward (``_flash`` :700, no lse
  written); when grad is enabled and an input requires grad it runs the
  ``torch.autograd.Function`` that mirrors the custom VJP ``_flash_fwd`` /
  ``_flash_bwd`` (:709-733): the forward with lse, then the backward.
- :func:`flash_attention_forward` returns ``(out, lse)``, lse ``[b, hq,
  s_q]`` fp32 of the scaled logits (``_pallas_forward`` :221 with lse; the
  TPU kernel's 8-lane axis is dropped).
- :func:`flash_attention_backward` returns ``(dq, dk, dv)`` from the saved
  ``(q, k, v, out, lse)`` and ``dout`` (``_pallas_backward`` :497).

On CUDA tensors the wrappers launch ``csrc/flash_fwd.cu`` (K1,
``_fa_fwd_kernel`` :117) and ``csrc/flash_bwd.cu`` (K2 ``_fa_bwd_dq_kernel``
:337, K3 ``_fa_bwd_dkv_kernel`` :420) or raise; on CPU tensors they run the
plain versions :func:`flash_attention_reference`,
:func:`flash_attention_reference_lse` (``_xla_reference_lse`` :736) and
:func:`flash_attention_backward_reference`, which applies the kernels'
formulas (P from the saved lse, delta from the stored output) rather than
autograd through the forward.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

NEG_INF = -1e30
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
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


def flash_attention_backward_reference(q, k, v, o, lse, dout,
                                       causal: bool = False, scale=None):
    """Plain backward with the kernels' formulas: ``P = exp(s - lse)`` (0
    where ``lse <= NEG_INF / 2``), ``delta = rowsum(dout * o)`` from the
    stored output, ``dS = P (dP - delta) scale``; dK and dV summed over each
    kv head's q heads in fp32. Returns (dq, dk, dv) in q's/k's/v's shapes
    and dtypes."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    b, s_q, hq, d = q.shape
    s_kv, hkv = k.shape[1], k.shape[2]
    qh, kh, vh = _heads_first(q, k, v)
    doh = dout.transpose(1, 2).float()
    lse = lse.float()[..., None]
    s = _scaled_logits(qh, kh, causal, scale)
    p = torch.where(lse > NEG_INF / 2, torch.exp(s - lse), 0.0)
    del s
    delta = (doh * o.transpose(1, 2).float()).sum(-1, keepdim=True)
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
    """What the CUDA kernels take: one bf16/fp32 dtype, head_dim 64 or 128,
    a contiguous head_dim, 16-byte rows for bf16, the grid limits and the
    current device. Raises otherwise."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, "
                         f"not {q.device}")
    if q.dtype not in _KERNEL_DTYPES or any(t.dtype != q.dtype
                                            for t in others):
        raise TypeError(f"flash kernels take bf16 or fp32 (one dtype), got "
                        f"{[str(t.dtype) for t in (q, *others)]}")
    d = q.shape[3]
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernels take head_dim in "
                         f"{_KERNEL_HEAD_DIMS}, got {d}")
    if any(t.stride(3) != 1 for t in (q, *others)):
        raise ValueError("flash kernels need a contiguous head_dim")
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])
            for t in (q, *others)):
        raise ValueError("bf16 flash kernels read rows as 16-byte vectors: "
                         "operands need 16-byte aligned storage and batch/"
                         "seq/head strides that are multiples of 8")
    if q.shape[0] > 65535 or q.shape[2] > 65535:
        raise ValueError(f"flash kernel grid limit: batch {q.shape[0]}, "
                         f"heads {q.shape[2]}")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"q is on {q.device}, the current device is "
                         f"cuda:{torch.cuda.current_device()}")


def _launch_forward(q, k, v, causal, scale, with_lse):
    """K1 on CUDA tensors: (out, lse [b, hq, s_q] fp32 or None)."""
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
    shape and dtype. CUDA tensors run the kernels (bf16 on the tensor cores
    or fp32 on FMAs, head_dim 64 or 128, any sequence lengths); CPU tensors
    run the plain versions. Differentiable: with grad enabled and an input
    that requires grad, the forward keeps its lse and the backward runs
    :func:`flash_attention_backward`."""
    _check(q, k, v)
    scale = _default_scale(q, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, bool(causal), scale)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale)
    out, _ = _launch_forward(q, k, v, causal, scale, with_lse=False)
    flash_attention.launches += 1
    return out


#: launches of the primal (no-lse) forward kernel; callers reset it to 0
flash_attention.launches = 0


def flash_attention_forward(q, k, v, causal: bool = False, scale=None):
    """The training forward: (out in q's shape and dtype, lse [b, hq, s_q]
    fp32 of the scaled logits, NEG_INF for a row that sees no key). CUDA
    tensors launch K1 with its lse output; CPU tensors run
    :func:`flash_attention_reference_lse`."""
    _check(q, k, v)
    scale = _default_scale(q, scale)
    if q.device.type == "cpu":
        return flash_attention_reference_lse(q, k, v, causal, scale)
    out, lse = _launch_forward(q, k, v, causal, scale, with_lse=True)
    flash_attention_forward.launches += 1
    return out, lse


#: launches of the forward kernel with its lse output
flash_attention_forward.launches = 0


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


def _launch_dq(q, k, v, o, lse, dout, causal, scale):
    """K2 on CUDA tensors: (dq, delta [b, hq, s_q] fp32)."""
    b, s_q, hq, d = q.shape
    s_kv, hkv = k.shape[1], k.shape[2]
    dq = torch.empty((b, s_q, hq, d), dtype=q.dtype, device=q.device)
    delta = torch.empty((b, hq, s_q), dtype=torch.float32, device=q.device)
    err = _flash_bwd_lib().paddle_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), delta.data_ptr(),
        _KERNEL_DTYPES[q.dtype], b, s_q, s_kv, hq, hkv, d,
        _bwd_strides(q, k, v, o, dout), float(scale), int(bool(causal)),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd dq kernel launch failed: CUDA error "
                           f"{err}")
    flash_attention_backward.launches_dq += 1
    return dq, delta


def _launch_dkv(q, k, v, dout, lse, delta, causal, scale):
    """K3 on CUDA tensors (after K2, whose delta it reads): (dk, dv)."""
    b, s_q, hq, d = q.shape
    s_kv, hkv = k.shape[1], k.shape[2]
    dk = torch.empty((b, s_kv, hkv, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, s_kv, hkv, d), dtype=v.dtype, device=v.device)
    err = _flash_bwd_lib().paddle_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _KERNEL_DTYPES[q.dtype], b, s_q, s_kv, hq, hkv, d,
        _bwd_strides(q, k, v, dout, dout), float(scale), int(bool(causal)),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd dkv kernel launch failed: CUDA error "
                           f"{err}")
    flash_attention_backward.launches_dkv += 1
    return dk, dv


def flash_attention_backward(q, k, v, o, lse, dout, causal: bool = False,
                             scale=None):
    """(dq, dk, dv) of :func:`flash_attention` from the forward's ``o`` and
    ``lse`` (:func:`flash_attention_forward`) and the output gradient
    ``dout``. CUDA tensors launch K2 then K3 on the current stream; CPU
    tensors run :func:`flash_attention_backward_reference`."""
    _check_backward(q, k, v, o, lse, dout)
    scale = _default_scale(q, scale)
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, o, lse, dout,
                                                  causal, scale)
    _check_kernel(q, k, v, o, dout)
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("lse must be a contiguous fp32 [b, hq, s_q] tensor")
    if q.numel() == 0 or k.shape[1] == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dq, delta = _launch_dq(q, k, v, o, lse, dout, causal, scale)
    dk, dv = _launch_dkv(q, k, v, dout, lse, delta, causal, scale)
    return dq, dk, dv


#: launches of K2 (dq) and K3 (dk/dv)
flash_attention_backward.launches_dq = 0
flash_attention_backward.launches_dkv = 0


class _FlashAttention(torch.autograd.Function):
    """The custom VJP of ``_flash`` (:700-733): the forward keeps (q, k, v,
    out, lse); the backward runs :func:`flash_attention_backward`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attention_forward(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, lse, dout.contiguous(), ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def _flash_lib():
    lib = _build.load("flash_fwd")
    fn = lib.paddle_flash_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _flash_bwd_lib():
    lib = _build.load("flash_bwd")
    for name in ("paddle_flash_bwd_dq", "paddle_flash_bwd_dkv"):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                           + [ctypes.POINTER(ctypes.c_longlong),
                              ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
    return lib
