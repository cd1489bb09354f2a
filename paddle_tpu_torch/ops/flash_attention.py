"""Flash attention forward: the hand-written CUDA kernel and its plain version.

Port of ``paddle_tpu/ops/flash_attention.py``: :func:`flash_attention` is the
public entry (``flash_attention`` :831) on the ``[batch, seq, heads,
head_dim]`` layout, and :func:`flash_attention_reference` is the plain
PyTorch version of ``_xla_reference`` (:62). On a CUDA tensor the wrapper
launches ``csrc/flash_fwd.cu`` (the port of the Pallas kernel
``_fa_fwd_kernel``, :117) or raises; on a CPU tensor it runs the plain
version. Forward only: the backward kernels (K2/K3) belong to the training
slice, so tensors that require grad are refused.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

NEG_INF = -1e30
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (64, 128)


def flash_attention_reference(q, k, v, causal: bool = False, scale=None):
    """Plain attention with the same semantics as the kernel: fp32 math,
    GQA by repeating each kv head over its q heads, end-aligned causal mask
    ``tril(k=s_kv - s_q)`` with the finite mask value. q [b, s_q, hq, d],
    k/v [b, s_kv, hkv, d]; returns q's shape and dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qh = q.transpose(1, 2).float()
    kh = k.transpose(1, 2).float()
    vh = v.transpose(1, 2).float()
    if kh.shape[1] != qh.shape[1]:
        rep = qh.shape[1] // kh.shape[1]
        kh = kh.repeat_interleave(rep, dim=1)
        vh = vh.repeat_interleave(rep, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * scale
    if causal:
        ql, kl = logits.shape[-2], logits.shape[-1]
        mask = torch.ones(ql, kl, dtype=torch.bool,
                          device=q.device).tril(kl - ql)
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vh)
    return out.transpose(1, 2).to(q.dtype)


def _check(q, k, v):
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "flash_attention is forward-only in this port: the backward "
            "kernels come with the training slice")
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


def flash_attention(q, k, v, causal: bool = False, scale=None):
    """Attention over ``[batch, seq, heads, head_dim]`` tensors (GQA when k/v
    have fewer heads; end-aligned causal mask when ``causal``). Returns q's
    shape and dtype. CUDA tensors run the kernel (bf16 on the tensor cores
    or fp32 on FMAs, head_dim 64 or 128, any sequence lengths); CPU tensors
    run :func:`flash_attention_reference`."""
    _check(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, "
                         f"not {q.device}")
    if q.dtype not in _KERNEL_DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash kernel takes bf16 or fp32 (one dtype), got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    b, s_q, hq, d = q.shape
    s_kv, hkv = k.shape[1], k.shape[2]
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {_KERNEL_HEAD_DIMS},"
                         f" got {d}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash kernel needs a contiguous head_dim")
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])
            for t in (q, k, v)):
        raise ValueError("bf16 flash kernel reads rows as 16-byte vectors: "
                         "q/k/v need 16-byte aligned storage and batch/seq/"
                         "head strides that are multiples of 8")
    if b > 65535 or hq > 65535:
        raise ValueError(f"flash kernel grid limit: batch {b}, heads {hq}")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"q is on {q.device}, the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    out = torch.empty((b, s_q, hq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _flash_lib()
    err = lib.paddle_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _KERNEL_DTYPES[q.dtype], b, s_q, s_kv, hq, hkv, d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        float(scale), int(bool(causal)),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error "
                           f"{err}")
    flash_attention.launches += 1
    return out


#: launches of the CUDA kernel (a plain count; callers reset it to 0)
flash_attention.launches = 0


def _flash_lib():
    lib = _build.load("flash_fwd")
    fn = lib.paddle_flash_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib
