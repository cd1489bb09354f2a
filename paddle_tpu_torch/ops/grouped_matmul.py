"""Padded grouped (per-expert) matmul: the hand-written CUDA kernels K5 and
K6 and their plain versions.

Port of ``paddle_tpu/ops/grouped_matmul.py``. Tokens are sorted by expert
and padded so that each expert's rows start at a ``tile_m`` boundary
(:func:`padded_group_layout`); then

- :func:`pgmm` ``(x, w, tile_gids, tile_m)``: ``out[r] = x[r] @
  w[tile_gids[r // tile_m]]`` with an fp32 accumulator, output in x's dtype.
  A ``torch.autograd.Function``, the counterpart of the custom VJP
  ``_pgmm_fwd``/``_pgmm_bwd`` (:184-194): the backward runs K5 again over
  the transposed weights for dx (the kernel's ``trans_w`` mode, no copy of
  ``w^T``) and K6 for dw.
- :func:`pgmm_raw` is the K5 wrapper (``_pgmm_kernel`` :38, called at :76);
  :func:`pgmm_dw` the K6 wrapper (``_pgmm_dw_kernel`` :93, called at :150):
  ``dw[e] = sum of x_r^T dout_r`` over expert e's rows, fp32 ``[E, k, n]``,
  zero for an expert that owns no tile (the kernel writes those zeros
  itself; the JAX package masks after its kernel, ``_mask_unvisited_experts``
  :128).

On CUDA tensors the wrappers launch ``csrc/grouped_matmul.cu`` or raise; on
CPU tensors they run the plain versions :func:`pgmm_reference` and
:func:`pgmm_dw_reference`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

TILE_M = 512
#: the kernels' own row tile; it must divide ``tile_m``
KERNEL_TILE_M = 128
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def padded_group_layout(flat_e, e: int, n_rows: int, tile_m=None):
    """Static-shape padded layout for rows sorted by expert (``:236-263``).

    flat_e [n_rows] integer expert ids (not necessarily sorted). Returns
    (order, padded_pos [n_rows], tile_gids [P // tile_m] int32, P): row
    ``order[r]`` of the input goes to padded row ``padded_pos[r]``; each
    tile belongs to one expert, the pad tail tiles to the last expert over
    zero rows. P = ceil(n_rows / tile_m) * tile_m + e * tile_m comes from
    Python ints, and everything else stays on flat_e's device: no value is
    read on the host."""
    tile_m = tile_m or TILE_M
    p_total = ((n_rows + tile_m - 1) // tile_m) * tile_m + e * tile_m
    dev = flat_e.device
    flat = flat_e.long()
    order = torch.argsort(flat, stable=True)
    se = flat[order]
    gs = torch.zeros(e, dtype=torch.long, device=dev).scatter_add_(
        0, flat, torch.ones_like(flat))
    padded = (gs + tile_m - 1) // tile_m * tile_m
    ends = torch.cumsum(padded, 0)
    pad_off = ends - padded
    off = torch.cumsum(gs, 0) - gs
    rank = torch.arange(n_rows, device=dev) - off[se]
    pos_sorted = pad_off[se] + rank
    tiles = torch.arange(p_total // tile_m, device=dev) * tile_m
    tile_gids = torch.searchsorted(ends, tiles, right=True).clamp_max(e - 1)
    return order, pos_sorted, tile_gids.to(torch.int32), p_total


def pgmm_reference(x, w, tile_gids, tile_m: int = TILE_M,
                   trans_w: bool = False):
    """Plain K5: x [P, k] against w [E, k, n] (``trans_w``: w [E, n, k],
    used as its transpose) by the tile's expert; fp32 products, x's dtype
    out."""
    p, k = x.shape
    wt = w.transpose(1, 2) if trans_w else w
    wg = wt.float()[tile_gids.long()]                     # [T, k, n]
    out = torch.bmm(x.float().reshape(p // tile_m, tile_m, k), wg)
    return out.reshape(p, -1).to(x.dtype)


def pgmm_dw_reference(x, dout, tile_gids, e: int, tile_m: int = TILE_M):
    """Plain K6: dw[e] = sum over expert e's tiles of x_t^T dout_t, fp32
    [E, k, n]; zero for an expert that owns no tile."""
    p, k = x.shape
    t = p // tile_m
    prod = torch.bmm(x.float().reshape(t, tile_m, k).transpose(1, 2),
                     dout.float().reshape(t, tile_m, -1))  # [T, k, n]
    dw = torch.zeros((e, k, prod.shape[2]), dtype=torch.float32,
                     device=x.device)
    return dw.index_add_(0, tile_gids.long(), prod)


def _check(x, tile_gids, tile_m, others):
    if x.ndim != 2 or tile_gids.ndim != 1:
        raise ValueError(f"x must be [P, k] and tile_gids [P // tile_m], got "
                         f"{tuple(x.shape)} and {tuple(tile_gids.shape)}")
    if x.shape[0] % tile_m or tile_gids.shape[0] != x.shape[0] // tile_m:
        raise ValueError(f"P = {x.shape[0]} must be tile_m ({tile_m}) x "
                         f"len(tile_gids) ({tile_gids.shape[0]})")
    if any(t.device != x.device for t in (tile_gids, *others)):
        raise ValueError("all operands must be on one device")


def _check_kernel(x, tile_gids, tile_m, k, n, others):
    """What the CUDA kernels take; raises otherwise."""
    if x.device.type != "cuda":
        raise ValueError(f"pgmm runs on cuda or cpu, not {x.device}")
    if x.dtype not in _KERNEL_DTYPES or any(t.dtype != x.dtype
                                            for t in others):
        raise TypeError(f"pgmm kernels take bf16 or fp32 (one dtype), got "
                        f"{[str(t.dtype) for t in (x, *others)]}")
    if tile_gids.dtype != torch.int32:
        raise TypeError(f"tile_gids must be int32, got {tile_gids.dtype}")
    if not all(t.is_contiguous() for t in (x, tile_gids, *others)):
        raise ValueError("pgmm kernels take contiguous operands")
    if tile_m % KERNEL_TILE_M:
        raise ValueError(f"tile_m {tile_m} must be a multiple of the "
                         f"kernels' row tile {KERNEL_TILE_M}")
    if min(x.shape[0], k, n) == 0:
        raise ValueError(f"empty pgmm operand: P {x.shape[0]}, k {k}, n {n}")
    if x.shape[0] // KERNEL_TILE_M > 65535 or k // 128 >= 65535:
        raise ValueError(f"pgmm kernel grid limit: P {x.shape[0]}, k {k}")
    if x.dtype == torch.bfloat16 and (
            k % 8 or n % 8
            or any(t.data_ptr() % 16 for t in (x, *others))):
        raise ValueError(f"bf16 pgmm kernels load tiles with TMA: k ({k}) "
                         f"and n ({n}) must be multiples of 8 (16-byte row "
                         f"strides) and operands 16-byte aligned")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"x is on {x.device}, the current device is "
                         f"cuda:{torch.cuda.current_device()}")


def pgmm_raw(x, w, tile_gids, tile_m: int = TILE_M, trans_w: bool = False):
    """K5: ``out[r] = x[r] @ w[tile_gids[r // tile_m]]``, or ``@ w[...]^T``
    with ``trans_w`` (w [E, n, k]). Not differentiable (:func:`pgmm` is).
    CUDA tensors launch the kernel; CPU tensors run
    :func:`pgmm_reference`."""
    if w.ndim != 3:
        raise ValueError(f"w must be [E, k, n], got {tuple(w.shape)}")
    _check(x, tile_gids, tile_m, (w,))
    k_w, n = (w.shape[2], w.shape[1]) if trans_w else (w.shape[1],
                                                        w.shape[2])
    if k_w != x.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} "
                         f"(trans_w={trans_w}) do not chain")
    if x.device.type == "cpu":
        return pgmm_reference(x, w, tile_gids, tile_m, trans_w)
    p, k = x.shape
    _check_kernel(x, tile_gids, tile_m, k, n, (w,))
    out = torch.empty((p, n), dtype=x.dtype, device=x.device)
    err = _lib().paddle_pgmm(
        x.data_ptr(), w.data_ptr(), tile_gids.data_ptr(), out.data_ptr(),
        _KERNEL_DTYPES[x.dtype], p, k, n, w.shape[0], tile_m,
        int(bool(trans_w)), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pgmm kernel launch failed: CUDA error {err}")
    pgmm.launches += 1
    return out


def pgmm_dw(x, dout, tile_gids, e: int, tile_m: int = TILE_M):
    """K6: ``dw[e] = sum of x_r^T dout_r`` over the rows of the tiles that
    ``tile_gids`` (monotone non-decreasing, as :func:`padded_group_layout`
    makes it) gives expert e; fp32 [E, k, n], zero for an expert that owns
    no tile. CUDA tensors launch the kernel; CPU tensors run
    :func:`pgmm_dw_reference`."""
    _check(x, tile_gids, tile_m, (dout,))
    if dout.ndim != 2 or dout.shape[0] != x.shape[0]:
        raise ValueError(f"dout {tuple(dout.shape)} must be [P, n] with x's "
                         f"P = {x.shape[0]}")
    if x.device.type == "cpu":
        return pgmm_dw_reference(x, dout, tile_gids, e, tile_m)
    p, k = x.shape
    n = dout.shape[1]
    _check_kernel(x, tile_gids, tile_m, k, n, (dout,))
    if not 0 < e <= 65535:
        raise ValueError(f"pgmm_dw kernel grid limit: {e} experts")
    dw = torch.empty((e, k, n), dtype=torch.float32, device=x.device)
    err = _lib().paddle_pgmm_dw(
        x.data_ptr(), dout.data_ptr(), tile_gids.data_ptr(), dw.data_ptr(),
        _KERNEL_DTYPES[x.dtype], p, k, n, e, tile_m,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pgmm_dw kernel launch failed: CUDA error {err}")
    pgmm_dw.launches += 1
    return dw


#: launches of K6; callers reset it to 0
pgmm_dw.launches = 0


class _Pgmm(torch.autograd.Function):
    """The custom VJP of ``pgmm`` (:173-197)."""

    @staticmethod
    def forward(ctx, x, w, tile_gids, tile_m):
        ctx.save_for_backward(x, w, tile_gids)
        ctx.tile_m = tile_m
        return pgmm_raw(x, w, tile_gids, tile_m)

    @staticmethod
    def backward(ctx, g):
        x, w, tile_gids = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # dx[r] = g[r] @ w[g(r)]^T: K5 in its trans_w mode
            dx = pgmm_raw(g, w, tile_gids, ctx.tile_m, trans_w=True)
        if ctx.needs_input_grad[1]:
            dw = pgmm_dw(x, g, tile_gids, w.shape[0], ctx.tile_m).to(w.dtype)
        return dx, dw, None, None


def pgmm(x, w, tile_gids, tile_m: int = TILE_M):
    """Padded grouped matmul, differentiable with respect to x and w: rows
    of tile t of x [P, k] (sorted by expert, tile-aligned, pad rows zero)
    hit w[tile_gids[t]] of w [E, k, n]; returns [P, n] in x's dtype."""
    return _Pgmm.apply(x, w, tile_gids, tile_m)


#: launches of K5 (forward and the backward's dx); callers reset it to 0
pgmm.launches = 0


def _lib():
    lib = _build.load("grouped_matmul")
    if lib.paddle_pgmm.argtypes is None:
        lib.paddle_pgmm.argtypes = ([ctypes.c_void_p] * 4
                                    + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.paddle_pgmm.restype = ctypes.c_int
        lib.paddle_pgmm_dw.argtypes = ([ctypes.c_void_p] * 4
                                       + [ctypes.c_int] * 6
                                       + [ctypes.c_void_p])
        lib.paddle_pgmm_dw.restype = ctypes.c_int
    return lib
