"""Automatic SParsity (n:m structured sparsity) — port of
``paddle_tpu/incubate/asp/__init__.py``.

The masks are computed on the host in numpy by the JAX package's own
algorithms (``get_mask_1d``, ``get_mask_2d_greedy``, ``get_mask_2d_best``
:73-176), so they are byte-equal to its masks. :func:`prune_model` (:255)
multiplies each supported layer's weight by its mask where the weight lies
and leaves the mask on the parameter (as a tensor on its device);
:func:`decorate` wraps an optimizer so that every ``step`` multiplies its
masked parameters by their masks again (:284-308). The compute stays
dense, as in JAX: the 2:4 pattern is kept, not run on sparse tensor cores.
"""

from __future__ import annotations

import itertools
from enum import Enum

import numpy as np
import torch

__all__ = [
    "calculate_density", "decorate", "prune_model",
    "set_excluded_layers", "reset_excluded_layers", "add_supported_layer",
    "MaskAlgo", "CheckMethod", "get_mask_1d", "get_mask_2d_greedy",
    "get_mask_2d_best", "check_mask_1d", "check_mask_2d", "create_mask",
    "check_sparsity", "OptimizerWithSparsityGuarantee",
]


class MaskAlgo(Enum):
    MASK_1D = "get_mask_1d"
    MASK_2D_GREEDY = "get_mask_2d_greedy"
    MASK_2D_BEST = "get_mask_2d_best"


class CheckMethod(Enum):
    CHECK_1D = "check_mask_1d"
    CHECK_2D = "check_mask_2d"

    @staticmethod
    def get_checking_method(mask_algo: "MaskAlgo") -> "CheckMethod":
        """CHECK_1D for MASK_1D, CHECK_2D for the 2D algorithms."""
        return (CheckMethod.CHECK_1D if mask_algo == MaskAlgo.MASK_1D
                else CheckMethod.CHECK_2D)


def _np(x):
    """A tensor (any device; bf16 and fp16 as float32, which orders the
    same values the same way) or an array as a numpy array."""
    if isinstance(x, torch.Tensor):
        t = x.detach().as_subclass(torch.Tensor)
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(x)


def calculate_density(x) -> float:
    """nonzero fraction of x (utils.py:86)."""
    a = _np(x)
    return float(np.count_nonzero(a)) / max(a.size, 1)


def _pad_cols(mat, m):
    pad = (-mat.shape[1]) % m
    if pad:
        mat = np.concatenate([mat, np.zeros((mat.shape[0], pad), mat.dtype)],
                             axis=1)
    return mat, pad


def check_mask_1d(mat, n: int, m: int) -> bool:
    """True iff every 1 x m block has >= n zeros (utils.py:142)."""
    mat = np.asarray(mat)
    mat, _ = _pad_cols(mat.reshape(mat.shape[0], -1) if mat.ndim > 1
                       else mat.reshape(1, -1), m)
    blocks = mat.reshape(-1, m)
    return bool(((blocks == 0).sum(axis=1) >= n).all())


def get_mask_1d(mat, n: int, m: int):
    """Keep the m-n largest |values| per 1 x m block — at least n zeros per
    block (utils.py:192). 1-D input is treated as one row, matching
    check_mask_1d."""
    mat = np.asarray(mat)
    if mat.ndim == 1:
        return get_mask_1d(mat.reshape(1, -1), n, m).reshape(-1)
    orig_cols = mat.shape[1]
    padded, pad = _pad_cols(mat, m)
    blocks = np.abs(padded.reshape(-1, m))
    keep = m - n
    # argsort ascending; zero out the n smallest per block
    order = np.argsort(blocks, axis=1, kind="stable")
    mask = np.zeros_like(blocks, dtype=mat.dtype)
    np.put_along_axis(mask, order[:, -keep:] if keep else order[:, :0],
                      1, axis=1)
    mask = mask.reshape(padded.shape)[:, :orig_cols]
    return mask


def check_mask_2d(mat, n: int, m: int) -> bool:
    """True iff every m x m block has >= n zeros per row AND per column
    (utils.py:277)."""
    mat = np.asarray(mat)
    r_pad = (-mat.shape[0]) % m
    c_pad = (-mat.shape[1]) % m
    mat = np.pad(mat, ((0, r_pad), (0, c_pad)))
    R, C = mat.shape
    for i in range(0, R, m):
        for j in range(0, C, m):
            b = mat[i:i + m, j:j + m]
            if ((b == 0).sum(axis=1) < n).any() or \
                    ((b == 0).sum(axis=0) < n).any():
                return False
    return True


def get_mask_2d_greedy(mat, n: int, m: int):
    """Per m x m block, keep entries in descending |value| while each row
    and column keeps at most m-n (utils.py:334)."""
    mat = np.asarray(mat)
    orig = mat.shape
    r_pad = (-mat.shape[0]) % m
    c_pad = (-mat.shape[1]) % m
    p = np.pad(mat, ((0, r_pad), (0, c_pad)))
    mask = np.zeros_like(p, dtype=mat.dtype)
    keep = m - n
    R, C = p.shape
    for i in range(0, R, m):
        for j in range(0, C, m):
            b = np.abs(p[i:i + m, j:j + m])
            rk = np.zeros(m, np.int32)
            ck = np.zeros(m, np.int32)
            for flat in np.argsort(-b, axis=None, kind="stable"):
                r, c = divmod(int(flat), m)
                if rk[r] < keep and ck[c] < keep:
                    mask[i + r, j + c] = 1
                    rk[r] += 1
                    ck[c] += 1
    return mask[:orig[0], :orig[1]]


_2D_PATTERNS: dict = {}


def _valid_2d_patterns(n, m):
    """All m x m 0/1 patterns with exactly m-n kept per row and column
    (reference _compute_valid_2d_patterns)."""
    key = (n, m)
    if key not in _2D_PATTERNS:
        keep = m - n
        rows = [np.asarray(p) for p in itertools.combinations(range(m), keep)]
        row_masks = []
        for p in rows:
            r = np.zeros(m, np.int64)
            r[list(p)] = 1
            row_masks.append(r)
        pats = []
        for combo in itertools.product(row_masks, repeat=m):
            g = np.stack(combo)
            if (g.sum(axis=0) == keep).all():
                pats.append(g)
        _2D_PATTERNS[key] = np.stack(pats)
    return _2D_PATTERNS[key]


def get_mask_2d_best(mat, n: int, m: int):
    """Exhaustive per-block search over all valid 2D n:m patterns, keeping
    the one with maximal |value| sum (utils.py get_mask_2d_best)."""
    mat = np.asarray(mat)
    orig = mat.shape
    r_pad = (-mat.shape[0]) % m
    c_pad = (-mat.shape[1]) % m
    p = np.pad(mat, ((0, r_pad), (0, c_pad)))
    pats = _valid_2d_patterns(n, m)  # [P, m, m]
    mask = np.zeros_like(p, dtype=mat.dtype)
    R, C = p.shape
    for i in range(0, R, m):
        for j in range(0, C, m):
            b = np.abs(p[i:i + m, j:j + m])
            scores = (pats * b[None]).sum(axis=(1, 2))
            mask[i:i + m, j:j + m] = pats[int(np.argmax(scores))]
    return mask[:orig[0], :orig[1]]


def _algo_value(name: str) -> str:
    """Normalize 'mask_1d' / '1d' / 'get_mask_1d' to the enum value."""
    if name.startswith("get_mask_"):
        return name
    if name.startswith("mask_"):
        return "get_" + name
    return "get_mask_" + name


def _as_2d(t):
    """Weight layout handling like the reference's create_mask: 1-D as one
    row, 2-D as-is, 3/4-D flattened to [dim0, rest]."""
    a = np.asarray(t)
    if a.ndim == 1:
        return a.reshape(1, -1), a.shape
    if a.ndim == 2:
        return a, a.shape
    return a.reshape(a.shape[0], -1), a.shape


def create_mask(tensor, func_name=MaskAlgo.MASK_1D, n: int = 2, m: int = 4):
    """n:m mask for a weight tensor of any rank (utils.py create_mask)."""
    if isinstance(func_name, str):
        func_name = MaskAlgo(_algo_value(func_name))
    mat, shape = _as_2d(_np(tensor))
    fn = globals()[func_name.value]
    return fn(mat, n, m).reshape(shape)


def check_sparsity(tensor, func_name=CheckMethod.CHECK_1D, n: int = 2,
                   m: int = 4) -> bool:
    """Check a weight tensor of any rank against the n:m pattern."""
    if isinstance(func_name, str):
        func_name = CheckMethod(func_name if func_name.startswith("check_")
                                else f"check_mask_{func_name}")
    mat, _ = _as_2d(_np(tensor))
    return globals()[func_name.value](mat, n, m)


# ---------------------------------------------------------------------------
# workflow: excluded layers, prune_model, decorate
# ---------------------------------------------------------------------------

_EXCLUDED: set = set()
_SUPPORTED_TYPES = {"Linear", "Conv2D"}


def set_excluded_layers(layers, main_program=None):
    """Exclude layers (by name or name prefix) from pruning."""
    for name in layers:
        _EXCLUDED.add(str(name))


def reset_excluded_layers(main_program=None):
    """Clear the exclusion list."""
    _EXCLUDED.clear()


def add_supported_layer(layer, pruning_func=None):
    """Register another layer type (a class, an instance or a class name)
    as prunable. A ``pruning_func`` (which the JAX package takes and
    ignores) raises."""
    if pruning_func is not None:
        raise NotImplementedError(
            "add_supported_layer(pruning_func=...): the JAX package takes "
            "it and ignores it")
    name = layer if isinstance(layer, str) else type(layer).__name__ \
        if not isinstance(layer, type) else layer.__name__
    _SUPPORTED_TYPES.add(name)


def _prunable_params(model):
    for lname, layer in model.named_sublayers():
        if type(layer).__name__ not in _SUPPORTED_TYPES:
            continue
        if any(lname == e or lname.startswith(e + ".") for e in _EXCLUDED):
            continue
        w = getattr(layer, "weight", None)
        if w is not None and w.ndim >= 2:
            yield lname, w


def prune_model(model, n: int = 2, m: int = 4, mask_algo: str = "mask_1d",
                with_mask: bool = True):
    """Prune every supported layer's weight to the n:m pattern; with
    ``with_mask`` the mask stays on the parameter (``_asp_mask``, on its
    device, in its dtype) for :func:`decorate`. 2-D weights are masked on
    the transposed matrix (the pattern runs along the reduction axis).
    Returns {parameter name: numpy mask}."""
    algo = MaskAlgo(_algo_value(mask_algo))
    masks = {}
    for lname, w in _prunable_params(model):
        a = _np(w)
        if a.ndim == 2:
            mask = create_mask(a.T, algo, n, m).T
        else:
            mask = create_mask(a, algo, n, m)
        dev_mask = torch.from_numpy(np.ascontiguousarray(mask)).to(
            device=w.device, dtype=w.dtype)
        with torch.no_grad():
            w.as_subclass(torch.Tensor).mul_(dev_mask)
        if with_mask:
            w._asp_mask = dev_mask
        masks[lname + ".weight"] = mask
    return masks


class OptimizerWithSparsityGuarantee:
    """An optimizer whose ``step`` multiplies each of its parameters that
    :func:`prune_model` masked by its mask again, so the pattern survives
    training; everything else is the wrapped optimizer's."""

    def __init__(self, optimizer):
        self._optimizer = optimizer

    def __getattr__(self, item):
        return getattr(self._optimizer, item)

    def step(self):
        self._optimizer.step()
        with torch.no_grad():
            for w in self._optimizer._parameter_list or []:
                mask = getattr(w, "_asp_mask", None)
                if mask is not None:
                    w.as_subclass(torch.Tensor).mul_(mask)


def decorate(optimizer) -> OptimizerWithSparsityGuarantee:
    """Wrap ``optimizer`` to keep the ASP masks after each step."""
    return OptimizerWithSparsityGuarantee(optimizer)
