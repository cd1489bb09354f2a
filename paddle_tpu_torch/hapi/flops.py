"""``paddle.flops`` / ``Model.flops`` — the port of the JAX package's
``flops`` (``paddle_tpu/__init__.py:165``), which asks XLA's cost model
(``compiled.cost_analysis()["flops"]``) about one jitted forward.

Torch has no such cost model, so the port runs one forward under a
``TorchDispatchMode`` and counts each aten op it sees by XLA's rules
(``HloCostAnalysis``):

- a product (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``mv``, ``dot``):
  2 M N K, plus one flop per output element for the added bias;
- a convolution: 2 x the output channels x the input channels a group x
  the pairs of (output position, kernel tap) that fall inside the
  unpadded input, per spatial axis (XLA counts no tap on the padding),
  plus the bias's elements;
- an elementwise op, a comparison, a select or a dtype conversion: one a
  result element; a transcendental one (exp, log, tanh, erf, sqrt, rsqrt,
  sigmoid, sin, cos ...): none, as XLA counts those apart;
- a reduction: the input's elements less the output's (``mean`` adds the
  division); ``var_mean`` four an input element, softmax four less two a
  row, as XLA counts their lowered forms; GELU the flops of JAX's lowering
  (64 an element exact, 8 in the tanh form);
- views, copies, gathers, concatenations and creations: none;
- the flash attention ops: the dense lowering the JAX package runs off
  the TPU (two products of 2 s_q s_kv d a head, the scale, the softmax).

Exact where the JAX package's program is a product and an add (tests:
``Linear`` is 2 M N K + M N); within a few percent on the vision and
encoder models (tests/test_torch_flops.py), where XLA's fusion and
simplifier and torch's decompositions lower some elementwise work
differently.
"""

from __future__ import annotations

import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_aten = torch.ops.aten

# no arithmetic: data movement, views, creation, gathers, RNG state
_FREE = {
    "view", "_unsafe_view", "reshape", "expand", "permute", "transpose",
    "t", "unsqueeze", "squeeze", "slice", "select", "as_strided", "clone",
    "contiguous", "copy_", "copy", "detach", "alias", "lift_fresh",
    "empty", "empty_like", "empty_strided", "zeros", "zeros_like", "ones",
    "ones_like", "full", "full_like", "arange", "fill_", "zero_", "new_zeros",
    "new_ones", "new_empty", "new_full", "cat", "stack", "split",
    "split_with_sizes", "chunk", "unbind", "index_select", "embedding",
    "gather", "index", "_reshape_alias", "unfold", "flip", "roll",
    "repeat", "repeat_interleave", "constant_pad_nd", "narrow",
    "scalar_tensor", "_local_scalar_dense", "lift_fresh_copy",
    "expand_copy", "view_copy", "permute_copy",
    "native_dropout_backward", "bernoulli_", "rand", "randn", "randint",
    "uniform_", "normal_", "item", "detach_", "set_", "resize_",
}
# XLA counts these as transcendentals, not flops
_TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "tanh", "erf",
    "erfc", "erfinv", "sqrt", "rsqrt", "sigmoid", "sin", "cos", "tan",
    "asin", "acos", "atan", "atan2", "sinh", "cosh", "asinh", "acosh",
    "atanh", "pow", "lgamma", "digamma",
}
_REDUCE = {"sum", "amax", "amin", "max", "min", "prod", "argmax", "argmin",
           "any", "all", "logsumexp", "norm", "linalg_vector_norm"}


def _numel(t):
    if isinstance(t, torch.Tensor):
        return t.numel()
    if isinstance(t, (tuple, list)):
        return sum(_numel(x) for x in t)
    return 0


def _first(t):
    return t[0] if isinstance(t, (tuple, list)) else t


def _valid_taps(size, k, stride, pad, dil, out):
    """Pairs (output position, kernel tap) along one axis whose input
    index lies inside the unpadded input."""
    n = 0
    for o in range(out):
        for j in range(k):
            i = o * stride - pad + j * dil
            n += 0 <= i < size
    return n


def _conv_flops(args, out):
    x, w, bias = args[0], args[1], args[2]
    stride, padding, dilation = args[3], args[4], args[5]
    transposed, groups = args[6], args[8]
    if transposed:   # as the gradient of a convolution: every tap counts
        return 2 * out.numel() * w.shape[0] // groups * math.prod(
            w.shape[2:]) + (out.numel() if bias is not None else 0)
    spatial = len(w.shape) - 2
    taps = 1
    for ax in range(spatial):
        taps *= _valid_taps(x.shape[2 + ax], w.shape[2 + ax], stride[ax],
                            padding[ax], dilation[ax], out.shape[2 + ax])
    per = 2 * out.shape[0] * w.shape[0] * w.shape[1] * taps
    return per + (out.numel() if bias is not None else 0)


def _attention_flops(q, k, causal):
    """The dense attention the JAX package lowers off the TPU, over [b, s,
    h, d] q and k: two products, the scale, the causal select, the fp32
    softmax."""
    b, s_q, h, d = q.shape
    s_kv = k.shape[1]
    n = b * h * s_q * s_kv
    rows = b * h * s_q
    return 4 * n * d + n + (2 * n if causal else 0) + 4 * n - 2 * rows


def op_flops(func, args, kwargs, out) -> int:
    """XLA's flops for one call of the op overload ``func`` (aten's or the
    port's)."""
    name = func.__name__.split(".")[0]
    ns = func.namespace
    if ns == "paddle_tpu_torch" and name.startswith("flash_fwd"):
        return _attention_flops(args[0], args[1], bool(args[3]))
    if ns != "aten" or name in _FREE or name in _TRANSCENDENTAL:
        return 0
    if name == "mm":
        (m, kk), n = args[0].shape, args[1].shape[1]
        return 2 * m * n * kk
    if name == "addmm":
        (m, kk), n = args[1].shape, args[2].shape[1]
        return 2 * m * n * kk + m * n
    if name in ("mv", "addmv"):
        a = args[0] if name == "mv" else args[1]
        return 2 * a.shape[0] * a.shape[1] + (a.shape[0] if name == "addmv"
                                              else 0)
    if name == "dot":
        return 2 * args[0].numel()
    if name in ("bmm", "baddbmm"):
        a, b_ = (args[0], args[1]) if name == "bmm" else (args[1], args[2])
        bb, m, kk = a.shape
        n = b_.shape[2]
        return 2 * bb * m * n * kk + (bb * m * n if name == "baddbmm" else 0)
    if name == "convolution":
        return _conv_flops(args, out)
    if name == "_to_copy":
        src = args[0]
        dt = kwargs.get("dtype")
        return src.numel() if dt is not None and dt != src.dtype else 0
    x = args[0] if args and isinstance(args[0], torch.Tensor) else None
    if name in _REDUCE:
        return x.numel() - _numel(_first(out)) if x is not None else 0
    if name == "mean":
        return x.numel()
    if name in ("var_mean", "var", "std", "std_mean"):
        return 4 * x.numel()
    if name in ("_softmax", "_log_softmax", "softmax", "log_softmax"):
        dim = args[1] % x.ndim
        return 4 * x.numel() - 2 * x.numel() // x.shape[dim]
    if name == "gelu":
        approx = kwargs.get("approximate", args[1] if len(args) > 1
                            else "none")
        return x.numel() * (8 if approx == "tanh" else 64)
    if name in ("clamp", "clip", "hardtanh"):   # a max and a min
        return 2 * _numel(out)
    return _numel(_first(out))


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.total = 0
        self.by_op = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        n = op_flops(func, args, kwargs, out)
        if n:
            key = str(func.overloadpacket)
            self.total += n
            self.by_op[key] = self.by_op.get(key, 0) + n
        return out


def _device_of(net):
    for p in net.parameters():
        return p.device
    for b in net.buffers():
        return b.device
    from ..device import resolve_device

    return resolve_device()


def flops(net, input_size, custom_ops=None, print_detail=False) -> int:
    """FLOPs of one forward of ``net`` on a float32 zero input of
    ``input_size`` (on the network's device), counted by XLA's rules (see
    the module). ``custom_ops`` is taken and unused, as in the JAX package
    (its cost model prices every op it compiles; here every aten op is
    priced)."""
    x = torch.zeros(tuple(input_size), dtype=torch.float32,
                    device=_device_of(net))
    counter = _Counter()
    with torch.no_grad(), counter:
        net(x)
    if print_detail:
        for op, n in sorted(counter.by_op.items(), key=lambda kv: -kv[1]):
            print(f"  {op}: {n}")
        print(f"Total Flops: {counter.total}  (XLA's rules, input "
              f"{tuple(input_size)})")
    return int(counter.total)
