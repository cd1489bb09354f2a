"""Mixture-of-Experts layer — port of
``paddle_tpu/incubate/distributed/models/moe/moe_layer.py`` with its
dropless ``pgmm`` dispatch.

Tokens go to their top-k experts with no capacity and no drop: the
(token, choice) rows are sorted by expert into a zero-padded, tile-aligned
buffer (``ops.grouped_matmul.padded_group_layout``), the expert FFN runs
as padded grouped matmuls (``ops.pgmm``: K5 forward and dx, K6 dw on the
card) and the rows come back weighted by their renormalised gate
probabilities. Module and parameter names are the JAX layer's
(``gate.gate_weight``, ``experts.w_gate`` ...), so ``weights.
load_jax_state`` carries a JAX MoE model across as it is.

The capacity dispatches (``einsum``, ``scatter``, and ``auto``, which
picks one of them) and ``ragged`` arrive with a later slice and raise
here, as does an expert layer's dense ``forward`` that they call.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .....device import resolve_device, resolve_dtype
from .....ops import grouped_matmul as gm
from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate, \
    _load_balance_loss

DISPATCH_MODES = ("auto", "einsum", "scatter", "ragged", "pgmm")


def _check_dispatch(mode: str) -> None:
    if mode not in DISPATCH_MODES:
        raise ValueError(f"dispatch_mode must be auto/einsum/scatter/ragged/"
                         f"pgmm, got {mode!r}")
    if mode != "pgmm":
        raise NotImplementedError(
            f"dispatch_mode={mode!r} is not ported yet: the capacity "
            "(einsum/scatter, and auto, which picks one of them) and ragged "
            "dispatches arrive with a later MoE slice; this slice runs "
            "dispatch_mode='pgmm'")


def routed_ffn(tokens, probs, expert_fn, k: int, capacity: int,
               renormalize: bool = True, dispatch_mode: str = "auto"):
    """Dispatch -> expert_fn -> combine (``routed_ffn`` :36, pgmm branch
    :73-106). tokens [n, d], probs [n, E] -> (out [n, d'], aux). Dropless:
    ``capacity`` is ignored, as in the JAX package's grouped modes."""
    _check_dispatch(dispatch_mode)
    if getattr(expert_fn, "forward_pgmm", None) is None:
        raise NotImplementedError(
            "dispatch_mode='pgmm' needs an expert layer with forward_pgmm "
            "(the JAX package falls back to the scatter dispatch, which is "
            "not ported yet)")
    n, d = tokens.shape
    e = probs.shape[-1]
    w, eidx = torch.topk(probs, k, dim=-1)                      # [n, k]
    if renormalize and k > 1:
        w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    # the first choice's one-hot (a comparison: F.one_hot may read its
    # input's range on the host)
    first = eidx[:, :1] == torch.arange(e, device=eidx.device)
    aux = _load_balance_loss(probs, first)
    flat_e = eidx.reshape(-1)                                   # [n*k]
    order, pos_sorted, tile_gids, p_total = gm.padded_group_layout(
        flat_e, e, n * k)
    # the padded row of each (token, choice) row: pos_sorted by the inverse
    # of the sort (the JAX package's gather by ``order // k`` in, then by
    # ``pos_sorted`` and the inverse permutation out, in one index)
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    x_pad = tokens.new_zeros((p_total, d)).index_put(
        (pos,), tokens.repeat_interleave(k, dim=0))
    out_pad = expert_fn.forward_pgmm(x_pad, tile_gids)
    out_flat = out_pad[pos].reshape(n, k, -1)
    # the "nk,nkd->nd" combine with w cast to the token dtype, summed in
    # fp32 as elementwise work: as an einsum it is a batched matmul of
    # depth k, which cuBLAS runs as n tiny GEMMs
    wk = w.to(tokens.dtype).float()[..., None]
    out = (wk * out_flat.float()).sum(1).to(tokens.dtype)
    return out, aux


def _normal(shape, dtype, std, device, gen):
    t = torch.empty(shape, dtype=resolve_dtype(dtype), device=device)
    t.normal_(0.0, std, generator=gen)
    return nn.Parameter(t)


def _dense_forward_later():
    return NotImplementedError(
        "the experts' dense [E, C, d] forward serves the capacity "
        "dispatches, which are not ported yet (dispatch_mode='pgmm' calls "
        "forward_pgmm)")


class ExpertFFN(nn.Module):
    """Stacked per-expert FFN with biases (``ExpertFFN`` :138): w1 [E, d,
    h], b1 [E, h], w2 [E, h, d], b2 [E, d]; the biases start at zero."""

    def __init__(self, num_experts: int, d_model: int, d_hidden: int,
                 activation: str = "gelu", dtype: str = "float32",
                 initializer_range: float = 0.02, *, device=None,
                 generator=None):
        super().__init__()
        if activation not in ("gelu", "relu", "silu"):
            raise ValueError(f"unknown activation {activation}")
        dev = resolve_device(device)
        self.num_experts = num_experts
        self.activation = activation
        self.w1 = _normal((num_experts, d_model, d_hidden), dtype,
                          initializer_range, dev, generator)
        self.b1 = nn.Parameter(torch.zeros((num_experts, d_hidden),
                                           dtype=resolve_dtype(dtype),
                                           device=dev))
        self.w2 = _normal((num_experts, d_hidden, d_model), dtype,
                          initializer_range, dev, generator)
        self.b2 = nn.Parameter(torch.zeros((num_experts, d_model),
                                           dtype=resolve_dtype(dtype),
                                           device=dev))

    def forward(self, x):
        raise _dense_forward_later()

    def _act(self, h):
        if self.activation == "gelu":
            return F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
        if self.activation == "relu":
            return F.relu(h)
        return F.silu(h)

    def forward_pgmm(self, x_pad, tile_gids, tile_m=None):
        """The pgmm path (:193-205): biases follow each row's tile expert
        (pad rows get one too; their outputs are never gathered back)."""
        tile_m = tile_m or gm.TILE_M
        row_e = tile_gids.long().repeat_interleave(tile_m)
        h = self._act(gm.pgmm(x_pad, self.w1, tile_gids, tile_m)
                      + self.b1[row_e])
        return gm.pgmm(h, self.w2, tile_gids, tile_m) + self.b2[row_e]


class SwiGLUExpertFFN(nn.Module):
    """Llama/Mixtral-style gated experts (``SwiGLUExpertFFN`` :208):
    w_gate, w_up [E, d, h] and w_down [E, h, d]."""

    def __init__(self, num_experts: int, d_model: int, d_hidden: int,
                 dtype: str = "float32", initializer_range: float = 0.02, *,
                 device=None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.num_experts = num_experts
        mk = lambda shape: _normal(shape, dtype, initializer_range, dev,
                                   generator)
        self.w_gate = mk((num_experts, d_model, d_hidden))
        self.w_up = mk((num_experts, d_model, d_hidden))
        self.w_down = mk((num_experts, d_hidden, d_model))

    def forward(self, x):
        raise _dense_forward_later()

    def forward_pgmm(self, x_pad, tile_gids, tile_m=None):
        """Dropless grouped swiglu through K5 (:245-255): three grouped
        matmuls a forward; their backward runs K5 (dx) and K6 (dw) three
        times each."""
        tile_m = tile_m or gm.TILE_M
        g = gm.pgmm(x_pad, self.w_gate, tile_gids, tile_m)
        u = gm.pgmm(x_pad, self.w_up, tile_gids, tile_m)
        return gm.pgmm(F.silu(g) * u, self.w_down, tile_gids, tile_m)


class MoELayer(nn.Module):
    """Mixture of Experts (``MoELayer`` :258-350).

    Args as the JAX layer's: ``d_model``, ``num_experts``, ``d_hidden``,
    ``experts`` (default :class:`ExpertFFN`), ``gate`` ("gshard" or
    "naive"/"topk", or a BaseGate), ``top_k``, ``capacity_factor``,
    ``activation``, ``dtype``, ``dispatch_mode`` (only "pgmm" is ported);
    and the port's ``device`` and ``generator`` for the initial weights."""

    def __init__(self, d_model: int, num_experts: int,
                 d_hidden: Optional[int] = None,
                 experts: Optional[nn.Module] = None, gate="gshard",
                 top_k: Optional[int] = None,
                 capacity_factor: Optional[float] = None,
                 activation: str = "gelu", dtype: str = "float32",
                 recompute_interval: int = 0, group=None,
                 dispatch_mode: str = "auto", *, device=None,
                 generator=None):
        super().__init__()
        _check_dispatch(dispatch_mode)
        self.d_model = d_model
        self.num_experts = num_experts
        self.dispatch_mode = dispatch_mode
        # capacity precedence: explicit arg > the gate's capacity > 1.25
        if capacity_factor is None and isinstance(gate, BaseGate):
            capacity_factor = getattr(gate, "capacity_factor", None)
        self.capacity_factor = (1.25 if capacity_factor is None
                                else capacity_factor)
        self.experts = experts if experts is not None else ExpertFFN(
            num_experts, d_model, d_hidden or 4 * d_model, activation, dtype,
            device=device, generator=generator)
        kw = dict(device=device, generator=generator)
        if isinstance(gate, BaseGate):
            self.gate = gate
            self.top_k = getattr(gate, "top_k", top_k or 2)
        elif gate == "gshard":
            self.top_k = top_k or 2
            self.gate = GShardGate(d_model, num_experts, topk=self.top_k, **kw)
        elif gate == "switch":
            self.top_k = 1
            self.gate = SwitchGate(d_model, num_experts, **kw)
        elif gate in ("naive", "topk"):
            self.top_k = top_k or 2
            self.gate = NaiveGate(d_model, num_experts, topk=self.top_k, **kw)
        else:
            raise ValueError(f"unknown gate {gate!r}")

    def capacity(self, num_tokens: int) -> int:
        cap = int(math.ceil(num_tokens * self.top_k * self.capacity_factor
                            / self.num_experts))
        return max(cap, self.top_k)

    def forward(self, x):
        """x: [batch, seq, d_model] or [tokens, d_model] -> the same shape;
        the gate keeps the aux loss (:meth:`get_loss`)."""
        tokens = x.reshape(-1, x.shape[-1])
        probs = self.gate.probs(tokens)
        out, aux = routed_ffn(tokens, probs, self.experts, self.top_k,
                              self.capacity(tokens.shape[0]),
                              getattr(self.gate, "renormalize", True),
                              dispatch_mode=self.dispatch_mode)
        if not getattr(self.gate, "use_aux", True):
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        self.gate.set_loss(aux)
        return out.reshape(x.shape)

    def get_loss(self, clear=True):
        """The gate's aux (load-balance) loss for this forward."""
        return self.gate.get_loss(clear=clear)
