"""Mixture-of-Experts layer — port of
``paddle_tpu/incubate/distributed/models/moe/moe_layer.py``.

:func:`routed_ffn` is the one dispatch -> experts -> combine pipeline, in
all five of the JAX package's modes:

- ``einsum``: GShard's dense one-hot dispatch and combine ``[n, E, C]``
  (:func:`gate.topk_dispatch`) and the experts' dense ``[E, C, d]`` forward.
- ``scatter``: the same routing (:func:`gate.topk_routing`), the kept
  (token, choice) rows written into their ``[E * C]`` slots and gathered
  back: O(n k d) instead of O(n E C d).
- ``auto``: ``scatter`` when ``E >= 16`` or the one-hot buffers would hold
  more than 2^24 elements, else ``einsum`` (``LlamaConfig``'s default).
- ``ragged``: dropless; rows sorted by expert through the experts'
  ``forward_ragged`` (``ops.grouped_dot``: K5/K6 on the card).
- ``pgmm``: dropless; the sorted rows in a zero-padded tile-aligned buffer
  (``ops.grouped_matmul.padded_group_layout``) through the experts'
  ``forward_pgmm`` (``ops.pgmm``: K5 forward and dx, K6 dw on the card).

An expert layer without ``forward_ragged`` / ``forward_pgmm`` takes the
``scatter`` dispatch for those modes, as in the JAX package (routing
semantics, not a device fallback). Module and parameter names are the JAX
layer's (``gate.gate_weight``, ``experts.w_gate`` ...), so ``weights.
load_jax_state`` carries a JAX MoE model across as it is.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .....device import resolve_device, resolve_dtype
from .....ops import grouped_matmul as gm
from .gate import (BaseGate, GShardGate, NaiveGate, SwitchGate,
                   _load_balance_loss, topk_dispatch, topk_routing)

DISPATCH_MODES = ("auto", "einsum", "scatter", "ragged", "pgmm")


def _check_dispatch(mode: str) -> None:
    if mode not in DISPATCH_MODES:
        raise ValueError(f"dispatch_mode must be auto/einsum/scatter/ragged/"
                         f"pgmm, got {mode!r}")


def resolve_dispatch(mode: str, n: int, e: int, capacity: int,
                     expert_fn) -> str:
    """The dispatch :func:`routed_ffn` runs (:67-75): ``auto`` is
    ``scatter`` iff ``e >= 16`` or ``n * e * capacity > 2**24`` (the dense
    one-hot buffers grow as n^2), else ``einsum``; ``ragged`` / ``pgmm`` on
    an expert layer without ``forward_ragged`` / ``forward_pgmm`` is
    ``scatter``. All from Python ints: no host read."""
    _check_dispatch(mode)
    if mode == "auto":
        mode = "scatter" if e >= 16 or n * e * capacity > (1 << 24) \
            else "einsum"
    if mode in ("ragged", "pgmm") and getattr(
            expert_fn, "forward_" + mode, None) is None:
        mode = "scatter"
    return mode


def _combine(w, rows, dtype):
    """The ``"nk,nkd->nd"`` combine with the weights cast to ``dtype``,
    summed in fp32 as elementwise work (as an einsum it is a batched matmul
    of depth k, which cuBLAS runs as n tiny GEMMs); out in ``dtype``."""
    wk = w.to(dtype).float()[..., None]
    return (wk * rows.float()).sum(1).to(dtype)


def routed_ffn(tokens, probs, expert_fn, k: int, capacity: int,
               renormalize: bool = True, dispatch_mode: str = "auto"):
    """Dispatch -> expert_fn -> combine (``routed_ffn`` :36-135). tokens
    [n, d], probs [n, E]; expert_fn maps [E, C, d] -> [E, C, d'] (and has
    ``forward_ragged`` / ``forward_pgmm`` for the grouped modes). Returns
    (out [n, d'], aux). ``capacity`` is ignored by the dropless modes."""
    n, d = tokens.shape
    e = probs.shape[-1]
    mode = resolve_dispatch(dispatch_mode, n, e, capacity, expert_fn)
    if mode in ("ragged", "pgmm"):
        return _grouped(tokens, probs, expert_fn, k, renormalize, mode)
    if mode == "einsum":
        combine, dispatch, aux = topk_dispatch(probs, k, capacity,
                                               renormalize)
        expert_in = torch.einsum("nec,nd->ecd", dispatch.to(tokens.dtype),
                                 tokens)
        expert_out = expert_fn(expert_in)
        out = torch.einsum("nec,ecd->nd", combine.to(tokens.dtype),
                           expert_out)
        return out, aux
    eidx, cpos, w, keep, aux = topk_routing(probs, k, capacity, renormalize)
    slot = (eidx.long() * capacity + cpos.long()).reshape(-1)   # [n*k]
    # JAX's segment_sum adds a dropped choice's zero row to slot 0 of its
    # expert; a plain (non-accumulating) write would overwrite a kept
    # token's row there with zeros, so dropped choices write to a spare
    # row, cut off afterwards. Kept choices never collide: capacity gives
    # each slot at most one token.
    spare = e * capacity
    dest = torch.where(keep.reshape(-1), slot, spare)
    expert_in = tokens.new_zeros((spare + 1, d)).index_copy(
        0, dest, tokens.repeat_interleave(k, dim=0))
    expert_out = expert_fn(expert_in[:spare].reshape(e, capacity, d))
    gathered = expert_out.reshape(spare, -1)[slot].reshape(n, k, -1)
    return _combine(w * keep.to(w.dtype), gathered, tokens.dtype), aux


def _grouped(tokens, probs, expert_fn, k, renormalize, mode):
    """The dropless modes (:76-106): top-k with no capacity, the (token,
    choice) rows sorted by expert through ``forward_ragged`` (``ragged``)
    or padded into tiles through ``forward_pgmm`` (``pgmm``)."""
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
    # one padded tile layout a layer, which both modes run through on the
    # card: order sorts the rows by expert, pos_sorted is each sorted row's
    # padded row
    order, pos_sorted, tile_gids, p_total = gm.padded_group_layout(
        flat_e, e, n * k)
    if mode == "pgmm":
        # the padded row of each (token, choice) row: pos_sorted by the
        # inverse of the sort (the JAX package's gather by ``order // k``
        # in, then by ``pos_sorted`` and the inverse permutation out, in
        # one index)
        pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
        x_pad = tokens.new_zeros((p_total, d)).index_put(
            (pos,), tokens.repeat_interleave(k, dim=0))
        out_flat = expert_fn.forward_pgmm(x_pad, tile_gids)[pos]
    else:
        group_sizes = torch.zeros(e, dtype=torch.long,
                                  device=flat_e.device).scatter_add_(
            0, flat_e, torch.ones_like(flat_e))
        out_sorted = expert_fn.forward_ragged(
            tokens[order // k], group_sizes, flat_e[order],
            layout=(pos_sorted, tile_gids, p_total))
        inv = torch.empty_like(order).scatter_(
            0, order, torch.arange(n * k, device=order.device))
        out_flat = out_sorted[inv]
    return _combine(w, out_flat.reshape(n, k, -1), tokens.dtype), aux


def _normal(shape, dtype, std, device, gen):
    t = torch.empty(shape, dtype=resolve_dtype(dtype), device=device)
    t.normal_(0.0, std, generator=gen)
    return nn.Parameter(t)


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
        """x [E, C, d_model], batched over the experts (:163-170)."""
        h = self._act(torch.bmm(x, self.w1) + self.b1[:, None, :])
        return torch.bmm(h, self.w2) + self.b2[:, None, :]

    def _act(self, h):
        if self.activation == "gelu":
            return F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
        if self.activation == "relu":
            return F.relu(h)
        return F.silu(h)

    def forward_ragged(self, x, group_sizes, expert_ids, layout=None):
        """The ragged path (:181-191): x [m, d] sorted by expert,
        group_sizes [E] row counts, expert_ids [m] each row's expert (for
        the biases), ``layout`` the rows' tile layout for
        ``ops.grouped_dot`` (built once by the caller, or None)."""
        h = self._act(gm.grouped_dot(x, self.w1, group_sizes, layout)
                      + self.b1[expert_ids])
        return (gm.grouped_dot(h, self.w2, group_sizes, layout)
                + self.b2[expert_ids])

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
        """x [E, C, d_model] (:225-231)."""
        g = torch.bmm(x, self.w_gate)
        u = torch.bmm(x, self.w_up)
        return torch.bmm(F.silu(g) * u, self.w_down)

    def forward_ragged(self, x, group_sizes, expert_ids, layout=None):
        """Dropless grouped swiglu over expert-sorted rows (:233-243):
        three ``grouped_dot`` calls over one tile layout (K5/K6 on the
        card)."""
        g = gm.grouped_dot(x, self.w_gate, group_sizes, layout)
        u = gm.grouped_dot(x, self.w_up, group_sizes, layout)
        return gm.grouped_dot(F.silu(g) * u, self.w_down, group_sizes,
                              layout)

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
    ``experts`` (default :class:`ExpertFFN`), ``gate`` ("gshard",
    "switch", "naive"/"topk", or a BaseGate), ``top_k``,
    ``capacity_factor`` (precedence: this argument, then a gate instance's
    ``capacity_factor``, then 1.25), ``activation``, ``dtype``,
    ``dispatch_mode`` (any of :data:`DISPATCH_MODES`); and the port's
    ``device`` and ``generator`` (the initial weights, and a switch gate's
    jitter)."""

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
        out, aux = self.forward_with_aux(x)
        self.gate.set_loss(aux)
        return out

    def forward_with_aux(self, x):
        """(out, aux loss) with no side effect (``_routed_forward``
        :311-329): what a checkpointed block returns."""
        tokens = x.reshape(-1, x.shape[-1])
        probs = self.gate.probs(tokens)
        out, aux = routed_ffn(tokens, probs, self.experts, self.top_k,
                              self.capacity(tokens.shape[0]),
                              getattr(self.gate, "renormalize", True),
                              dispatch_mode=self.dispatch_mode)
        if not getattr(self.gate, "use_aux", True):
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return out.reshape(x.shape), aux

    def get_loss(self, clear=True):
        """The gate's aux (load-balance) loss for this forward."""
        return self.gate.get_loss(clear=clear)
