"""MoE gates — port of ``paddle_tpu/incubate/distributed/models/moe/gate.py``.

A gate scores tokens against the experts with an fp32 ``gate_weight``
``[d_model, E]`` (fp32 inside a bf16 model, as in the JAX package) and
keeps the load-balance aux loss of the last forward. :func:`topk_routing`
is the one source of the capacity modes' routing (GShard semantics: top-k
by repeated argmax, per-expert capacity, positions from a running cumsum);
:func:`topk_dispatch` assembles the dense combine/dispatch tensors from
it. One-hots are comparisons against ``torch.arange``: ``F.one_hot`` reads
its input's range on the host, which would sync every step.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .....device import resolve_device


class BaseGate(nn.Module):
    """Holds the aux (load-balance) loss (``BaseGate`` :29-49)."""

    def __init__(self, num_expert, world_size=1):
        super().__init__()
        self.world_size = world_size
        self.num_expert = num_expert
        self.tot_expert = world_size * num_expert
        self.loss = None

    def forward(self, x):
        raise NotImplementedError("Base gate cannot be directly used for fwd")

    def set_loss(self, loss):
        self.loss = loss

    def get_loss(self, clear=True):
        loss = self.loss
        if clear:
            self.loss = None
        return loss


def _load_balance_loss(probs, first_choice_mask):
    """GShard aux loss: E * sum_e mean_tokens(prob_e) * mean_tokens(routed_e)
    (:52)."""
    me = probs.mean(dim=0)
    ce = first_choice_mask.to(probs.dtype).mean(dim=0)
    return probs.shape[-1] * torch.sum(me * ce)


def _one_hot(idx, n: int, dtype):
    """``jax.nn.one_hot(idx, n, dtype)`` as a comparison (no host read)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def topk_routing(probs, k: int, capacity: int, renormalize: bool = True):
    """Sparse top-k routing with per-expert capacity (``topk_routing``
    :59-96). probs [n, E]. Returns (expert_idx [n, k] int32, cap_pos [n, k]
    int32, weight [n, k], keep [n, k] bool, aux_loss). A choice that
    overflows its expert's capacity gets keep=False, weight 0 and position
    0. The k choices come from k argmaxes (the first maximum wins a tie, as
    in ``jnp.argmax``), positions from a cumsum in probs' dtype as in JAX."""
    n, e = probs.shape
    remaining = probs
    prev_count = torch.zeros((e,), dtype=torch.int32, device=probs.device)
    gate_sum = torch.zeros((n,), dtype=probs.dtype, device=probs.device)
    first_mask = None
    eidxs, cposs, gates, keeps = [], [], [], []
    for _ in range(k):
        idx = torch.argmax(remaining, dim=-1)                   # [n]
        mask = _one_hot(idx, e, probs.dtype)                    # [n, e]
        if first_mask is None:
            first_mask = mask
        # the running count down the tokens, scanned along each expert's
        # row of the transposed mask: a scan over the outer dimension of
        # [n, E] runs one thread per column on the card (2.6 ms at
        # [16384, 8] on the H100). Counts of ones are exact in either order.
        run = mask.t().contiguous().cumsum(dim=1).t()
        pos = run - 1 + prev_count[None, :].to(probs.dtype)
        prev_count = prev_count + mask.sum(0).to(torch.int32)
        mask = mask * (pos < capacity).to(probs.dtype)
        gate_j = (probs * mask).sum(-1)                         # [n]
        gate_sum = gate_sum + gate_j
        eidxs.append(idx.to(torch.int32))
        cposs.append((pos * mask).sum(-1).to(torch.int32))
        gates.append(gate_j)
        keeps.append(mask.sum(-1) > 0)
        remaining = remaining * (1.0 - _one_hot(idx, e, probs.dtype))
    w = torch.stack(gates, dim=1)                               # [n, k]
    if renormalize and k > 1:
        w = w / gate_sum.clamp_min(1e-9)[:, None]
    aux = _load_balance_loss(probs, first_mask)
    return (torch.stack(eidxs, dim=1), torch.stack(cposs, dim=1), w,
            torch.stack(keeps, dim=1), aux)


def topk_dispatch(probs, k: int, capacity: int, renormalize: bool = True):
    """Dense top-k routing with per-expert capacity (``topk_dispatch``
    :99-113): (combine [n, E, C], dispatch_mask [n, E, C] bool, aux_loss),
    assembled from :func:`topk_routing`."""
    n, e = probs.shape
    eidx, cpos, w, keep, aux = topk_routing(probs, k, capacity, renormalize)
    onehot_e = _one_hot(eidx, e, probs.dtype)                   # [n, k, E]
    onehot_c = _one_hot(cpos, capacity, probs.dtype)            # [n, k, C]
    wk = w * keep.to(probs.dtype)
    combine = torch.einsum("nk,nke,nkc->nec", wk, onehot_e, onehot_c)
    return combine, combine > 0, aux


class NaiveGate(BaseGate):
    """Linear scorer + top-k, no aux loss (``NaiveGate`` :117-141)."""

    renormalize = True   # renormalize combine weights over the selected top-k
    use_aux = False      # whether the load-balance aux loss trains the gate

    def __init__(self, d_model, num_expert, world_size=1, topk=2, *,
                 device=None, generator=None):
        super().__init__(num_expert, world_size)
        self.top_k = topk
        dev = resolve_device(device)
        # XavierUniform over [d_model, E]: fan_in d_model, fan_out E
        limit = math.sqrt(6.0 / (d_model + self.tot_expert))
        w = torch.empty((d_model, self.tot_expert), dtype=torch.float32,
                        device=dev)
        w.uniform_(-limit, limit, generator=generator)
        self.gate_weight = nn.Parameter(w)

    def probs(self, inp):
        """Softmax gate probabilities [tokens, E] in fp32."""
        return torch.softmax(inp.float() @ self.gate_weight, dim=-1)

    scores = probs

    def forward(self, inp, capacity: int):
        """(combine, dispatch) of :func:`topk_dispatch` at ``capacity``
        (:131-136); keeps the aux loss (zero without ``use_aux``)."""
        p = self.probs(inp)
        combine, dispatch, aux = topk_dispatch(p, self.top_k, capacity,
                                               self.renormalize)
        self.set_loss(aux if self.use_aux
                      else torch.zeros((), dtype=torch.float32,
                                       device=p.device))
        return combine, dispatch


class GShardGate(NaiveGate):
    """Top-2 with the load-balance aux loss (``GShardGate`` :144)."""

    use_aux = True

    def __init__(self, d_model, num_expert, world_size=1, topk=2,
                 capacity=(1.2, 2.4), random_routing=True, group=None, *,
                 device=None, generator=None):
        if topk != 2:
            raise ValueError("topk should be 2 in gshard")
        super().__init__(d_model, num_expert, world_size, topk=2,
                         device=device, generator=generator)
        self.capacity_factor = (capacity[0] if isinstance(capacity,
                                                          (tuple, list))
                                else capacity)


class SwitchGate(NaiveGate):
    """Top-1 with capacity and the aux loss, and multiplicative jitter in
    ``[1 - switch_eps, 1 + switch_eps]`` on the logits while training
    (``SwitchGate`` :157-181).

    The jitter draws from ``generator`` (the one that drew the initial
    weights; the default generator if None). ``jax.random``'s bits cannot
    be reproduced, so the contract is: in eval mode, or at ``switch_eps=0``,
    the gate equals the JAX gate; in training mode it is deterministic for
    a given generator seed and stays inside its bounds. ``noise_generator``
    names the generator for the model's remat, which rewinds it so that a
    checkpoint's recompute draws the forward's noise."""

    renormalize = False
    use_aux = True

    def __init__(self, d_model, num_expert, world_size=1, topk=1,
                 switch_eps=0.1, capacity=(1.2, 2.4), group=None, *,
                 device=None, generator=None):
        if topk != 1:
            raise ValueError("topk should be 1 in switch")
        super().__init__(d_model, num_expert, world_size, topk=1,
                         device=device, generator=generator)
        self.switch_eps = switch_eps
        self.noise_generator = generator

    def probs(self, inp):
        logits = inp.float() @ self.gate_weight
        if self.training and self.switch_eps > 0:
            noise = torch.empty_like(logits).uniform_(
                1.0 - self.switch_eps, 1.0 + self.switch_eps,
                generator=self.noise_generator)
            logits = logits * noise
        return torch.softmax(logits, dim=-1)

    scores = probs
