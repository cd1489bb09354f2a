"""MoE gates — port of ``paddle_tpu/incubate/distributed/models/moe/gate.py``.

A gate scores tokens against the experts with an fp32 ``gate_weight``
``[d_model, E]`` (fp32 inside a bf16 model, as in the JAX package) and
keeps the load-balance aux loss of the last forward. The capacity modes'
routing (``topk_routing``, ``topk_dispatch``) arrives with the
capacity-dispatch slice; the dropless ``pgmm`` dispatch routes in
``moe_layer.routed_ffn``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .....device import resolve_device


def _later_slice(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: it arrives with a later MoE slice of the "
        "port; this slice trains the dropless pgmm dispatch with the naive "
        "and gshard gates")


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
        raise _later_slice("the capacity dispatch (gate.forward, "
                           "topk_dispatch)")


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
    """Top-1 with multiplicative jitter in training (``SwitchGate`` :157).
    Not ported: its jitter draws from ``jax.random`` and needs the port's
    own generator contract first."""

    def __init__(self, *args, **kwargs):
        raise _later_slice("SwitchGate (training jitter needs a torch "
                           "generator contract)")
