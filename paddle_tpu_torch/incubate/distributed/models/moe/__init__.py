"""Mixture of Experts — port of ``paddle_tpu/incubate/distributed/models/moe``
(the einsum, scatter, auto, ragged and pgmm dispatches)."""

from .gate import (BaseGate, GShardGate, NaiveGate, SwitchGate,  # noqa: F401
                   topk_dispatch, topk_routing)
from .moe_layer import (ExpertFFN, MoELayer, SwiGLUExpertFFN,  # noqa: F401
                        resolve_dispatch, routed_ffn)
