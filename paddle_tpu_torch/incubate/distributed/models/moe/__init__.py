"""Mixture of Experts — port of ``paddle_tpu/incubate/distributed/models/moe``
(the dropless ``pgmm`` dispatch)."""

from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate  # noqa: F401
from .moe_layer import (ExpertFFN, MoELayer, SwiGLUExpertFFN,  # noqa: F401
                        routed_ffn)
