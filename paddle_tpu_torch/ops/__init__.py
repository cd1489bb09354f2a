"""The port's kernels: each wrapper launches a hand-written CUDA kernel on
CUDA tensors and runs its plain PyTorch version on CPU tensors."""

from .flash_attention import (flash_attention,  # noqa: F401
                              flash_attention_backward,
                              flash_attention_backward_reference,
                              flash_attention_forward,
                              flash_attention_reference,
                              flash_attention_reference_lse)
from .fused_ce import fused_linear_cross_entropy  # noqa: F401
from .grouped_matmul import (padded_group_layout, pgmm,  # noqa: F401
                             pgmm_dw, pgmm_dw_reference, pgmm_raw,
                             pgmm_reference)
from .paged_attention import (append_paged_kv,  # noqa: F401
                              paged_decode_attention, paged_decode_reference)
