"""The port's kernels: each wrapper launches a hand-written CUDA kernel on
CUDA tensors and runs its plain PyTorch version on CPU tensors."""

from .flash_attention import (flash_attention,  # noqa: F401
                              flash_attention_backward,
                              flash_attention_backward_reference,
                              flash_attention_forward,
                              flash_attention_reference,
                              flash_attention_reference_lse,
                              flash_attention_rowmask,
                              flash_attention_rowmask_reference,
                              flash_attention_varlen,
                              flash_attention_varlen_reference,
                              flash_attention_with_lse)
from .fused_ce import fused_linear_cross_entropy  # noqa: F401
from .grouped_matmul import (grouped_dot,  # noqa: F401
                             grouped_dot_reference, grouped_dot_tiled,
                             padded_group_layout,
                             pgmm, pgmm_dw, pgmm_dw_reference, pgmm_raw,
                             pgmm_reference)
from .paged_attention import (KV_QMAX, BlockAllocator,  # noqa: F401
                              QuantizedKVPool, RadixPrefixCache,
                              append_paged_kv, copy_pages, dequantize_kv,
                              gather_chain_pages, gather_chain_scales,
                              gather_paged_kv, scatter_chain_pages,
                              kv_absmax, paged_decode_attention,
                              paged_decode_reference,
                              paged_prefill_attention,
                              paged_verify_attention, quantize_kv)
