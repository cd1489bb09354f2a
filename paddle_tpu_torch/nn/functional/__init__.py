"""Attention functionals of the port (``paddle_tpu.nn.functional``), on
``torch.Tensor``s: the flash and flashmask entry points and the packed
(varlen) ones."""

from .extras import (flash_attn_qkvpacked,  # noqa: F401
                     flash_attn_varlen_qkvpacked)
from .flash_attention import (flash_attention,  # noqa: F401
                              flashmask_attention,
                              scaled_dot_product_attention)
