"""Functionals of the port (``paddle_tpu.nn.functional``), on
``torch.Tensor``s: the flash and flashmask entry points and the packed
(varlen) ones; linear, dropout, flatten, activations, conv2d, pooling,
batch_norm and cross_entropy."""

from .activation import gelu, relu, relu6, silu  # noqa: F401
from .common import dropout, flatten, linear  # noqa: F401
from .conv import conv2d  # noqa: F401
from .extras import (flash_attn_qkvpacked,  # noqa: F401
                     flash_attn_varlen_qkvpacked)
from .flash_attention import (flash_attention,  # noqa: F401
                              flashmask_attention,
                              scaled_dot_product_attention)
from .loss import cross_entropy  # noqa: F401
from .norm import batch_norm  # noqa: F401
from .pooling import (adaptive_avg_pool2d, avg_pool2d,  # noqa: F401
                      max_pool2d)
