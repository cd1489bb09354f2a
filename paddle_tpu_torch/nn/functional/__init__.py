"""Functionals of the port (``paddle_tpu.nn.functional``), on
``torch.Tensor``s (Paddle's or plain), each through the op dispatcher: the
flash and flashmask entry points and the packed (varlen) ones; linear,
dropout, embedding, flatten, activations, softmax, conv2d, pooling,
layer_norm, batch_norm and cross_entropy."""

from .activation import gelu, relu, relu6, silu, softmax  # noqa: F401
from .common import dropout, embedding, flatten, linear  # noqa: F401
from .conv import conv2d  # noqa: F401
from .extras import (flash_attn_qkvpacked,  # noqa: F401
                     flash_attn_varlen_qkvpacked)
from .flash_attention import (flash_attention,  # noqa: F401
                              flashmask_attention,
                              scaled_dot_product_attention)
from .loss import cross_entropy  # noqa: F401
from .norm import batch_norm, layer_norm  # noqa: F401
from .pooling import (adaptive_avg_pool2d, avg_pool2d,  # noqa: F401
                      max_pool2d)
