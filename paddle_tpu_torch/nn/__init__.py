"""Neural-network layers of the port (``paddle_tpu.nn``): ``Layer`` (a
``torch.nn.Module`` with Paddle's API), ``LayerList``, ``Sequential``,
``ParameterList``, ``Linear``, ``Embedding``, ``Dropout``, ``ReLU``,
``ReLU6``, ``Conv2D``, the 2-D pools, ``LayerNorm``, ``BatchNorm2D``,
``CrossEntropyLoss``, the Transformer family and the gradient clips, in the
JAX package's parameter names and layouts. The functionals are in
``nn.functional``."""

from . import functional  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue)
from .layer.activation import ReLU, ReLU6  # noqa: F401
from .layer.common import Dropout, Embedding, Linear  # noqa: F401
from .layer.conv import Conv2D  # noqa: F401
from .layer.layers import (Layer, LayerList, ParameterList,  # noqa: F401
                           Sequential)
from .layer.loss import CrossEntropyLoss  # noqa: F401
from .layer.norm import BatchNorm2D, LayerNorm  # noqa: F401
from .layer.pooling import (AdaptiveAvgPool2D, AvgPool2D,  # noqa: F401
                            MaxPool2D)
from .layer.transformer import (MultiHeadAttention, Transformer,  # noqa: F401
                                TransformerDecoder, TransformerDecoderLayer,
                                TransformerEncoder, TransformerEncoderLayer)
