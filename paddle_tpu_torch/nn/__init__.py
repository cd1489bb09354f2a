"""Neural-network layers of the port (``paddle_tpu.nn``): ``Linear``,
``Dropout``, ``ReLU``, ``ReLU6``, ``Conv2D``, the 2-D pools,
``BatchNorm2D``, ``CrossEntropyLoss`` and the gradient clips, in the JAX
package's parameter names and layouts; ``Sequential`` is torch's (children
``0``, ``1``, ... in both frameworks). The functionals are in
``nn.functional``."""

from torch.nn import Sequential  # noqa: F401

from . import functional  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue)
from .layer.activation import ReLU, ReLU6  # noqa: F401
from .layer.common import Dropout, Linear  # noqa: F401
from .layer.conv import Conv2D  # noqa: F401
from .layer.loss import CrossEntropyLoss  # noqa: F401
from .layer.norm import BatchNorm2D  # noqa: F401
from .layer.pooling import (AdaptiveAvgPool2D, AvgPool2D,  # noqa: F401
                            MaxPool2D)
