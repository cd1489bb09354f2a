"""Neural-network layers of the port (``paddle_tpu.nn``): ``Layer`` (a
``torch.nn.Module`` with Paddle's API), the containers, every activation,
loss, normalisation, pooling, convolution, recurrent and common layer of
the JAX package's modules of those names, the Transformer family, the
gradient clips and the initializers, and the long tail of its
``nn/layer/extras.py`` (CTC and RNN-T losses, ``BiRNN``,
``BeamSearchDecoder`` / ``dynamic_decode``, ``SpectralNorm``,
``LayerDict`` ...), in the JAX package's parameter names and layouts. The
functionals are in ``nn.functional``.
"""

from __future__ import annotations

import numpy as np  # noqa: F401

from ..core import dtype as dtype_mod  # noqa: F401
from ..core.tensor import Parameter, Tensor  # noqa: F401
from . import functional, initializer  # noqa: F401
from . import functional as F  # noqa: F401
from . import initializer as I  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue)
from .layer.activation import (CELU, ELU, GELU, GLU, SELU,  # noqa: F401
                               Hardshrink, Hardsigmoid, Hardswish, Hardtanh,
                               LeakyReLU, LogSigmoid, LogSoftmax, Maxout,
                               Mish, PReLU, ReLU, ReLU6, RReLU, Sigmoid, Silu,
                               Softmax, Softplus, Softshrink, Softsign, Swish,
                               Tanh, Tanhshrink, ThresholdedReLU)
from .layer.common import (AlphaDropout, Bilinear,  # noqa: F401
                           ChannelShuffle, CosineSimilarity, Dropout,
                           Dropout2D, Dropout3D, Embedding, Flatten, Fold,
                           Identity, Linear, Pad1D, Pad2D, Pad3D,
                           PixelShuffle, PixelUnshuffle, Unfold, Upsample,
                           UpsamplingBilinear2D, UpsamplingNearest2D,
                           ZeroPad2D)
from .layer.conv import (Conv1D, Conv1DTranspose, Conv2D,  # noqa: F401
                         Conv2DTranspose, Conv3D, Conv3DTranspose)
from .layer.extras import (AdaptiveLogSoftmaxWithLoss,  # noqa: F401
                           BeamSearchDecoder, BiRNN, CTCLoss,
                           FeatureAlphaDropout, FractionalMaxPool2D,
                           FractionalMaxPool3D, GaussianNLLLoss,
                           HSigmoidLoss, LayerDict, LPPool1D, LPPool2D,
                           MaxUnPool1D, MaxUnPool2D, MaxUnPool3D,
                           MultiLabelSoftMarginLoss, MultiMarginLoss,
                           PairwiseDistance, PoissonNLLLoss, RNNCellBase,
                           RNNTLoss, SoftMarginLoss, Softmax2D, SpectralNorm,
                           TripletMarginWithDistanceLoss, Unflatten,
                           ZeroPad1D, ZeroPad3D, dynamic_decode)
from .layer.layers import (Layer, LayerList, ParameterList,  # noqa: F401
                           Sequential)
from .layer.loss import (BCELoss, BCEWithLogitsLoss,  # noqa: F401
                         CosineEmbeddingLoss, CrossEntropyLoss,
                         HingeEmbeddingLoss, HuberLoss, KLDivLoss, L1Loss,
                         MarginRankingLoss, MSELoss, NLLLoss, SmoothL1Loss,
                         TripletMarginLoss)
from .layer.norm import (BatchNorm, BatchNorm1D, BatchNorm2D,  # noqa: F401
                         BatchNorm3D, GroupNorm, InstanceNorm1D,
                         InstanceNorm2D, InstanceNorm3D, LayerNorm,
                         LocalResponseNorm, RMSNorm, SyncBatchNorm)
from .layer.pooling import (AdaptiveAvgPool1D,  # noqa: F401
                            AdaptiveAvgPool2D, AdaptiveAvgPool3D,
                            AdaptiveMaxPool1D, AdaptiveMaxPool2D,
                            AdaptiveMaxPool3D, AvgPool1D, AvgPool2D,
                            AvgPool3D, MaxPool1D, MaxPool2D, MaxPool3D)
from .layer.rnn import (GRU, LSTM, RNN, GRUCell, LSTMCell,  # noqa: F401
                        SimpleRNN, SimpleRNNCell)
from .layer.transformer import (MultiHeadAttention, Transformer,  # noqa: F401
                                TransformerDecoder, TransformerDecoderLayer,
                                TransformerEncoder, TransformerEncoderLayer)
