"""Functionals of the port (``paddle_tpu.nn.functional``), on
``torch.Tensor``s (Paddle's or plain), each through the op dispatcher:
every activation, loss, normalisation, pooling, convolution and common
functional of the JAX package's modules of those names, and the flash
and flashmask attention entry points and the packed (varlen) ones.

and the long tail of the JAX package's ``nn/functional/extras.py``
(CTC and RNN-T losses, ``grid_sample``, the fractional and unpooling
pools, beams, the in-place activations ...).
"""

from __future__ import annotations

import numpy as np  # noqa: F401

from ...core.op_registry import (AMP_BLACK, AMP_WHITE, OpDef,  # noqa: F401
                                 apply_fn)
from ...core.tensor import Tensor, unwrap  # noqa: F401
from .activation import (celu, elu, gelu, glu, gumbel_softmax,  # noqa: F401
                         hardshrink, hardsigmoid, hardswish, hardtanh,
                         leaky_relu, log_sigmoid, log_softmax, logsigmoid,
                         maxout, mish, prelu, relu, relu6, relu_, rrelu,
                         selu, sigmoid, silu, softmax, softmax_, softplus,
                         softshrink, softsign, swish, tanh, tanhshrink,
                         thresholded_relu)
from .common import (alpha_dropout, bilinear, channel_shuffle,  # noqa: F401
                     cosine_similarity, dropout, dropout2d, dropout3d,
                     dropout_eval_kernel, dropout_train_kernel, embedding,
                     flatten, fold, interpolate, label_smooth, linear,
                     normalize, one_hot, pad, pixel_shuffle,
                     pixel_unshuffle, unfold, upsample)
from .conv import (conv1d, conv1d_transpose, conv2d,  # noqa: F401
                   conv2d_transpose, conv3d, conv3d_transpose)
from .extras import (adaptive_log_softmax_with_loss,  # noqa: F401
                     affine_grid, class_center_sample, ctc_loss, elu_,
                     feature_alpha_dropout, flash_attn_qkvpacked,
                     flash_attn_varlen_qkvpacked, fractional_max_pool2d,
                     fractional_max_pool3d, gather_tree, gaussian_nll_loss,
                     grid_sample, hardtanh_, hsigmoid_loss, leaky_relu_,
                     margin_cross_entropy, max_pool2d_with_mask,
                     max_unpool1d, max_unpool2d, max_unpool3d,
                     multi_label_soft_margin_loss, multi_margin_loss,
                     npair_loss, pairwise_distance, poisson_nll_loss,
                     rnnt_loss, sequence_mask, soft_margin_loss, softmax_2d,
                     sparse_attention, tanh_, temporal_shift,
                     thresholded_relu_, triplet_margin_with_distance_loss,
                     zeropad2d)
from .flash_attention import (flash_attention,  # noqa: F401
                              flashmask_attention,
                              scaled_dot_product_attention, sdp_kernel)
from .loss import (binary_cross_entropy,  # noqa: F401
                   binary_cross_entropy_with_logits, cosine_embedding_loss,
                   cross_entropy, dice_loss, hinge_embedding_loss,
                   huber_loss, kl_div, l1_loss, log_loss,
                   margin_ranking_loss, mse_loss, nll_loss,
                   sigmoid_focal_loss, smooth_l1_loss,
                   softmax_with_cross_entropy, square_error_cost,
                   triplet_margin_loss)
from .norm import (batch_norm, group_norm, instance_norm,  # noqa: F401
                   layer_norm, local_response_norm, rms_norm, spectral_norm)
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d,  # noqa
                      adaptive_avg_pool3d, adaptive_max_pool1d,
                      adaptive_max_pool2d, adaptive_max_pool3d, avg_pool1d,
                      avg_pool2d, avg_pool3d, lp_pool1d, lp_pool2d,
                      max_pool1d, max_pool2d, max_pool3d)
