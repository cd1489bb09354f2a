"""AMP op lists — a copy of ``paddle_tpu/amp/amp_lists.py`` (reference:
python/paddle/amp/amp_lists.py). The dispatcher consults them only for an
op whose ``OpDef`` carries a category (``core/op_registry.py``)."""

# ops that are numerically safe + fast in low precision (tensor-core bound)
WHITE_LIST = {
    "matmul", "linear", "conv1d", "conv2d", "conv3d", "conv1d_transpose",
    "conv2d_transpose", "conv3d_transpose", "bmm", "mv", "inner", "outer",
    "einsum", "multi_dot", "scaled_dot_product_attention",
}

# ops that must stay fp32 (reductions / exponentials prone to overflow)
BLACK_LIST = {
    "exp", "square", "log", "log2", "log10", "log1p", "mean", "sum", "cos_sim",
    "softmax", "log_softmax", "softmax_with_cross_entropy", "sigmoid_cross_entropy_with_logits",
    "cross_entropy", "bce_with_logits", "binary_cross_entropy", "nll_loss", "kl_div",
    "layer_norm", "group_norm", "instance_norm", "batch_norm", "rms_norm",
    "logsumexp", "erfinv", "pow", "cumprod", "prod", "linspace", "acos", "asin",
    "cosh", "sinh", "tan", "atanh", "acosh", "asinh",
}
