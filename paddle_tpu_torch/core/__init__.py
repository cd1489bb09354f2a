"""``paddle_tpu.core`` in the port: dtypes, the ``Tensor`` subclass of
``torch.Tensor``, the op dispatcher and the autograd API."""

from . import autograd_engine, dtype, op_registry, tensor  # noqa: F401
from .tensor import Parameter, Tensor  # noqa: F401
