"""Optimizers of the port (``paddle_tpu.optimizer``): ``Optimizer``,
``SGD`` and ``Momentum``. The JAX package's other optimizers and its LR
schedulers (``optimizer.lr``) raise ``NotImplementedError`` naming the
slice that ports them."""

from .._later import later_slice
from .optimizer import SGD, Momentum, Optimizer  # noqa: F401

_LATER = ("ASGD", "LBFGS", "Adadelta", "Adagrad", "Adam", "Adamax", "AdamW",
          "Lamb", "NAdam", "RAdam", "RMSProp", "Rprop", "lr")


def __getattr__(name):
    if name in _LATER:
        raise later_slice(f"paddle_tpu_torch.optimizer.{name}",
                          "Paddle API surface", "8")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
