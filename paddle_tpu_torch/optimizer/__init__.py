"""Optimizers and LR schedulers of the port (``paddle_tpu.optimizer``)."""

from . import lr  # noqa: F401
from .optimizer import (ASGD, LBFGS, SGD, Adadelta, Adagrad,  # noqa: F401
                        Adam, Adamax, AdamW, Lamb, Momentum, NAdam,
                        Optimizer, RAdam, RMSProp, Rprop, name_parameters)
