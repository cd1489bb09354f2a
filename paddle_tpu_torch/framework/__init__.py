"""``paddle_tpu.framework`` in the port: ``save``, ``load`` and
``ParamAttr`` (JAX ``framework/__init__.py`` :9-20)."""

from .io import load, save  # noqa: F401


class ParamAttr:
    """A parameter's configuration (reference: python/paddle/base/
    param_attr.py), read by ``Layer.create_parameter``: its
    ``initializer`` (replacing the layer's default), ``name``,
    ``learning_rate`` (a factor on the optimizer's rate, kept in
    ``param.optimize_attr``), ``regularizer`` (replacing the optimizer's
    ``weight_decay`` for this parameter), ``trainable`` and ``need_clip``.
    ``do_model_average`` is kept and read by nothing, as in the JAX
    package."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip
