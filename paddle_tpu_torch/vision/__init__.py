"""``paddle_tpu.vision`` in the port: the models, the synthetic datasets and
the transforms."""

from . import datasets, models, transforms  # noqa: F401
