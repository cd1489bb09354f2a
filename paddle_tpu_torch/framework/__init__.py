"""``paddle_tpu.framework`` in the port: ``save`` and ``load``."""

from .io import load, save  # noqa: F401
