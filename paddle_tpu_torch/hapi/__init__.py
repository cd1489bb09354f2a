"""``paddle_tpu.hapi`` in the port: ``Model``, its callbacks and
``summary``."""

from . import callbacks  # noqa: F401
from .model import Model  # noqa: F401
from .summary import summary  # noqa: F401
