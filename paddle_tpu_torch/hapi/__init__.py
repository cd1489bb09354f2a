"""``paddle_tpu.hapi`` in the port: ``Model``'s batch steps."""

from .model import Model  # noqa: F401
