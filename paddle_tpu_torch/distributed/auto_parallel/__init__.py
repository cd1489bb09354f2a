"""``paddle_tpu.distributed.auto_parallel``'s engine, single device."""

from .engine import Engine  # noqa: F401
