"""``distributed.fleet.utils``: Megatron sequence parallelism."""

from . import sequence_parallel_utils  # noqa: F401
