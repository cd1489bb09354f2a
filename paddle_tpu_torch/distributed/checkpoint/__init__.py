"""``paddle_tpu.distributed.checkpoint`` for the port: sharded save and
load with reshard-on-load in the JAX package's format (``<rank>_0.distcp``
as ``.npz``, ``0.metadata`` as JSON), with its integrity checks, replica
recovery and async saves. The generation-fenced ``LATEST`` pointer
(``latest.py``) belongs to the resilience trainer, a later part of item 6,
and raises."""

from .._refuse import GUARD, refuse
from .integrity import CheckpointCorruptionError  # noqa: F401
from .load_state_dict import get_state_dict_shapes, load_state_dict  # noqa: F401
from .metadata import ChunkRecord, Metadata, TensorMetadata  # noqa: F401
from .save_state_dict import save_state_dict, wait_async_save  # noqa: F401

_LATER = ("StaleGenerationError", "claim_generation", "commit_latest",
          "read_latest", "latest")


def __getattr__(name):
    if name in _LATER:
        raise refuse(f"checkpoint.{name} (the generation-fenced LATEST "
                     "pointer)", GUARD)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
