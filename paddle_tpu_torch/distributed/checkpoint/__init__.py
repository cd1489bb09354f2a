"""``paddle_tpu.distributed.checkpoint`` for the port: sharded save and
load with reshard-on-load in the JAX package's format (``<rank>_0.distcp``
as ``.npz``, ``0.metadata`` as JSON), with its integrity checks, replica
recovery and async saves, and the generation-fenced ``LATEST`` resume
pointer (``latest.py``, PT-CKPT-005)."""

from .integrity import CheckpointCorruptionError  # noqa: F401
from .latest import (StaleGenerationError, claim_generation,  # noqa: F401
                     commit_latest, read_latest)
from .load_state_dict import get_state_dict_shapes, load_state_dict  # noqa: F401
from .metadata import ChunkRecord, Metadata, TensorMetadata  # noqa: F401
from .save_state_dict import save_state_dict, wait_async_save  # noqa: F401
