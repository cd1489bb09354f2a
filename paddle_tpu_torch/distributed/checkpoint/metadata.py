"""Checkpoint metadata — port of ``paddle_tpu/distributed/checkpoint/
metadata.py``, the same on-disk format: for every saved tensor its global
shape, its dtype and the (offsets, lengths) -> (file, key) records of its
chunks, JSON beside the data files, with the per-file digests that
``integrity`` checks. A chunk's window is the slice of the global tensor a
shard holds (a DTensor's local window, a JAX shard's index).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class ChunkRecord:
    offsets: List[int]          # global start per dim
    lengths: List[int]          # chunk extent per dim
    file: str                   # data file holding this chunk
    key: str                    # key inside the file


@dataclasses.dataclass
class TensorMetadata:
    global_shape: List[int]
    dtype: str
    chunks: List[ChunkRecord]


@dataclasses.dataclass
class Metadata:
    tensors: Dict[str, TensorMetadata]
    flat_mapping: Optional[Dict[str, str]] = None  # user key -> storage key
    # integrity records per data file: {fname: {"size", "crc32", "sha256"}} —
    # written by save_state_dict, verified by load_state_dict (PT-CKPT codes,
    # docs/RESILIENCE.md). Optional so pre-integrity checkpoints still load.
    files: Optional[Dict[str, Dict]] = None

    def to_json(self) -> str:
        return json.dumps(
            {
                "tensors": {
                    name: {
                        "global_shape": tm.global_shape,
                        "dtype": tm.dtype,
                        "chunks": [dataclasses.asdict(c) for c in tm.chunks],
                    }
                    for name, tm in self.tensors.items()
                },
                "flat_mapping": self.flat_mapping,
                "files": self.files,
            },
            indent=1,
        )

    @classmethod
    def from_json(cls, text: str) -> "Metadata":
        obj = json.loads(text)
        tensors = {
            name: TensorMetadata(
                global_shape=t["global_shape"],
                dtype=t["dtype"],
                chunks=[ChunkRecord(**c) for c in t["chunks"]],
            )
            for name, t in obj["tensors"].items()
        }
        return cls(tensors=tensors, flat_mapping=obj.get("flat_mapping"),
                   files=obj.get("files"))


def index_to_offsets(index: Tuple, shape: Tuple[int, ...]) -> Tuple[List[int], List[int]]:
    """Convert an addressable-shard index (tuple of slices) to offsets/lengths."""
    offsets, lengths = [], []
    for sl, dim in zip(index, shape):
        start = 0 if sl.start is None else int(sl.start)
        stop = dim if sl.stop is None else int(sl.stop)
        offsets.append(start)
        lengths.append(stop - start)
    if not index:  # scalar
        return [], []
    return offsets, lengths
