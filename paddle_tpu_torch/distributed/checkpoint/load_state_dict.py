"""Sharded checkpoint load with reshard-on-load — port of
``paddle_tpu/distributed/checkpoint/load_state_dict.py``.

The target's own placement decides what each rank reads: for a DTensor,
the window of its local shard, assembled from every saved chunk that
overlaps it, whatever mesh or degree saved them; for a plain tensor, the
whole. So a checkpoint written by either package on one mesh loads onto
any other. Every data file is verified against the digests in
``0.metadata`` before a chunk is read; corruption raises
:class:`CheckpointCorruptionError` naming the shard, and a verifying
``<shard>.replica`` recovers the load. ``verify=False`` opts out.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from .integrity import (REPLICA_SUFFIX, CheckpointCorruptionError,
                        verify_shard_file)
from .metadata import Metadata
from .save_state_dict import _flatten_state_dict, local_window, \
    wait_async_save

_TORCH_DTYPES = {"float32": torch.float32, "float16": torch.float16,
                 "bfloat16": torch.bfloat16, "float64": torch.float64,
                 "int32": torch.int32, "int64": torch.int64,
                 "int8": torch.int8, "uint8": torch.uint8,
                 "bool": torch.bool}


class _ChunkReader:
    """Opens the ``.npz`` files the metadata names on first use, after
    checking their digests (falling back to a verifying replica), and
    caches the members it has decompressed."""

    def __init__(self, path: str, files: Dict = None, verify: bool = True):
        self.path = path
        self.files = files or {}
        self.verify = verify
        self._files = {}
        self._members = {}

    def _verified_path(self, fname: str) -> str:
        primary = os.path.join(self.path, fname)
        if not self.verify:
            return primary
        rec = self.files.get(fname)
        try:
            verify_shard_file(primary, rec, self.path, fname)
            return primary
        except FileNotFoundError:
            primary_err = CheckpointCorruptionError(
                "PT-CKPT-003", self.path, fname,
                "data file missing (torn save?)")
        except CheckpointCorruptionError as e:
            primary_err = e
        # the replica is held to the primary's digest record
        try:
            verify_shard_file(primary + REPLICA_SUFFIX, rec, self.path,
                              fname + REPLICA_SUFFIX)
            return primary + REPLICA_SUFFIX
        except FileNotFoundError:
            if not os.path.exists(primary + REPLICA_SUFFIX):
                raise primary_err from None
            replica_reason = "replica vanished mid-verify"
        except CheckpointCorruptionError as re_err:
            replica_reason = f"{re_err.code}: {re_err.reason}"
        raise CheckpointCorruptionError(
            primary_err.code, self.path, fname,
            f"primary and replica both failed verification — "
            f"primary: {primary_err.reason}; "
            f"replica ({fname + REPLICA_SUFFIX}): {replica_reason}"
        ) from None

    def _open(self, fname: str):
        if fname not in self._files:
            path = self._verified_path(fname)
            if not self.verify:
                self._files[fname] = np.load(path)
                return self._files[fname]
            try:
                self._files[fname] = np.load(path)
            except Exception as e:
                raise CheckpointCorruptionError(
                    "PT-CKPT-004", self.path, fname,
                    f"undecodable shard container: {e!r}") from e
        return self._files[fname]

    def read(self, rec):
        ck = (rec.file, rec.key)
        if ck not in self._members:
            self._members[ck] = self._open(rec.file)[rec.key]
        return self._members[ck]


def _assemble_slice(meta, reader, name, offsets, lengths, dtype: str):
    """The [offsets, offsets + lengths) window of tensor ``name`` as a
    torch tensor of the saved dtype."""
    tm = meta.tensors[name]
    bf16 = dtype == "bfloat16"
    out = np.zeros(lengths, dtype=np.uint16 if bf16 else np.dtype(dtype))
    covered = np.zeros(lengths, dtype=bool)
    for rec in tm.chunks:
        src_sel, dst_sel = [], []
        overlap = True
        for ro, rl, wo, wl in zip(rec.offsets, rec.lengths, offsets, lengths):
            lo = max(ro, wo)
            hi = min(ro + rl, wo + wl)
            if hi <= lo:
                overlap = False
                break
            src_sel.append(slice(lo - ro, hi - ro))
            dst_sel.append(slice(lo - wo, hi - wo))
        if not overlap:
            continue
        out[tuple(dst_sel)] = reader.read(rec)[tuple(src_sel)]
        covered[tuple(dst_sel)] = True
    if not np.all(covered):
        raise ValueError(f"checkpoint chunks do not cover tensor {name!r} "
                         f"window offsets={offsets} lengths={lengths}")
    t = torch.from_numpy(out)
    return t.view(torch.bfloat16) if bf16 else t


def _flatten_with_refs(state_dict, prefix=""):
    """(flat_name, container, key, value) for in-place replacement."""
    for k, v in state_dict.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from _flatten_with_refs(v, name)
        else:
            yield name, state_dict, k, v


def load_state_dict(state_dict: Dict, path: str, process_group=None,
                    coordinator_rank: int = 0, unique_id=None,
                    offload: bool = False, verify: bool = True) -> None:
    """Fill ``state_dict`` in place from the checkpoint at ``path``, each
    tensor laid out by its CURRENT placement: a DTensor's local shard, a
    plain tensor whole (copied in place, cast to its dtype and device);
    other values are replaced by tensors."""
    wait_async_save(path)
    with open(os.path.join(path, "0.metadata")) as f:
        meta = Metadata.from_json(f.read())
    reader = _ChunkReader(path, files=meta.files, verify=verify)
    for name, container, key, v in _flatten_with_refs(state_dict):
        if name not in meta.tensors:
            raise KeyError(f"tensor {name!r} not found in checkpoint {path}")
        tm = meta.tensors[name]
        shape = tuple(tm.global_shape)
        if isinstance(v, DTensor):
            if tuple(v.shape) != shape:
                raise ValueError(f"shape mismatch for {name}: checkpoint "
                                 f"{shape} vs {tuple(v.shape)}")
            offsets, lengths = local_window(shape, v.device_mesh,
                                            v.placements)
            piece = _assemble_slice(meta, reader, name, offsets, lengths,
                                    tm.dtype)
            with torch.no_grad():
                v.to_local().copy_(piece)
            continue
        full = _assemble_slice(meta, reader, name, [0] * len(shape),
                               list(shape), tm.dtype)
        if isinstance(v, torch.Tensor) and tuple(v.shape) == shape:
            with torch.no_grad():
                v.copy_(full)
        else:
            container[key] = full.to(_TORCH_DTYPES.get(tm.dtype, full.dtype))


def get_state_dict_shapes(state_dict):
    """{name: shape} of a (nested) state dict."""
    return {k: list(getattr(v, "shape", np.shape(v)))
            for k, v in _flatten_state_dict(state_dict).items()}
