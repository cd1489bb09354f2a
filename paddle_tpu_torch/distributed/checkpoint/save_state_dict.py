"""Sharded checkpoint save — port of ``paddle_tpu/distributed/checkpoint/
save_state_dict.py``, the same on-disk format.

Each rank writes the chunks it owns to ``<rank>_0.distcp`` (an ``.npz``;
none where it owns no chunk):
a DTensor's local shard when the rank is the first replica of it (its
coordinate is 0 on every axis that does not shard it), a plain tensor
whole from the coordinator rank. bf16 chunks are stored as their uint16
bits. Each rank serializes in memory and records its file's digests; the
coordinator gathers every rank's records (``all_gather_object``) and
writes ``0.metadata`` last, so its atomic appearance commits the
checkpoint. Every file lands through tempfile + ``os.replace``.
``replica=True`` writes a ``.replica`` copy of each shard; the fault site
``checkpoint.shard`` corrupts the primary bytes after their digests were
recorded (how the corruption drills are seeded). ``async_save=True`` in a
world of one moves the file writes to a thread that ``wait_async_save``
(also run at exit, and before any save or load of the same path) joins;
with several ranks the save stays synchronous, as the JAX package's
multi-process save does.
"""

from __future__ import annotations

import atexit
import io
import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from ..resilience import faults as _faults
from .integrity import REPLICA_SUFFIX, atomic_write_bytes, file_digests
from .metadata import ChunkRecord, Metadata, TensorMetadata

__all__ = ["save_state_dict", "wait_async_save"]


def _flatten_state_dict(state_dict, prefix=""):
    flat = {}
    for k, v in state_dict.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            flat.update(_flatten_state_dict(v, key))
        else:
            flat[key] = v
    return flat


def dtype_name(dtype) -> str:
    """numpy's name of a torch dtype ("float32", "bfloat16", "int32")."""
    return str(dtype).replace("torch.", "")


def local_window(shape, mesh, placements) -> Tuple[List[int], List[int]]:
    """(offsets, lengths) of this rank's shard of a tensor of ``shape``
    under ``placements`` (DTensor's ``torch.chunk`` layout)."""
    coord = mesh.get_coordinate()
    offsets = [0] * len(shape)
    lengths = list(shape)
    for i, p in enumerate(placements):
        if not p.is_shard():
            continue
        n, d = mesh.size(i), p.dim
        step = -(-lengths[d] // n)
        start = min(coord[i] * step, lengths[d])
        stop = min(start + step, lengths[d])
        offsets[d] += start
        lengths[d] = stop - start
    return offsets, lengths


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy()
    return t.numpy()


def _key(name, offsets):
    return f"{name}|{','.join(map(str, offsets)) or 'scalar'}"


def _chunks_of(flat, rank, fname, coordinator):
    """This rank's (chunks, tensor metadata)."""
    chunks, meta = {}, {}
    for name, v in flat.items():
        if v is None:
            continue
        if isinstance(v, DTensor):
            if any(p.is_partial() for p in v.placements):
                v = v.redistribute(v.device_mesh, [
                    Replicate() if p.is_partial() else p
                    for p in v.placements])
            records = []
            coord = v.device_mesh.get_coordinate()
            owner = coord is not None and all(
                c == 0 for c, p in zip(coord, v.placements)
                if not p.is_shard())
            if owner:
                offsets, lengths = local_window(v.shape, v.device_mesh,
                                                v.placements)
                key = _key(name, offsets)
                chunks[key] = _host(v.to_local())
                records.append(ChunkRecord(offsets=offsets, lengths=lengths,
                                           file=fname, key=key))
            meta[name] = TensorMetadata(global_shape=list(v.shape),
                                        dtype=dtype_name(v.dtype),
                                        chunks=records)
            continue
        if not isinstance(v, torch.Tensor):
            v = torch.as_tensor(np.asarray(v))
        records = []
        if rank == coordinator:
            key = _key(name, [0] * v.ndim)
            chunks[key] = _host(v)
            records.append(ChunkRecord(offsets=[0] * v.ndim,
                                       lengths=list(v.shape), file=fname,
                                       key=key))
        meta[name] = TensorMetadata(global_shape=list(v.shape),
                                    dtype=dtype_name(v.dtype), chunks=records)
    return chunks, meta


# in-flight async saves: (path, thread, error-holder)
_ASYNC: List[Tuple[str, threading.Thread, list]] = []
_ASYNC_LOCK = threading.Lock()


def wait_async_save(path: Optional[str] = None) -> None:
    """Block until pending ``async_save`` writes (to ``path``, or all of
    them) are durable; re-raises the first writer error."""
    with _ASYNC_LOCK:
        mine = [rec for rec in _ASYNC
                if path is None or rec[0] == os.path.abspath(path)]
        for rec in mine:
            _ASYNC.remove(rec)
    first_err = None
    for _, thread, err in mine:
        thread.join()
        if err and first_err is None:
            first_err = err[0]
    if first_err is not None:
        raise first_err


atexit.register(wait_async_save)


def _write_files(path: str, fname: str, blob: bytes, replica: bool) -> None:
    # the fault site corrupts the PRIMARY copy only: the digests were
    # recorded from the clean bytes, so verification at load catches it
    primary = _faults.corrupt("checkpoint.shard", fname, blob)
    atomic_write_bytes(os.path.join(path, fname), primary)
    if replica:
        atomic_write_bytes(os.path.join(path, fname + REPLICA_SUFFIX), blob)


def _merge(parts) -> Metadata:
    merged: Dict[str, TensorMetadata] = {}
    files: Dict[str, Dict] = {}
    for m in parts:
        files.update(m.files or {})
        for name, tm in m.tensors.items():
            if name in merged:
                merged[name].chunks.extend(tm.chunks)
            else:
                merged[name] = tm
    return Metadata(merged, files=files)


def save_state_dict(state_dict: Dict, path: str, process_group=None,
                    coordinator_rank: int = 0, unique_id=None,
                    async_save: bool = False, replica: bool = False) -> None:
    """Save a state dict of DTensors and plain tensors (nested dicts are
    flattened with "." joins) to ``path``; a collective call on every rank
    of the group (the world by default)."""
    wait_async_save(path)               # never interleave saves to one dir
    pg = getattr(process_group, "pg", process_group)
    multi = dist.is_initialized() and dist.get_world_size(pg) > 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    os.makedirs(path, exist_ok=True)
    fname = f"{rank}_0.distcp"
    chunks, meta = _chunks_of(_flatten_state_dict(state_dict), rank, fname,
                              coordinator_rank)
    # serialize in memory: the digests come from the exact bytes on disk
    buf = io.BytesIO()
    np.savez(buf, **chunks)
    blob = buf.getvalue()
    # a rank that owns no chunk (a replica of every tensor) writes no file
    mine = Metadata(meta, files={fname: file_digests(blob)} if chunks
                    else {})

    if multi:
        if chunks:
            _write_files(path, fname, blob, replica)
        parts = [None] * dist.get_world_size(pg)
        dist.all_gather_object(parts, mine, group=pg)
        if rank == coordinator_rank:
            atomic_write_bytes(os.path.join(path, "0.metadata"),
                               _merge(parts).to_json().encode())
        dist.barrier(group=pg)
        return

    meta_blob = mine.to_json().encode()

    def write():
        _write_files(path, fname, blob, replica)
        # metadata last: its (atomic) appearance commits the checkpoint
        atomic_write_bytes(os.path.join(path, "0.metadata"), meta_blob)

    if not async_save:
        write()
        return
    err: list = []

    def runner():
        try:
            write()
        except BaseException as e:  # surfaced by wait_async_save
            err.append(e)

    thread = threading.Thread(target=runner, daemon=False,
                              name=f"pt-ckpt-save:{os.path.basename(path)}")
    with _ASYNC_LOCK:
        # publish and start under one critical section: a concurrent
        # wait_async_save must never join a thread not yet started
        _ASYNC.append((os.path.abspath(path), thread, err))
        thread.start()
