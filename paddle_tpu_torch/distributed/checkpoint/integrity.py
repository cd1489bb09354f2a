"""Checkpoint integrity — port of ``paddle_tpu/distributed/checkpoint/
integrity.py``: atomic shard writes, per-shard digests (size, crc32,
sha256) recorded in ``0.metadata`` and verified at load, and a typed
corruption error naming the bad shard. When a ``<shard>.replica`` copy
exists and verifies, the loader recovers from it.

Diagnostic codes (the JAX package's):

- ``PT-CKPT-001`` — shard digest mismatch (bit-flip / partial overwrite)
- ``PT-CKPT-002`` — shard truncated (size mismatch)
- ``PT-CKPT-003`` — shard file referenced by the metadata is missing
  (torn save)
- ``PT-CKPT-004`` — shard unreadable / undecodable

All writes go through :func:`atomic_write_bytes` (same-directory tempfile +
``os.replace``), so a crash mid-write leaves either the old file or the new
one — never a torn shard.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
import zlib
from typing import Dict, Optional

__all__ = ["CheckpointCorruptionError", "atomic_write_bytes",
           "file_digests", "verify_shard_bytes", "verify_shard_file",
           "REPLICA_SUFFIX"]

REPLICA_SUFFIX = ".replica"


class CheckpointCorruptionError(RuntimeError):
    """A checkpoint shard failed integrity verification.

    Attributes: ``code`` (PT-CKPT-xxx), ``path`` (checkpoint dir),
    ``shard`` (the bad file's name), ``reason``.
    """

    def __init__(self, code: str, path: str, shard: str, reason: str):
        self.code = code
        self.path = path
        self.shard = shard
        self.reason = reason
        super().__init__(
            f"{code}: checkpoint shard '{shard}' in {path}: {reason}")


def file_digests(data: bytes) -> Dict[str, object]:
    """The integrity record stored per shard file in ``0.metadata``."""
    return {
        "size": len(data),
        "crc32": zlib.crc32(data) & 0xFFFFFFFF,
        "sha256": hashlib.sha256(data).hexdigest(),
    }


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Write-then-rename so readers never observe a partial file."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(prefix=".pt_tmp_", dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _check_digests(size: int, crc: int, sha_hex: str,
                   record: Optional[Dict], path: str, shard: str) -> None:
    if record is None:
        # pre-integrity checkpoint: verifies vacuously, stays loadable
        return
    want_size = record.get("size")
    if want_size is not None and size != int(want_size):
        raise CheckpointCorruptionError(
            "PT-CKPT-002", path, shard,
            f"truncated: {size} bytes on disk, {want_size} recorded")
    want_crc = record.get("crc32")
    if want_crc is not None and crc != int(want_crc):
        raise CheckpointCorruptionError(
            "PT-CKPT-001", path, shard,
            f"crc32 mismatch: {crc:#010x} on disk, "
            f"{int(want_crc):#010x} recorded")
    want_sha = record.get("sha256")
    if want_sha is not None and sha_hex != want_sha:
        raise CheckpointCorruptionError(
            "PT-CKPT-001", path, shard, "sha256 mismatch")


def verify_shard_bytes(data: bytes, record: Optional[Dict], path: str,
                       shard: str) -> None:
    """Check in-memory ``data`` against its recorded digests; raise a
    typed, named corruption error on mismatch."""
    _check_digests(len(data), zlib.crc32(data) & 0xFFFFFFFF,
                   hashlib.sha256(data).hexdigest(), record, path, shard)


def verify_shard_file(fpath: str, record: Optional[Dict], path: str,
                      shard: str, chunk_size: int = 1 << 20) -> None:
    """Digest-check a shard ON DISK in fixed-size chunks — peak memory is
    one chunk, not the whole (multi-GB) shard. FileNotFoundError
    propagates; digest mismatches raise the same PT-CKPT errors as the
    bytes variant."""
    size, crc, sha = 0, 0, hashlib.sha256()
    with open(fpath, "rb") as f:
        while True:
            block = f.read(chunk_size)
            if not block:
                break
            size += len(block)
            crc = zlib.crc32(block, crc)
            sha.update(block)
    _check_digests(size, crc & 0xFFFFFFFF, sha.hexdigest(), record, path,
                   shard)
