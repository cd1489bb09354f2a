"""Shared-memory batch channel for DataLoader worker -> trainer transport —
port of ``paddle_tpu/io/shm_channel.py``.

A POSIX shared-memory MPMC ring (``csrc/shm_ring.cc``, built with g++ at
first use into ``build/native/`` at the root of the checkout and loaded
with ctypes) carries each batch: its structure (nesting, dtypes, shapes)
pickled, its ndarray payloads written raw, so bulk bytes never pass
through a pickle pipe. Without a C++ compiler ``ShmChannel.available()``
is False and the DataLoader uses its queue instead.

Message layout: [u32 manifest_len][pickle(manifest)][array0 bytes][array1 ...].
The manifest is the batch structure with each ndarray replaced by
("__nd__", i, dtype_str, shape); oversized batches (> ring capacity) raise and
the caller falls back to the queue transport.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pickle
import shutil
import struct
import subprocess
import threading
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "csrc" / "shm_ring.cc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_CXX_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17", "-pthread",
              "-fvisibility=hidden"]
_lib = None
_lib_err: Optional[str] = None
_lock = threading.Lock()


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    sigs = {
        "pt_shmring_create": (c.c_void_p, [c.c_char_p, c.c_longlong]),
        "pt_shmring_attach": (c.c_void_p, [c.c_char_p]),
        "pt_shmring_push": (c.c_int, [c.c_void_p, c.c_char_p, c.c_longlong,
                                      c.c_int]),
        "pt_shmring_pop": (c.c_longlong, [c.c_void_p,
                                          c.POINTER(c.POINTER(c.c_uint8)),
                                          c.c_int]),
        "pt_shmring_size": (c.c_longlong, [c.c_void_p]),
        "pt_shmring_close": (None, [c.c_void_p]),
        "pt_shmring_detach": (None, [c.c_void_p]),
        "pt_shmring_unlink": (None, [c.c_char_p]),
        "pt_shmring_free": (None, [c.c_void_p]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def _build() -> Path:
    """Compile (or reuse) the ring library; raises RuntimeError without a
    working C++ compiler."""
    cxx = os.environ.get("CXX", "g++")
    if shutil.which(cxx) is None:
        raise RuntimeError(f"no C++ compiler ({cxx}) to build the shm ring")
    h = hashlib.sha256(" ".join([cxx] + _CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    out = _BUILD_DIR / f"shm_ring-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *_CXX_FLAGS, "-o", str(tmp), str(_SRC),
                           "-lrt"], capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"shm ring build failed:\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def _load() -> Optional[ctypes.CDLL]:
    """The ring library, built at first use; None when it cannot be."""
    global _lib, _lib_err
    with _lock:
        if _lib is None and _lib_err is None:
            try:
                _lib = _bind(ctypes.CDLL(str(_build())))
            except Exception as e:  # noqa: BLE001 — any failure: the queue
                _lib_err = str(e)
        return _lib


__all__ = ["ShmChannel", "pack_batch", "unpack_batch"]


def _extract(obj: Any, arrays: List[np.ndarray]) -> Any:
    if isinstance(obj, np.ndarray):
        idx = len(arrays)
        arrays.append(np.ascontiguousarray(obj))
        return ("__nd__", idx, obj.dtype.str, obj.shape)
    if isinstance(obj, tuple):
        return tuple(_extract(o, arrays) for o in obj)
    if isinstance(obj, list):
        return [_extract(o, arrays) for o in obj]
    if isinstance(obj, dict):
        return {k: _extract(v, arrays) for k, v in obj.items()}
    return obj


def _rebuild(obj: Any, buf: memoryview, offsets: List[Tuple[int, int]]) -> Any:
    if isinstance(obj, tuple):
        if len(obj) == 4 and obj[0] == "__nd__":
            _, idx, dtype, shape = obj
            start, nbytes = offsets[idx]
            return np.frombuffer(buf[start:start + nbytes], dtype=np.dtype(dtype)).reshape(shape)
        return tuple(_rebuild(o, buf, offsets) for o in obj)
    if isinstance(obj, list):
        return [_rebuild(o, buf, offsets) for o in obj]
    if isinstance(obj, dict):
        return {k: _rebuild(v, buf, offsets) for k, v in obj.items()}
    return obj


def pack_batch(payload: Any) -> bytes:
    arrays: List[np.ndarray] = []
    manifest = _extract(payload, arrays)
    head = pickle.dumps((manifest, [(a.dtype.str, a.shape, a.nbytes) for a in arrays]),
                        protocol=pickle.HIGHEST_PROTOCOL)
    parts = [struct.pack("<I", len(head)), head]
    parts.extend(a.tobytes() for a in arrays)
    return b"".join(parts)


def unpack_batch(data: bytes) -> Any:
    (hlen,) = struct.unpack_from("<I", data, 0)
    manifest, metas = pickle.loads(data[4:4 + hlen])
    buf = memoryview(data)
    offsets = []
    pos = 4 + hlen
    for _, _, nbytes in metas:
        offsets.append((pos, nbytes))
        pos += nbytes
    return _rebuild(manifest, buf, offsets)


class ShmChannel:
    """MPMC byte-record channel over a named POSIX shm ring."""

    def __init__(self, name: str, capacity: int = 64 << 20, create: bool = True):
        self._lib = _load()
        if self._lib is None:
            raise RuntimeError(f"shm ring unavailable: {_lib_err}")
        self.name = name
        self.capacity = capacity
        if create:
            self._handle = self._lib.pt_shmring_create(name.encode(), capacity)
        else:
            self._handle = self._lib.pt_shmring_attach(name.encode())
        if not self._handle:
            raise RuntimeError(f"shm ring {'create' if create else 'attach'}({name}) failed")
        self._owner = create

    @classmethod
    def available(cls) -> bool:
        return _load() is not None

    def put(self, payload: Any, timeout: Optional[float] = None) -> None:
        data = pack_batch(payload)
        tmo = -1 if timeout is None else int(timeout * 1000)
        rc = self._lib.pt_shmring_push(self._handle, data, len(data), tmo)
        if rc == -2:
            raise ValueError(
                f"record of {len(data)} bytes exceeds ring capacity {self.capacity}")
        if rc != 0:
            raise TimeoutError("shm ring push timed out or channel closed")

    def get(self, timeout: Optional[float] = None) -> Any:
        tmo = -1 if timeout is None else int(timeout * 1000)
        out = ctypes.POINTER(ctypes.c_uint8)()
        n = self._lib.pt_shmring_pop(self._handle, ctypes.byref(out), tmo)
        if n == -3:
            raise EOFError("shm ring closed")
        if n < 0:
            raise TimeoutError("shm ring pop timed out")
        try:
            data = ctypes.string_at(out, int(n)) if n > 0 else b""
        finally:
            if out:
                self._lib.pt_shmring_free(out)
        return unpack_batch(data)

    def qsize_bytes(self) -> int:
        return int(self._lib.pt_shmring_size(self._handle))

    def close(self) -> None:
        if self._handle:
            self._lib.pt_shmring_close(self._handle)
            self._handle = None
            if self._owner:
                self._lib.pt_shmring_unlink(self.name.encode())

    def detach(self) -> None:
        if self._handle:
            self._lib.pt_shmring_detach(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close() if self._owner else self.detach()
        except Exception:
            pass
