"""The generation-fenced ``LATEST`` resume pointer — port of
``paddle_tpu/distributed/checkpoint/latest.py``.

``LATEST`` names the newest durable checkpoint step and carries a
monotonic generation token, ``"<step> <generation>"``, byte for byte as
the JAX package writes it, so either package's trainer resumes from and
fences the other's directory. Every writer claims a generation strictly
above the committed one (:func:`claim_generation`); :func:`commit_latest`
refuses, with :class:`StaleGenerationError` (PT-CKPT-005), a commit whose
token is below the one on disk, so a zombie writer from before a restart
cannot rewind the job. The file moves by tempfile + ``os.replace``:
readers see the old pair or the new one, never a torn mix. A bare-integer
``LATEST`` reads as generation 0.
"""

from __future__ import annotations

import os
import threading
from typing import Optional, Tuple

from .integrity import atomic_write_bytes

__all__ = ["LATEST_FILE", "StaleGenerationError", "read_latest",
           "latest_generation", "claim_generation", "commit_latest"]

LATEST_FILE = "LATEST"

# read-check-replace is one critical section per process: the async-save
# committer and a publisher share this path
_LATEST_LOCK = threading.Lock()


class StaleGenerationError(RuntimeError):
    """A writer holding an outdated generation token tried to move LATEST.

    Attributes: ``path`` (checkpoint root), ``committed`` (generation on
    disk), ``attempted`` (the stale writer's token). Code PT-CKPT-005.
    """

    code = "PT-CKPT-005"

    def __init__(self, path: str, committed: int, attempted: int):
        self.path = path
        self.committed = committed
        self.attempted = attempted
        super().__init__(
            f"PT-CKPT-005: stale checkpoint writer fenced in {path}: "
            f"generation {attempted} < committed generation {committed} "
            f"(a newer trainer/publisher owns this directory)")


def read_latest(ckpt_dir: str) -> Optional[Tuple[int, int]]:
    """``(step, generation)`` from LATEST; ``None`` when missing or
    unparsable. A bare integer reads as generation 0."""
    try:
        with open(os.path.join(ckpt_dir, LATEST_FILE)) as f:
            fields = f.read().split()
        step = int(fields[0])
        gen = int(fields[1]) if len(fields) > 1 else 0
        return step, gen
    except (OSError, ValueError, IndexError):
        return None


def latest_generation(ckpt_dir: str) -> int:
    """The committed generation (0 when no fenced LATEST exists yet)."""
    rec = read_latest(ckpt_dir)
    return rec[1] if rec is not None else 0


def claim_generation(ckpt_dir: str) -> int:
    """A generation token strictly above everything committed: what a new
    trainer (or a publisher taking ownership) claims once at start. Any
    writer still holding an older token is fenced from then on."""
    with _LATEST_LOCK:
        return latest_generation(ckpt_dir) + 1


def commit_latest(ckpt_dir: str, step: int, generation: int) -> None:
    """Atomically move the resume pointer to ``step`` under ``generation``;
    :class:`StaleGenerationError` when the generation on disk is above it.
    Equal generations commit freely (a writer moves its own pointer)."""
    with _LATEST_LOCK:
        committed = latest_generation(ckpt_dir)
        if int(generation) < committed:
            raise StaleGenerationError(ckpt_dir, committed, int(generation))
        atomic_write_bytes(os.path.join(ckpt_dir, LATEST_FILE),
                           f"{int(step)} {int(generation)}".encode())
