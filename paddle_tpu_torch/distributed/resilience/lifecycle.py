"""The checkpoint lifecycle, train -> serve — port of ``paddle_tpu/
distributed/resilience/lifecycle.py``.

A :class:`CheckpointPublisher` hands a ``ResilientTrainer`` checkpoint to
a serving fleet in three fenced moves:

1. **verify** — every shard file the ``0.metadata`` manifest names is
   digest-checked (crc32 + sha256 + size, replica fallback included;
   ``checkpoint.load_state_dict._ChunkReader``) before a byte reaches a
   model, refused with the loader's typed ``PT-CKPT`` errors;
2. **load** — the trained parameters fill the serving model's tensors in
   place (``load_state_dict`` on ``{"model": model.state_dict()}``; the
   moments and the step stay behind);
3. **swap** — ``fleet.rolling_restart()`` drains and rebuilds one replica
   at a time, so traffic never sees a half-updated replica and the
   swapped fleet serves as a cold fleet built from the checkpoint would.

The publisher refuses to publish a generation below the one it already
served (:class:`StaleGenerationError`, PT-CKPT-005). Module-level stats
feed ``observability.checkpoint_collector``; a ``tracer`` gets one
``publish`` span per publish (``TraceRecorder.publish``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional, Tuple

from ..checkpoint import load_state_dict
from ..checkpoint.latest import StaleGenerationError, read_latest
from ..checkpoint.load_state_dict import _ChunkReader

__all__ = ["CheckpointPublisher", "LIFECYCLE_PHASES", "lifecycle_stats",
           "reset_lifecycle_stats", "set_lifecycle_phase"]

#: the lifecycle's state machine
LIFECYCLE_PHASES = ("idle", "train", "checkpoint", "shrink", "resume",
                    "publish", "serve")

# shared by trainer threads, the publisher and scrape threads
_STATS_LOCK = threading.Lock()
_STATS = {
    "generation": 0,          # newest generation successfully published
    "publish_total": 0,
    "publish_failures": 0,
    "phase": "idle",
}


def lifecycle_stats() -> Dict[str, object]:
    """Snapshot for the checkpoint collector (zero-state renders at 0)."""
    with _STATS_LOCK:
        return dict(_STATS)


def reset_lifecycle_stats() -> None:
    with _STATS_LOCK:
        _STATS.update(generation=0, publish_total=0, publish_failures=0,
                      phase="idle")


def set_lifecycle_phase(phase: str) -> None:
    """Advance the phase marker (``pt_lifecycle_phase``)."""
    if phase not in LIFECYCLE_PHASES:
        raise ValueError(f"unknown lifecycle phase {phase!r} "
                         f"(one of {LIFECYCLE_PHASES})")
    with _STATS_LOCK:
        _STATS["phase"] = phase


class CheckpointPublisher:
    """Hand a training checkpoint to a serving fleet, fenced and verified.

    Args:
        ckpt_dir: the ``ResilientTrainer`` checkpoint root (``step_<n>/``
            dirs plus the generation-bearing ``LATEST`` pointer).
        tracer: optional ``TraceRecorder``; every publish lands as a
            ``publish`` span (step, generation, shard count, outcome).
    """

    def __init__(self, ckpt_dir: str, *, tracer=None):
        self.ckpt_dir = str(ckpt_dir)
        self.tracer = tracer
        self._lock = threading.Lock()
        self._published: Optional[Tuple[int, int]] = None   # (step, gen)

    def latest(self) -> Optional[Tuple[int, int]]:
        """The committed ``(step, generation)`` resume pointer, or None."""
        return read_latest(self.ckpt_dir)

    def step_dir(self, step: int) -> str:
        return os.path.join(self.ckpt_dir, f"step_{step:08d}")

    def verify(self, step: int) -> int:
        """Digest-check every shard the manifest names; the number of
        verified shard files. Raises the loader's ``PT-CKPT`` errors on
        damage, ``FileNotFoundError`` on a missing manifest."""
        path = self.step_dir(step)
        with open(os.path.join(path, "0.metadata")) as f:
            files = json.load(f).get("files") or {}
        reader = _ChunkReader(path, files=files, verify=True)
        for fname in sorted(files):
            reader._verified_path(fname)
        return len(files)

    def load_weights(self, model, step: int) -> int:
        """Fill ``model``'s parameters in place from the checkpoint (the
        moments and the step are not read); the number of tensors
        filled."""
        target = {"model": model.state_dict()}
        load_state_dict(target, self.step_dir(step))
        return len(target["model"])

    def publish(self, model, fleet=None, *, step: Optional[int] = None,
                verify: bool = True) -> Dict[str, object]:
        """Verify -> load -> hot-swap. ``step=None`` publishes the
        committed LATEST pointer. ``fleet`` (a ``FleetRouter`` or anything
        with ``rolling_restart()``) is swapped replica by replica;
        ``fleet=None`` only updates the model. Returns ``{"step",
        "generation", "shards", "params", "time_s"}``. Verification runs
        before the in-place load, so a corrupt checkpoint is refused with
        the serving weights intact; any failure counts in
        ``publish_failures``."""
        t0 = time.monotonic()
        rec = self.latest()
        if step is None:
            if rec is None:
                raise FileNotFoundError(
                    f"no committed LATEST pointer in {self.ckpt_dir}")
            step, gen = rec
        else:
            gen = rec[1] if rec is not None and rec[0] == step else 0
        set_lifecycle_phase("publish")
        try:
            with self._lock:
                if (self._published is not None
                        and gen < self._published[1]):
                    raise StaleGenerationError(
                        self.ckpt_dir, self._published[1], gen)
            shards = self.verify(step) if verify else 0
            params = self.load_weights(model, step)
            if fleet is not None:
                fleet.rolling_restart()
            with self._lock:
                self._published = (step, gen)
        except BaseException:
            with _STATS_LOCK:
                _STATS["publish_failures"] += 1
            if self.tracer is not None:
                self.tracer.publish(t0, step, gen, 0, ok=False)
            raise
        with _STATS_LOCK:
            _STATS["publish_total"] += 1
            _STATS["generation"] = max(_STATS["generation"], gen)
        set_lifecycle_phase("serve")
        dt = time.monotonic() - t0
        if self.tracer is not None:
            self.tracer.publish(t0, step, gen, shards, ok=True)
        return {"step": step, "generation": gen, "shards": shards,
                "params": params, "time_s": dt}
