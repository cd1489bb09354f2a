"""The resilient trainer — port of ``paddle_tpu/distributed/resilience/
trainer.py`` without its elastic half.

``ResilientTrainer(build_engine, ckpt_dir)`` trains an ``Engine`` with:

- periodic checkpoints of ``engine.state_dict()`` every ``save_every``
  steps through ``save_state_dict(async_save=True)``, *committed* (the
  ``LATEST`` pointer moved) only after ``wait_async_save`` proved the
  shards durable, so a crash mid-save never tears the resume point. The
  pointer is generation-fenced (``checkpoint/latest.py``): the trainer
  claims a token at construction, and a zombie writer from before a
  restart gets :class:`StaleGenerationError` instead of rewinding the job;
- resume from the newest checkpoint that verifies, falling back past a
  corrupt one (PT-CKPT); the newest ``keep`` checkpoints are kept;
- the engine's numeric :class:`GuardPolicy`: each step's health word goes
  through a :class:`NumericWatchdog`. A skipped step was already left
  unapplied by the engine; a rollback restores the last committed
  checkpoint into a freshly built engine (the builder re-seeds; the old
  engine's tensors are released first, so two never sit on the card
  together) and re-warms the learning rate; an abort raises
  :class:`NumericAnomalyError`. Offending batches are captured to
  ``ckpt_dir/badbatch/``.

Checkpoint directories are the JAX package's format, ``LATEST`` included,
so a run of either package resumes in the other. ``elastic=`` (the
``ElasticManager``'s scale events and the reshard-on-scale path) comes
with the store, launch and elastic part of item 6 and raises.
"""

from __future__ import annotations

import gc
import os
import shutil
from typing import Callable, List, Optional

import torch

from ...framework.numeric_guard import BadBatchRecorder, NumericAnomalyError
from .._refuse import STORE, refuse
from ..checkpoint import (CheckpointCorruptionError, load_state_dict,
                          save_state_dict, wait_async_save)
from ..checkpoint.latest import claim_generation, commit_latest, read_latest
from .faults import poison_arrays
from .watchdog import NumericWatchdog

__all__ = ["ResilientTrainer"]


class ResilientTrainer:
    """Auto-resuming training driver.

    Args:
        build_engine: ``(alive_nodes: List[str]) -> Engine``; called with
            ``["local"]``.
        ckpt_dir: checkpoint root; each save lands in ``step_<n>/``.
        elastic: must be None (see the module docstring).
        save_every: checkpoint cadence in steps.
        keep: how many newest checkpoints to retain.
        max_restarts: kept for the JAX signature (scale events only).
        async_save: write periodic checkpoints in the background (the
            final save is always synchronous).
    """

    def __init__(self, build_engine: Callable, ckpt_dir: str, *,
                 elastic=None, save_every: int = 10, keep: int = 3,
                 max_restarts: int = 3, async_save: bool = True):
        if elastic is not None:
            raise refuse("ResilientTrainer(elastic=...) (scale events and "
                         "the reshard-on-scale path)", STORE)
        self.build_engine = build_engine
        self.ckpt_dir = str(ckpt_dir)
        self.elastic = None
        self.save_every = max(1, int(save_every))
        self.keep = max(1, int(keep))
        self.max_restarts = int(max_restarts)
        self.async_save = bool(async_save)
        self.restarts = 0
        self.resumed_at: List[int] = []
        self.numeric_rollbacks = 0
        self.rollback_at: List[int] = []
        self._pending_commit: Optional[int] = None
        os.makedirs(self.ckpt_dir, exist_ok=True)
        # fence token: strictly above whatever is committed (PT-CKPT-005)
        self.generation = claim_generation(self.ckpt_dir)

    # -- checkpoint bookkeeping -------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.ckpt_dir, f"step_{step:08d}")

    def _recorded_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.ckpt_dir):
            if name.startswith("step_"):
                try:
                    out.append(int(name[len("step_"):]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        rec = read_latest(self.ckpt_dir)
        return rec[0] if rec is not None else None

    def save(self, engine, step: int, sync: bool = False) -> None:
        """Checkpoint the engine at ``step``. An async save is committed
        (LATEST moved) by the next :meth:`commit`, so pointer and data
        never disagree."""
        self.commit()                       # the previous async save
        use_async = self.async_save and not sync
        save_state_dict(engine.state_dict(), self._step_dir(step),
                        async_save=use_async)
        if use_async:
            self._pending_commit = step
        else:
            commit_latest(self.ckpt_dir, step, self.generation)
            self._gc()

    def commit(self) -> None:
        """Flush any in-flight async save and move LATEST. The pending step
        is dropped before the flush: if ``wait_async_save`` raises (a shard
        writer died), the move is abandoned for good, and a later commit
        cannot flip LATEST to the torn step."""
        if self._pending_commit is None:
            return
        step, self._pending_commit = self._pending_commit, None
        wait_async_save()
        commit_latest(self.ckpt_dir, step, self.generation)
        self._gc()

    def _gc(self) -> None:
        latest = self.latest_step()
        doomed = [s for s in self._recorded_steps()[: -self.keep]
                  if s != latest]
        for s in doomed:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- resume ------------------------------------------------------------
    def resume(self, engine) -> int:
        """Load the newest checkpoint that verifies (at or before LATEST)
        into ``engine``; returns the step to resume at (0 when there is
        none). A corrupt newest checkpoint falls back to the next."""
        latest = self.latest_step()
        candidates = [s for s in reversed(self._recorded_steps())
                      if latest is None or s <= latest]
        for step in candidates:
            sd = engine.state_dict()
            try:
                load_state_dict(sd, self._step_dir(step))
            except CheckpointCorruptionError:
                continue                    # named in the error; try older
            except FileNotFoundError:
                continue                    # torn dir (no metadata yet)
            engine.set_state_dict(sd)
            return int(sd["step"])
        return 0

    def _rebuild(self, engine):
        """A fresh engine from the builder, the old one's tensors released
        first (on the card two full engines never coexist)."""
        engine.release()
        del engine
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        return self.build_engine(["local"])

    # -- the loop ------------------------------------------------------------
    def fit(self, data_fn: Callable, steps: int, *, shard: bool = True):
        """Train to ``steps`` with auto-resume.

        ``data_fn(step) -> (inputs, labels)`` must be deterministic in
        ``step``: replayed steps after a rollback then reproduce the
        uninterrupted trajectory. Returns ``{"engine", "losses",
        "restarts", "resumed_at", "final_step", "numeric_rollbacks",
        "rollback_at", "numeric_skips", "numeric_events"}``.
        """
        engine = self.build_engine(["local"])
        step = self.resume(engine)
        losses = {}
        watchdog, recorder = self._arm_guard(engine)
        while step < steps:
            ids, lbl = poison_arrays(step, data_fn(step))
            batch = (engine.shard_batch(ids, lbl)
                     if shard and engine.mesh is not None else (ids, lbl))
            if watchdog is not None:
                engine.lr_scale = watchdog.lr_scale(step)
            loss = engine.step(*batch)
            if watchdog is not None:
                # the one host read of the step (the JAX caller's too)
                word = (int(engine.last_health)
                        if engine.last_health is not None else 0)
                if word:
                    decision = watchdog.observe(step + 1, word)
                    if recorder is not None:
                        recorder.record(
                            step + 1, word,
                            {"input_ids": ids, "labels": lbl},
                            extra={"decision": decision,
                                   "lr_scale": float(engine.lr_scale)})
                    if decision == "abort":
                        raise NumericAnomalyError(
                            word, step=step + 1,
                            detail="guard budgets exhausted"
                            if engine.guard.action != "abort" else "")
                    if decision == "rollback":
                        # restore the last COMMITTED checkpoint, re-seed
                        # through the builder, re-warm the LR
                        self.commit()
                        del loss, batch
                        engine = self._rebuild(engine)
                        step = self.resume(engine)
                        watchdog.note_rollback(step)
                        self.numeric_rollbacks += 1
                        self.rollback_at.append(step)
                        continue
                    # "warn" applied the update, "skip_step" left it
                    # unapplied: the step counter advances either way
            step += 1
            losses[step] = float(loss)
            if step % self.save_every == 0 and step < steps:
                self.save(engine, step)
        self.save(engine, steps, sync=True)
        return {"engine": engine, "losses": losses, "restarts": self.restarts,
                "resumed_at": list(self.resumed_at), "final_step": step,
                "numeric_rollbacks": self.numeric_rollbacks,
                "rollback_at": list(self.rollback_at),
                "numeric_skips": (list(watchdog.skipped_steps)
                                  if watchdog is not None else []),
                "numeric_events": (list(watchdog.events)
                                   if watchdog is not None else [])}

    def _arm_guard(self, engine):
        """The watchdog and bad-batch recorder when the engine carries a
        GuardPolicy (the guard's bookkeeping outlives engine rebuilds on
        the watchdog, not on the engine)."""
        guard = getattr(engine, "guard", None)
        if guard is None:
            return None, None
        recorder = (BadBatchRecorder(os.path.join(self.ckpt_dir, "badbatch"))
                    if guard.record_bad_batches else None)
        return NumericWatchdog(guard), recorder
