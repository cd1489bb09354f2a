"""Watchdogs — port of ``paddle_tpu/distributed/resilience/watchdog.py``.

- :class:`NumericWatchdog` — the host's policy over the guarded train
  step's health word (``framework.numeric_guard``): ``warn`` logs and
  lets the applied update stand; ``skip_step`` counts the (already
  unapplied) step against ``max_skips_per_window`` and escalates to
  rollback when a window's budget is blown; ``rollback`` restores the
  last committed checkpoint and re-warms the learning rate over
  ``rewarm_steps``, up to ``max_rollbacks``, then aborts; ``abort``
  raises :class:`NumericAnomalyError` (through the trainer).
- :class:`StepWatchdog` — a wall-clock budget for serving engine steps.
  A step that overruns its budget is flagged **while it is still stuck**
  (PT-SRV-002), so the supervisor can rebuild-from-journal the moment the
  step returns and an external monitor can read ``fired`` mid-hang. The
  port's engine ``step()`` returns once its work is queued on the card,
  so it times the host side of a step, as the JAX watchdog times an
  asynchronous dispatch.
"""

from __future__ import annotations

import threading
import time
import warnings
from typing import List, Optional, Tuple

from ...framework.numeric_guard import GuardPolicy, describe_health

__all__ = ["NumericWatchdog", "StepWatchdog"]


class StepWatchdog:
    """Wall-clock budget per monitored step (serving engine steps).

    Usage::

        wd = StepWatchdog(budget_s=0.5)
        wd.arm("step:7")
        engine.step()                  # may stall/hang
        if wd.disarm():                # True: the step overran its budget
            supervisor.rebuild()       # PT-SRV-002 path

    A single daemon thread watches the armed window; when the budget
    elapses with the step still running it sets :attr:`fired` and records
    ``(tag, elapsed_at_flag)`` in :attr:`overruns`. ``disarm`` returns
    whether the just-finished step overran (by flag or by final wall time,
    so an overrun is never missed even if the thread was slow to wake) and
    re-arms cleanly for the next step.
    """

    def __init__(self, budget_s: float):
        self.budget_s = float(budget_s)
        self.fired = False
        self.overruns: List[Tuple[str, float]] = []
        self._cond = threading.Condition()
        self._armed: Optional[Tuple[str, float]] = None
        self._closed = False
        self._thread = threading.Thread(target=self._watch, daemon=True,
                                        name="serving-step-watchdog")
        self._thread.start()

    def arm(self, tag: str = "") -> None:
        with self._cond:
            self.fired = False
            self._armed = (str(tag), time.monotonic())
            self._cond.notify_all()

    def disarm(self) -> bool:
        with self._cond:
            armed, self._armed = self._armed, None
            self._cond.notify_all()
            if armed is None:
                return False
            tag, t0 = armed
            elapsed = time.monotonic() - t0
            if elapsed > self.budget_s and not self.fired:
                # the thread did not wake in time: account the overrun here
                self.fired = True
                self.overruns.append((tag, elapsed))
            return self.fired

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._armed = None
            self._cond.notify_all()
        self._thread.join(timeout=1.0)

    def _watch(self) -> None:
        with self._cond:
            while not self._closed:
                if self._armed is None:
                    self._cond.wait()
                    continue
                tag, t0 = self._armed
                remain = self.budget_s - (time.monotonic() - t0)
                if remain > 0:
                    self._cond.wait(timeout=remain)
                    continue
                if self._armed is not None and self._armed[1] == t0 \
                        and not self.fired:
                    self.fired = True
                    self.overruns.append((tag, time.monotonic() - t0))
                    warnings.warn(
                        f"PT-SRV-002: engine step {tag!r} exceeded its "
                        f"{self.budget_s:.3f}s budget and is still running "
                        "— stall suspected", RuntimeWarning)
                # wait for disarm/re-arm before watching again
                while self._armed is not None and self._armed[1] == t0 \
                        and not self._closed:
                    self._cond.wait()


class NumericWatchdog:
    """Per-run anomaly bookkeeping (JAX :131-193). ``observe`` returns the
    decision for one step: ``"ok" | "warn" | "skip_step" | "rollback" |
    "abort"``."""

    def __init__(self, policy: GuardPolicy):
        self.policy = policy
        self.events: List[Tuple[int, int]] = []      # (step, health_word)
        self.skipped_steps: List[int] = []
        self.rollbacks = 0
        self._window_skips: List[int] = []
        self._rewarm_from: Optional[int] = None

    def observe(self, step: int, word: int) -> str:
        word = int(word)
        if word == 0:
            return "ok"
        self.events.append((int(step), word))
        act = self.policy.action
        if act == GuardPolicy.WARN:
            warnings.warn(
                f"[numeric_guard] step {step}: {describe_health(word)} "
                "(policy=warn, update applied)")
            return "warn"
        if act == GuardPolicy.ABORT:
            return "abort"
        if act == GuardPolicy.ROLLBACK:
            return self._rollback_or_abort()
        # SKIP_STEP: prune the window, then charge this skip against it
        lo = int(step) - self.policy.window
        self._window_skips = [s for s in self._window_skips if s > lo]
        self._window_skips.append(int(step))
        if len(self._window_skips) > self.policy.max_skips_per_window:
            return self._rollback_or_abort()
        self.skipped_steps.append(int(step))
        return "skip_step"

    def _rollback_or_abort(self) -> str:
        return ("abort" if self.rollbacks >= self.policy.max_rollbacks
                else "rollback")

    def note_rollback(self, resumed_step: int) -> None:
        """The trainer restored a checkpoint at ``resumed_step``: charge
        the rollback budget, clear the skip window (the streak's cause was
        discarded with the state) and arm the LR re-warm ramp."""
        self.rollbacks += 1
        self._window_skips = []
        if self.policy.rewarm_steps > 0:
            self._rewarm_from = int(resumed_step)

    def lr_scale(self, step: int) -> float:
        """LR multiplier for ``step``: a linear 1/k .. k/k ramp over the
        ``rewarm_steps`` steps after a rollback, 1.0 otherwise."""
        if self._rewarm_from is None:
            return 1.0
        k = self.policy.rewarm_steps
        i = int(step) - self._rewarm_from
        if i >= k:
            self._rewarm_from = None
            return 1.0
        return float(max(0, i) + 1) / float(k)
