"""Wall-clock step budgets for serving engine steps — port of
``StepWatchdog`` (``paddle_tpu/distributed/resilience/watchdog.py``).

A step that overruns its budget is flagged **while it is still stuck**
(PT-SRV-002), so the supervisor can rebuild-from-journal the moment the
step returns and an external monitor can read ``fired`` mid-hang.

The port's engine ``step()`` returns once its work is queued on the card,
so the watchdog times the host side of a step, as the JAX watchdog times
an asynchronous dispatch. ``NumericWatchdog`` arrives with the numeric
guard (distributed-training slice).
"""

from __future__ import annotations

import threading
import time
import warnings
from typing import List, Optional, Tuple

__all__ = ["StepWatchdog"]


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
