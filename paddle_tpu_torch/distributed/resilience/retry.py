"""Shared retry/timeout/backoff — port of
``paddle_tpu/distributed/resilience/retry.py``: one policy object for every
control-plane call that may fail transiently.

A transient failure (peer restarting, store momentarily unreachable,
injected fault) is retried with exponential backoff + jitter under an
overall deadline; exhaustion raises a :class:`RetryError` carrying a stable
``PT-RETRY-xxx`` diagnostic code so logs and tests can assert on the
failure class, not a message string.

Diagnostic codes:

- ``PT-RETRY-001`` — overall deadline exhausted while retrying
- ``PT-RETRY-002`` — attempt budget exhausted
- Non-retryable exceptions propagate unchanged (a typed ``KeyError`` from a
  store miss must stay a ``KeyError``).

``PT_RETRY_DISABLE=1`` collapses every policy to a single attempt.

Every ``retry_call`` also feeds a module-level stats registry
(:func:`retry_stats`): calls / attempts / retries / give-ups and cumulative
latency, plus a bounded per-``what`` attempt breakdown. The serving engine
copies the attempts and give-ups into ``ContinuousBatchingEngine.stats`` at
``finished()``, and ``observability.retry_collector`` exports the registry.
The delay sequence of a policy under a seeded ``random.Random`` is the JAX
package's, draw for draw.
"""

from __future__ import annotations

import dataclasses
import os
import random
import threading
import time
from typing import Callable, Optional, Tuple, Type

__all__ = ["RetryPolicy", "RetryError", "retry_call", "DEFAULT_POLICY",
           "backoff_delays", "retries_disabled", "retry_stats",
           "reset_retry_stats"]

# -- stats registry ---------------------------------------------------------
# retry_call runs CONCURRENTLY (fleet ``parallel_step`` replica threads,
# any thread pool fan-out), so the read-modify-write counter updates need a
# real lock: ``+=`` under the GIL loses increments across threads. The
# lock is control-plane cost only. ``by_what`` is bounded so an unbounded
# label space (per-key store ops) cannot grow the registry without limit.
_BY_WHAT_CAP = 64

_STATS_LOCK = threading.Lock()
_STATS = {"calls": 0, "attempts": 0, "retries": 0, "giveups": 0,
          "latency_s": 0.0}
_BY_WHAT: dict = {}


def retry_stats() -> dict:
    """Snapshot of the registry: aggregate counters plus the per-``what``
    attempt counts (``by_what``, capped at 64 distinct labels)."""
    with _STATS_LOCK:
        out = dict(_STATS)
        out["by_what"] = dict(_BY_WHAT)
    return out


def reset_retry_stats() -> None:
    with _STATS_LOCK:
        for k in _STATS:
            _STATS[k] = 0.0 if k == "latency_s" else 0
        _BY_WHAT.clear()


def _note_attempt(what: str) -> None:
    with _STATS_LOCK:
        _STATS["attempts"] += 1
        if what in _BY_WHAT or len(_BY_WHAT) < _BY_WHAT_CAP:
            _BY_WHAT[what] = _BY_WHAT.get(what, 0) + 1


def _note(key: str, amount=1) -> None:
    with _STATS_LOCK:
        _STATS[key] += amount


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with full jitter under an overall deadline.

    Delay before attempt ``k`` (1-based, first retry is k=2):
    ``min(max_delay, base_delay * multiplier**(k-2))`` scaled by a uniform
    jitter in ``[1-jitter, 1+jitter]``, truncated so the sleep never crosses
    ``deadline``.
    """

    max_attempts: int = 4
    base_delay: float = 0.05
    multiplier: float = 2.0
    max_delay: float = 2.0
    jitter: float = 0.25
    deadline: Optional[float] = None       # seconds across ALL attempts
    retry_on: Tuple[Type[BaseException], ...] = (
        ConnectionError, TimeoutError, OSError)


DEFAULT_POLICY = RetryPolicy()


class RetryError(RuntimeError):
    """Terminal retry failure with a stable diagnostic code.

    Attributes: ``code`` (PT-RETRY-xxx), ``what`` (operation label),
    ``attempts``, ``elapsed``, ``last`` (the final underlying exception).
    """

    def __init__(self, code: str, what: str, attempts: int, elapsed: float,
                 last: BaseException):
        self.code = code
        self.what = what
        self.attempts = attempts
        self.elapsed = elapsed
        self.last = last
        super().__init__(
            f"{code}: {what} failed after {attempts} attempt(s) in "
            f"{elapsed:.2f}s: {last!r}")


def retries_disabled() -> bool:
    return os.environ.get("PT_RETRY_DISABLE") == "1"


def backoff_delays(policy: RetryPolicy, rng: Optional[random.Random] = None):
    """The delay sequence a policy produces (attempt 2, 3, ...) — exposed so
    tests can pin the schedule without sleeping."""
    r = rng or random
    d = policy.base_delay
    for _ in range(max(0, policy.max_attempts - 1)):
        j = 1.0 + policy.jitter * (2.0 * r.random() - 1.0) if policy.jitter else 1.0
        yield min(policy.max_delay, d) * j
        d *= policy.multiplier


def retry_call(fn: Callable, *args, policy: Optional[RetryPolicy] = None,
               what: str = "call", on_retry: Optional[Callable] = None,
               rng: Optional[random.Random] = None, sleep=time.sleep, **kwargs):
    """Call ``fn(*args, **kwargs)``, retrying ``policy.retry_on`` failures.

    ``on_retry(attempt, exc, delay)`` is invoked before each backoff sleep
    (reconnect hooks, logging). ``sleep`` is injectable for tests.
    """
    pol = policy or DEFAULT_POLICY
    attempts = 1 if retries_disabled() else max(1, pol.max_attempts)
    start = time.monotonic()
    delays = backoff_delays(pol, rng)
    last: Optional[BaseException] = None
    _note("calls")
    for attempt in range(1, attempts + 1):
        _note_attempt(what)
        try:
            result = fn(*args, **kwargs)
            _note("latency_s", time.monotonic() - start)
            return result
        except pol.retry_on as e:
            last = e
            elapsed = time.monotonic() - start
            if attempt >= attempts:
                _note("giveups")
                _note("latency_s", elapsed)
                if attempts == 1:
                    raise        # retries disabled/single-shot: raw failure
                raise RetryError("PT-RETRY-002", what, attempt, elapsed, e) from e
            delay = next(delays, pol.max_delay)
            if pol.deadline is not None:
                remain = pol.deadline - elapsed
                if remain <= 0:
                    _note("giveups")
                    _note("latency_s", elapsed)
                    raise RetryError("PT-RETRY-001", what, attempt, elapsed,
                                     e) from e
                delay = min(delay, remain)
            _note("retries")
            if on_retry is not None:
                on_retry(attempt, e, delay)
            sleep(max(0.0, delay))
    raise AssertionError("unreachable")  # loop always returns or raises
