"""The numeric health word, its eager half — port of ``paddle_tpu/
framework/numeric_guard.py`` (:59-106, :223-272).

One process-wide word of anomaly bits, with the JAX package's values and
PT-NUM codes, into which every eager detection channel reports: the op
dispatcher's nan/inf check (``FLAGS_check_nan_inf``) and the AMP loss
scaler's overflow scan. ``consume_health`` reads and clears it once a step.
The on-device guard (``guard_step``, ``GuardPolicy``) and the bad-batch
recorder belong to the training engine's resilience slice (ROADMAP item 6).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Tuple

NAN_GRAD = 1
INF_GRAD = 2
NAN_LOSS = 4
SPIKE = 8
OVERFLOW = 16
ALL_BITS = NAN_GRAD | INF_GRAD | NAN_LOSS | SPIKE | OVERFLOW

BIT_NAMES = {
    NAN_GRAD: "NAN_GRAD",
    INF_GRAD: "INF_GRAD",
    NAN_LOSS: "NAN_LOSS",
    SPIKE: "SPIKE",
    OVERFLOW: "OVERFLOW",
}
BIT_CODES = {
    NAN_GRAD: "PT-NUM-001",
    INF_GRAD: "PT-NUM-002",
    NAN_LOSS: "PT-NUM-003",
    SPIKE: "PT-NUM-004",
    OVERFLOW: "PT-NUM-005",
}


def describe_health(word: int) -> str:
    """``"NAN_GRAD|SPIKE (PT-NUM-001, PT-NUM-004)"`` for a non-zero word."""
    word = int(word)
    if not word:
        return "healthy"
    names = [n for b, n in BIT_NAMES.items() if word & b]
    codes = [c for b, c in BIT_CODES.items() if word & b]
    return "|".join(names) + " (" + ", ".join(codes) + ")"


def health_codes(word: int) -> List[str]:
    return [c for b, c in BIT_CODES.items() if int(word) & b]


_EAGER_LOCK = threading.Lock()
_EAGER: Dict[str, object] = {"word": 0, "events": []}
_MAX_EVENTS = 256


def record_health(bits: int, source: str = "") -> None:
    """OR ``bits`` into the process-global eager health word (the loss
    scaler's overflow scan and the dispatcher's nan/inf check call it)."""
    with _EAGER_LOCK:
        _EAGER["word"] = int(_EAGER["word"]) | int(bits)
        ev: List = _EAGER["events"]  # type: ignore[assignment]
        if len(ev) < _MAX_EVENTS:
            ev.append((int(bits), source))


def report_nan_inf(num_nan: int, num_inf: int, source: str = "") -> int:
    """Map host-side nan/inf counts onto the PT-NUM-001/002 bits and record
    them. Returns the bits (0 when both counts are zero)."""
    bits = (NAN_GRAD if num_nan else 0) | (INF_GRAD if num_inf else 0)
    if bits:
        record_health(bits, source)
    return bits


def consume_health() -> int:
    """Read-and-clear the eager health word (one consumer per step)."""
    with _EAGER_LOCK:
        word = int(_EAGER["word"])
        _EAGER["word"] = 0
        _EAGER["events"] = []
    return word


def peek_health() -> int:
    with _EAGER_LOCK:
        return int(_EAGER["word"])


def health_events() -> List[Tuple[int, str]]:
    with _EAGER_LOCK:
        return list(_EAGER["events"])  # type: ignore[arg-type]
