"""The host tracer — port of ``paddle_tpu/native/src/trace.cc`` (the
reference's HostTracer + ChromeTracingLogger) in Python.

It records host scopes (``begin`` / ``end``, which ``RecordEvent`` calls),
instants and counters into per-thread buffers: a thread appends to its own
buffer without a lock, and the lock is taken only to register a thread's
buffer, to restart and to dump. ``start`` clears every buffer, resets the
epoch and bumps the generation, so a scope begun before a restart can tell
that it must not close a later one (``generation``). ``dump`` writes the
same chrome://tracing JSON as trace.cc: ``{"traceEvents": [...]}`` with a
``process_name`` metadata event, then ``ph`` X (with ``dur``), i (``"s":
"t"``) or C (``args.value``) events, timestamps in microseconds from the
epoch, ``tid`` the OS thread id.
"""

from __future__ import annotations

import json
import os
import threading
import time

_lock = threading.Lock()
_bufs = []
_local = threading.local()
_state = {"enabled": False, "generation": 0, "epoch_us": 0}


def _now_us():
    return time.perf_counter_ns() // 1000


class _ThreadBuf:
    __slots__ = ("events", "open", "tid")

    def __init__(self):
        self.events = []        # (name, ph, ts_us, dur_us, value, tid)
        self.open = []          # begin() stack: (name, t0_us)
        self.tid = threading.get_native_id()


def _buf():
    b = getattr(_local, "buf", None)
    if b is None:
        b = _local.buf = _ThreadBuf()
        with _lock:
            _bufs.append(b)
    return b


def start():
    with _lock:
        for b in _bufs:
            b.events.clear()
            b.open.clear()
        _state["epoch_us"] = _now_us()
        _state["generation"] += 1
        _state["enabled"] = True


def stop():
    _state["enabled"] = False


def enabled():
    return _state["enabled"]


def generation():
    return _state["generation"]


def begin(name):
    if _state["enabled"]:
        _buf().open.append((name, _now_us()))


def end():
    if not _state["enabled"]:
        return
    b = _buf()
    if not b.open:
        return
    name, t0 = b.open.pop()
    b.events.append((name, "X", t0 - _state["epoch_us"], _now_us() - t0,
                     0.0, b.tid))


def instant(name):
    if _state["enabled"]:
        b = _buf()
        b.events.append((name, "i", _now_us() - _state["epoch_us"], 0, 0.0,
                         b.tid))


def counter(name, value):
    if _state["enabled"]:
        b = _buf()
        b.events.append((name, "C", _now_us() - _state["epoch_us"], 0,
                         float(value), b.tid))


def event_count():
    with _lock:
        return sum(len(b.events) for b in _bufs)


def dump(path, process_name="paddle_tpu"):
    """Write the chrome trace to ``path``; False when it cannot be
    written."""
    pid = os.getpid()
    parts = [json.dumps({"ph": "M", "pid": pid, "name": "process_name",
                         "args": {"name": process_name or "paddle_tpu"}},
                        separators=(",", ":"))]
    with _lock:
        for b in _bufs:
            for name, ph, ts, dur, value, tid in list(b.events):
                e = {"ph": ph, "pid": pid, "tid": tid, "ts": ts,
                     "name": name}
                if ph == "X":
                    e["dur"] = dur
                elif ph == "C":
                    e["args"] = {"value": value}
                else:
                    e["s"] = "t"
                parts.append(json.dumps(e, separators=(",", ":")))
    try:
        with open(path, "w") as f:
            f.write('{"traceEvents":[\n' + ",\n".join(parts) + "\n]}\n")
    except OSError:
        return False
    return True
