"""paddle_tpu_torch.profiler — port of ``paddle_tpu/profiler`` (reference:
python/paddle/profiler + fluid/platform/profiler).

The device tracer is ``torch.profiler.profile`` (Kineto over CUPTI on the
card) where the JAX package starts ``jax.profiler``: one session for the
profiler's life, driven by the scheduler (READY is Kineto's warm-up,
RECORD and RECORD_AND_RETURN record), and each recorded window's
chrome-trace JSON is written into the profiler's trace directory
(``device_trace_<n>.json``), which ``load_profiler_result(dir)`` reads as
JAX reads its newest ``.json``. ``RecordEvent`` opens a
``torch.profiler.record_function`` where JAX opens a ``TraceAnnotation``,
feeds the wall-clock table ``_host_events`` (OperatorView) and, while the
host tracer (``_host_tracer``, the port of trace.cc) runs, a host scope.

``Profiler(targets=[GPU])`` (the default where a card is present) needs
Kineto to record CUDA activity: where it records none, stopping the
recording raises ``RuntimeError`` and no host-only trace is written. The
memory brackets of ``profile_memory=True`` read
``torch.cuda.memory_allocated`` / ``max_memory_allocated`` on the card
(None on the CPU place). ``summary()`` prints JAX's three views and no
others: OverView (steps), OperatorView (host scopes, sorted by
``SortedKeys``; the GPU keys fall back to CPUTotal as in JAX) and, with
``profile_memory``, MemoryView.
"""

from __future__ import annotations

import contextlib
import enum as _enum
import os
import time
from collections import defaultdict
from enum import Enum
from typing import Optional

import torch

from . import _host_tracer


class ProfilerState(Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class ProfilerTarget(Enum):
    CPU = 0
    GPU = 1
    XPU = 2
    CUSTOM_DEVICE = 3
    TPU = 4


def make_scheduler(*, closed=0, ready=0, record=1, repeat=0, skip_first=0):
    total = closed + ready + record

    def scheduler(step):
        s = step - skip_first
        if s < 0:
            return ProfilerState.CLOSED
        if repeat and s >= repeat * total:
            return ProfilerState.CLOSED
        pos = s % total
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == total - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return scheduler


def export_chrome_tracing(dir_name: str, worker_name: Optional[str] = None):
    def handler(prof):
        prof.export(dir_name)

    return handler


def export_host_chrome_trace(path: str,
                             process_name: str = "paddle_tpu") -> bool:
    """Dump the host tracer's events as a chrome://tracing JSON file."""
    return _host_tracer.dump(path, process_name)


export_protobuf = export_chrome_tracing


class RecordEvent:
    """Named host scope (reference: profiler/utils.py:47): a
    ``record_function`` range in the device trace, a row of the host
    statistics table and, while the host tracer runs, a host-trace
    scope."""

    def __init__(self, name: str, event_type=None):
        self.name = name
        self._ann = None
        self._gen = None
        self.begin_ts = None

    def begin(self):
        self.begin_ts = time.perf_counter()
        self._ann = torch.profiler.record_function(self.name)
        self._ann.__enter__()
        _host_events.start(self.name, self.begin_ts)
        if _host_tracer.enabled():
            _host_tracer.begin(self.name)
            self._gen = _host_tracer.generation()

    def end(self):
        if self._ann is None:
            return
        self._ann.__exit__(None, None, None)
        _host_events.stop(self.name, time.perf_counter())
        self._ann = None
        if self._gen is not None:
            # a restart mid-scope cleared the begin stack: popping now
            # would close another scope
            if _host_tracer.enabled() \
                    and _host_tracer.generation() == self._gen:
                _host_tracer.end()
            self._gen = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False


def _device_mem_stats():
    """(bytes in use, peak bytes in use) of the current card, or None on
    the CPU place or without a card."""
    from .. import device

    if not torch.cuda.is_available() or (
            device._PLACE is not None and device._PLACE.type == "cpu"):
        return None
    return (int(torch.cuda.memory_allocated()),
            int(torch.cuda.max_memory_allocated()))


class _HostEvents:
    """Per-name host wall-clock stats + optional per-scope device-memory
    brackets (reference: profiler_statistic.py:856 StatisticData — calls,
    total, avg, max, min; :630 memory items). The memory brackets are on
    while any started ``Profiler(profile_memory=True)`` runs (refcounted)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.maxs = defaultdict(float)
        self.mins = defaultdict(lambda: float("inf"))
        self._open = {}
        self.mem_enabled = False
        self.mem_refs = 0
        self.mem_delta = defaultdict(int)
        self.mem_peak = defaultdict(int)
        self._mem_open = {}

    def start(self, name, ts):
        self._open.setdefault(name, []).append(ts)
        # pushed unconditionally (None while the brackets are off): a
        # profile_memory Profiler starting or stopping inside an open
        # scope pops that scope's own entry, never another's
        self._mem_open.setdefault(name, []).append(
            _device_mem_stats() if self.mem_enabled else None)

    def stop(self, name, ts):
        if self._open.get(name):
            t0 = self._open[name].pop()
            dt = ts - t0
            self.totals[name] += dt
            self.counts[name] += 1
            self.maxs[name] = max(self.maxs[name], dt)
            self.mins[name] = min(self.mins[name], dt)
        if self._mem_open.get(name):
            before = self._mem_open[name].pop()
            # only scopes that ran wholly under memory profiling count
            if self.mem_enabled and before is not None:
                after = _device_mem_stats()
                if after is not None:
                    self.mem_delta[name] += after[0] - before[0]
                    self.mem_peak[name] = max(self.mem_peak[name], after[1])

    def reset(self):
        self.totals.clear()
        self.counts.clear()
        self.maxs.clear()
        self.mins.clear()
        self._open.clear()
        self.mem_delta.clear()
        self.mem_peak.clear()
        self._mem_open.clear()


_host_events = _HostEvents()


def _format_table(title, headers, rows):
    """Aligned ASCII table in the reference's _build_table style
    (profiler_statistic.py:874)."""
    widths = [max(len(str(h)), *(len(str(r[i])) for r in rows))
              if rows else len(str(h)) for i, h in enumerate(headers)]
    sep = "-" * (sum(widths) + 2 * len(widths))
    out = [sep, title, sep,
           "  ".join(str(h).ljust(w) for h, w in zip(headers, widths))]
    for r in rows:
        out.append("  ".join(str(c).ljust(w) for c, w in zip(r, widths)))
    out.append(sep)
    return "\n".join(out)


def _cuda_events(prof):
    """Kernel events (copies and memsets left out) Kineto recorded."""
    return sum(1 for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and not e.name().startswith(("Memcpy", "Memset")))


class Profiler:
    """Reference: python/paddle/profiler/profiler.py:358. See the module
    docstring for the device trace."""

    def __init__(self, *, targets=None, scheduler=None, on_trace_ready=None,
                 record_shapes=False, profile_memory=False, timer_only=False,
                 emit_nvtx=False, custom_device_types=None, with_flops=False):
        if targets is None:
            targets = [ProfilerTarget.CPU] + (
                [ProfilerTarget.GPU] if torch.cuda.is_available() else [])
        self._gpu = ProfilerTarget.GPU in targets
        self._record_shapes = record_shapes
        self._with_flops = with_flops
        # the memory brackets are refcounted on start()/stop(): overlapping
        # profilers don't disable each other, and a profiler never started
        # turns nothing on
        self._mem_owner = bool(profile_memory)
        self._mem_active = False
        self._scheduler = scheduler if callable(scheduler) else (
            make_scheduler(record=scheduler[1] - scheduler[0],
                           closed=scheduler[0])
            if isinstance(scheduler, (tuple, list))
            else (lambda step: ProfilerState.RECORD))
        self._on_trace_ready = on_trace_ready
        self._timer_only = timer_only
        self.step_num = 0
        self._state = ProfilerState.CLOSED
        self._trace_dir = None
        self._host_on = False
        self._kineto = None
        self._traces = []       # device traces written, oldest first
        self._step_times = []
        self._last_step_ts = None

    def start(self):
        if self._mem_owner and not self._mem_active:
            self._mem_active = True
            _host_events.mem_refs += 1
            _host_events.mem_enabled = True
        self._state = self._scheduler(self.step_num)
        if not self._timer_only:
            self._start_kineto()
        self._toggle_host_tracer()
        self._last_step_ts = time.perf_counter()

    def stop(self):
        self._state = ProfilerState.CLOSED
        try:
            if self._kineto is not None:
                kineto, self._kineto = self._kineto, None
                if self._gpu:
                    torch.cuda.synchronize()
                kineto.stop()
        finally:
            self._toggle_host_tracer()
            if self._mem_active:
                self._mem_active = False
                _host_events.mem_refs = max(0, _host_events.mem_refs - 1)
                _host_events.mem_enabled = _host_events.mem_refs > 0
        if self._on_trace_ready:
            self._on_trace_ready(self)

    def step(self, num_samples=None):
        now = time.perf_counter()
        if self._last_step_ts is not None:
            self._step_times.append((now - self._last_step_ts, num_samples))
        self._last_step_ts = now
        if self._kineto is not None and self._gpu and self._tracing:
            torch.cuda.synchronize()    # the step's kernels in its window
        self.step_num += 1
        self._state = self._scheduler(self.step_num)
        if self._kineto is not None:
            self._kineto.step()
        self._toggle_host_tracer()

    @property
    def _tracing(self):
        """Whether this step is recorded (RECORD or RECORD_AND_RETURN)."""
        return self._kineto is not None and self._state in (
            ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN)

    def _toggle_host_tracer(self):
        on = self._tracing
        if on and not self._host_on:
            _host_tracer.start()
        elif not on and self._host_on:
            _host_tracer.stop()
        self._host_on = on

    def _start_kineto(self):
        """One Kineto session for the profiler's life, driven by the
        scheduler: READY is Kineto's warm-up (CUPTI on, events dropped;
        started cold at RECORD, a long-lived process lost the window's
        first K1-lse record on an H100), RECORD_AND_RETURN saves."""
        import tempfile

        from torch.profiler import ProfilerAction, ProfilerActivity

        if self._gpu and not torch.cuda.is_available():
            raise RuntimeError("Profiler(targets=[GPU]): no CUDA device")
        self._trace_dir = self._trace_dir or tempfile.mkdtemp(
            prefix="paddle_tpu_torch_prof_")
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self._gpu else [])
        action = {ProfilerState.CLOSED: ProfilerAction.NONE,
                  ProfilerState.READY: ProfilerAction.WARMUP,
                  ProfilerState.RECORD: ProfilerAction.RECORD,
                  ProfilerState.RECORD_AND_RETURN:
                      ProfilerAction.RECORD_AND_SAVE}
        step0 = self.step_num
        self._kineto = torch.profiler.profile(
            activities=acts,
            schedule=lambda step: action[self._scheduler(step + step0)],
            on_trace_ready=self._write_trace,
            record_shapes=self._record_shapes, with_flops=self._with_flops)
        self._kineto.start()

    def _write_trace(self, prof):
        """Kineto's handler: the recorded window's chrome JSON into the
        trace directory; a GPU target with no CUDA kernel recorded raises
        (no host-only trace is written)."""
        if self._gpu and not _cuda_events(prof):
            raise RuntimeError(
                "Profiler(targets=[GPU]): Kineto recorded no CUDA activity "
                "(CUPTI unavailable?); no device trace was written")
        path = os.path.join(self._trace_dir,
                            f"device_trace_{len(self._traces)}.json")
        prof.export_chrome_trace(path)
        self._traces.append(path)

    def export(self, path=None, format="json"):
        """Into ``path``: the newest device trace as ``device_trace.json``
        and the host tracer's as ``host_trace.json``. Returns the trace
        directory."""
        if path and format == "json":
            import shutil

            os.makedirs(path, exist_ok=True)
            if self._traces:
                shutil.copyfile(self._traces[-1],
                                os.path.join(path, "device_trace.json"))
            export_host_chrome_trace(os.path.join(path, "host_trace.json"))
        return self._trace_dir

    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit="ms"):
        """Sorted per-scope tables and the memory summary (reference:
        profiler_statistic.py:856 StatisticData / :874 _build_table):
        OverView (step timing), OperatorView (host RecordEvent scopes:
        Calls/Total/Avg/Max/Min/Ratio, sorted by ``sorted_by``) and, with
        ``profile_memory=True``, MemoryView (per-scope device-memory
        increase and peak bytes in use)."""
        scale = {"ms": 1e3, "s": 1.0, "us": 1e6}[time_unit]
        he = _host_events
        key = {
            None: lambda n: -he.totals[n],
            SortedKeys.CPUTotal: lambda n: -he.totals[n],
            SortedKeys.CPUAvg: lambda n: -he.totals[n] / max(he.counts[n], 1),
            SortedKeys.CPUMax: lambda n: -he.maxs[n],
            SortedKeys.CPUMin: lambda n: he.mins[n],
        }.get(sorted_by, lambda n: -he.totals[n])
        grand = sum(he.totals.values()) or 1.0
        rows = []
        for name in sorted(he.totals, key=key):
            n = he.counts[name]
            tot = he.totals[name]
            mn = 0.0 if he.mins[name] == float("inf") else he.mins[name]
            rows.append((
                name, n,
                f"{tot * scale:.3f}",
                f"{tot / max(n, 1) * scale:.3f}",
                f"{he.maxs[name] * scale:.3f}",
                f"{mn * scale:.3f}",
                f"{tot / grand * 100:.1f}%",
            ))
        parts = []
        if self._step_times:
            ts = [t for t, _ in self._step_times]
            parts.append(_format_table(
                "OverView", ("Metric", "Value"),
                [("steps", len(ts)),
                 (f"avg_step ({time_unit})",
                  f"{sum(ts) / len(ts) * scale:.3f}"),
                 (f"max_step ({time_unit})", f"{max(ts) * scale:.3f}"),
                 (f"min_step ({time_unit})", f"{min(ts) * scale:.3f}")]))
        parts.append(_format_table(
            f"OperatorView (host, unit: {time_unit})",
            ("Name", "Calls", "Total", "Avg", "Max", "Min", "Ratio"),
            rows))
        if self._mem_owner or he.mem_enabled or he.mem_peak:
            mem_rows = [(name,
                         f"{he.mem_delta[name] / 2**20:.2f}",
                         f"{he.mem_peak[name] / 2**20:.2f}")
                        for name in sorted(set(he.mem_delta)
                                           | set(he.mem_peak),
                                           key=lambda n: -he.mem_peak[n])]
            cur = _device_mem_stats()
            if cur is not None:
                mem_rows.append(("[device now]", f"{cur[0] / 2**20:.2f}",
                                 f"{cur[1] / 2**20:.2f}"))
            parts.append(_format_table(
                "MemoryView (device HBM, MB)",
                ("Name", "Increase", "PeakInUse"),
                mem_rows))
        table = "\n".join(parts)
        print(table)
        return table

    def step_info(self, unit=None):
        if not self._step_times:
            return ""
        t, n = self._step_times[-1]
        ips = (n / t) if (n and t > 0) else (1.0 / t if t > 0 else 0.0)
        return f"step_time: {t * 1e3:.2f} ms, ips: {ips:.2f}"

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


@contextlib.contextmanager
def profile(log_dir="./profiler_log"):
    """The device tracer over the scope, its chrome trace written to
    ``log_dir/device_trace.json``."""
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with torch.profiler.profile(activities=acts) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "device_trace.json"))


class ProfilerResult:
    """Aggregated view of an exported chrome trace (reference:
    profiler_statistic.py statistics over the event tree)."""

    def __init__(self, events):
        self.events = events
        agg = {}
        for e in events:
            if e.get("ph") != "X":
                continue
            name = e.get("name", "?")
            d = agg.setdefault(name, {"calls": 0, "total_us": 0.0})
            d["calls"] += 1
            d["total_us"] += float(e.get("dur", 0.0))
        self.summary = {
            n: {**d, "avg_us": d["total_us"] / max(d["calls"], 1)}
            for n, d in agg.items()}

    def sorted_by_total(self):
        return sorted(self.summary.items(), key=lambda kv: -kv[1]["total_us"])


def load_profiler_result(path):
    """Load an exported chrome-trace JSON (a device trace, a
    ``host_trace.json`` or a trace directory, whose newest ``.json`` is
    read) into a ProfilerResult with per-name call counts and
    durations."""
    import gzip
    import json

    if os.path.isdir(path):
        cands = [os.path.join(r, f) for r, _, fs in os.walk(path)
                 for f in fs if f.endswith((".json", ".json.gz",
                                            ".trace.json.gz"))]
        if not cands:
            raise FileNotFoundError(f"no chrome-trace .json under {path}")
        path = max(cands, key=os.path.getmtime)  # newest capture
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    events = data.get("traceEvents", data if isinstance(data, list) else [])
    return ProfilerResult(events)


class SortedKeys(_enum.IntEnum):
    """Summary sort keys (reference: profiler/profiler_statistic.py
    SortedKeys)."""

    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    CPUMin = 3
    GPUTotal = 4
    GPUAvg = 5
    GPUMax = 6
    GPUMin = 7


class SummaryView(_enum.IntEnum):
    """Summary view selector (reference: profiler/profiler.py
    SummaryView)."""

    DeviceView = 0
    OverView = 1
    ModelView = 2
    DistributedView = 3
    KernelView = 4
    OperatorView = 5
    MemoryView = 6
    MemoryManipulationView = 7
    UDFView = 8
