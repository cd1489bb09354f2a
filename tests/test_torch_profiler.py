"""``paddle_tpu_torch.profiler`` (and its host tracer, the port of
``paddle_tpu/native/src/trace.cc``) against the JAX package's, on the CPU.

Held: ``make_scheduler``'s state for steps 0-30 under five settings;
``summary()``'s views, headers and row names and call counts for the same
scopes (times differ); ``load_profiler_result``'s aggregation of the same
chrome trace; the host tracer's chrome layout and its generation counter
(a scope begun before a restart never closes a later one); the memory
brackets' push/pop discipline when a ``profile_memory`` profiler toggles
mid-scope (tests/test_profiler_summary.py's case); the device trace (Kineto
on the CPU here) holding the ``RecordEvent`` ranges; ``targets=[GPU]``
without a card raising; and ``TraceRecorder(mirror_host_events=True)``
feeding OperatorView.
"""

import json
import os
import re
import threading
import time

import jax  # noqa: F401  (JAX on the CPU, as tests/conftest.py sets it)
import pytest
import torch

import paddle_tpu.profiler as jprof
import paddle_tpu_torch as pt
import paddle_tpu_torch.profiler as pprof
from paddle_tpu_torch import device as pt_device
from paddle_tpu_torch.profiler import _host_tracer

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def cpu_place():
    prev = pt_device._PLACE
    pt.set_device("cpu")
    pprof._host_events.reset()
    yield
    pt_device._PLACE = prev
    _host_tracer.stop()


@pytest.mark.parametrize("kw", [
    dict(), dict(closed=1, ready=1, record=2),
    dict(closed=2, ready=0, record=3, repeat=2),
    dict(record=1, skip_first=3), dict(closed=1, ready=2, record=1,
                                       repeat=1, skip_first=2)])
def test_make_scheduler_is_jax(kw):
    a, b = jprof.make_scheduler(**kw), pprof.make_scheduler(**kw)
    assert [a(s).name for s in range(31)] == [b(s).name for s in range(31)]
    assert [e.name for e in pprof.ProfilerState] == \
        [e.name for e in jprof.ProfilerState]
    assert [(e.name, e.value) for e in pprof.SortedKeys] == \
        [(e.name, e.value) for e in jprof.SortedKeys]
    assert [(e.name, e.value) for e in pprof.SummaryView] == \
        [(e.name, e.value) for e in jprof.SummaryView]
    assert [e.name for e in pprof.ProfilerTarget] == \
        [e.name for e in jprof.ProfilerTarget]


class _Clock:
    """The clock both profilers read (``time.perf_counter`` and the host
    tracer's ``time.perf_counter_ns``), advanced only by :meth:`run`: the
    scopes' durations, and so the order a sort by time gives, are the
    same on a loaded machine (a 0.5 ms sleep can outlast a 3 ms one under
    a parallel test run)."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t

    def ns(self):
        return int(round(self.t * 1e9))

    def run(self, seconds):
        self.t += seconds


def _summary(mod, sorted_by=None, profile_memory=True):
    from unittest import mock

    clock = _Clock()
    with mock.patch.object(time, "perf_counter", clock), \
            mock.patch.object(time, "perf_counter_ns", clock.ns):
        mod._host_events.reset()
        p = mod.Profiler(timer_only=True, profile_memory=profile_memory)
        p.start()
        for _ in range(3):
            with mod.RecordEvent("op.matmul"):
                clock.run(0.003)
            with mod.RecordEvent("op.norm"):
                clock.run(0.0005)
            p.step(num_samples=8)
        p.stop()
        return p, p.summary(sorted_by=sorted_by)


def _shape(table):
    """The table without its numbers: titles, headers, row names and
    call counts."""
    out = []
    for line in table.splitlines():
        cols = line.split()
        if cols and cols[0].startswith("op."):
            out.append(cols[:2])
        elif line and not line.startswith("-") and not re.match(
                r"^(avg|max|min)_step|\[device", line):
            out.append(re.sub(r"\s+", " ", line).strip())
    return out


@pytest.mark.parametrize("key", [None, "CPUTotal", "CPUMin", "CPUMax",
                                 "GPUTotal"])
def test_summary_views_match_jax(key):
    jk = None if key is None else getattr(jprof.SortedKeys, key)
    pk = None if key is None else getattr(pprof.SortedKeys, key)
    jp_, jt = _summary(jprof, jk)
    pp_, ptab = _summary(pprof, pk)
    assert _shape(ptab) == _shape(jt)
    titles = [ln for ln in ptab.splitlines() if ln.endswith("View")
              or "View (" in ln]
    assert titles == ["OverView", "OperatorView (host, unit: ms)",
                      "MemoryView (device HBM, MB)"]
    assert "KernelView" not in ptab
    assert pp_.step_info().startswith("step_time:") and "ips:" in \
        pp_.step_info()


def test_summary_without_memory_has_two_views():
    _, ptab = _summary(pprof, profile_memory=False)
    _, jtab = _summary(jprof, profile_memory=False)
    assert "MemoryView" not in ptab and _shape(ptab) == _shape(jtab)


def test_load_profiler_result_aggregates_as_jax(tmp_path):
    events = [{"ph": "X", "name": "a", "dur": 3.0, "ts": 0},
              {"ph": "X", "name": "a", "dur": 5.0, "ts": 4},
              {"ph": "i", "name": "a", "ts": 1},
              {"ph": "X", "name": "b", "dur": 1.5, "ts": 9},
              {"ph": "C", "name": "c", "ts": 2, "args": {"value": 1}}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    a = jprof.load_profiler_result(str(path))
    b = pprof.load_profiler_result(str(tmp_path))   # newest .json of dir
    assert a.summary == b.summary
    assert a.sorted_by_total() == b.sorted_by_total()
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        pprof.load_profiler_result(str(tmp_path / "empty"))


def test_host_tracer_chrome_layout_and_threads(tmp_path):
    _host_tracer.start()
    with pprof.RecordEvent("outer"):
        _host_tracer.instant("mark")
        _host_tracer.counter("queue", 3)

        def worker():
            with pprof.RecordEvent("in_thread"):
                pass

        t = threading.Thread(target=worker)
        t.start()
        t.join()
    _host_tracer.stop()
    assert _host_tracer.event_count() == 4
    path = str(tmp_path / "host.json")
    assert pprof.export_host_chrome_trace(path, "proc")
    doc = json.load(open(path))
    ev = doc["traceEvents"]
    assert ev[0] == {"ph": "M", "pid": os.getpid(), "name": "process_name",
                     "args": {"name": "proc"}}
    by = {e["name"]: e for e in ev[1:]}
    assert by["outer"]["ph"] == "X" and by["outer"]["dur"] >= 0
    assert by["mark"]["s"] == "t" and by["queue"]["args"] == {"value": 3.0}
    assert by["in_thread"]["tid"] != by["outer"]["tid"]
    assert list(by["outer"]) == ["ph", "pid", "tid", "ts", "name", "dur"]
    r = pprof.load_profiler_result(path)
    assert r.summary["outer"]["calls"] == 1


def test_restart_inside_a_scope_does_not_close_a_later_one():
    _host_tracer.start()
    outer = pprof.RecordEvent("before_restart")
    outer.begin()
    _host_tracer.start()                  # a restart mid-scope
    inner = pprof.RecordEvent("after_restart")
    inner.begin()
    outer.end()                           # stale: must not pop "inner"
    inner.end()
    _host_tracer.stop()
    names = [e[0] for b in _host_tracer._bufs for e in b.events]
    assert names == ["after_restart"]


def test_memory_bracket_toggle_mid_scope_no_desync():
    """tests/test_profiler_summary.py's case on the port: the bracket stack
    is pushed and popped unconditionally."""
    he = pprof._host_events
    outer = pprof.RecordEvent("op.toggle")
    outer.begin()
    p = pprof.Profiler(timer_only=True, profile_memory=True)
    p.start()
    with pprof.RecordEvent("op.toggle"):
        pass
    outer.end()
    assert len(he._mem_open.get("op.toggle", [])) == 0
    outer2 = pprof.RecordEvent("op.toggle2")
    outer2.begin()
    p.stop()
    outer2.end()
    assert len(he._mem_open.get("op.toggle2", [])) == 0
    assert he.mem_refs == 0 and not he.mem_enabled
    p2 = pprof.Profiler(timer_only=True, profile_memory=True)
    p3 = pprof.Profiler(timer_only=True, profile_memory=True)
    p2.start()
    p3.start()
    p2.stop()
    assert he.mem_enabled          # refcounted: p3 still runs
    p3.stop()
    assert not he.mem_enabled
    assert pprof._device_mem_stats() is None    # the CPU place


def test_device_trace_holds_the_scopes(tmp_path):
    out = str(tmp_path / "out")
    p = pprof.Profiler(targets=[pprof.ProfilerTarget.CPU],
                       scheduler=pprof.make_scheduler(closed=1, ready=1,
                                                      record=2),
                       on_trace_ready=pprof.export_chrome_tracing(out))
    p.start()
    for _ in range(4):
        with pprof.RecordEvent("step"):
            pt.matmul(pt.ones([8, 8]), pt.ones([8, 8]))
        p.step()
    p.stop()
    assert sorted(os.listdir(out)) == ["device_trace.json",
                                       "host_trace.json"]
    dev = pprof.load_profiler_result(os.path.join(out, "device_trace.json"))
    assert dev.summary["step"]["calls"] == 2      # the two RECORD steps
    host = pprof.load_profiler_result(os.path.join(out, "host_trace.json"))
    assert host.summary["step"]["calls"] == 2
    assert pprof.load_profiler_result(p._trace_dir).summary["step"][
        "calls"] == 2


def test_gpu_target_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = pprof.Profiler(targets=[pprof.ProfilerTarget.GPU])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p.start()
    assert pprof.Profiler()._gpu is False       # default: CPU only here


def test_trace_recorder_mirrors_spans_into_operator_view():
    from paddle_tpu_torch.observability import TraceRecorder

    tr = TraceRecorder(mirror_host_events=True)
    p = pprof.Profiler(timer_only=True)
    p.start()
    t0 = tr.now()
    for i in range(3):
        tr.span("decode_block", 0, t0, t0 + 0.001 * (i + 1))
    tr.span("prefill_chunk", 1, t0, t0 + 0.002)
    p.stop()
    rows = {ln.split()[0]: ln.split()[1] for ln in p.summary().splitlines()
            if ln.startswith(("decode_block", "prefill_chunk"))}
    assert rows == {"decode_block": "3", "prefill_chunk": "1"}
    assert abs(pprof._host_events.totals["decode_block"] - 0.006) < 1e-9
    assert not TraceRecorder().mirror_host_events


def test_profile_context_writes_a_device_trace(tmp_path):
    with pprof.profile(str(tmp_path)):
        with pprof.RecordEvent("ctx"):
            pt.ones([4]).sum()
    r = pprof.load_profiler_result(str(tmp_path))
    assert r.summary["ctx"]["calls"] == 1
