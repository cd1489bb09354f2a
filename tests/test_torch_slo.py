"""The port's SLO observatory (``paddle_tpu_torch.observability`` workload
and slo modules, ``paddle_tpu_torch.inference.autoscale``) against the JAX
package's.

Every scenario runs through both packages and must give the same result:
the seeded schedules (bytes and digests, poisson / burst / diurnal, two
tenants with a shared prefix and a priority), the windowed attainment and
goodput math on scripted stamps (tests/test_slo_observatory.py
TestAttainmentMath), the autoscaler's hysteresis on scripted monitors and
fake routers (TestAutoscalerHysteresis), the open-loop driver on fake
targets (TestReplayDriver) and the recorder/SLO collectors. The headline
is the observatory end to end: ``tools/traffic_replay.py``'s
``run_replay`` configuration (1-layer tiny Llama, 2 slots, max_len 32,
page 8, block 2, prefix cache, its seeded burst workload, a VirtualClock
at 0.05 s a step, the autoscaler at min 1 / max 3 / up 2 / down 4 /
cooldown 1) in both packages with the autoscaler off and on: the whole
report dict must be equal.

The engines stamp queue wait with the wall clock (``time.monotonic`` in
both packages' serving modules), which no two runs share; the end-to-end
replays point that clock at the replay's VirtualClock in BOTH packages
(``chip_smoke._EngineClock``), so every number of the report is a
function of the schedule and the scheduling alone.
"""

import dataclasses
import os
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.inference.autoscale as jautoscale
import paddle_tpu.inference.fleet as jfleet
import paddle_tpu.inference.serving as jserving
import paddle_tpu.observability as jobs
import paddle_tpu_torch.inference.autoscale as tautoscale
import paddle_tpu_torch.inference.fleet as tfleet
import paddle_tpu_torch.inference.serving as tserving
import paddle_tpu_torch.observability as tobs
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.weights import load_jax_state, state_from_jax_layer

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PKGS = {
    "jax": types.SimpleNamespace(O=jobs, A=jautoscale, F=jfleet, S=jserving),
    "torch": types.SimpleNamespace(O=tobs, A=tautoscale, F=tfleet,
                                   S=tserving),
}


def _both(fn):
    """``fn(pkg)`` for each package; asserts the two results are equal and
    returns the port's."""
    out = {name: fn(pkg) for name, pkg in PKGS.items()}
    assert out["torch"] == out["jax"]
    return out["torch"]


# ---------------------------------------------------------------------------
# contract 2: schedules
# ---------------------------------------------------------------------------

def _wl(O, **kw):
    base = dict(seed=5, duration_s=20.0, rate_rps=6.0, vocab_size=97,
                prompt_min=4, prompt_max=32, output_min=2, output_max=16,
                tenants=(O.TenantSpec("sys", weight=3.0, prefix_len=8),
                         O.TenantSpec("low", weight=1.0, prefix_len=0,
                                      priority=2)))
    base.update(kw)
    return O.WorkloadConfig(**base)


@pytest.mark.parametrize("arrival", ["poisson", "burst", "diurnal"])
def test_schedule_bytes_and_digest_equal_jax(arrival):
    enc = {}
    for name, pkg in PKGS.items():
        sched = pkg.O.generate_schedule(_wl(pkg.O, arrival=arrival))
        enc[name] = (pkg.O.encode_schedule(sched),
                     pkg.O.schedule_digest(sched))
    assert enc["torch"] == enc["jax"]
    data = enc["jax"][0]
    assert data.count(b"\n") > 50
    # the port decodes the JAX package's bytes to the same arrivals
    back = tobs.decode_schedule(data)
    assert tobs.encode_schedule(back) == data
    assert [dataclasses.astuple(a) for a in back] == [
        dataclasses.astuple(a) for a in jobs.decode_schedule(data)]
    sys_prompts = [a.prompt for a in back if a.tenant == "sys"]
    assert sys_prompts and all(p[:8] == sys_prompts[0][:8]
                               for p in sys_prompts)
    assert all(a.priority == 2 for a in back if a.tenant == "low")


def test_schedule_seed_and_refusals_match_jax():
    for name, pkg in PKGS.items():
        a = pkg.O.generate_schedule(_wl(pkg.O))
        b = pkg.O.generate_schedule(_wl(pkg.O, seed=6))
        assert pkg.O.encode_schedule(a) != pkg.O.encode_schedule(b)
        with pytest.raises(ValueError, match="unknown arrival"):
            pkg.O.generate_schedule(_wl(pkg.O, arrival="flat"))
        with pytest.raises(ValueError, match="positive"):
            pkg.O.generate_schedule(_wl(pkg.O, rate_rps=0.0))


def test_schedule_shapes_burst_and_diurnal():
    def shape(pkg):
        burst = pkg.O.generate_schedule(_wl(
            pkg.O, arrival="burst", burst_every_s=5.0, burst_len_s=1.0,
            burst_multiplier=6.0, duration_s=30.0))
        in_burst = sum(1 for a in burst if (a.t % 5.0) < 1.0)
        diurnal = pkg.O.generate_schedule(_wl(
            pkg.O, arrival="diurnal", diurnal_period_s=20.0,
            diurnal_depth=0.9, duration_s=20.0, rate_rps=20.0))
        peak = sum(1 for a in diurnal if 2.5 <= a.t < 7.5)
        trough = sum(1 for a in diurnal if 12.5 <= a.t < 17.5)
        return in_burst, len(burst) - in_burst, peak, trough

    in_burst, out_burst, peak, trough = _both(shape)
    assert in_burst / 1.0 > 2.0 * (out_burst / 4.0)
    assert peak > 2 * max(1, trough)


# ---------------------------------------------------------------------------
# histogram windows (tests/test_slo_observatory.py TestHistogramWindows)
# ---------------------------------------------------------------------------

def test_histogram_windows_equal_jax():
    def run(pkg):
        h = pkg.O.Histogram("w_ms", buckets=(1.0, 10.0, 100.0))
        h.observe(5.0)
        h.observe(50.0)
        mark = h.snapshot()
        h.observe(0.5)
        h.observe(500.0)
        row = h.delta(mark)
        q = pkg.O.Histogram("q_ms", buckets=(10.0, 20.0, 40.0))
        for v in (5.0, 15.0, 15.0, 35.0):
            q.observe(v)
        qrow = q.snapshot()
        out = (mark, row, h.row_count(row), h.delta(None) == h.snapshot(),
               q.row_quantile(qrow, 0.5), q.row_quantile(qrow, 0.99),
               q.row_fraction_le(qrow, 20.0), q.row_fraction_le(qrow, 1e9),
               q.row_fraction_le((0.0,) * 5, 10.0))
        q.observe(1e9)
        return out + (q.row_fraction_le(q.snapshot(), 40.0),)

    out = _both(run)
    assert out[2] == 2 and out[1][0] == 1.0 and out[1][3] == 1.0 and out[3]
    assert out[4] == pytest.approx(15.0, abs=5.0)
    assert out[6] == pytest.approx(0.75) and out[7] == pytest.approx(1.0)
    assert out[8] is None and out[9] == pytest.approx(0.8)


def test_histogram_reads_consistent_under_concurrent_observes():
    h = tobs.Histogram("c_ms", buckets=(1.0, 10.0))
    stop = threading.Event()

    def writer():
        while not stop.is_set():
            h.observe(5.0)

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    try:
        for _ in range(200):
            row = h.snapshot()
            assert row[-1] == pytest.approx(5.0 * h.row_count(row))
    finally:
        stop.set()
        t.join(timeout=30)
    assert not t.is_alive()


# ---------------------------------------------------------------------------
# contract 8: attainment math on scripted stamps
# ---------------------------------------------------------------------------

def _stamp_request(tr, clock, rid, tenant, ttft_s, n_out, qwait_s=0.0,
                   kind="finish"):
    tr.submit(rid, 8, n_out, {"tenant": tenant} if tenant else None)
    clock.advance(ttft_s)
    if kind == "shed":
        tr.shed(rid)
        return
    tr.admit(rid, qwait_s)
    tr.first_token(rid)
    tr.finish(rid, n_out, failed=kind in ("evict", "fail"),
              error="deadline exceeded" if kind == "evict" else None)


def _monitor(pkg, **cfg):
    clock = pkg.O.VirtualClock()
    tr = pkg.O.TraceRecorder(clock=clock)
    mon = pkg.O.SLOMonitor(pkg.O.SLOConfig(**cfg), tracer=tr)
    return clock, tr, mon


def _scenario_windowed(pkg):
    clock, tr, mon = _monitor(pkg, ttft_ms=100.0, window_s=1.0)
    _stamp_request(tr, clock, 1, "a", 0.05, 10)
    _stamp_request(tr, clock, 2, "a", 0.20, 10)
    _stamp_request(tr, clock, 3, "b", 0.01, 5)
    _stamp_request(tr, clock, 4, "b", 0.01, 5, kind="shed")
    w = mon.roll_window(duration_s=2.0)
    w2 = mon.roll_window(duration_s=1.0)
    return w, w2, mon.report()


def _scenario_evict_fail(pkg):
    clock, tr, mon = _monitor(pkg, ttft_ms=1e9, window_s=1.0)
    _stamp_request(tr, clock, 1, None, 0.01, 4, kind="evict")
    _stamp_request(tr, clock, 2, None, 0.01, 4, kind="fail")
    return mon.roll_window(duration_s=1.0)


def _scenario_vacuous(pkg):
    clock, tr, mon = _monitor(pkg, ttft_ms=100.0, inter_token_ms=1.0,
                              queue_wait_ms=1.0, window_s=1.0)
    _stamp_request(tr, clock, 1, None, 0.05, 1)
    return mon.roll_window(duration_s=1.0)


def _scenario_queue_wait(pkg):
    clock, tr, mon = _monitor(pkg, ttft_ms=None, queue_wait_ms=10.0,
                              window_s=1.0)
    _stamp_request(tr, clock, 1, None, 0.0, 4, qwait_s=0.005)
    _stamp_request(tr, clock, 2, None, 0.0, 4, qwait_s=0.5)
    return mon.roll_window(duration_s=1.0)


def _scenario_reroute(pkg):
    clock, tr, mon = _monitor(pkg, ttft_ms=100.0, window_s=1.0)
    tr.submit(1, 8, 4, {"tenant": "a"})
    tr.shed(1)
    tr.submit(1, 8, 4, {"tenant": "a"})
    clock.advance(0.05)
    tr.admit(1, 0.01)
    tr.first_token(1)
    tr.finish(1, 4)
    return mon.roll_window(duration_s=1.0)


def _scenario_unrerouted_shed(pkg):
    clock, tr, mon = _monitor(pkg, ttft_ms=100.0, window_s=1.0)
    tr.submit(1, 8, 4, {"tenant": "a"})
    tr.shed(1)
    return mon.roll_window(duration_s=1.0), mon.report()["totals"]


def _scenario_served(pkg):
    clock, tr, mon = _monitor(pkg, ttft_ms=100.0, window_s=1.0)
    _stamp_request(tr, clock, 1, None, 0.01, 4)
    _stamp_request(tr, clock, 2, None, 0.01, 4, kind="shed")
    return mon.roll_window(duration_s=1.0)


def _scenario_bounded(pkg):
    clock = pkg.O.VirtualClock()
    tr = pkg.O.TraceRecorder(clock=clock)
    mon = pkg.O.SLOMonitor(pkg.O.SLOConfig(window_s=1.0), tracer=tr,
                           max_windows=4)
    for _ in range(10):
        mon.roll_window(duration_s=1.0)
    return mon.report()


def _scenario_second_terminal(pkg):
    clock, tr, mon = _monitor(pkg, ttft_ms=1e9, window_s=1.0)
    _stamp_request(tr, clock, 1, None, 0.01, 4)
    mon.note_terminal(1, "finish", 4, None)
    return mon.roll_window(duration_s=1.0)


def _scenario_aggregate(pkg):
    clock, tr, mon = _monitor(pkg, ttft_ms=100.0, window_s=1.0)
    _stamp_request(tr, clock, 1, None, 0.01, 4)
    mon.roll_window(duration_s=1.0)
    _stamp_request(tr, clock, 2, None, 0.5, 4)
    _stamp_request(tr, clock, 3, None, 0.5, 4)
    mon.roll_window(duration_s=1.0)
    return mon.attainment(), mon.attainment(last_n=1), mon.report()


def test_windowed_attainment_goodput_and_tenants():
    w, w2, _ = _both(_scenario_windowed)
    assert w["finished"] == 4 and w["met"] == 2
    assert w["attainment"] == pytest.approx(0.5)
    assert w["tokens"] == 25 and w["good_tokens"] == 15
    assert w["goodput_tokens_per_sec"] == pytest.approx(7.5)
    assert w["by_tenant"]["a"] == {"finished": 2, "met": 1,
                                   "attainment": 0.5}
    assert w["signals"]["ttft_ms"]["count"] == 3
    assert w2["finished"] == 0 and w2["attainment"] is None


@pytest.mark.parametrize("scenario,check", [
    (_scenario_evict_fail,
     lambda w: w["finished"] == 2 and w["met"] == 0 and w["tokens"] == 8),
    (_scenario_vacuous, lambda w: w["met"] == 1),
    (_scenario_queue_wait, lambda w: w["finished"] == 2 and w["met"] == 1),
    (_scenario_reroute,
     lambda w: (w["finished"], w["met"], w["shed"], w["good_tokens"])
     == (1, 1, 0, 4)),
    (_scenario_unrerouted_shed,
     lambda r: r[0]["shed"] == 1 and r[0]["served_attainment"] is None
     and r[1]["shed"] == 1),
    (_scenario_served,
     lambda w: w["attainment"] == 0.5 and w["served_attainment"] == 1.0),
    (_scenario_bounded,
     lambda r: len(r["windows"]) == 4 and r["windows_total"] == 10),
    (_scenario_second_terminal, lambda w: w["finished"] == 1),
    (_scenario_aggregate,
     lambda r: r[0] == pytest.approx(1 / 3) and r[1] == 0.0
     and r[2]["totals"]["finished"] == 3),
], ids=["evict_fail", "vacuous", "queue_wait", "reroute", "unrerouted_shed",
        "served", "bounded", "second_terminal", "aggregate"])
def test_monitor_scenarios_equal_jax(scenario, check):
    assert check(_both(scenario))


# ---------------------------------------------------------------------------
# contract 8: the autoscaler on scripted monitors and fake routers
# ---------------------------------------------------------------------------

class _FakeSup:
    def load(self):
        return 0


class _FakeReplica:
    def __init__(self, pkg, idx):
        self.idx = idx
        self.state = pkg.F.ReplicaState.ALIVE
        self.sup = _FakeSup()


class _FakeRouter:
    def __init__(self, pkg, n=1):
        self.pkg = pkg
        self.replicas = [_FakeReplica(pkg, i) for i in range(n)]
        self.actions = []

    def add_replica(self):
        idx = len(self.replicas)
        self.replicas.append(_FakeReplica(self.pkg, idx))
        self.actions.append(("add", idx))
        return idx

    def retire_replica(self, idx):
        self.replicas[idx].state = self.pkg.F.ReplicaState.RETIRED
        self.actions.append(("retire", idx))
        return True

    def force_brownout(self, active):
        self.actions.append(("brownout", bool(active)))


class _ScriptedMonitor:
    def __init__(self, pkg, series, finished=10):
        self.config = pkg.O.SLOConfig(target_attainment=0.9)
        self._series = list(series)
        self._finished = finished
        self._i = -1

    def advance(self):
        self._i += 1

    def last_window(self):
        if self._i < 0 or self._i >= len(self._series):
            return None
        att = self._series[self._i]
        served = None
        if isinstance(att, tuple):
            att, served = att
        fin = self._finished if att is not None else 0
        return {"window": self._i + 1, "attainment": att,
                "served_attainment": served, "finished": fin,
                "met": 0 if att is None else int(att * fin)}


def _scaled(series, n=1, enabled=True, traced=False, **cfg_kw):
    base = dict(min_replicas=1, max_replicas=3, up_after=2, down_after=3,
                cooldown_windows=1)
    base.update(cfg_kw)

    def run(pkg):
        router = _FakeRouter(pkg, n)
        mon = _ScriptedMonitor(pkg, series)
        reg = pkg.O.MetricsRegistry() if traced else None
        tracer = pkg.O.TraceRecorder(registry=reg) if traced else None
        scaler = pkg.A.SLOAutoscaler(router, mon,
                                     pkg.A.AutoscaleConfig(**base),
                                     registry=reg, tracer=tracer,
                                     enabled=enabled)
        decisions = []
        for _ in series:
            mon.advance()
            decisions.append(scaler.tick())
        out = dict(decisions=decisions, actions=router.actions,
                   report=scaler.report())
        if traced:
            out["events"] = [(e["name"], e["args"]) for e in tracer.events
                             if e["name"] == "autoscale"]
            out["scrape"] = reg.dump()
        return out

    return _both(run)


def test_autoscaler_scale_up_needs_consecutive_pressure():
    out = _scaled([0.5, 0.95, 0.5, 0.5])
    assert out["decisions"] == [None, None, None, "scale_up"]
    assert out["actions"] == [("add", 1)]


def test_autoscaler_cooldown_quiets_the_controller():
    out = _scaled([0.5] * 5, cooldown_windows=2)
    assert out["decisions"] == [None, "scale_up", None, None, "scale_up"]


@pytest.mark.parametrize("tail", [[0.99] * 4, [(0.66, 0.99)] * 4],
                         ids=["headroom", "served_attainment"])
def test_autoscaler_brownout_at_max_and_exit(tail):
    out = _scaled([0.5, 0.5] + tail, n=3, cooldown_windows=0)
    assert out["decisions"] == [None, "brownout", None, None,
                                "brownout_exit", None]
    assert out["actions"] == [("brownout", True), ("brownout", False)]
    assert out["report"]["stats"]["brownouts"] == 1


def test_autoscaler_scale_down_never_below_min():
    out = _scaled([0.99] * 8, n=2, cooldown_windows=0)
    assert out["decisions"][2] == "scale_down"
    assert out["decisions"].count("scale_down") == 1


def test_autoscaler_empty_windows_are_no_evidence():
    out = _scaled([0.5, None, 0.5, 0.5])
    assert out["decisions"][:3] == [None, None, "scale_up"]


def test_autoscaler_disabled_observes_but_never_acts():
    out = _scaled([0.1] * 6, enabled=False)
    assert out["decisions"] == [None] * 6 and out["actions"] == []
    assert out["report"]["stats"]["pressured_windows"] == 6


def test_autoscaler_decisions_traced_and_counted():
    out = _scaled([0.5, 0.5], traced=True, down_after=4)
    assert out["decisions"] == [None, "scale_up"]
    assert [name for name, _ in out["events"]] == ["autoscale"]
    assert "pt_autoscaler_scale_ups_total 1" in out["scrape"]
    assert "pt_autoscaler_replicas 2" in out["scrape"]


# ---------------------------------------------------------------------------
# contract 8: the open-loop driver on fake targets
# ---------------------------------------------------------------------------

class _FakeTarget:
    def __init__(self, pkg, per_step=0, refuse_after=None):
        self.pkg = pkg
        self.queue, self.done, self.submitted = [], [], 0
        self.per_step, self.refuse_after = per_step, refuse_after

    def submit(self, req):
        if (self.refuse_after is not None
                and self.submitted >= self.refuse_after):
            raise self.pkg.S.EngineSaturated("full")
        self.submitted += 1
        self.queue.append(req)

    def step(self):
        for _ in range(self.per_step):
            if self.queue:
                self.done.append(self.queue.pop(0))

    def has_work(self):
        return bool(self.queue)


@pytest.mark.parametrize("case", ["no_progress", "refusals", "windows"])
def test_replay_driver_equal_jax(case):
    def run(pkg):
        O = pkg.O
        sched = O.generate_schedule(O.WorkloadConfig(
            seed=5, duration_s=3.0 if case == "windows" else 2.0,
            rate_rps=5.0 if case == "windows" else 10.0, vocab_size=97,
            prompt_min=4, prompt_max=32, output_min=2, output_max=16))
        clock = O.VirtualClock()
        mon = None
        if case == "windows":
            tr = O.TraceRecorder(clock=clock)
            mon = O.SLOMonitor(O.SLOConfig(ttft_ms=100.0, window_s=1.0),
                               tracer=tr)
        target = _FakeTarget(pkg, per_step={"no_progress": 0, "refusals": 1,
                                            "windows": 3}[case],
                             refuse_after=5 if case == "refusals" else None)
        drv = O.ReplayDriver(target, sched, clock=clock, dt_s=0.1,
                             monitor=mon,
                             max_steps=30 if case == "no_progress" else 100)
        rep = drv.run()
        return rep, len(sched), target.has_work(), [
            (len(r.prompt), r.max_new_tokens, r.seed, r.priority, r.tenant)
            for r in drv.requests]

    rep, n, busy, _ = _both(run)
    if case == "no_progress":
        assert rep["driver"]["submitted"] == n and busy
    elif case == "refusals":
        assert rep["driver"]["submitted"] == 5
        assert rep["driver"]["refused"] == n - 5
    else:
        assert rep["driver"]["windows"] >= 3 and rep["slo"]["windows"]


# ---------------------------------------------------------------------------
# recorder health + SLO collectors
# ---------------------------------------------------------------------------

def test_tracer_and_slo_collectors_equal_jax():
    def run(pkg):
        O = pkg.O
        tr = O.TraceRecorder(max_events=3, max_requests=2)
        for rid in (1, 2, 3):
            tr.submit(rid, 4, 4)
            tr.finish(rid, 4)
        reg = O.MetricsRegistry()
        reg.register_collector(O.tracer_collector(tr))
        clock, tr2, mon = _monitor(pkg, ttft_ms=100.0, window_s=1.0)
        _stamp_request(tr2, clock, 1, "t0", 0.01, 4)
        mon.roll_window(duration_s=1.0)
        reg.register_collector(O.slo_collector(mon))
        return tr.counters(), reg.dump()

    counters, text = _both(run)
    assert counters["dropped"] > 0 and counters["gc"] > 0
    fams = tobs.parse_prometheus_text(text)
    for name in ("pt_tracer_dropped_total", "pt_tracer_gc_total",
                 "pt_slo_requests_finished_total", "pt_slo_attainment",
                 "pt_slo_goodput_tokens_per_sec", "pt_slo_windows_total"):
        assert name in fams, name
    assert {"window", "total", "tenant:t0", "signal:ttft_ms"} <= {
        s[1].get("scope") for s in fams["pt_slo_attainment"].samples}


# ---------------------------------------------------------------------------
# contract 7: the observatory end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def traffic_replay():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import traffic_replay as tool
    finally:
        sys.path.pop(0)
    return tool


@pytest.fixture(scope="module")
def tiny_models():
    paddle.seed(11)
    jm = JaxLlama(JaxConfig.tiny(num_hidden_layers=1))
    tm = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1),
                          device="cpu")
    load_jax_state(tm, state_from_jax_layer(jm))
    return jm, tm


def _jax_report(tool, model, d, on):
    """``run_replay`` of the JAX tool with the JAX engines' queue-wait
    clock pointed at the replay's VirtualClock, as
    ``chip_smoke.observatory_replay`` does on the port."""
    import chip_smoke

    made = {}

    class _VC(jobs.VirtualClock):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made["clock"] = self

    saved_vc, saved_time = jobs.VirtualClock, jserving._time
    jobs.VirtualClock = _VC          # run_replay imports it at call time
    jserving._time = chip_smoke._EngineClock(lambda: made["clock"]())
    try:
        return tool.run_replay(d, autoscale_on=on, model=model)
    finally:
        jobs.VirtualClock, jserving._time = saved_vc, saved_time


def test_observatory_report_equal_jax_both_arms(traffic_replay, tiny_models,
                                                tmp_path):
    import chip_smoke

    jm, tm = tiny_models
    reports = {}
    for on in (False, True):
        # rids from 1, as in the fresh process the tool runs in (the
        # router breaks load ties by rid)
        saved = jserving.Request._counter[0]
        jserving.Request._counter[0] = 0
        try:
            j = _jax_report(traffic_replay, jm, str(tmp_path / f"j{on}"), on)
        finally:
            jserving.Request._counter[0] = max(saved,
                                               jserving.Request._counter[0])
        t = chip_smoke.observatory_replay(tm, str(tmp_path / f"t{on}"),
                                          autoscale_on=on, device="cpu")
        assert t == j
        reports[on] = t
    off, on = reports[False], reports[True]
    # the JAX test's own assertions hold on the port
    target = off["slo"]["config"]["target_attainment"]
    att_off = traffic_replay.second_half_attainment(off)
    att_on = traffic_replay.second_half_attainment(on)
    assert att_off is not None and att_off < target
    assert traffic_replay.report_exit(off) == 1
    assert on["autoscaler"]["stats"]["scale_ups"] >= 1
    assert traffic_replay.report_exit(on) == 0
    assert att_on > att_off
    assert on["schedule"]["digest"] == off["schedule"]["digest"]
    assert max(w["goodput_tokens_per_sec"] or 0
               for w in on["slo"]["windows"]) > 0
