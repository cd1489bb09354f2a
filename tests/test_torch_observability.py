"""The port's serving observability (``paddle_tpu_torch.observability``:
metrics registry, trace recorder, collectors, metrics server; the tracer
threaded through the engine, the supervisor, the fleet and the tiers; the
``retry`` registry the engine copies into its stats) against the JAX
package's, on carried tiny-Llama weights (fp32, CPU).

- Metrics: the same registry operations give byte-equal Prometheus text,
  equal parses, quantiles and window reads; the JAX TestMetrics scenarios.
- Recorder: the same scripted stamps on a VirtualClock give equal chrome
  exports, SLO summaries, counters, lifecycles and registry text (hwm
  dedup and recovered tagging, a resubmit reopening a terminal rid, the
  bounded buffer and GC, migration and recovery edges); concurrent
  stamping stays exact.
- Traced engines (legacy, prefix-cache, fused, fused + spec): one wave
  with more requests than slots, an eos, a RequestShed, a max_queue
  refusal and a deadline eviction, each engine's recorder on a tick clock
  (every call returns the next integer): equal event sequences (name,
  rid, replica, args), equal token counters and SLO counts; every stream
  equals the same engine's untraced stream.
- Supervisor crash replay, fleet failover edges, tier migration spans and
  a corrupt chain's failure, against the JAX classes.
- The scrape surface of a fleet wave with every ported collector, served
  by MetricsServer; the retry registry in ``engine.finished()``.

Queue waits are stamped with the wall clock in both packages (the
``queue_wait_ms`` admit argument and the queue-wait histogram), and a
deadline eviction's error names its wall-clock age: those are left out of
the comparisons, and nothing else is.
"""

import ast
import itertools
import os
import random
import re
import sys
import threading
import types
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed.resilience.faults as jfaults
import paddle_tpu.distributed.resilience.retry as jretry
import paddle_tpu.inference.disagg as jdisagg
import paddle_tpu.inference.fleet as jfleet
import paddle_tpu.inference.recovery as jrecovery
import paddle_tpu.inference.serving as jserving
import paddle_tpu.observability as jobs
import paddle_tpu_torch.distributed.resilience.faults as tfaults
import paddle_tpu_torch.distributed.resilience.retry as tretry
import paddle_tpu_torch.inference.disagg as tdisagg
import paddle_tpu_torch.inference.fleet as tfleet
import paddle_tpu_torch.inference.recovery as trecovery
import paddle_tpu_torch.inference.serving as tserving
import paddle_tpu_torch.observability as tobs
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.weights import load_jax_state, state_from_jax_layer

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TERMINALS = ("finish", "evict", "shed", "fail")
_AGE = re.compile(r"\d+\.\d+s")


class _Pkg:
    def __init__(self, name, obs, serving, recovery, fleet, disagg, faults,
                 retry, model, **engine_kw):
        self.name = name
        self.O, self.s, self.r, self.fl = obs, serving, recovery, fleet
        self.d, self.f, self.retry = disagg, faults, retry
        self.model = model
        self.engine_kw = engine_kw

    def engine(self, **kw):
        kw = {**dict(max_batch=2, max_len=32, page_size=8, block_size=2),
              **self.engine_kw, **kw}
        return self.s.ContinuousBatchingEngine(self.model, **kw)

    def factory(self, **kw):
        return lambda: self.engine(**kw)

    def plan(self, *specs):
        return self.f.FaultPlan(seed=7,
                                specs=[self.f.FaultSpec(*s) for s in specs])


@pytest.fixture(scope="module")
def pkgs():
    paddle.seed(11)
    jm = JaxLlama(JaxConfig.tiny(num_hidden_layers=1))
    tm = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1),
                          device="cpu")
    load_jax_state(tm, state_from_jax_layer(jm))
    return (_Pkg("jax", jobs, jserving, jrecovery, jfleet, jdisagg, jfaults,
                 jretry, jm),
            _Pkg("torch", tobs, tserving, trecovery, tfleet, tdisagg,
                 tfaults, tretry, tm, device="cpu"))


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n,)).astype(
        np.int32)


def _tick():
    count = itertools.count()
    return lambda: float(next(count))


def _events(tr):
    """(name, rid, replica, args) of every event, the wall-clock fields
    left out (module docstring)."""
    out = []
    for e in tr.events:
        args = {k: (_AGE.sub("<age>", v) if k == "error" else v)
                for k, v in e["args"].items() if k != "queue_wait_ms"}
        out.append((e["name"], e["tid"], e["pid"], args))
    return out


def _slo(tr):
    return {k: v for k, v in tr.slo_summary().items()
            if "queue_wait" not in k}


def _both(pkgs, case, tmp_path=None):
    """``case(pkg[, dir])`` for each package from one rid base."""
    base = max(jserving.Request._counter[0],
               tserving.Request._counter[0]) + 1
    out = []
    for pkg in pkgs:
        jserving.Request._counter[0] = tserving.Request._counter[0] = base
        if tmp_path is None:
            out.append(case(pkg))
        else:
            d = tmp_path / pkg.name
            d.mkdir()
            out.append(case(pkg, d))
    return out


# ---------------------------------------------------------------------------
# contract 1: the metrics registry
# ---------------------------------------------------------------------------

def _registry_ops(O):
    reg = O.MetricsRegistry()
    c = reg.counter("pt_t_total", "things")
    c.inc(2, kind="a")
    c.inc(kind='b "quoted"\nline\\slash')
    c.inc(0.25, kind="a")
    reg.counter("pt_idle_total", "never incremented")
    g = reg.gauge("pt_level")
    g.set(1.5)
    g.set(1e20, shard="big")
    g.set(-0.125, shard="neg")
    g.set(float("inf"), shard="inf")
    g.set(3.0000000000000004, shard="repr")
    h = reg.histogram("pt_lat_ms", "latency")
    for v in (0.5, 5, 5, 50, 5000, 40000, 12.25):
        h.observe(v)
    h.observe(7.0, replica="1")
    reg.histogram("pt_empty_ms", buckets=(1, 10, 100))
    custom = reg.histogram("pt_custom_ms", buckets=(10, 1, 100))
    for v in (0.5, 5, 5, 50, 5000):
        custom.observe(v)
    reg.register_collector(
        lambda: [O.MetricFamily("pt_dup", "gauge").add(1, replica="0")])
    reg.register_collector(
        lambda: [O.MetricFamily("pt_dup", "gauge").add(2, replica="1")])
    reg.register_collector(lambda: 1 / 0)
    coll = types.SimpleNamespace(collect=lambda: [
        O.MetricFamily("pt_obj", "counter", "from collect()").add(
            7, suffix="", x="y")])
    reg.register_collector(coll)
    errors = []
    for bad in (lambda: reg.gauge("pt_t_total"),
                lambda: reg.counter("bad name"),
                lambda: O.Counter("pt_ok").inc(**{"0bad": "y"}),
                lambda: O.Counter("pt_c").inc(-1),
                lambda: O.MetricFamily("pt_k", "summary")):
        try:
            bad()
        except ValueError as e:
            errors.append(str(e))
    assert reg.counter("pt_t_total") is c
    text = reg.dump()
    fams = O.parse_prometheus_text(text)
    parsed = {n: (f.kind, f.samples) for n, f in fams.items()}
    reads = (h.count(), h.quantile(0.5), h.quantile(0.99),
             h.quantile(0.999), custom.buckets, custom.quantile(0.5),
             h.snapshot(replica="1"), c.value(kind="a"), g.value())
    return text, parsed, reads, errors


def test_registry_dump_bytes_and_parse_equal_jax():
    jax_out, port_out = _registry_ops(jobs), _registry_ops(tobs)
    assert port_out[0] == jax_out[0]          # the exposition bytes
    assert port_out[1:] == jax_out[1:]
    text, parsed = port_out[0], port_out[1]
    assert text.count("# TYPE pt_dup gauge") == 1
    assert parsed["pt_collector_errors"][1][0][2] == 1
    assert parsed["pt_idle_total"][1] == [("", {}, 0.0)]
    assert len(port_out[3]) == 5
    # either package parses the other's text to the same families
    assert {n: (f.kind, f.samples) for n, f in
            jobs.parse_prometheus_text(text).items()} == parsed


def test_metrics_scenarios_of_the_jax_tests():
    reg = tobs.MetricsRegistry()
    c = reg.counter("pt_t_total", "things")
    c.inc(2, kind="a")
    c.inc(kind='b "quoted"\nline')
    reg.gauge("pt_level").set(1.5)
    fams = tobs.parse_prometheus_text(reg.dump())
    vals = {tuple(sorted(lbl.items())): v
            for _, lbl, v in fams["pt_t_total"].samples}
    assert vals[(("kind", "a"),)] == 2
    assert vals[(("kind", 'b "quoted"\nline'),)] == 1
    assert fams["pt_level"].samples[0][2] == 1.5
    h = reg.histogram("pt_lat_ms", buckets=(1, 10, 100))
    for v in (0.5, 5, 5, 50, 5000):
        h.observe(v)
    assert h.count() == 5 and 1 <= h.quantile(0.5) <= 10
    assert h.quantile(0.999) == 100
    s = tobs.parse_prometheus_text(reg.dump())["pt_lat_ms"].samples
    assert [v for suf, lbl, v in s
            if suf == "_bucket" and lbl.get("le") == "+Inf"] == [5]
    assert any(suf == "_sum" and abs(v - 5060.5) < 1e-6 for suf, _, v in s)


def test_concurrent_observes_and_increments_are_exact():
    reg = tobs.MetricsRegistry()
    c, h = reg.counter("pt_n_total"), reg.histogram("pt_w_ms")

    def work():
        for _ in range(2000):
            c.inc(replica="0")
            h.observe(5.0)

    threads = [threading.Thread(target=work, daemon=True) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert c.value(replica="0") == 16000 and h.count() == 16000
    assert h.snapshot()[-1] == 5.0 * 16000


def test_metrics_server_serves_the_dump_and_closes():
    reg = tobs.MetricsRegistry()
    reg.counter("pt_up_total").inc()
    srv = tobs.MetricsServer(reg, port=0)
    try:
        with urllib.request.urlopen(srv.url, timeout=5) as resp:
            body = resp.read().decode("utf-8")
            ctype = resp.headers["Content-Type"]
        assert body == reg.dump() and "pt_up_total 1" in body
        assert ctype == "text/plain; version=0.0.4; charset=utf-8"
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/healthz", timeout=5) as resp:
            assert resp.read() == b"ok"
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/nope",
                                   timeout=5)
    finally:
        srv.close()
    assert not srv._thread.is_alive()


# ---------------------------------------------------------------------------
# contract 3: the trace recorder
# ---------------------------------------------------------------------------

def _recorder_script(O):
    clock = O.VirtualClock()
    reg = O.MetricsRegistry()
    tr = O.TraceRecorder(registry=reg, clock=clock)
    tags = {"replica": 1, "tenant": "acme"}
    tr.submit(1, 10, 8, tags)
    clock.advance(0.004)
    tr.admit(1, 0.002, hit_tokens=4, miss_tokens=6, tags=tags)
    t0 = tr.now()
    clock.advance(0.01)
    tr.prefill_chunk(1, t0, 16, tags={"replica": 1})
    tr.first_tokens([(1, 1)], tags={"replica": 1})
    clock.advance(0.02)
    tr.decode_block_batch(tr.now() - 0.02, 4, 1, [(1, 5)],
                          tags={"replica": 1}, tokens=4)
    # a crash: the replay twin is marked at its delivered mark
    tr.mark_recovered(1, hwm=5, tags={"replica": 1})
    tr.tokens(1, 3)                      # catch-up below the mark
    tr.first_token(1)                    # replay: TTFT not reset
    tr.tokens(1, 7)
    tr.recovery(t0, "PT-SRV-001", 1, tags={"replica": 1})
    tr.finish(1, 8, tags={"replica": 1})
    # a shed rid re-opened by a resubmit (fleet fall-through)
    tr.submit(2, 4, 4)
    tr.shed(2, reason="full")
    tr.submit(2, 4, 4, {"replica": 0})
    tr.admit(2, 0.0)
    clock.advance(0.1)
    tr.first_token(2)
    tr.failover(2, 0, 1)
    tr.migrate(2, 0, 1, pages=3, nbytes=4096, t0=tr.now() - 0.003,
               tags={"replica": 1})
    tr.migration_failure(2, "corrupt", tags={"replica": 1})
    tr.finish(2, 4, failed=True, error="deadline exceeded: 1s")
    tr.submit(3, 4, 4)
    tr.finish(3, 2, failed=True, error="boom")
    tr.shed(4, tags={"tenant": "late"})           # shed before any engine
    tr.publish(t0, step=3, generation=2, shards=4)
    tr.resume(t0, step=3, world=2)
    tr.instant("autoscale", None, None, action="scale_up")
    tr.submit(5, 4, 4)
    doc = tr.export_chrome()
    lifecycles = {rid: tr.lifecycle(rid) for rid in (1, 2, 3, 4, 5)}
    # bounded buffer and GC
    small = O.TraceRecorder(max_events=3, max_requests=2, clock=clock)
    for rid in (1, 2, 3):
        small.submit(rid, 4, 4)
        small.finish(rid, 4)
    return (doc, tr.slo_summary(), tr.counters(), lifecycles, reg.dump(),
            tr.incomplete(), tr.is_open(5), tr._c_tokens.value(),
            small.counters(), small.export_chrome()["otherData"])


def test_recorder_script_equal_jax():
    jax_out, port_out = _recorder_script(jobs), _recorder_script(tobs)
    for a, b in zip(port_out, jax_out):
        assert a == b
    doc, slo, counters, lifecycles = port_out[:4]
    assert lifecycles[1][:4] == ["submit", "admit", "prefill_chunk",
                                 "first_token"]
    assert "recovered" in lifecycles[1] and \
        "first_token_replay" in lifecycles[1]
    assert [e for e in doc["traceEvents"] if e.get("tid") == 1][-1][
        "args"]["recovered"] is True
    assert port_out[7] == 8 + 4 + 2     # hwm dedup: stream lengths only
    assert counters["resubmits"] == 1 and slo["submitted"] == 5
    assert port_out[5] == [5] and port_out[6]
    assert port_out[8]["dropped"] > 0 and port_out[8]["gc"] > 0
    assert port_out[9] == {"dropped_events": port_out[8]["dropped"]}


def test_mirror_host_events_names_its_slice():
    """The profiler mirror was refused until the profiler's slice; now a
    span's duration lands in the profiler's host-event table, as JAX's
    recorder feeds it."""
    from paddle_tpu_torch import profiler

    profiler._host_events.reset()
    tr = tobs.TraceRecorder(mirror_host_events=True)
    assert tr.mirror_host_events
    tr.span("decode_block", 3, 1.0, 1.25)
    assert profiler._host_events.counts["decode_block"] == 1
    assert profiler._host_events.totals["decode_block"] == 0.25
    profiler._host_events.reset()


def test_concurrent_stamping_is_exact():
    tr = tobs.TraceRecorder(max_events=500_000)
    n_threads, n_reqs, n_toks = 8, 25, 20
    errs = []

    def replica(t):
        try:
            for i in range(n_reqs):
                rid = t * 1000 + i
                tr.submit(rid, 4, n_toks, tags={"replica": t})
                tr.first_token(rid, tags={"replica": t})
                for k in range(1, n_toks + 1):
                    tr.tokens(rid, k)
                tr.decode_block_batch(tr.now(), 1, 1, [(rid, n_toks)],
                                      tags={"replica": t})
                tr.finish(rid, n_toks, tags={"replica": t})
                tr.export_chrome()
                tr.incomplete()
        except Exception as e:            # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=replica, args=(t,), daemon=True)
               for t in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)          # interleave the stamp sites
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    total = n_threads * n_reqs
    slo = tr.slo_summary()
    assert slo["submitted"] == total
    assert slo["tokens_streamed"] == total * n_toks
    assert tr.incomplete() == []
    assert tr.registry.get("pt_serving_requests_terminal_total").value(
        kind="finish") == total
    assert len([e for e in tr.export_chrome()["traceEvents"]
                if e["name"] == "finish"]) == total


# ---------------------------------------------------------------------------
# contract 4: traced engines
# ---------------------------------------------------------------------------

KINDS = {
    "legacy": {},
    "prefix": dict(prefix_cache="cfg"),
    "fused": dict(prefix_cache="cfg", fused=True),
    "spec": dict(prefix_cache="cfg", fused=True, speculative="spec"),
}


def _kind_kw(pkg, kind):
    kw = dict(KINDS[kind], max_len=48, max_queue=6)
    if "prefix_cache" in kw:
        kw["prefix_cache"] = pkg.s.PrefixCacheConfig(prefill_chunk=8,
                                                     extra_blocks=4)
    if "speculative" in kw:
        kw["speculative"] = pkg.s.SpecConfig(k=4)
    return kw


def _traced_wave(pkg, kind, eos, traced=True):
    tr = pkg.O.TraceRecorder(clock=_tick()) if traced else None
    eng = pkg.engine(tracer=tr, **_kind_kw(pkg, kind))
    prompts = [_prompt(n, 30 + i) for i, n in enumerate((8, 12, 9, 16, 5))]
    reqs = [pkg.s.Request(p, max_new_tokens=6 + i)
            for i, p in enumerate(prompts)]
    reqs[2].eos_token_id = eos
    # queued past its deadline before the first step: evicted there
    doomed = pkg.s.Request(prompts[0], max_new_tokens=3, deadline_s=1e-9)
    for r in reqs + [doomed]:
        eng.add_request(r)
    with pytest.raises(pkg.s.EngineSaturated):
        eng.add_request(pkg.s.Request(prompts[1], max_new_tokens=2))
    eng.step()
    # the decode rate is measured now: an infeasible deadline sheds
    with pytest.raises(pkg.s.RequestShed):
        eng.add_request(pkg.s.Request(prompts[1], max_new_tokens=3,
                                      deadline_s=1e-9))
    eng.run_until_done(max_steps=500)
    streams = [list(r.tokens) for r in reqs]
    assert doomed.failed and "deadline" in doomed.error
    if not traced:
        return streams
    return dict(events=_events(tr), streams=streams, slo=_slo(tr),
                counters=tr.counters(), tokens=tr._c_tokens.value(),
                lifecycles={r.rid: tr.lifecycle(r.rid)
                            for r in reqs + [doomed]},
                incomplete=tr.incomplete())


@pytest.mark.parametrize("kind", list(KINDS))
def test_traced_engine_events_equal_jax(pkgs, kind):
    ref = pkgs[1].model.generate(_prompt(9, 32)[None], max_new_tokens=4,
                                 temperature=0.0, max_length=48).tolist()[0]
    eos = int(ref[-2])                   # request 2 stops at its 3rd token
    jax_run, port_run = _both(pkgs, lambda p: _traced_wave(p, kind, eos))
    assert port_run == jax_run
    assert port_run["incomplete"] == []
    assert len(port_run["streams"][2]) == 3      # the eos request
    names = {e[0] for e in port_run["events"]}
    assert {"submit", "admit", "first_token", "decode_block", "finish",
            "evict", "shed"} <= names
    # the evicted request streamed nothing
    assert port_run["tokens"] == sum(len(s) for s in port_run["streams"])
    for rid, names in port_run["lifecycles"].items():
        terms = [n for n in names if n in TERMINALS]
        assert len(terms) == 1, (rid, names)
        if terms == ["finish"]:
            chain = iter(names)
            assert all(s in chain for s in ("submit", "admit",
                                            "first_token", "finish"))
    # tracing changes no token
    assert _both(pkgs[1:], lambda p: _traced_wave(
        p, kind, eos, traced=False))[0] == port_run["streams"]


def test_fused_engine_tracer_swapped_after_construction(pkgs):
    """The captured step reads nothing of the tracer: a recorder attached
    after construction stamps at the next block (the supervisor's
    _attach_tracer and bench's fresh-recorder swap rely on it)."""
    pkg = pkgs[1]
    eng = pkg.engine(**_kind_kw(pkg, "fused"))
    tr = tobs.TraceRecorder()
    eng.tracer, eng.trace_tags = tr, {"replica": 3}
    r = pkg.s.Request(_prompt(8, 1), max_new_tokens=5)
    eng.add_request(r)
    eng.run_until_done()
    names = tr.lifecycle(r.rid)
    assert names[0] == "submit" and names[-1] == "finish"
    assert {e["pid"] for e in tr.events} == {3}


# ---------------------------------------------------------------------------
# contract 5: the supervisor across a crash
# ---------------------------------------------------------------------------

def _supervised(pkg, d):
    reg = pkg.O.MetricsRegistry()
    tr = pkg.O.TraceRecorder(registry=reg, clock=_tick())
    sup = pkg.r.ServingSupervisor(pkg.factory(prefix_cache=True),
                                  str(d / "j.jrnl"), tracer=tr)
    reg.register_collector(pkg.O.supervisor_collector(sup))
    served = [pkg.s.Request(_prompt(8, 1 + i), max_new_tokens=4, seed=1 + i)
              for i in range(3)]
    for r in served:
        sup.submit(r)
    doomed = pkg.s.Request(_prompt(8, 9), max_new_tokens=4, deadline_s=1e-9)
    sup.submit(doomed)
    sup.run_until_done(max_steps=500)
    with pytest.raises(pkg.s.RequestShed):
        sup.submit(pkg.s.Request(_prompt(8, 10), max_new_tokens=4,
                                 deadline_s=1e-9))
    reqs = [pkg.s.Request(_prompt(8, 50 + i), max_new_tokens=6, seed=50 + i)
            for i in range(2)]
    for r in reqs:
        sup.submit(r)
    with pkg.plan(("serving.step", "kill", 1, 1)):
        sup.run_until_done(max_steps=2000)
    sup.close()
    text = reg.dump()
    return dict(events=_events(tr), recoveries=sup.recoveries,
                streams=[list(r.output) for r in served + reqs],
                failed=[bool(r.failed) for r in served + [doomed] + reqs],
                tokens=tr._c_tokens.value(), streamed=dict(tr._streamed),
                incomplete=tr.incomplete(), slo=_slo(tr),
                lifecycles={r.rid: tr.lifecycle(r.rid) for r in reqs},
                last_tags=[[e for e in tr.events if e["tid"] == r.rid][-1][
                    "args"].get("recovered") for r in reqs],
                recovery=[e["args"] for e in tr.events
                          if e["name"] == "recovery"],
                scraped="pt_supervisor_recoveries 1" in text
                and "pt_serving_time_to_first_token_ms_bucket" in text)


def test_supervisor_crash_replay_trace_equal_jax(pkgs, tmp_path):
    jax_run, port_run = _both(pkgs, _supervised, tmp_path)
    assert port_run == jax_run
    assert port_run["recoveries"] == 1 and port_run["incomplete"] == []
    assert port_run["failed"] == [False] * 3 + [True] + [False] * 2
    for names in port_run["lifecycles"].values():
        assert sum(n in TERMINALS for n in names) == 1, names
        assert "recovered" in names and "first_token_replay" in names
    assert port_run["last_tags"] == [True, True]
    assert [a["code"] for a in port_run["recovery"]] == ["PT-SRV-001"]
    # dedup: streamed tokens end at the callers' stream lengths
    assert port_run["tokens"] == sum(len(s) for s in port_run["streams"])
    assert port_run["scraped"]


# ---------------------------------------------------------------------------
# contract 6: fleet failover edges, tier migrations
# ---------------------------------------------------------------------------

def _fleet_kill(pkg, d):
    tr = pkg.O.TraceRecorder(clock=_tick())
    fleet = pkg.fl.FleetRouter(pkg.factory(prefix_cache=True), str(d),
                               num_replicas=2, tracer=tr)
    reqs = [pkg.s.Request(_prompt(8 + i % 3, 70 + i), max_new_tokens=10)
            for i in range(6)]
    for r in reqs:
        fleet.submit(r)
    with pkg.plan(("fleet.replica_kill", "kill", 3, 1, "replica:1:")):
        fleet.run_until_done(max_steps=3000)
    fleet.close()
    return dict(events=_events(tr), streams=[list(r.output) for r in reqs],
                failover=[(e[1], e[3]["from_replica"], e[3]["to_replica"])
                          for e in _events(tr) if e[0] == "failover"],
                deaths=fleet.stats["replica_deaths"],
                incomplete=tr.incomplete(), tokens=tr._c_tokens.value(),
                pids={(e[0], e[2]) for e in _events(tr)})


def test_fleet_failover_edges_equal_jax(pkgs, tmp_path):
    jax_run, port_run = _both(pkgs, _fleet_kill, tmp_path)
    assert port_run == jax_run
    assert port_run["deaths"] == 1 and port_run["failover"]
    assert {f[1:] for f in port_run["failover"]} == {(1, 0)}
    assert port_run["incomplete"] == []
    assert port_run["tokens"] == sum(len(s) for s in port_run["streams"])
    # every replica's engine events carry its replica id
    assert {pid for name, pid in port_run["pids"]
            if name == "decode_block"} == {0, 1}


def _tiered(pkg, d, corrupt):
    tr = pkg.O.TraceRecorder(clock=_tick())
    tiered = pkg.d.TieredRouter(pkg.factory(prefix_cache=True),
                                pkg.factory(prefix_cache=True), str(d),
                                num_prefill=1, num_decode=1, tracer=tr)
    reqs = [pkg.s.Request(_prompt(9 + 3 * i, 80 + i), max_new_tokens=8)
            for i in range(4)]
    for r in reqs:
        tiered.submit(r)
    specs = [("serving.kv_transfer", "bitflip", 1, 1)] if corrupt else []
    with pkg.plan(*specs):
        tiered.run_until_done(max_steps=3000)
    tiered.close()
    evs = _events(tr)
    migrate = [(e[1], e[2], e[3]["from_replica"], e[3]["to_replica"],
                e[3]["pages"]) for e in evs if e[0] == "migrate"]
    return dict(events=[e if e[0] != "migrate" else e[:3] + (
        {k: v for k, v in e[3].items() if k != "bytes"},) for e in evs],
        migrate=migrate, nbytes=sum(e[3]["bytes"] for e in evs
                                    if e[0] == "migrate"),
        router_bytes=tiered.stats["migration_bytes"],
        failures=[(e[1], e[3]["reason"]) for e in evs
                  if e[0] == "migrate_failure"],
        streams=[list(r.output) for r in reqs],
        counted=(tr._c_migrations.value(),
                 tr._h_migration.count(), tiered.stats["migrations"]),
        incomplete=tr.incomplete(), tokens=tr._c_tokens.value())


@pytest.mark.parametrize("corrupt", [False, True], ids=["clean", "bitflip"])
def test_tier_migration_spans_equal_jax(pkgs, tmp_path, corrupt):
    jax_run, port_run = _both(pkgs, lambda p, d: _tiered(p, d, corrupt),
                              tmp_path)
    # the PTKV1 header carries the page crcs, whose digits differ with the
    # last bits of the page bytes: every other field is equal, and each
    # package's migrate spans add up to its router's moved bytes
    for run in (jax_run, port_run):
        assert run.pop("nbytes") == run.pop("router_bytes")
    assert port_run == jax_run
    assert port_run["incomplete"] == []
    assert port_run["tokens"] == sum(len(s) for s in port_run["streams"])
    if corrupt:
        assert [f[1] for f in port_run["failures"]] == ["corrupt"]
        assert port_run["counted"][0] == port_run["counted"][2]
    else:
        assert port_run["failures"] == [] and port_run["migrate"]
        assert all(m[1] == 1 and (m[2], m[3]) == (0, 1)
                   for m in port_run["migrate"])
        n = len(port_run["migrate"])
        assert port_run["counted"] == (n, n, n)


# ---------------------------------------------------------------------------
# contract 9: the scrape surface; contract 10: the retry registry
# ---------------------------------------------------------------------------

# families of later slices of the port (ROADMAP Queue 1): the numeric
# guard and the checkpoint lifecycle (item 6), the process fleet (item 3b)
LATER_SLICE_FAMILIES = {
    "pt_guard_health_events_total",
    "pt_procfleet_spawned_total", "pt_procfleet_reaped_total",
    "pt_procfleet_heartbeats_total", "pt_procfleet_workers_alive",
    "pt_transport_retries", "pt_transport_hedges",
    "pt_transport_breaker_state",
    "pt_checkpoint_generation", "pt_checkpoint_publish_total",
    "pt_checkpoint_publish_failures", "pt_lifecycle_phase",
}
# wall-clock readings (seconds of host work, rates, queue waits) and the
# engines' compile-cache gauge (the JAX engine counts compiled programs,
# the port's dispatch shapes): equal in family, not in value
WALL_FAMILIES = re.compile(
    r"_s$|_seconds_total$|tokens_per_sec$|queue_wait_ms$|"
    r"compile_cache_entries$")


def _required_families():
    tree = ast.parse(open(os.path.join(ROOT, "tools",
                                       "scrape_metrics.py")).read())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", "") ==
                "REQUIRED_FAMILIES"):
            return ast.literal_eval(node.value)
    raise AssertionError("REQUIRED_FAMILIES not found")


def _scraped_fleet(pkg, d):
    pkg.retry.reset_retry_stats()
    reg = pkg.O.MetricsRegistry()
    tr = pkg.O.TraceRecorder(registry=reg, clock=_tick())
    mon = pkg.O.SLOMonitor(pkg.O.SLOConfig(ttft_ms=1e9), tracer=tr)
    fleet = pkg.fl.FleetRouter(pkg.factory(prefix_cache=True), str(d),
                               num_replicas=2, tracer=tr)
    for coll in (pkg.O.fleet_collector(fleet), pkg.O.retry_collector(),
                 pkg.O.tracer_collector(tr), pkg.O.slo_collector(mon)):
        reg.register_collector(coll)
    reqs = [pkg.s.Request(_prompt(8 + i, 90 + i), max_new_tokens=5,
                          tenant="t")
            for i in range(5)]
    for r in reqs:
        fleet.submit(r)
    fleet.run_until_done(max_steps=2000)
    mon.roll_window(duration_s=1.0)
    srv = pkg.O.MetricsServer(reg, port=0)
    try:
        with urllib.request.urlopen(srv.url, timeout=5) as resp:
            body = resp.read().decode("utf-8")
        dump = reg.dump()
    finally:
        srv.close()
        fleet.close()
    return body, dump, pkg.O.parse_prometheus_text(dump)


def test_scrape_surface_renders_required_families_equal_jax(pkgs, tmp_path):
    (jbody, _, jfams), (body, dump, fams) = _both(pkgs, _scraped_fleet,
                                                  tmp_path)
    assert body == dump
    required = set(_required_families())
    assert LATER_SLICE_FAMILIES <= required
    missing = required - LATER_SLICE_FAMILIES - set(fams)
    assert not missing, missing
    assert set(jfams) - set(fams) <= LATER_SLICE_FAMILIES, \
        set(jfams) - set(fams)
    # the port's own engine counters (graph/spec captures and replays,
    # eager steps, prefill calls, decode steps) are extra pt_engine_*
    # families
    assert set(fams) - set(jfams) == {
        "pt_engine_prefill_groups", "pt_engine_decode_steps",
        "pt_engine_graph_captures", "pt_engine_graph_replays",
        "pt_engine_eager_decode_steps", "pt_engine_spec_graph_captures",
        "pt_engine_spec_graph_replays", "pt_engine_eager_spec_steps"}
    compared = 0
    for name, fam in fams.items():
        if name not in jfams or WALL_FAMILIES.search(name):
            continue
        assert sorted(map(repr, fam.samples)) == sorted(
            map(repr, jfams[name].samples)), name
        compared += 1
    assert compared > 40


def _retry_sequence(pkg):
    pkg.retry.reset_retry_stats()
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise ConnectionError("transient")
        return "ok"

    sleeps = []
    pol = pkg.retry.RetryPolicy(max_attempts=4, base_delay=0.01)
    assert pkg.retry.retry_call(flaky, policy=pol, what="store.get",
                                rng=random.Random(5),
                                sleep=sleeps.append) == "ok"
    with pytest.raises(pkg.retry.RetryError, match="PT-RETRY-002"):
        pkg.retry.retry_call(lambda: (_ for _ in ()).throw(OSError("x")),
                             policy=pol, what="rpc.call",
                             rng=random.Random(6), sleep=sleeps.append)
    eng = pkg.engine()
    eng.add_request(pkg.s.Request(_prompt(6, 2), max_new_tokens=2))
    eng.run_until_done()
    stats = pkg.retry.retry_stats()
    stats.pop("latency_s")
    delays = list(pkg.retry.backoff_delays(
        pkg.retry.RetryPolicy(max_attempts=6, jitter=0.3), random.Random(9)))
    return (eng.stats["retry_attempts"], eng.stats["retry_giveups"], stats,
            sleeps, delays)


def test_engine_finished_copies_the_retry_registry_as_jax(pkgs):
    jax_out, port_out = _both(pkgs, _retry_sequence)
    assert port_out == jax_out
    assert port_out[:2] == (7, 1)
    assert port_out[2]["by_what"] == {"store.get": 3, "rpc.call": 4}
    reg = tobs.MetricsRegistry()
    reg.register_collector(tobs.retry_collector())
    assert "pt_retry_attempts_total 7" in reg.dump()
    tretry.reset_retry_stats()
    jretry.reset_retry_stats()


def test_later_collectors_name_their_slices():
    """The guard and checkpoint collectors (ported with the resilience
    trainer) render JAX's families; the process fleet's over an object
    that is no fleet renders them at zero, as JAX's does."""
    from paddle_tpu.distributed.resilience import lifecycle as jlife
    from paddle_tpu.distributed.resilience import watchdog as jwd
    from paddle_tpu.framework import numeric_guard as jng
    from paddle_tpu_torch.distributed.resilience import lifecycle as tlife
    from paddle_tpu_torch.distributed.resilience import watchdog as twd
    from paddle_tpu_torch.framework import numeric_guard as tng

    dumps = []
    for obs, ng, wdm, life in ((tobs, tng, twd, tlife),
                               (jobs, jng, jwd, jlife)):
        ng.consume_health()
        life.reset_lifecycle_stats()
        wd = wdm.NumericWatchdog(ng.GuardPolicy(max_skips_per_window=1))
        wd.observe(3, ng.SPIKE)
        ng.record_health(ng.INF_GRAD, "check")
        life.set_lifecycle_phase("train")
        reg = obs.MetricsRegistry()
        reg.register_collector(obs.guard_collector(wd))
        reg.register_collector(obs.checkpoint_collector())
        dumps.append(reg.dump())
        ng.consume_health()
        life.reset_lifecycle_stats()
    assert dumps[0] == dumps[1]
    assert "pt_guard_window_skips 1" in dumps[0]
    assert 'pt_lifecycle_phase{phase="train"} 1' in dumps[0]
    port = tobs.MetricsRegistry()
    port.register_collector(tobs.procfleet_collector(None))
    ref = jobs.MetricsRegistry()
    ref.register_collector(jobs.procfleet_collector(None))
    assert port.dump() == ref.dump()
    assert "pt_procfleet_workers_alive 0" in port.dump()
    assert sorted(tobs.__all__) == sorted(jobs.__all__)
