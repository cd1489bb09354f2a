"""Port fleet router (``paddle_tpu_torch.inference.fleet``) against the JAX
package's, on carried tiny-Llama weights (fp32, CPU).

Each case of tests/test_fleet.py (least-loaded spread, affinity and its
yield to balance, no alive replica, kill 1 of 3, failover off, the sole
replica killed, the heartbeat wedge, rolling restart, drain, hard
restart, fleet brownout, the warm-prefix hit rate, router restart over
journals and over their latest generation) runs through both packages
from the same rids, prompts and ``FaultPlan``. The two runs must give
equal greedy streams, equal fleet stats and event codes, the same
replica for every request, equal ``plan.log`` and equal journal records
in every replica's journal file apart from timing fields. Seeded-sampling
streams are held to an uninterrupted single engine of the same package
(the two packages' draws differ by design) and their journal records are
compared by token count.
"""

import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.resilience import faults as jfaults
from paddle_tpu.inference import fleet as jfleet
from paddle_tpu.inference import recovery as jrecovery
from paddle_tpu.inference import serving as jserving
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.distributed.resilience import faults as tfaults
from paddle_tpu_torch.inference import fleet as tfleet
from paddle_tpu_torch.inference import recovery as trecovery
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.weights import load_jax_state, state_from_jax_layer

torch.set_num_threads(1)

STATS = ("submitted", "fleet_shed", "replica_deaths", "failovers",
         "failover_requests", "drains", "migrated", "restarts", "brownouts",
         "affinity_hits")


class _Pkg:
    def __init__(self, name, serving, recovery, fleet, faults, model,
                 **engine_kw):
        self.name = name
        self.s, self.r, self.fl, self.f = serving, recovery, fleet, faults
        self.model = model
        self.engine_kw = engine_kw

    def build(self, **kw):
        def build():
            return self.s.ContinuousBatchingEngine(
                self.model, max_batch=2, max_len=32, page_size=8,
                block_size=2, **{**self.engine_kw, **kw})
        return build

    def fleet(self, d, num_replicas, build=None, **kw):
        return self.fl.FleetRouter(build or self.build(), str(d),
                                   num_replicas=num_replicas, **kw)

    def plan(self, seed, *specs):
        return self.f.FaultPlan(seed=seed,
                                specs=[self.f.FaultSpec(*s) for s in specs])


@pytest.fixture(scope="module")
def pkgs():
    paddle.seed(13)
    jm = JaxLlama(JaxConfig.tiny(num_hidden_layers=1))
    tm = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1),
                          device="cpu")
    load_jax_state(tm, state_from_jax_layer(jm))
    return (_Pkg("jax", jserving, jrecovery, jfleet, jfaults, jm),
            _Pkg("torch", tserving, trecovery, tfleet, tfaults, tm,
                 device="cpu"))


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n,)).astype(
        np.int32)


def _ref(pkgs, prompt, n):
    return pkgs[1].model.generate(np.asarray(prompt)[None], max_new_tokens=n,
                                  temperature=0.0,
                                  max_length=32).tolist()[0]


def _both(pkgs, case, tmp_path):
    """``case(pkg, dir)`` for each package, both from one rid base."""
    base = max(jserving.Request._counter[0],
               tserving.Request._counter[0]) + 1
    out = []
    for pkg in pkgs:
        jserving.Request._counter[0] = tserving.Request._counter[0] = base
        d = tmp_path / pkg.name
        d.mkdir()
        out.append(case(pkg, d))
    return out


def _journals(pkg, d, sampled=()):
    """Every journal file under ``d``: its records without timing fields
    (sampled streams' tokens by count)."""
    out = {}
    for root, _, files in os.walk(d):
        for name in sorted(files):
            if not name.endswith(".jrnl"):
                continue
            recs = []
            for rec in pkg.r.RequestJournal.load(os.path.join(root, name)):
                rec = {k: v for k, v in rec.items()
                       if k not in ("seconds", "msg")}
                if rec["k"] == "prog" and rec["rid"] in sampled:
                    rec["toks"] = len(rec["toks"])
                recs.append(rec)
            out[os.path.relpath(os.path.join(root, name), d)] = recs
    return out


def _obs(pkg, fleet, d, reqs=(), sampled=(), plan=None):
    """What both packages must agree on after a fleet run."""
    return dict(
        streams=[list(r.output) if r.rid not in sampled else len(r.output)
                 for r in reqs],
        failed=[bool(r.failed) for r in reqs],
        stats={k: fleet.stats[k] for k in STATS},
        codes=[c for c, _ in fleet.events],
        assigned=dict(fleet._assigned),
        states=[(rep.state, rep.gen) for rep in fleet.replicas],
        log=None if plan is None else plan.log,
        journals=_journals(pkg, d, set(sampled)))


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def test_least_loaded_spread(pkgs, tmp_path):
    def case(pkg, d):
        fleet = pkg.fleet(d, 3, config=pkg.fl.FleetConfig(affinity=False))
        reqs = []
        for i in range(3):
            reqs.append(pkg.s.Request(_prompt(6, i), max_new_tokens=2))
            fleet.submit(reqs[-1])
        assert sorted(fleet.load().values()) == [1, 1, 1]
        for i in range(3):
            reqs.append(pkg.s.Request(_prompt(6, 10 + i), max_new_tokens=2))
            fleet.submit(reqs[-1])
        assert sorted(fleet.load().values()) == [2, 2, 2]
        fleet.run_until_done()
        fleet.close()
        return _obs(pkg, fleet, d, reqs)

    j, t = _both(pkgs, case, tmp_path)
    assert t == j


def test_affinity_sticks_and_yields_to_balance(pkgs, tmp_path):
    def case(pkg, d):
        fleet = pkg.fleet(d, 2, config=pkg.fl.FleetConfig(queue_slack=1))
        shared = _prompt(16, 3)             # two full 8-token pages
        r0 = pkg.s.Request(shared, max_new_tokens=2)
        fleet.submit(r0)
        home = fleet._assigned[r0.rid]
        r1 = pkg.s.Request(np.concatenate([shared[:8], _prompt(8, 4)]),
                           max_new_tokens=2)
        fleet.submit(r1)
        assert fleet._assigned[r1.rid] == home
        assert fleet.stats["affinity_hits"] == 1
        reqs = [r0, r1]
        for _ in range(4):
            reqs.append(pkg.s.Request(shared, max_new_tokens=2))
            fleet.submit(reqs[-1])
        assert any(fleet._assigned[r.rid] != home for r in reqs[2:]), \
            "affinity never yielded to queue_slack balance"
        fleet.run_until_done()
        fleet.close()
        return _obs(pkg, fleet, d, reqs)

    j, t = _both(pkgs, case, tmp_path)
    assert t == j


def test_no_alive_replica_raises(pkgs, tmp_path):
    def case(pkg, d):
        fleet = pkg.fleet(d, 1)
        fleet.replicas[0].state = pkg.fl.ReplicaState.DEAD
        with pytest.raises(pkg.s.EngineSaturated, match="no alive replica"):
            fleet.submit(pkg.s.Request(_prompt(6, 5), max_new_tokens=2))
        fleet.replicas[0].state = pkg.fl.ReplicaState.ALIVE
        fleet.close()
        return _obs(pkg, fleet, d)

    j, t = _both(pkgs, case, tmp_path)
    assert t == j


# ---------------------------------------------------------------------------
# failover
# ---------------------------------------------------------------------------

def test_kill_one_of_three_byte_identical(pkgs, tmp_path):
    """Kill 1 of 3 replicas mid-traffic: every request completes with the
    stream of an uninterrupted single engine (greedy and seeded); the dead
    replica rejoins cold."""
    prompts = [_prompt(6, 20 + i) for i in range(6)]
    kws = [dict(max_new_tokens=8, seed=70 + i) for i in range(6)]
    for i in (2, 5):
        kws[i].update(temperature=0.9, top_p=0.9)

    def case(pkg, d):
        ref_eng = pkg.build()()
        ref_reqs = [pkg.s.Request(p, **kw) for p, kw in zip(prompts, kws)]
        for r in ref_reqs:
            ref_eng.add_request(r)
        ref_eng.run_until_done(max_steps=500)
        plan = pkg.plan(0, ("fleet.replica_kill", "kill", 2, 1, 0.0,
                            "replica:0:"))
        fleet = pkg.fleet(d, 3)
        reqs = [pkg.s.Request(p, **kw) for p, kw in zip(prompts, kws)]
        with plan:
            for r in reqs:
                fleet.submit(r)
            fleet.run_until_done(max_steps=500)
        assert plan.log, "kill never fired"
        for r, want in zip(reqs, ref_reqs):
            assert r.done and not r.failed, r.error
            assert list(r.tokens) == list(want.tokens)
        assert fleet.replicas[0].state == pkg.fl.ReplicaState.DEAD
        fleet.restart(0)
        assert fleet.replicas[0].state == pkg.fl.ReplicaState.ALIVE
        assert fleet.replicas[0].gen == 1
        fleet.close()
        return _obs(pkg, fleet, d, reqs, {reqs[2].rid, reqs[5].rid}, plan)

    j, t = _both(pkgs, case, tmp_path)
    assert t == j
    assert t["stats"]["replica_deaths"] == t["stats"]["failovers"] == 1
    assert t["codes"].count("PT-FLT-001") >= 1
    assert [s for i, s in enumerate(t["streams"]) if i not in (2, 5)] == [
        _ref(pkgs, p, 8) for i, p in enumerate(prompts) if i not in (2, 5)]


def test_failover_disabled_control_arm(pkgs, tmp_path):
    def case(pkg, d):
        plan = pkg.plan(0, ("fleet.replica_kill", "kill", 1, 1, 0.0,
                            "replica:0:"))
        fleet = pkg.fleet(d, 2, failover=False)
        reqs = [pkg.s.Request(_prompt(6, 30 + i), max_new_tokens=8)
                for i in range(4)]
        with plan:
            for r in reqs:
                fleet.submit(r)
            fleet.run_until_done(max_steps=500)
        lost = [r for r in reqs if r.failed]
        assert lost and all("PT-FLT-001" in r.error for r in lost)
        assert all(r.done for r in reqs)
        fleet.close()
        return _obs(pkg, fleet, d, reqs, plan=plan)

    j, t = _both(pkgs, case, tmp_path)
    assert t == j


def test_kill_sole_replica_fails_requests(pkgs, tmp_path):
    def case(pkg, d):
        plan = pkg.plan(0, ("fleet.replica_kill", "kill", 1, 1))
        fleet = pkg.fleet(d, 1)
        r = pkg.s.Request(_prompt(6, 40), max_new_tokens=8)
        with plan:
            fleet.submit(r)
            fleet.run_until_done(max_steps=100)
        assert r.failed and "no surviving replica" in r.error
        fleet.close()
        return _obs(pkg, fleet, d, [r], plan=plan)

    j, t = _both(pkgs, case, tmp_path)
    assert t == j


def test_heartbeat_wedge_drives_failover(pkgs, tmp_path):
    prompts = [_prompt(6, 50 + i) for i in range(2)]
    refs = [_ref(pkgs, p, 6) for p in prompts]

    def case(pkg, d):
        fleet = pkg.fleet(d, 2, config=pkg.fl.FleetConfig(
            affinity=False, heartbeat_ttl_s=0.0))
        reqs = [pkg.s.Request(p, max_new_tokens=6) for p in prompts]
        for r in reqs:
            fleet.submit(r)
        wedged = fleet.replicas[0]
        wedged.sup.engine.step = lambda: None   # steps "succeed", no work
        fleet.run_until_done(max_steps=200)
        assert any("heartbeat stale" in msg for _, msg in fleet.events)
        recs = pkg.r.RequestJournal.load(wedged.journal_path)
        done = {r["rid"] for r in recs if r["k"] in ("fin", "migr")}
        assert all(r["rid"] in done for r in recs if r["k"] == "admit")
        fleet.close()
        return _obs(pkg, fleet, d, reqs)

    j, t = _both(pkgs, case, tmp_path)
    assert t == j
    assert t["stats"]["replica_deaths"] == 1 and t["streams"] == refs
    assert t["failed"] == [False, False]


# ---------------------------------------------------------------------------
# drain / restart
# ---------------------------------------------------------------------------

def test_rolling_restart_zero_loss(pkgs, tmp_path):
    prompts = [_prompt(6, 60 + i) for i in range(6)]
    refs = [_ref(pkgs, p, 8) for p in prompts]

    def case(pkg, d):
        fleet = pkg.fleet(d, 3)
        reqs = [pkg.s.Request(p, max_new_tokens=8, seed=90 + i)
                for i, p in enumerate(prompts)]
        for r in reqs:
            fleet.submit(r)
        fleet.step()                        # work in flight everywhere
        fleet.rolling_restart(max_steps=500)
        fleet.run_until_done(max_steps=500)
        assert all(rep.journal_path.endswith(".g1.jrnl")
                   for rep in fleet.replicas)
        fleet.close()
        return _obs(pkg, fleet, d, reqs)

    j, t = _both(pkgs, case, tmp_path)
    assert t == j
    assert t["stats"]["restarts"] == 3
    assert t["states"] == [("alive", 1)] * 3
    assert t["streams"] == refs and not any(t["failed"])


def test_drain_migrates_queued_keeps_inflight(pkgs, tmp_path):
    def case(pkg, d):
        fleet = pkg.fleet(d, 2, config=pkg.fl.FleetConfig(affinity=False))
        reqs = [pkg.s.Request(_prompt(6, 70 + i), max_new_tokens=8)
                for i in range(6)]
        for r in reqs:
            fleet.submit(r)
        fleet.step()
        fleet.drain(0)
        assert fleet.replicas[0].state == pkg.fl.ReplicaState.DRAINING
        assert fleet.stats["migrated"] >= 1
        recs = fleet.replicas[0].sup.journal.records
        assert any(rec["k"] == "migr" for rec in recs)
        with pytest.raises(pkg.s.EngineSaturated):  # draining: no target
            probe = pkg.s.Request(_prompt(6, 99), max_new_tokens=2)
            fleet.replicas[1].state = pkg.fl.ReplicaState.DEAD
            try:
                fleet.submit(probe)
            finally:
                fleet.replicas[1].state = pkg.fl.ReplicaState.ALIVE
        fleet.run_until_done(max_steps=500)
        assert fleet.replicas[0].state == pkg.fl.ReplicaState.ALIVE
        assert all(r.done and not r.failed for r in reqs)
        fleet.close()
        return _obs(pkg, fleet, d, reqs)

    j, t = _both(pkgs, case, tmp_path)
    assert t == j
    assert t["states"][0] == ("alive", 1)
    assert t["streams"] == [_ref(pkgs, _prompt(6, 70 + i), 8)
                            for i in range(6)]


def test_hard_restart_control_arm(pkgs, tmp_path):
    def case(pkg, d):
        fleet = pkg.fleet(d, 2, graceful_drain=False)
        reqs = [pkg.s.Request(_prompt(6, 80 + i), max_new_tokens=8)
                for i in range(4)]
        for r in reqs:
            fleet.submit(r)
        fleet.step()
        fleet.drain(0)
        lost = [r for r in reqs if r.failed]
        assert lost and all("PT-FLT-002" in r.error for r in lost)
        assert fleet.replicas[0].state == pkg.fl.ReplicaState.ALIVE
        assert fleet.replicas[0].gen == 1
        fleet.run_until_done(max_steps=500)
        assert all(r.done for r in reqs)
        fleet.close()
        return _obs(pkg, fleet, d, reqs)

    j, t = _both(pkgs, case, tmp_path)
    assert t == j


# ---------------------------------------------------------------------------
# brownout, affinity hit rate, router restart
# ---------------------------------------------------------------------------

def test_fleet_brownout_sheds_and_exits(pkgs, tmp_path):
    def case(pkg, d):
        fleet = pkg.fleet(d, 2, build=pkg.build(max_queue=4),
                          config=pkg.fl.FleetConfig(
                              brownout_depth=1, brownout_enter_after=2,
                              brownout_exit_after=2))
        R = pkg.s.Request
        flood = [R(_prompt(6, 100 + i), max_new_tokens=4,
                   priority=R.PRIORITY_LOW) for i in range(8)]
        shed = []
        for r in flood:
            try:
                fleet.submit(r)
            except pkg.s.RequestShed as e:
                assert "PT-FLT-003" in str(e)
                shed.append(r.rid)
        assert fleet.stats["brownouts"] == 1 and shed
        vip = R(_prompt(6, 120), max_new_tokens=4, priority=R.PRIORITY_HIGH)
        fleet.submit(vip)
        fleet.run_until_done(max_steps=500)
        assert vip.done and not vip.failed
        for _ in range(3):
            fleet.step()
        assert not fleet._brownout_active
        assert any(c == "PT-FLT-004" and "exited" in msg
                   for c, msg in fleet.events)
        fleet.close()
        return shed, _obs(pkg, fleet, d, [r for r in flood + [vip]
                                          if r.rid not in shed])

    j, t = _both(pkgs, case, tmp_path)
    assert t == j
    assert t[1]["stats"]["fleet_shed"] == len(t[0])


def test_warm_prefix_hit_rate_vs_single_replica(pkgs, tmp_path):
    shared = _prompt(16, 7)

    def case(pkg, d):
        build = pkg.build(prefix_cache=pkg.s.PrefixCacheConfig(
            extra_blocks=4))

        def sessions():
            rng = np.random.default_rng(8)
            return [np.concatenate([shared, rng.integers(0, 256, (4,))
                                    .astype(np.int32)]) for _ in range(6)]

        def hit_rate(fleet, sub):
            reqs = []
            for wave in range(3):
                for p in sessions()[wave * 2:(wave + 1) * 2]:
                    reqs.append(pkg.s.Request(p, max_new_tokens=2))
                    fleet.submit(reqs[-1])
                fleet.run_until_done(max_steps=500)
            hits = misses = 0
            for rep in fleet.replicas:
                hits += rep.sup.engine.stats["hit_tokens"]
                misses += rep.sup.engine.stats["miss_tokens"]
            fleet.close()
            return hits / max(1, hits + misses), _obs(pkg, fleet, d / sub,
                                                      reqs)

        single = hit_rate(pkg.fleet(d / "one", 1, build=build), "one")
        three = hit_rate(pkg.fleet(d / "three", 3, build=build), "three")
        assert single[0] > 0, "baseline never hit its own cache"
        assert three[0] >= single[0], (three[0], single[0])
        return single, three

    j, t = _both(pkgs, case, tmp_path)
    assert t == j


def _restart_case(pkg, d, rolling):
    prompts = [_prompt(6, (140 if rolling else 130) + i) for i in range(2)]
    cfg = pkg.fl.FleetConfig(affinity=False)
    fleet = pkg.fleet(d, 2, config=cfg)
    if rolling:
        fleet.rolling_restart()             # idle: drains at once, g0 -> g1
        assert all(rep.gen == 1 for rep in fleet.replicas)
    reqs = [pkg.s.Request(p, max_new_tokens=6) for p in prompts]
    for r in reqs:
        fleet.submit(r)
    fleet.step()                            # some tokens delivered
    delivered = [list(r.output) for r in reqs]
    for rep in fleet.replicas:              # process dies: no clean close
        rep.sup.abandon()
    fleet2 = pkg.fleet(d, 2, config=cfg)
    gens = [(rep.gen, os.path.basename(rep.journal_path))
            for rep in fleet2.replicas]
    fleet2.run_until_done(max_steps=500)
    out = {r.rid: r for rep in fleet2.replicas
           for r in rep.sup.requests.values()}
    assert sorted(out) == sorted(r.rid for r in reqs)
    for r in reqs:
        got = out[r.rid]
        assert got.done and not got.failed, got.error
    fleet2.close()
    return dict(delivered=delivered, gens=gens,
                streams=[[int(t) for t in out[r.rid].output] for r in reqs],
                codes=[[c for c, _ in rep.sup.events]
                       for rep in fleet2.replicas],
                journals=_journals(pkg, d)), prompts


@pytest.mark.parametrize("rolling", [False, True],
                         ids=["over_journals", "latest_generation"])
def test_router_restart(pkgs, tmp_path, rolling):
    """A FleetRouter constructed over an existing fleet_dir resumes each
    replica's latest journal generation (g1 after a rolling restart); every
    supervisor re-admits its unfinished requests and the streams complete
    byte-identically."""
    (j, prompts), (t, _) = _both(
        pkgs, lambda pkg, d: _restart_case(pkg, d, rolling), tmp_path)
    assert t == j
    assert t["streams"] == [_ref(pkgs, p, 6) for p in prompts]
    assert [g for g, _ in t["gens"]] == ([1, 1] if rolling else [0, 0])
    assert all(name.endswith(f".g{g}.jrnl") for g, name in t["gens"])


# ---------------------------------------------------------------------------
# the port's own contracts
# ---------------------------------------------------------------------------

def test_parallel_step_with_a_rebuild_inside_a_thread(pkgs, tmp_path):
    """``parallel_step=True`` steps the replicas in threads; a
    ``serving.step`` kill makes one supervisor rebuild its engine inside
    its thread while the others step. Streams equal the single engine's
    and the launch-free CPU path counts nothing twice."""
    pkg = pkgs[1]
    prompts = [_prompt(6, 300 + i) for i in range(6)]
    fleet = pkg.fleet(tmp_path, 3, build=pkg.build(
        fused=True, prefix_cache=pkg.s.PrefixCacheConfig(extra_blocks=4)),
        config=pkg.fl.FleetConfig(parallel_step=True))
    reqs = [pkg.s.Request(p, max_new_tokens=10) for p in prompts]
    plan = pkg.plan(0, ("serving.step", "kill", 4, 1))
    with plan:
        for r in reqs:
            fleet.submit(r)
        fleet.run_until_done(max_steps=500)
    assert plan.fired() == {"serving.step": 1}
    assert sum(rep.sup.recoveries for rep in fleet.replicas) == 1
    assert fleet.stats["replica_deaths"] == 0
    for r, p in zip(reqs, prompts):
        assert r.done and not r.failed
        assert list(r.output) == _ref(pkgs, p, 10)
    fleet.close()


def test_parallel_step_serializes_device_work(pkgs, tmp_path):
    """Stress: more stepping threads than cores, a tiny switch interval.
    The replicas share one model; the engines' device work runs one at a
    time (``serving._DEVICE_LOCK``), so no two threads are ever inside the
    model's decode step at once, and every stream is still exact."""
    import sys
    import threading

    pkg = pkgs[1]
    model = pkg.model
    inside, overlaps = [0], []
    guard = threading.Lock()
    step = model.paged_token_step

    def exclusive(*args, **kwargs):
        with guard:
            inside[0] += 1
            if inside[0] > 1:
                overlaps.append(threading.get_ident())
        try:
            return step(*args, **kwargs)
        finally:
            with guard:
                inside[0] -= 1

    n_rep = (os.cpu_count() or 4) + 4
    prompts = [_prompt(5 + i % 7, 400 + i) for i in range(2 * n_rep)]
    fleet = pkg.fleet(tmp_path, n_rep, build=pkg.build(
        fused=True, prefix_cache=pkg.s.PrefixCacheConfig(extra_blocks=4)),
        config=pkg.fl.FleetConfig(parallel_step=True, affinity=False))
    reqs = [pkg.s.Request(p, max_new_tokens=6) for p in prompts]
    interval = sys.getswitchinterval()
    model.paged_token_step = exclusive
    sys.setswitchinterval(1e-6)
    try:
        for r in reqs:
            fleet.submit(r)
        fleet.run_until_done(max_steps=200)
    finally:
        sys.setswitchinterval(interval)
        del model.paged_token_step
    assert overlaps == []
    assert all(r.done and not r.failed for r in reqs)
    assert [list(r.output) for r in reqs] == [_ref(pkgs, p, 6)
                                              for p in prompts]
    fleet.close()


def test_later_slices_refused_and_exports(pkgs, tmp_path):
    import paddle_tpu_torch.inference as inference
    pkg = pkgs[1]
    from paddle_tpu_torch import observability
    # fleet tracing is ported, and so is the process fleet's collector
    # (item 3b): over an in-process fleet it reads zero workers
    tr = observability.TraceRecorder()
    fleet = pkg.fleet(tmp_path, 1, tracer=tr)
    assert fleet.replicas[0].sup.tracer is tr
    assert fleet.replicas[0].sup.engine.trace_tags == {"replica": 0}
    fleet.close()
    fams = {f.name: f for f in observability.procfleet_collector(fleet)()}
    assert fams["pt_procfleet_workers_alive"].samples[0][2] == 0
    assert fams["pt_transport_breaker_state"].samples[0][1] == {
        "replica": "0"}
    for name in ("FleetRouter", "FleetConfig", "ReplicaState",
                 "ServingSupervisor", "RequestJournal", "JournalCorrupt",
                 "MeshDegraded", "SLOAutoscaler", "AutoscaleConfig"):
        assert hasattr(inference, name)
    assert tfleet.FleetConfig() == tfleet.FleetConfig(**{
        k: getattr(jfleet.FleetConfig(), k)
        for k in ("affinity", "queue_slack", "heartbeat_ttl_s",
                  "brownout_depth", "brownout_enter_after",
                  "brownout_exit_after", "shed_priority", "prefix_map_cap",
                  "parallel_step")})
