"""Port crash recovery (``paddle_tpu_torch.inference.recovery``) against
the JAX package's, on carried tiny-Llama weights (fp32, CPU).

Each case of tests/test_serving_recovery.py (priority order, shedding,
resume submissions, crash replay, journal restart under backpressure,
deadline eviction during replay, brownout, the stall watchdog) runs
through both packages from the same rids, the same prompts and the same
``FaultPlan``; the two runs must give equal greedy streams, equal event
codes, equal ``recoveries`` / ``replayed_requests``, equal ``plan.log`` and
equal journal records apart from timing fields (``seconds``, ``msg``).
Seeded-sampling streams are held to each package's own uninterrupted run:
the port draws with splitmix64 keys, the JAX package with threefry, so
their sampled tokens differ by design (``generation_utils``); their
journal records are compared by token count.

Then the journal itself: the same record dicts give byte-identical lines
in both packages, torn tails are truncated, mid-file damage and interior
blank lines raise ``JournalCorrupt``, and a journal left mid-wave by one
package's supervisor restarts in the other's to the same greedy streams.
Last, the port's own checks: the flush barrier, the old engine freed after
a rebuild, the tenant carried across a restart, the later-slice refusals.
"""

import gc
import warnings
import weakref

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.resilience import faults as jfaults
from paddle_tpu.inference import recovery as jrecovery
from paddle_tpu.inference import serving as jserving
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.distributed.resilience import faults as tfaults
from paddle_tpu_torch.inference import recovery as trecovery
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.weights import load_jax_state, state_from_jax_layer

torch.set_num_threads(1)

TIMING = ("seconds", "msg")


class _Pkg:
    """One package's serving surface, driven alike by every case."""

    def __init__(self, name, serving, recovery, faults, model, **engine_kw):
        self.name = name
        self.s, self.r, self.f = serving, recovery, faults
        self.model = model
        self.engine_kw = engine_kw

    def engine(self, **kw):
        return self.s.ContinuousBatchingEngine(self.model,
                                               **{**self.engine_kw, **kw})

    def prefix(self, max_queue=None):
        return self.engine(max_batch=2, max_len=32, page_size=8,
                           block_size=2, max_queue=max_queue,
                           prefix_cache=self.s.PrefixCacheConfig(
                               prefill_chunk=8))

    def plan(self, seed, *specs):
        return self.f.FaultPlan(seed=seed,
                                specs=[self.f.FaultSpec(*s) for s in specs])


@pytest.fixture(scope="module")
def pkgs():
    paddle.seed(11)
    jm = JaxLlama(JaxConfig.tiny(num_hidden_layers=1))
    tm = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1),
                          device="cpu")
    load_jax_state(tm, state_from_jax_layer(jm))
    return (_Pkg("jax", jserving, jrecovery, jfaults, jm),
            _Pkg("torch", tserving, trecovery, tfaults, tm, device="cpu"))


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n,)).astype(
        np.int32)


def _ref(pkgs, prompt, n):
    tm = pkgs[1].model
    return tm.generate(np.asarray(prompt)[None], max_new_tokens=n,
                       temperature=0.0, max_length=32).tolist()[0]


def _fresh_rid_base():
    return max(jserving.Request._counter[0],
               tserving.Request._counter[0]) + 1


def _sync_rids(base=None):
    """Both packages' rid counters at ``base`` (default: a fresh value):
    the cases create the same requests in the same order, so the rids
    (and the fault sites' ``rid:<id>`` details) agree."""
    if base is None:
        base = _fresh_rid_base()
    jserving.Request._counter[0] = tserving.Request._counter[0] = base


def _records(pkg, path, sampled=()):
    """The journal's records without timing fields; sampled streams'
    token lists by length only (the two packages' draws differ)."""
    out = []
    for rec in pkg.r.RequestJournal.load(path):
        rec = {k: v for k, v in rec.items() if k not in TIMING}
        if rec["k"] == "prog" and rec["rid"] in sampled:
            rec["toks"] = len(rec["toks"])
        out.append(rec)
    return out


def _both(pkgs, case, tmp_path):
    """``case(pkg, dir)`` for each package from the same rids."""
    out = []
    base = _fresh_rid_base()
    for pkg in pkgs:
        _sync_rids(base)
        d = tmp_path / pkg.name
        d.mkdir()
        out.append(case(pkg, d))
    return out


# ---------------------------------------------------------------------------
# the eight cases of tests/test_serving_recovery.py, through both packages
# ---------------------------------------------------------------------------

def test_priority_orders_queue_fifo_within_class(pkgs, tmp_path):
    def case(pkg, d):
        e = pkg.engine(max_batch=1, max_len=32, page_size=8)
        R = pkg.s.Request
        reqs = [R(_prompt(4, 200 + i), max_new_tokens=2, priority=pr)
                for i, pr in enumerate([R.PRIORITY_LOW, R.PRIORITY_HIGH,
                                        R.PRIORITY_NORMAL, R.PRIORITY_HIGH])]
        for r in reqs:
            e.add_request(r)
        assert [r.rid for r in e._queue] == [reqs[1].rid, reqs[3].rid,
                                             reqs[2].rid, reqs[0].rid]
        e.run_until_done(max_steps=200)
        return [r.rid for r in e._queue], [list(r.tokens) for r in reqs]

    j, t = _both(pkgs, case, tmp_path)
    assert t == j


def test_shed_infeasible_at_submit_survivors_byte_identical(pkgs, tmp_path):
    pa, pb = _prompt(6, 211), _prompt(6, 212)
    refs = [_ref(pkgs, pa, 8), _ref(pkgs, pb, 8)]

    def case(pkg, d):
        e = pkg.engine(max_batch=2, max_len=32, page_size=8, block_size=2)
        R = pkg.s.Request
        e.add_request(R(_prompt(4, 210), max_new_tokens=2))
        e.run_until_done(max_steps=200)         # measures the decode rate
        ra = R(pa, max_new_tokens=8, seed=3)
        rb = R(pb, max_new_tokens=8, seed=4)
        e.add_request(ra)
        e.add_request(rb)
        e.step()                                # survivors decoding
        doomed = R(_prompt(6, 213), max_new_tokens=16, deadline_s=1e-3)
        with pytest.raises(pkg.s.RequestShed, match="PT-SRV-003"):
            e.add_request(doomed)
        # shed BEFORE touching engine state
        assert doomed._n_out == 0
        assert doomed.rid not in [r.rid for r in e._queue]
        assert doomed.rid not in [r.rid for r in e._slots if r is not None]
        e.run_until_done(max_steps=300)
        return e.stats["shed"], [list(ra.tokens), list(rb.tokens)]

    j, t = _both(pkgs, case, tmp_path)
    assert t == j == (1, refs)


def test_resume_submit_never_shed(pkgs, tmp_path):
    def case(pkg, d):
        def build():
            return pkg.engine(max_batch=2, max_len=32, page_size=8,
                              block_size=2, max_queue=1)

        sup = pkg.r.ServingSupervisor(build, str(d / "j.jrnl"))
        R = pkg.s.Request
        sup.submit(R(_prompt(4, 240), max_new_tokens=2))
        sup.run_until_done(max_steps=200)       # arms the decode-rate EMA
        doomed_kw = dict(max_new_tokens=16, deadline_s=1e-3)
        with pytest.raises(pkg.s.RequestShed):
            sup.submit(R(_prompt(6, 241), **doomed_kw))
        rescued = R(_prompt(6, 242), **doomed_kw)
        sup.submit(rescued, resume=True)        # a rescued one admits
        assert rescued.rid in sup._live
        assert sup.engine.shed_infeasible and sup.engine.max_queue == 1
        sup.run_until_done(max_steps=300)
        sup.close()
        return sup.stats["shed"], _records(pkg, str(d / "j.jrnl"))

    j, t = _both(pkgs, case, tmp_path)
    # the rescued request may deadline out later on either side (its own
    # fate, timed by each host): compare up to its first terminal record
    cut = [next(i for i, r in enumerate(recs) if r["k"] == "admit"
                and r["deadline_s"] is not None) for _, recs in (j, t)]
    assert t[0] == j[0] == 1
    assert t[1][:cut[1] + 1] == j[1][:cut[0] + 1]


def test_crash_recovery_bit_identical_greedy_and_seeded(pkgs, tmp_path):
    """``serving.step`` kill mid-decode: the supervisor rebuilds from the
    journal (fresh pool, empty radix) and the recovered streams, greedy and
    seeded, equal the uninterrupted run of the same package."""
    pa, pb = _prompt(8, 220), _prompt(6, 221)

    def case(pkg, d):
        R = pkg.s.Request

        def wave():
            return [R(pa, max_new_tokens=6, seed=70),
                    R(pb, max_new_tokens=10, temperature=0.9, seed=71)]

        ref_eng = pkg.prefix()
        refs = wave()
        for r in refs:
            ref_eng.add_request(r)
        ref_eng.run_until_done(max_steps=300)
        plan = pkg.plan(5, ("serving.step", "kill", 2, 1))
        sup = pkg.r.ServingSupervisor(pkg.prefix, str(d / "j.jrnl"))
        reqs = wave()
        with plan:
            for r in reqs:
                sup.submit(r)
            done = sup.run_until_done(max_steps=300)
        sup.close()
        assert plan.log, "serving.step kill never fired"
        assert set(done) == {r.rid for r in reqs}
        for got, want in zip(reqs, refs):
            assert got.done and not got.failed
            assert list(got.tokens) == list(want.tokens)
        return dict(greedy=list(reqs[0].tokens), log=plan.log,
                    codes=[c for c, _ in sup.events],
                    recoveries=sup.recoveries,
                    replayed=sup.stats["replayed_requests"],
                    records=_records(pkg, str(d / "j.jrnl"),
                                     sampled={reqs[1].rid}))

    j, t = _both(pkgs, case, tmp_path)
    assert t == j
    assert t["codes"] == ["PT-SRV-001"] and t["recoveries"] == 1
    kinds = [r["k"] for r in t["records"]]
    assert "crash" in kinds and "recovered" in kinds
    assert kinds.count("fin") == 2


def test_journal_restart_replays_with_backpressure_in_flight(pkgs,
                                                             tmp_path):
    prompts = [_prompt(24, 230), _prompt(24, 231), _prompt(6, 232),
               _prompt(6, 233)]
    refs = [_ref(pkgs, p, 4) for p in prompts[:3]]

    def case(pkg, d):
        path = str(d / "j.jrnl")
        R = pkg.s.Request

        def build():
            return pkg.prefix(max_queue=1)

        sup1 = pkg.r.ServingSupervisor(build, path)
        r0 = R(prompts[0], max_new_tokens=4)
        sup1.submit(r0)
        sup1.step()                             # slot 0: chunk 1 of 3
        r1 = R(prompts[1], max_new_tokens=4)
        sup1.submit(r1)
        sup1.step()                             # slot 1: chunk 1 of 3
        assert len(sup1.engine._prefill_next) == 2
        r2 = R(prompts[2], max_new_tokens=4)
        sup1.submit(r2)                         # queued (high-water mark)
        with pytest.raises(pkg.s.EngineSaturated):
            sup1.submit(R(prompts[3], max_new_tokens=4))
        rids = [r0.rid, r1.rid, r2.rid]
        sup1.step()
        sup1.close()                            # "process death" mid-flight
        sup2 = pkg.r.ServingSupervisor(build, path)
        assert sorted(sup2.requests) == sorted(rids)
        sup2.run_until_done(max_steps=500)
        sup2.close()
        outs = []
        for rid in rids:
            req = sup2.requests[rid]
            assert req.done and not req.failed
            outs.append(list(req.tokens))
        return dict(outs=outs, codes=[c for c, _ in sup2.events],
                    replayed=sup2.stats["replayed_requests"],
                    records=_records(pkg, path))

    j, t = _both(pkgs, case, tmp_path)
    assert t == j
    assert t["outs"] == refs
    kinds = [r["k"] for r in t["records"]]
    assert "recovered" in kinds and kinds.count("admit") == 3


def test_replay_deadline_eviction_is_not_divergence(pkgs, tmp_path):
    def case(pkg, d):
        sup = pkg.r.ServingSupervisor(pkg.prefix, str(d / "j.jrnl"))
        req = pkg.s.Request(_prompt(8, 240), max_new_tokens=8,
                            deadline_s=60.0)
        sup.submit(req)
        while req._n_out < 2:                   # deliver past the mark
            sup.step()
        sup._meta[req.rid]["deadline_s"] = 1e-3
        plan = pkg.plan(9, ("serving.step", "kill", 0, 1))
        with plan:
            done = sup.run_until_done(max_steps=300)
        sup.close()
        assert req.rid in done and req.failed
        assert "deadline" in (req.error or "")
        return dict(codes=[c for c, _ in sup.events], log=plan.log,
                    recoveries=sup.recoveries, out=list(req.output),
                    records=_records(pkg, str(d / "j.jrnl")))

    j, t = _both(pkgs, case, tmp_path)
    assert t == j
    assert t["codes"] == ["PT-SRV-001"]         # no PT-SRV-005


def test_brownout_enters_serves_legacy_exits_hysteretically(pkgs, tmp_path):
    pa = _prompt(8, 240)                        # exactly one full page
    ref9, ref8 = _ref(pkgs, pa, 9), _ref(pkgs, pa, 8)

    def case(pkg, d):
        e = pkg.engine(max_batch=2, max_len=32, page_size=8, block_size=2,
                       prefix_cache=pkg.s.PrefixCacheConfig(prefill_chunk=8),
                       brownout=pkg.s.BrownoutConfig(
                           enter_after=2, exit_free_frac=0.5, exit_after=2))
        R = pkg.s.Request
        ra = R(pa, max_new_tokens=8)
        e.add_request(ra)
        e.run_until_done(max_steps=200)
        assert e._radix.match(pa)
        e._alloc.hold(e._alloc.free_blocks)     # pool exhausted
        rb = R(pa, max_new_tokens=9)
        e.add_request(rb)
        hits0 = e.stats["hit_tokens"]
        for _ in range(3):
            e.step()
        assert e._brownout_active and e.stats["brownouts"] == 1
        assert not e._radix.match(pa)
        assert rb._n_out == 0
        e._alloc.release_held()
        e.run_until_done(max_steps=300)
        assert e.stats["hit_tokens"] == hits0
        for _ in range(4):
            e.step()
        assert not e._brownout_active
        rc = R(pa, max_new_tokens=8)
        e.add_request(rc)
        e.run_until_done(max_steps=200)
        rd = R(pa, max_new_tokens=8)
        e.add_request(rd)
        e.run_until_done(max_steps=200)
        assert e.stats["hit_tokens"] > hits0
        return ([list(r.tokens) for r in (ra, rb, rc, rd)],
                {k: e.stats[k] for k in ("brownouts", "brownout_steps",
                                         "hit_tokens", "miss_tokens")})

    j, t = _both(pkgs, case, tmp_path)
    assert t == j
    assert t[0] == [ref8, ref9, ref8, ref8]


def test_stall_watchdog_triggers_rebuild_streams_identical(pkgs, tmp_path):
    prompts = [_prompt(6, 250), _prompt(6, 251)]

    def case(pkg, d):
        def build():
            return pkg.engine(max_batch=2, max_len=32, page_size=8,
                              block_size=2)

        sup = pkg.r.ServingSupervisor(build, str(d / "j.jrnl"))

        def wave():
            reqs = [pkg.s.Request(p, max_new_tokens=8, seed=80 + i)
                    for i, p in enumerate(prompts)]
            for r in reqs:
                sup.submit(r)
            return reqs

        warm = wave()
        sup.run_until_done(max_steps=200)
        refs = [list(r.tokens) for r in warm]
        sup.set_step_budget(0.6)
        plan = pkg.plan(6, ("serving.stall", "stall", 2, 1, 1.5))
        reqs = wave()
        with plan, warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            sup.run_until_done(max_steps=200)
        sup.close()
        assert [list(r.tokens) for r in reqs] == refs
        return dict(refs=refs, log=plan.log,
                    codes=[c for c, _ in sup.events],
                    recoveries=sup.recoveries,
                    replayed=sup.stats["replayed_requests"],
                    records=_records(pkg, str(d / "j.jrnl")))

    j, t = _both(pkgs, case, tmp_path)
    assert t == j
    assert t["codes"] == ["PT-SRV-002"]


# ---------------------------------------------------------------------------
# the journal, across the two packages
# ---------------------------------------------------------------------------

RECORDS = [
    ("admit", dict(rid=1, prompt=[3, 4], max_new=4, eos=None, temp=0.0,
                   top_p=1.0, top_k=0, seed=1, deadline_s=None, priority=1,
                   tenant=None)),
    ("prog", dict(rid=1, hwm=2, toks=[7, 8])),
    ("admit", dict(rid=2, prompt=[5], max_new=2, eos=7, temp=0.9,
                   top_p=0.95, top_k=5, seed=2, deadline_s=2.5, priority=0,
                   tenant="tenant-ä")),
    ("crash", dict(code="PT-SRV-001", msg="engine step raised — é \"q\"")),
    ("prog", dict(rid=1, hwm=3, toks=[9])),
    ("recovered", dict(code="PT-SRV-001", n=2, seconds=0.012345)),
    ("fin", dict(rid=2, failed=False)),
    ("migr", dict(rid=3)),
    ("shed", dict(rid=4)),
]


def _write(journal_cls, path):
    j = journal_cls(path)
    for kind, fields in RECORDS[:3]:
        j.append(kind, **fields)
    for kind, fields in RECORDS[3:]:
        j.defer(kind, **fields)
    j.flush()
    j.close()


def test_journal_lines_byte_identical_to_jax(tmp_path):
    jp, tp = str(tmp_path / "j.jrnl"), str(tmp_path / "t.jrnl")
    _write(jrecovery.RequestJournal, jp)
    _write(trecovery.RequestJournal, tp)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    recs = trecovery.RequestJournal.load(jp)
    assert recs == jrecovery.RequestJournal.load(tp)
    assert [r["k"] for r in recs] == [k for k, _ in RECORDS]
    j2 = trecovery.RequestJournal(jp)
    assert [r["rid"] for r in j2.unfinished()] == [1]
    assert j2.delivered(1) == [7, 8, 9]
    assert trecovery.RequestJournal.pending(recs) == \
        jrecovery.RequestJournal.pending(recs)
    j2.close()


def test_journal_torn_tail_truncated(tmp_path):
    p = str(tmp_path / "j.jrnl")
    j = trecovery.RequestJournal(p)
    j.append("admit", **RECORDS[0][1])
    j.close()
    with open(p, "ab") as f:                    # crash mid-append
        f.write(b"deadbeef {\"k\": \"pro")
    assert [r["k"] for r in jrecovery.RequestJournal.load(p)] == ["admit"]
    j2 = trecovery.RequestJournal(p)            # tolerated + truncated
    assert [r["k"] for r in j2.records] == ["admit"]
    j2.append("fin", rid=1, failed=False)
    j2.close()
    assert [r["k"] for r in trecovery.RequestJournal.load(p)] == \
        ["admit", "fin"]
    # an abandoned journal loses its deferred records, never flushed ones
    j3 = trecovery.RequestJournal(p)
    j3.defer("prog", rid=1, hwm=1, toks=[5])
    j3.abandon()
    assert [r["k"] for r in trecovery.RequestJournal.load(p)] == \
        ["admit", "fin"]


@pytest.mark.parametrize("damage", ["crc", "blank"])
def test_journal_midfile_damage_raises(tmp_path, damage):
    p = str(tmp_path / "j.jrnl")
    _write(trecovery.RequestJournal, p)
    raw = open(p, "rb").read()
    if damage == "crc":
        raw = bytearray(raw)
        raw[12] ^= 0xFF                         # damage the FIRST record
        raw = bytes(raw)
        match = "PT-SRV-004"
    else:
        first, rest = raw.split(b"\n", 1)
        raw = first + b"\n\n" + rest
        match = "blank"
    open(p, "wb").write(raw)
    for cls in (trecovery.RequestJournal, jrecovery.RequestJournal):
        with pytest.raises(cls.__module__.startswith("paddle_tpu_torch")
                           and trecovery.JournalCorrupt
                           or jrecovery.JournalCorrupt, match=match):
            cls.load(p)
    with pytest.raises(trecovery.JournalCorrupt):
        trecovery.RequestJournal(p)             # never appends past damage


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_cross_package_restart(pkgs, tmp_path, direction):
    """A supervisor of one package runs a greedy wave part way and dies
    (``abandon()``: deferred records lost); a supervisor of the other
    package over the same journal replays it to the same streams, and
    nothing delivered is delivered twice. Greedy only: sampled draws
    differ between the packages, so a cross-package replay of a sampled
    stream is PT-SRV-005 by design."""
    src, dst = pkgs if direction == "jax_to_torch" else pkgs[::-1]
    prompts = [_prompt(24, 260), _prompt(6, 261), _prompt(12, 262)]
    news = [5, 7, 6]
    refs = [_ref(pkgs, p, n) for p, n in zip(prompts, news)]
    path = str(tmp_path / "j.jrnl")
    _sync_rids()
    sup = src.r.ServingSupervisor(src.prefix, path)
    reqs = [src.s.Request(p, max_new_tokens=n)
            for p, n in zip(prompts, news)]
    for r in reqs:
        sup.submit(r)
    for _ in range(3):
        sup.step()
    delivered = {r.rid: list(r.output) for r in reqs}
    assert any(delivered.values()) and not all(r.done for r in reqs)
    sup.abandon()
    sup2 = dst.r.ServingSupervisor(dst.prefix, path)
    assert sorted(sup2.requests) == sorted(
        r.rid for r in reqs if not r.done)
    for rid, user in sup2.requests.items():
        assert user.output == delivered[rid]    # the journaled prefix
    sup2.run_until_done(max_steps=500)
    sup2.close()
    for r, want in zip(reqs, refs):
        got = sup2.requests.get(r.rid, r)
        assert got.done and not got.failed and list(got.output) == want
    assert [c for c, _ in sup2.events] == ["PT-SRV-001"]
    recs = dst.r.RequestJournal.load(path)
    for r in reqs:                              # each token journaled once
        toks = [t for rec in recs if rec["k"] == "prog"
                and rec["rid"] == r.rid for t in rec["toks"]]
        assert toks == refs[reqs.index(r)]


# ---------------------------------------------------------------------------
# the port's own contracts
# ---------------------------------------------------------------------------

class _Watched(list):
    """A caller's output list that checks the flush barrier: every token
    extended into it is already in the journal on disk."""

    def __init__(self, path, rid):
        super().__init__()
        self.path, self.rid = path, rid
        self.checked = 0

    def extend(self, toks):
        toks = list(toks)
        on_disk = [t for r in trecovery.RequestJournal.load(self.path)
                   if r["k"] == "prog" and r["rid"] == self.rid
                   for t in r["toks"]]
        assert on_disk[:len(self) + len(toks)] == list(self) + toks
        self.checked += len(toks)
        super().extend(toks)


def test_flush_barrier_and_old_engine_freed(pkgs, tmp_path):
    """No token reaches a caller's Request before its ``prog`` record is on
    disk, across a crash replay; the crashed engine is freed by reference
    counting once the recovery returns (no cycle keeps its pools or, on
    the card, its captured graph alive)."""
    pkg = pkgs[1]
    path = str(tmp_path / "j.jrnl")
    engines = []

    def build():
        e = pkg.engine(max_batch=2, max_len=32, page_size=8, block_size=2,
                       fused=True, prefix_cache=pkg.s.PrefixCacheConfig(
                           prefill_chunk=8))
        engines.append(weakref.ref(e))
        return e

    sup = trecovery.ServingSupervisor(build, path)
    reqs = [pkg.s.Request(_prompt(n, 270 + n), max_new_tokens=k)
            for n, k in ((6, 9), (10, 7), (8, 12))]
    for r in reqs:
        r.output = _Watched(path, r.rid)
        sup.submit(r)
    gc.disable()
    try:
        with pkg.plan(1, ("serving.step", "kill", 3, 1)):
            sup.run_until_done(max_steps=300)
        assert sup.recoveries == 1 and len(engines) == 2
        assert engines[0]() is None             # freed without the gc
    finally:
        gc.enable()
    sup.close()
    for r in reqs:
        assert r.done and not r.failed
        assert r.output.checked == r.max_new_tokens
        assert list(r.output) == _ref(pkgs, r.prompt, r.max_new_tokens)


def test_tenant_carried_across_restart(pkgs, tmp_path):
    pkg = pkgs[1]
    path = str(tmp_path / "j.jrnl")
    sup = trecovery.ServingSupervisor(pkg.prefix, path)
    r = pkg.s.Request(_prompt(6, 280), max_new_tokens=6, tenant="acme")
    assert r.tenant == "acme"
    assert pkg.s.Request(_prompt(2, 0)).tenant is None
    sup.submit(r)
    sup.step()
    sup.abandon()
    admit = [x for x in trecovery.RequestJournal.load(path)
             if x["k"] == "admit"][0]
    assert admit["tenant"] == "acme"
    sup2 = trecovery.ServingSupervisor(pkg.prefix, path)
    assert sup2.requests[r.rid].tenant == "acme"
    sup2.run_until_done(max_steps=200)
    sup2.close()


def test_later_slices_refused(pkgs, tmp_path):
    pkg = pkgs[1]
    from paddle_tpu_torch.observability import TraceRecorder
    # tracing is ported: the supervisor attaches its recorder and tags to
    # the engine it builds
    tr = TraceRecorder()
    sup = trecovery.ServingSupervisor(pkg.prefix, str(tmp_path / "a"),
                                      tracer=tr, trace_tags={"replica": 0})
    assert sup.engine.tracer is tr
    assert sup.engine.trace_tags == {"replica": 0}
    sup.close()
    sup = trecovery.ServingSupervisor(pkg.prefix, str(tmp_path / "c"))

    def lose():
        raise pkg.s.MeshDegraded("PT-SRV-008: lost", lost=1, survivors=1)

    sup.engine.step = lose
    with pytest.raises(NotImplementedError, match="tp-sharded"):
        sup.step()
    sup.elastic = False                         # the control arm escapes
    with pytest.raises(pkg.s.MeshDegraded):
        sup.step()
    sup.close()
    e = pkg.s.MeshDegraded("x", lost=3, survivors=-1)
    assert (e.lost, e.survivors) == (3, 0)


def test_engine_fault_sites_fire_like_jax(pkgs, tmp_path):
    """The engine's step sites and the admission hold consult the plan in
    the JAX engine's order, with its details; an ``exhaust`` at admission
    defers the request until the held blocks are released."""
    def case(pkg, d):
        e = pkg.prefix()
        plan = pkg.plan(0, ("serving.stall", "delay", 0, -1),
                        ("serving.step", "delay", 1, 2),
                        ("device.loss", "lose", 2, 1, 1.0),
                        ("serving.block_pool", "exhaust", 1, 1, 64.0))
        reqs = [pkg.s.Request(_prompt(6, 290 + i), max_new_tokens=4)
                for i in range(3)]
        with plan:
            for r in reqs:
                e.add_request(r)
            for _ in range(3):
                e.step()
            held_queue = len(e._queue)
            e._alloc.release_held()
            e.run_until_done(max_steps=100)
        assert e._step_idx == len([x for x in plan.log
                                   if x[0] == "serving.stall"])
        return dict(log=plan.log, held_queue=held_queue,
                    rids=[r.rid for r in reqs],
                    outs=[list(r.tokens) for r in reqs])

    j, t = _both(pkgs, case, tmp_path)
    assert t == j
    # the hold fires at the second admission, which defers until release
    assert [x for x in t["log"] if x[0] == "serving.block_pool"] == [
        ("serving.block_pool", f"rid:{t['rids'][1]}", "exhaust")]
    assert t["held_queue"] == 1
    assert t["outs"] == [_ref(pkgs, _prompt(6, 290 + i), 4)
                         for i in range(3)]


def test_withdraw_queued(pkgs):
    pkg = pkgs[1]
    e = pkg.engine(max_batch=1, max_len=32, page_size=8)
    a = pkg.s.Request(_prompt(4, 1), max_new_tokens=2)
    b = pkg.s.Request(_prompt(4, 2), max_new_tokens=2, deadline_s=60.0)
    e.add_request(a)
    e.add_request(b)
    assert e._n_deadlined == 1
    e.step()                                    # a is slotted, b queued
    assert not e.withdraw_queued(a.rid)         # active: not withdrawn
    assert e.withdraw_queued(b.rid)
    assert e._n_deadlined == 0 and not e._queue
    assert not e.withdraw_queued(b.rid)
    e.run_until_done(max_steps=50)
    assert a.done and not b.done


@pytest.mark.parametrize("kind", ["legacy", "prefix", "fused"])
def test_fixed_row_counts_keep_the_streams(pkgs, kind):
    """On the card every prefill, first-token and re-step call carries a
    fixed row count (``_fixed_rows``: parked rows, or copies of the first
    row on the legacy engine's re-step), so a prompt's bytes do not depend
    on what was admitted beside it. Forced on here, on the CPU, the
    streams equal the default engine's and the JAX engine's."""
    jax_pkg, pkg = pkgs
    kw = dict(max_batch=4, max_len=32, page_size=8, block_size=2)
    if kind == "legacy":
        kw.update(prompt_buckets=[8, 16, 32])    # exact and re-stepped rows
    else:
        # pack_rows 2: a fused pack of more rows runs as several calls
        kw.update(prefix_cache=pkg.s.PrefixCacheConfig(prefill_chunk=8,
                                                       pack_rows=2),
                  fused=kind == "fused")
    prompts = [_prompt(n, 310 + n) for n in (5, 8, 13, 16, 3, 11, 28, 30)]
    news = [6, 4, 3, 5, 8, 3, 4, 2]

    def serve(eng, R):
        reqs = [R(p, max_new_tokens=k) for p, k in zip(prompts, news)]
        for r in reqs[:3]:
            eng.add_request(r)
        eng.step()
        for r in reqs[3:]:
            eng.add_request(r)
        eng.run_until_done(max_steps=300)
        return [list(r.tokens) for r in reqs]

    want = serve(pkg.engine(**kw), pkg.s.Request)
    fixed = pkg.engine(**kw)
    fixed._fixed_rows = True
    assert serve(fixed, pkg.s.Request) == want
    jkw = dict(kw)
    if kind != "legacy":
        jkw["prefix_cache"] = jax_pkg.s.PrefixCacheConfig(prefill_chunk=8,
                                                          pack_rows=2)
    assert serve(jax_pkg.engine(**jkw), jax_pkg.s.Request) == want
    if kind != "legacy":
        assert fixed._first_token_group(1) == 4
    if kind == "fused":
        assert fixed._pack_group(1) == fixed._pack_group(20) == 2
        assert fixed.stats["prefill_groups"] >= fixed.stats["packed_rows"] / 2
