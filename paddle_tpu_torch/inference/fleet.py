"""Fleet-level serving: a replica router over journaled engine
supervisors — port of ``paddle_tpu/inference/fleet.py``.

:class:`FleetRouter` manages N :class:`~paddle_tpu_torch.inference.
recovery.ServingSupervisor`-wrapped replicas and makes them behave like one
reliable engine:

- **Routing** — radix-cache affinity: the router remembers which replica
  holds each prompt's page-aligned prefix chain and routes same-prefix
  sessions there, UNLESS that replica is ``queue_slack`` deeper than the
  best candidate. Everything else goes to the least-loaded replica
  (deterministic rid-based tie-break). A replica refusing admission falls
  through to the next candidate before the refusal reaches the caller.
- **Failover** (PT-FLT-001) — a replica death (an exception escaping its
  supervisor, a ``fleet.replica_kill`` fault, or heartbeat staleness) is
  absorbed by re-admitting the dead replica's unfinished requests on
  survivors, read from its ON-DISK journal. The survivor regenerates each
  delivered prefix, verifies it byte for byte and streams on.
- **Rolling drain/restart** (PT-FLT-002) — ``drain(i)`` stops routing to a
  replica, migrates its still-QUEUED requests (journaled ``migr``), lets
  in-flight slots finish in place, then rebuilds it with a fresh journal
  generation; ``rolling_restart()`` walks the fleet.
- **Fleet brownout/shedding** (PT-FLT-003/004) — when EVERY alive replica
  sits at depth the fleet sheds sheddable-priority requests at submit
  (hysteretic exit); ``add_replica``/``retire_replica``/``force_brownout``
  are the autoscaler's hooks (PT-FLT-005).

Replicas of one process share its card. Failover here covers host-side
faults (a crash, a stall, a wedge): a real CUDA fault poisons the context
of every in-process replica, and surviving it takes one process per
replica (the process fleet, a later slice). ``parallel_step=True`` steps
replicas in threads; the engines' device work is serialized per process
(``serving._DEVICE_LOCK``), so a replica rebuilding (and capturing its
CUDA graph) in one thread never races another replica's step.

``tracer=`` takes ONE ``TraceRecorder`` across the fleet: every
supervisor and engine stamps with ``trace_tags={"replica": idx}`` (pid =
replica in the chrome trace), a failed-over request's spans continue in
the same lane after a ``failover`` edge (from, to), a fleet brownout shed
is stamped before any replica sees the request, and a request lost with
its replica gets its terminal (or a ``request_lost`` instant).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import re
import threading
import time
from typing import Callable, Dict, List, Optional, Set

from ..distributed.resilience.faults import FaultInjected, maybe_inject
from .recovery import RequestJournal, ServingSupervisor, _request_from
from .serving import (ContinuousBatchingEngine, EngineSaturated, Request,
                      RequestShed)

__all__ = ["FleetConfig", "FleetRouter", "ReplicaState"]


class ReplicaState:
    ALIVE = "alive"
    DRAINING = "draining"
    DEAD = "dead"
    #: drained and REMOVED from service (autoscaler scale-in): unlike DEAD
    #: there is no work to rescue and no respawn — the slot is simply gone
    RETIRED = "retired"


#: states excluded from routing, stepping, load and completion accounting
_GONE = (ReplicaState.DEAD, ReplicaState.RETIRED)


@dataclasses.dataclass
class FleetConfig:
    """Router knobs (:class:`FleetRouter`).

    - ``affinity``: route same-prefix sessions to the replica whose radix
      cache holds the blocks (off = pure load spread).
    - ``queue_slack``: affinity yields to balance once the warm replica is
      this many requests deeper than the least-loaded one.
    - ``heartbeat_ttl_s``: a replica that still has work but whose
      PROGRESS marker (scheduled tokens + completions) has not advanced
      for this long is declared dead. The supervisor's step watchdog
      catches a step that HANGS; this heartbeat catches the wedge it
      cannot — steps that keep returning without moving any stream
      forward (e.g. a pool wedged behind a stuck admission, every slot
      deferring forever).
    - ``brownout_depth``: per-replica load (queued+slotted) that counts as
      pressure; default = the engine's ``max_queue`` (or ``2*max_batch``
      when unbounded).
    - ``brownout_enter_after`` / ``brownout_exit_after``: hysteresis, in
      consecutive pressure(-free) events.
    - ``shed_priority``: minimum ``Request.priority`` value shed during
      fleet brownout (default: LOW traffic sheds, interactive survives).
    - ``prefix_map_cap``: bound on remembered prefix chains (oldest drop).
    - ``parallel_step``: step replicas in threads. The engines' device
      work is serialized per process (one card), so the threads overlap
      host work only; keep False for deterministic drills/tests.
    """

    affinity: bool = True
    queue_slack: int = 2
    heartbeat_ttl_s: float = 60.0
    brownout_depth: Optional[int] = None
    brownout_enter_after: int = 2
    brownout_exit_after: int = 4
    shed_priority: int = Request.PRIORITY_LOW
    prefix_map_cap: int = 4096
    parallel_step: bool = False


class _Replica:
    def __init__(self, idx: int, sup: ServingSupervisor, journal_path: str,
                 gen: int = 0, tier: str = "serving"):
        self.idx = idx
        self.sup = sup
        self.journal_path = journal_path
        self.state = ReplicaState.ALIVE
        self.gen = gen
        self.tier = tier                # "serving" | "prefill" | "decode"
        self.retiring = False           # drain completes into RETIRED
        self.progress = None            # supervisor progress marker
        self.last_progress_t = time.monotonic()


class FleetRouter:
    """N supervisor-wrapped engine replicas behaving like one reliable
    engine (module docstring).

    >>> fleet = FleetRouter(build_engine, fleet_dir, num_replicas=3)
    >>> fleet.submit(Request(prompt, max_new_tokens=64))
    >>> done = fleet.run_until_done()

    ``failover=False`` is the drill's control arm: a replica death marks
    its in-flight requests failed instead of re-admitting them.
    ``graceful_drain=False`` models a deployment that restarts replicas
    WITHOUT draining: the drain signal becomes a hard kill (state
    discarded, no migration) followed by a cold respawn.
    """

    def __init__(self, build_engine: Callable[[], ContinuousBatchingEngine],
                 fleet_dir: str, num_replicas: int = 2,
                 step_budget_s: Optional[float] = None,
                 max_recoveries: int = 2, failover: bool = True,
                 graceful_drain: bool = True,
                 config: Optional[FleetConfig] = None, fsync: bool = False,
                 tracer=None):
        if num_replicas < 1:
            raise ValueError("num_replicas must be >= 1")
        self._build = build_engine
        self.fleet_dir = fleet_dir
        os.makedirs(fleet_dir, exist_ok=True)
        self.config = config or FleetConfig()
        self.failover = bool(failover)
        self.graceful_drain = bool(graceful_drain)
        self.tracer = tracer
        self._sup_kw = dict(step_budget_s=step_budget_s,
                            max_recoveries=max_recoveries, fsync=fsync)
        self.stats = {"submitted": 0, "fleet_shed": 0, "replica_deaths": 0,
                      "failovers": 0, "failover_s": 0.0,
                      "failover_requests": 0, "drains": 0, "migrated": 0,
                      "restarts": 0, "brownouts": 0, "affinity_hits": 0,
                      "replicas_added": 0, "replicas_retired": 0}
        self.events: List[tuple] = []                # (code, message)
        self.replicas: List[_Replica] = []
        try:
            for i in range(num_replicas):
                # restart over an existing fleet_dir: resume each
                # replica's LATEST generation — rolling restarts leave
                # g1/g2/... journals and replaying a superseded g0 would
                # lose the newer work
                gen = self._latest_gen(i)
                path = os.path.join(fleet_dir, f"replica{i}.g{gen}.jrnl")
                self.replicas.append(_Replica(
                    i, self._make_sup(i, path), path, gen=gen,
                    tier=self.tier_of(i)))
        except Exception:
            # a replica that failed to build must not strand the ones
            # already built
            for rep in self.replicas:
                try:
                    rep.sup.abandon()
                except Exception:  # noqa: BLE001 — best-effort teardown
                    pass
            raise
        self.requests: Dict[int, Request] = {}
        self._assigned: Dict[int, int] = {}          # rid -> replica idx
        self._returned: Set[int] = set()
        self._prefix_map: Dict[bytes, int] = {}      # chain digest -> idx
        self._step_idx = 0
        self._brownout_active = False
        self._pressure_events = 0
        self._clear_events = 0
        self._brownout_forced = False

    def _trace_lost(self, rid: int, user: Request, replica: int) -> None:
        """Terminal stamp for a lost request. The engine may have
        terminal'd the rid in the very step its replica died (twin
        finished, result never spliced): a second terminal would break the
        one-terminal invariant, so that case records a non-terminal
        ``request_lost`` event instead."""
        if self.tracer is None:
            return
        if self.tracer.is_open(rid):
            self.tracer.finish(rid, len(user.output), failed=True,
                               error=user.error, kind="fail",
                               tags={"replica": replica})
        else:
            self.tracer.instant("request_lost", rid,
                                tags={"replica": replica},
                                error=(user.error or "")[:200])

    def _make_sup(self, idx: int, path: str):
        """Build the replica-``idx`` supervisor over journal ``path`` — the
        ONE construction point (initial fleet, ``_respawn``,
        ``add_replica``); the router consumes only the replica surface
        (submit/step/finished/load/progress/withdraw/behind/close/abandon
        + ``.engine`` geometry)."""
        return ServingSupervisor(self._builder(idx), path,
                                 **self._rep_kw(idx))

    def _builder(self, idx: int) -> Callable[[], ContinuousBatchingEngine]:
        """Engine factory for replica ``idx`` — one homogeneous fleet
        (a tiered router overrides it with per-tier factories)."""
        return self._build

    def tier_of(self, idx: int) -> str:
        """Tier label for replica ``idx`` (``"serving"`` in a flat
        fleet)."""
        return "serving"

    def _rep_kw(self, idx: int) -> dict:
        kw = dict(self._sup_kw)
        if self.tracer is not None:
            kw.update(tracer=self.tracer, trace_tags={"replica": idx})
        return kw

    def _latest_gen(self, idx: int) -> int:
        best = 0
        pat = re.compile(rf"replica{idx}\.g(\d+)\.jrnl$")
        for name in os.listdir(self.fleet_dir):
            mm = pat.fullmatch(name)
            if mm:
                best = max(best, int(mm.group(1)))
        return best

    def _retire_journal(self, path: str, migrated: List[int],
                        failed: List[int]) -> None:
        """Mark rescued/lost rids in a dead replica's ON-DISK journal so a
        router restarted over this fleet_dir does not replay work that is
        now owned by survivors (``migr``) or was deliberately lost
        (``fin`` failed) — double service, not recovery."""
        if not (migrated or failed):
            return
        j = RequestJournal(path)
        try:
            for rid in migrated:
                j.defer("migr", rid=rid)
            for rid in failed:
                j.defer("fin", rid=rid, failed=True)
            j.flush()
        finally:
            j.close()

    # -- submission / routing ----------------------------------------------
    def submit(self, req: Request) -> int:
        """Route + admit. ``RequestShed``/``EngineSaturated`` reach the
        caller only once EVERY routable replica refused (or the fleet is
        in brownout and the request's class is sheddable)."""
        self._fleet_shed_check(req)
        candidates = self._route_order(req)
        if not candidates:
            raise EngineSaturated("fleet has no alive replica")
        last: Optional[Exception] = None
        for rep, warm in candidates:
            try:
                rep.sup.submit(req)
            except (EngineSaturated, RequestShed) as e:
                last = e
                continue
            self.stats["submitted"] += 1
            if warm:
                self.stats["affinity_hits"] += 1
            self.requests[req.rid] = req
            self._assigned[req.rid] = rep.idx
            self._register_prefix(req.prompt, rep.idx)
            # sustained all-replicas-full submission pressure counts toward
            # fleet brownout even between steps
            self._pressure_event(self._fleet_pressured())
            return req.rid
        self._pressure_event(True)
        raise last

    def _fleet_shed_check(self, req: Request) -> None:
        if (self._brownout_active
                and req.priority >= self.config.shed_priority):
            self.stats["fleet_shed"] += 1
            if self.tracer is not None:
                # shed before any replica saw it: the tracer books the
                # implicit submit so the lifecycle still closes (with the
                # tenant, so fleet sheds count against that tenant)
                self.tracer.shed(
                    req.rid,
                    tags=({"tenant": req.tenant} if req.tenant is not None
                          else None),
                    reason="fleet brownout")
            raise RequestShed(
                f"PT-FLT-003: fleet brownout — priority {req.priority} "
                f"request rid={req.rid} shed at submit (every replica at "
                "depth); retry later or raise the priority")

    def _routable(self, req: Request) -> List[_Replica]:
        """Replicas eligible to admit a NEW submission — the whole alive
        fleet."""
        return [r for r in self.replicas if r.state == ReplicaState.ALIVE]

    def _route_order(self, req: Request):
        """Candidate replicas, best first, as ``(replica, is_warm)``:
        affinity target (bounded by ``queue_slack``), then least-loaded
        with a deterministic rid-based tie-break so equal-load replicas
        share the traffic."""
        alive = self._routable(req)
        if not alive:
            return []
        loads = {r.idx: r.sup.load() for r in alive}
        n = len(alive)
        order = sorted(alive, key=lambda r: (loads[r.idx],
                                             (r.idx - req.rid) % n))
        warm_idx = None
        if self.config.affinity and not self._brownout_active:
            warm_idx = self._affinity_lookup(req.prompt)
        if warm_idx is not None:
            warm = next((r for r in alive if r.idx == warm_idx), None)
            if (warm is not None and loads[warm.idx]
                    <= loads[order[0].idx] + self.config.queue_slack):
                order = [warm] + [r for r in order if r is not warm]
                return [(r, r is warm) for r in order]
        return [(r, False) for r in order]

    def _chain_keys(self, prompt) -> List[bytes]:
        """One digest per full prompt page, each covering the whole prefix
        up to and including that page — computed with a single incremental
        hasher (O(pages), not O(pages^2))."""
        page = self.replicas[0].sup.engine.page_size
        n_full = len(prompt) // page
        if not n_full:
            return []
        raw = bytes(memoryview(prompt[: n_full * page]).cast("B"))
        bpp = page * prompt.itemsize
        h = hashlib.blake2b(digest_size=8)
        keys = []
        for k in range(n_full):
            h.update(raw[k * bpp:(k + 1) * bpp])
            keys.append(h.copy().digest())
        return keys

    def _register_prefix(self, prompt, idx: int) -> None:
        for key in self._chain_keys(prompt):
            self._prefix_map.pop(key, None)      # re-insert: newest-last
            self._prefix_map[key] = idx
        while len(self._prefix_map) > self.config.prefix_map_cap:
            self._prefix_map.pop(next(iter(self._prefix_map)))

    def _affinity_lookup(self, prompt) -> Optional[int]:
        best = None
        for key in self._chain_keys(prompt):
            idx = self._prefix_map.get(key)
            if idx is None:
                break
            best = idx
        return best

    def _drop_prefixes(self, idx: int) -> None:
        self._prefix_map = {k: v for k, v in self._prefix_map.items()
                            if v != idx}

    # -- stepping / health -------------------------------------------------
    def step(self) -> None:
        """One fleet tick: drain signals, one supervisor step per live
        replica, staleness checks, failover for the newly dead, drain
        completion, brownout hysteresis."""
        self._step_idx += 1
        for rep in self.replicas:
            if rep.state in _GONE:
                continue
            try:
                maybe_inject("fleet.drain",
                             f"replica:{rep.idx}:step:{self._step_idx}")
            except FaultInjected:
                self.drain(rep.idx)
        live = [r for r in self.replicas
                if r.state in (ReplicaState.ALIVE, ReplicaState.DRAINING)]
        died = self._step_all(live)
        now = time.monotonic()
        for rep in live:
            if rep.state == ReplicaState.DEAD or rep in died:
                continue
            try:
                sig = rep.sup.progress()
            except Exception as e:  # noqa: BLE001 — replica death boundary
                self._mark_dead(rep, f"progress probe failed: "
                                f"{type(e).__name__}: {e}")
                died.append(rep)
                continue
            if sig != rep.progress:
                rep.progress = sig
                rep.last_progress_t = now
            elif (rep.sup.has_work() and now - rep.last_progress_t
                    > self.config.heartbeat_ttl_s):
                self._mark_dead(
                    rep, "heartbeat stale: steps complete but no stream has "
                    f"advanced for {now - rep.last_progress_t:.1f}s "
                    f"(> ttl {self.config.heartbeat_ttl_s:.1f}s)")
                died.append(rep)
        for rep in died:
            self._handle_death(rep)
        for rep in self.replicas:
            if rep.state == ReplicaState.DRAINING and not rep.sup.has_work():
                self._finish_drain(rep)
        self._pressure_event(self._fleet_pressured())

    def _step_all(self, live: List[_Replica]) -> List[_Replica]:
        """Step every live replica; returns the ones that died doing it.
        ``parallel_step`` steps replicas in threads; death handling stays
        sequential after the join."""
        errs: Dict[int, Exception] = {}

        def one(rep: _Replica):
            try:
                maybe_inject("fleet.replica_kill",
                             f"replica:{rep.idx}:step:{self._step_idx}")
                rep.sup.step()
            except Exception as e:  # noqa: BLE001 — replica death boundary
                errs[rep.idx] = e

        if self.config.parallel_step and len(live) > 1:
            threads = [threading.Thread(target=one, args=(rep,), daemon=True)
                       for rep in live]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        else:
            for rep in live:
                one(rep)
        died = []
        for rep in live:
            if rep.idx in errs:
                e = errs[rep.idx]
                self._mark_dead(rep, f"{type(e).__name__}: {e}")
                died.append(rep)
        return died

    def _mark_dead(self, rep: _Replica, why: str) -> None:
        rep.state = ReplicaState.DEAD
        rep.sup.abandon()       # fd + watchdog released, NO flush: the
        #                         on-disk journal is what failover trusts
        self._drop_prefixes(rep.idx)    # its cache died with it — stale
        #                                 affinity would route cold misses
        self.stats["replica_deaths"] += 1
        self.events.append(
            ("PT-FLT-001", f"replica {rep.idx} died: {why}"))

    def _handle_death(self, rep: _Replica) -> None:
        if self.failover:
            self._failover(rep)
            return
        # control arm (drill): the dead replica's in-flight requests are
        # simply lost — surfaced as failures so callers don't hang
        lost = []
        for rid, idx in list(self._assigned.items()):
            user = self.requests.get(rid)
            if idx != rep.idx or user is None or user.done:
                continue
            user.done = user.failed = True
            user.error = (f"PT-FLT-001: replica {rep.idx} died and failover "
                          "is disabled — request lost")
            self._trace_lost(rid, user, rep.idx)
            lost.append(rid)
        self._retire_journal(rep.journal_path, [], lost)

    # -- failover ----------------------------------------------------------
    def _failover(self, dead: _Replica) -> None:
        """Re-admit the dead replica's unfinished requests on survivors,
        from its ON-DISK journal. Streamed-token dedup rides the journaled
        high-water marks (``submit(resume=True)``): each survivor
        regenerates the delivered prefix, verifies it byte-for-byte and
        streams on — byte-identical to an uninterrupted run."""
        t0 = time.monotonic()
        recs = RequestJournal.load(dead.journal_path)
        pending = RequestJournal.pending(recs)
        resumed: List[tuple] = []
        for rec in pending:
            rid = rec["rid"]
            user = self.requests.get(rid)
            if user is None:
                # router restarted over existing journals: reconstruct the
                # caller-facing object from the admit record
                user = self.requests[rid] = _request_from(rec)
            if user.done:
                continue
            # the on-disk delivered prefix is authoritative (the flush
            # barrier ran before anything was surfaced, so normally these
            # are equal — reconcile in its favor regardless)
            delivered = [t for r in recs
                         if r["k"] == "prog" and r["rid"] == rid
                         for t in r["toks"]]
            if [int(t) for t in user.output] != delivered:
                user.output[:] = delivered
            user._n_out = len(user.output)
            user.done = user.failed = False
            user.error = None
            target = self._pick_survivor(req=user, exclude={dead.idx})
            if target is None:
                user.done = user.failed = True
                user.error = ("PT-FLT-001: no surviving replica to fail "
                              f"over rid={rid} to")
                self._trace_lost(rid, user, dead.idx)
                continue
            if self.tracer is not None:
                # the failover EDGE: which journal the request came from
                # and which survivor continues its stream
                self.tracer.failover(rid, dead.idx, target.idx)
            # resume=True: journaled work is never refused — the supervisor
            # disables backpressure AND feasibility shedding for it (both
            # were charged at the original submit)
            target.sup.submit(user, resume=True)
            self._assigned[rid] = target.idx
            self._register_prefix(user.prompt, target.idx)
            resumed.append((target, rid))
        # mark ownership movement in the dead journal: a router restarted
        # over this fleet_dir must not replay rescued (or lost) work
        self._retire_journal(
            dead.journal_path, [rid for _, rid in resumed],
            [r["rid"] for r in pending
             if self.requests.get(r["rid"]) is not None
             and self.requests[r["rid"]].failed])
        # catch each survivor up to the delivered marks before the fleet
        # resumes normal ticking — recovery ends with the streams whole
        for target in {t for t, _ in resumed}:
            rids = [rid for t, rid in resumed if t is target]
            guard = 0
            while any(target.sup.behind(rid) for rid in rids):
                target.sup.step()
                guard += 1
                if guard > 100000:
                    raise RuntimeError(
                        "failover replay did not reach the journaled "
                        "high-water marks on replica "
                        f"{target.idx}")
        dt = time.monotonic() - t0
        self.stats["failovers"] += 1
        self.stats["failover_s"] += dt
        self.stats["failover_requests"] += len(resumed)
        self.events.append(
            ("PT-FLT-001",
             f"failover: {len(resumed)} request(s) from replica "
             f"{dead.idx}'s journal re-admitted on survivors in {dt:.2f}s"))

    def _pick_survivor(self, req: Request,
                       exclude: Set[int] = frozenset()) -> Optional[_Replica]:
        alive = [r for r in self.replicas
                 if r.state == ReplicaState.ALIVE and r.idx not in exclude]
        if not alive:
            return None
        n = len(alive)
        return min(alive, key=lambda r: (r.sup.load(),
                                         (r.idx - req.rid) % n))

    # -- drain / rolling restart ------------------------------------------
    def drain(self, idx: int) -> None:
        """Stop routing to replica ``idx``, migrate its still-queued
        requests to survivors, let in-flight slots finish in place. The
        replica rebuilds and rejoins automatically once idle (observed by
        ``step``). ``graceful_drain=False`` deployments hard-kill instead —
        the control arm showing what drains exist to prevent."""
        rep = self.replicas[idx]
        if rep.state != ReplicaState.ALIVE:
            return
        self.stats["drains"] += 1
        if not self.graceful_drain:
            self._mark_dead(rep, "hard restart without drain "
                            "(graceful_drain=False)")
            # no failover on a hard restart: the operator replaced the
            # process without migrating — exactly the lost-work mode the
            # graceful path exists to prevent
            lost = []
            for rid, aidx in list(self._assigned.items()):
                user = self.requests.get(rid)
                if aidx != idx or user is None or user.done:
                    continue
                user.done = user.failed = True
                user.error = ("PT-FLT-002: replica hard-restarted without "
                              "drain — request lost")
                self._trace_lost(rid, user, idx)
                lost.append(rid)
            self._retire_journal(rep.journal_path, [], lost)
            self._respawn(rep)
            return
        rep.state = ReplicaState.DRAINING
        self._drop_prefixes(idx)        # its cache dies with the restart
        migrated = 0
        for rid, aidx in list(self._assigned.items()):
            if aidx != idx:
                continue
            user = self.requests.get(rid)
            if user is None or user.done:
                continue
            rec = rep.sup.withdraw(rid)
            if rec is None:
                continue                # active in a slot: finishes here
            target = self._pick_survivor(user, exclude={idx})
            if target is None:
                # single-replica fleet: nothing to migrate to — hand it
                # back to the draining replica (finishes before restart)
                target = rep
            # resume=True: migrated work is never refused (supervisor
            # disables backpressure + shedding for it)
            target.sup.submit(user, resume=True)
            self._assigned[rid] = target.idx
            migrated += 1
        self.stats["migrated"] += migrated
        self.events.append(
            ("PT-FLT-002", f"replica {idx} draining: {migrated} queued "
             "request(s) migrated, in-flight slots finishing in place"))

    def _finish_drain(self, rep: _Replica) -> None:
        rep.sup.close()
        if rep.retiring:
            # scale-in: the drain migrated/finished every request —
            # remove the replica instead of respawning it
            rep.retiring = False
            rep.state = ReplicaState.RETIRED
            self.stats["replicas_retired"] += 1
            self.events.append(
                ("PT-FLT-005", f"replica {rep.idx} retired after drain "
                 "(scale-in)"))
            return
        self._respawn(rep)
        self.events.append(
            ("PT-FLT-002", f"replica {rep.idx} rebuilt and rejoined "
             f"(generation {rep.gen})"))

    def _respawn(self, rep: _Replica) -> None:
        rep.gen += 1
        rep.journal_path = os.path.join(
            self.fleet_dir, f"replica{rep.idx}.g{rep.gen}.jrnl")
        rep.sup = self._make_sup(rep.idx, rep.journal_path)
        rep.state = ReplicaState.ALIVE
        rep.retiring = False
        rep.progress = None
        rep.last_progress_t = time.monotonic()
        self.stats["restarts"] += 1

    def restart(self, idx: int) -> None:
        """Cold-respawn a DEAD replica (failover already rescued its work;
        a fresh journal avoids replaying requests survivors now own)."""
        rep = self.replicas[idx]
        if rep.state != ReplicaState.DEAD:
            raise ValueError(f"replica {idx} is {rep.state}, not dead — "
                             "use drain() for live replicas")
        self._respawn(rep)
        self.events.append(
            ("PT-FLT-002", f"replica {idx} restarted after death "
             f"(generation {rep.gen})"))

    # -- autoscaling hooks (PT-FLT-005) -----------------------------------
    def add_replica(self) -> int:
        """Grow the fleet by one supervisor-wrapped replica, built through
        the SAME factory/journal path as the originals (a scaled-up
        replica is failover-, drain- and restart-capable from birth). The
        new replica starts cold (empty cache, uncompiled programs) and is
        immediately routable. Returns its index."""
        idx = len(self.replicas)
        gen = self._latest_gen(idx)
        path = os.path.join(self.fleet_dir, f"replica{idx}.g{gen}.jrnl")
        self.replicas.append(_Replica(
            idx, self._make_sup(idx, path), path, gen=gen,
            tier=self.tier_of(idx)))
        self.stats["replicas_added"] += 1
        self.events.append(
            ("PT-FLT-005", f"replica {idx} added (scale-out: fleet now "
             f"{sum(1 for r in self.replicas if r.state not in _GONE)} "
             "serving replica(s))"))
        return idx

    def retire_replica(self, idx: int) -> bool:
        """Scale-in: drain replica ``idx`` (still-queued work migrates to
        survivors, in-flight slots finish in place) and REMOVE it once
        idle instead of respawning it. Refused (returns False) for the
        last serving replica or a replica that is not ALIVE; requires
        ``graceful_drain`` (a hard-restart deployment has no lossless
        scale-in path — use drain semantics or accept the loss
        explicitly)."""
        rep = self.replicas[idx]
        if rep.state != ReplicaState.ALIVE or not self.graceful_drain:
            return False
        alive = [r for r in self.replicas
                 if r.state == ReplicaState.ALIVE]
        if len(alive) <= 1:
            return False            # never retire the last replica
        rep.retiring = True
        self.drain(idx)
        return True

    def force_brownout(self, active: bool) -> None:
        """Controller override of the fleet brownout (an autoscaler at max
        replicas): while forced, the hysteretic pressure state machine is
        suspended — the controller owns the exit as well as the entry, so
        one pressure-free tick cannot undo a deliberate degradation."""
        if active and not self._brownout_active:
            self.stats["brownouts"] += 1
            self.events.append(
                ("PT-FLT-003", "fleet brownout FORCED (autoscaler at max "
                 "replicas): shedding priority >= "
                 f"{self.config.shed_priority} at submit"))
        elif not active and self._brownout_forced:
            self.events.append(
                ("PT-FLT-004", "forced fleet brownout released"))
        self._brownout_forced = bool(active)
        self._brownout_active = bool(active)
        self._pressure_events = self._clear_events = 0

    def rolling_restart(self, max_steps: int = 100000) -> None:
        """Drain + rebuild every replica, one at a time, under traffic —
        the zero-downtime update path (PT-FLT-002)."""
        for rep in list(self.replicas):
            if rep.state in _GONE:
                continue
            self.drain(rep.idx)
            guard = 0
            while rep.state == ReplicaState.DRAINING and guard < max_steps:
                self.step()
                guard += 1
            if rep.state == ReplicaState.DRAINING:
                raise RuntimeError(
                    f"replica {rep.idx} did not finish draining in "
                    f"{max_steps} fleet steps")

    # -- brownout ----------------------------------------------------------
    def _fleet_pressured(self) -> bool:
        alive = [r for r in self.replicas if r.state == ReplicaState.ALIVE]
        if not alive:
            return True
        depth = self.config.brownout_depth
        if depth is None:
            # load() counts queued AND slotted, so the threshold must too:
            # full slots + full queue (or an equal backlog when unbounded)
            # — plain slot utilization with an empty queue is healthy, not
            # pressure
            eng = alive[0].sup.engine
            depth = eng.max_batch + (eng.max_queue
                                     if eng.max_queue is not None
                                     else eng.max_batch)
        return min(r.sup.load() for r in alive) >= max(1, depth)

    def _pressure_event(self, pressured: bool) -> None:
        cfg = self.config
        if self._brownout_forced:
            return          # controller-owned: force_brownout(False) exits
        if self._brownout_active:
            if pressured:
                self._clear_events = 0
            else:
                self._clear_events += 1
                if self._clear_events >= cfg.brownout_exit_after:
                    self._brownout_active = False
                    self._pressure_events = self._clear_events = 0
                    self.events.append(
                        ("PT-FLT-004", "fleet brownout exited"))
            return
        if pressured:
            self._pressure_events += 1
            if self._pressure_events >= cfg.brownout_enter_after:
                self._brownout_active = True
                self._clear_events = 0
                self.stats["brownouts"] += 1
                self.events.append(
                    ("PT-FLT-004",
                     "fleet brownout entered: every alive replica at "
                     "depth — shedding priority >= "
                     f"{cfg.shed_priority} at submit"))
        else:
            self._pressure_events = 0

    # -- completion --------------------------------------------------------
    def has_work(self) -> bool:
        if any(rep.sup.has_work() for rep in self.replicas
               if rep.state not in _GONE):
            return True
        return any(not r.done for r in self.requests.values())

    def run_until_done(self, max_steps: int = 100000) -> Dict[int, Request]:
        steps = 0
        while self.has_work() and steps < max_steps:
            self.step()
            steps += 1
        return self.finished()

    def finished(self) -> Dict[int, Request]:
        for rep in self.replicas:
            if rep.state not in _GONE:
                rep.sup.finished()
        out = {rid: r for rid, r in self.requests.items()
               if r.done and rid not in self._returned}
        self._returned.update(out)
        return out

    def load(self) -> Dict[int, int]:
        """Per-replica load snapshot (queued + slotted), DEAD/RETIRED
        replicas excluded — the observability surface the balancer itself
        uses."""
        return {rep.idx: rep.sup.load() for rep in self.replicas
                if rep.state not in _GONE}

    def close(self) -> None:
        for rep in self.replicas:
            if rep.state not in _GONE:
                rep.sup.close()
