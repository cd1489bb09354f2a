"""Process-per-replica fleet wiring: FleetRouter over worker processes —
port of ``paddle_tpu/inference/procfleet/router.py``.

:class:`ProcFleetRouter` is a :class:`~paddle_tpu_torch.inference.fleet.
FleetRouter` whose ONE overridden construction point (``_make_sup``)
spawns a replica worker process and returns its :class:`~.proxy.
ProcReplica` — every router behavior (radix-affinity routing,
journal-backed failover, drain/rolling restart, brownout, the autoscaler's
``add_replica``/``retire_replica``) runs unchanged over real processes:

- ``add_replica()`` SPAWNS a process: each worker owns its own CUDA
  context, model and device memory;
- ``retire_replica()`` drains then REAPS the process (scale-in);
- a replica death is process death: ``WorkerDead`` out of a step hits the
  router's exception boundary, the proxy's on-disk journal (shared
  ``fleet_dir``, the same format) feeds the failover, and a SIGKILLed
  worker's streams continue byte-identically on survivors.

Workers on one card time-slice it: a process fleet there buys isolation
(a CUDA fault kills one worker, not every replica), not throughput.

:class:`ProcTieredRouter` runs the disaggregated prefill/decode split
(``inference/disagg.py``) over process tiers: finished-prefill KV chains
travel the wire as PTKV1 artifacts in MIGRATE_OUT/MIGRATE_IN frames —
per-page crc32 + chain digest verified at import on the decode worker, so
in-transit damage is a typed PT-SRV-007 refusal there exactly as
in-process.
"""

from __future__ import annotations

import dataclasses
import socket
import time
from typing import Callable, Dict, List, Optional, Union

from ..fleet import FleetRouter, ReplicaState, _GONE
from .proxy import ProcReplica, WorkerDead
from .worker import WorkerSpec

__all__ = ["ProcFleetConfig", "ProcFleetRouter", "ProcTieredRouter"]


@dataclasses.dataclass
class ProcFleetConfig:
    """How worker processes are built and supervised.

    - ``factory`` / ``factory_kwargs``: the picklable engine factory every
      worker imports and calls (procfleet/presets.py ships test/bench
      factories). Factories seed their own rng — identical weights per
      replica is what makes cross-process failover byte-identical.
    - ``sup_kwargs``: per-worker ``ServingSupervisor`` knobs
      (step_budget_s, max_recoveries, fsync).
    - ``env``: environment of the child process, set before it imports
      torch (e.g. ``{"OMP_NUM_THREADS": "1"}`` for CPU workers).
    - ``op_timeout_s``: per-wire-op budget; a worker that stops answering
      is treated as dead (PT-PROC-003).
    - ``spawn_timeout_s``: spawn → HELLO budget (covers the child's torch
      import, CUDA context, model build and engine construction with its
      graph capture).
    - ``heartbeat_s``: optional driver-side heartbeat probe interval
      (``pt_procfleet_heartbeats_total``); None polls only at fleet steps.
    - ``metrics_port``: 0 = each worker binds an ephemeral ``/metrics``
      port (reported in HELLO, aggregated under ``replica=i`` labels by
      ``procfleet_collector``); None disables worker endpoints.
    - ``transport``: ``"tcp"`` (default, real worker processes) or
      ``"loopback"`` — worker threads over an in-process queue-pair
      transport: same supervisor/journal/serve loop, no process spawn
      (the fast arm for tests and chaos drills; ``env`` is NOT applied,
      workers bind no metrics port and share this process's CUDA
      context).
    - ``chaos``: wrap every replica transport in a
      :class:`~.transport.ChaosTransport` — the active ``FaultPlan``'s
      ``net.connect``/``net.send``/``net.recv`` specs inject drops,
      stalls, duplicate delivery, torn frames, payload bitflips and
      per-peer blackholes.
    - ``breaker``: per-replica circuit-breaker kwargs (see
      :class:`~.proxy.CircuitBreaker`: fail_threshold, latency_s,
      cooldown_s, ema_alpha), or None for no breaker.
    - ``migrate_bw_bytes_per_s``: assumed wire bandwidth sizing the
      MIGRATE_IN/OUT per-op deadlines to the payload bytes.
    - ``hedge``: race a timed-out MIGRATE_IN against the next decode
      replica (False = retry the same target only).
    - ``verify_crc``: worker-side per-page crc verification on chain
      import — ``False`` is the fault drills' control arm (silent
      corruption instead of a typed PT-SRV-007).
    - ``mesh``: in-replica tensor-parallel width. None/1 = unsharded
      workers; a width above 1 waits for tp-sharded serving (a later
      slice of the port) and raises ``NotImplementedError`` at spawn.
    """

    factory: Union[str, Callable]
    factory_kwargs: dict = dataclasses.field(default_factory=dict)
    sup_kwargs: dict = dataclasses.field(default_factory=dict)
    env: dict = dataclasses.field(default_factory=dict)
    op_timeout_s: float = 120.0
    spawn_timeout_s: float = 300.0
    heartbeat_s: Optional[float] = None
    metrics_port: Optional[int] = 0
    transport: str = "tcp"
    chaos: bool = False
    breaker: Optional[dict] = None
    migrate_bw_bytes_per_s: float = 32.0 * 1024 * 1024
    hedge: bool = True
    verify_crc: bool = True
    mesh: Optional[int] = None


class ProcFleetRouter(FleetRouter):
    """N replica worker PROCESSES behaving like one reliable engine.

    >>> proc = ProcFleetConfig(
    ...     factory="paddle_tpu_torch.inference.procfleet.presets:"
    ...             "tiny_llama_engine")
    >>> fleet = ProcFleetRouter(proc, fleet_dir, num_replicas=2)
    >>> fleet.submit(Request(prompt, max_new_tokens=64))
    >>> done = fleet.run_until_done()
    >>> fleet.close()                       # reaps every worker

    ``step_budget_s``/``max_recoveries``/``fsync`` are per-WORKER
    supervisor knobs here — set them in ``proc_config.sup_kwargs`` (each
    worker arms its own StepWatchdog in its own process)."""

    def __init__(self, proc_config: ProcFleetConfig, fleet_dir: str,
                 num_replicas: int = 2, **kw):
        self.proc = proc_config
        # build_engine is never called driver-side (workers build their
        # own engines); the factory rides along for introspection only
        super().__init__(proc_config.factory, fleet_dir,
                         num_replicas=num_replicas, **kw)
        self.stats.setdefault("proc_spawned", 0)
        self.stats.setdefault("proc_reaped", 0)

    def _cfg_for(self, idx: int) -> ProcFleetConfig:
        """The replica's FULL worker config — factory AND transport knobs
        (op/spawn timeouts, heartbeat); the tiered subclass returns the
        tier's own config so a slow decode build gets decode's budgets."""
        return self.proc

    def _spec_kwargs(self, idx: int) -> dict:
        cfg = self._cfg_for(idx)
        mesh = (int(cfg.mesh) if cfg.mesh and int(cfg.mesh) > 1 else None)
        return dict(factory=cfg.factory,
                    factory_kwargs=dict(cfg.factory_kwargs),
                    sup_kwargs=dict(cfg.sup_kwargs),
                    env=dict(cfg.env),
                    metrics_port=cfg.metrics_port,
                    verify_crc=cfg.verify_crc,
                    mesh=mesh,
                    tier=self.tier_of(idx))

    def _make_sup(self, idx: int, path: str) -> ProcReplica:
        spec = WorkerSpec(journal_path=path, **self._spec_kwargs(idx))
        cfg = self._cfg_for(idx)
        tags = {"replica": idx}
        return ProcReplica(
            spec, idx=idx, tracer=self.tracer, trace_tags=tags,
            op_timeout_s=cfg.op_timeout_s,
            spawn_timeout_s=cfg.spawn_timeout_s,
            heartbeat_s=cfg.heartbeat_s, stats=self.stats,
            transport=cfg.transport, chaos=cfg.chaos,
            breaker=cfg.breaker,
            migrate_bw_bytes_per_s=cfg.migrate_bw_bytes_per_s)

    def drain(self, idx: int) -> None:
        """Router drain + a worker-side DRAIN mark (the worker refuses new
        non-resumed admissions for the window — defense in depth while
        the router migrates its queue)."""
        rep = self.replicas[idx]
        if (self.graceful_drain and rep.state == ReplicaState.ALIVE
                and isinstance(rep.sup, ProcReplica) and not rep.sup.dead):
            try:
                rep.sup.drain_mark()
            except WorkerDead:
                pass            # death wins: the step loop will adjudicate
        super().drain(idx)

    def worker_metrics_urls(self) -> Dict[int, str]:
        """``{replica idx: /metrics url}`` for every live worker — the
        remote-scrape topology input (``procfleet_collector``)."""
        out = {}
        for rep in self.replicas:
            if rep.state in _GONE or not isinstance(rep.sup, ProcReplica):
                continue
            url = rep.sup.metrics_url
            if url and not rep.sup.dead:
                out[rep.idx] = url
        return out

    def heartbeat_total(self) -> int:
        return sum(rep.sup.heartbeat_count() for rep in self.replicas
                   if isinstance(rep.sup, ProcReplica))


class ProcTieredRouter(ProcFleetRouter):
    """Disaggregated prefill/decode tiers over process replicas.

    Replicas ``0..num_prefill-1`` are the prefill tier (new submissions
    route only here), the rest decode. After every fleet tick the driver
    pumps finished prefills: MIGRATE_OUT exports + retires the chain on
    the prefill worker (its journal's ``migr-kv`` keeps the rid out of its
    replay set), the artifact crosses the wire, MIGRATE_IN splices it into
    the least-loaded decode worker which verifies per-page crc32 + chain
    digest before a byte touches its pool. Refusal, typed corruption and
    import TIMEOUT all take ONE retry-elsewhere policy (the driver still
    holds the clean artifact — wire-transit damage is per-hop): try the
    next decode worker, with the timeout arm HEDGING onto the
    next-least-loaded replica and rolling the loser back via
    MIGRATE_CANCEL; exhausted, re-run prefill under resume semantics on a
    survivor."""

    def __init__(self, prefill_config: ProcFleetConfig,
                 decode_config: ProcFleetConfig, fleet_dir: str,
                 num_prefill: int = 1, num_decode: int = 1, **kw):
        if num_prefill < 1 or num_decode < 1:
            raise ValueError("each tier needs at least one replica")
        self._prefill_cfg = prefill_config
        self._decode_cfg = decode_config
        self._num_prefill = int(num_prefill)
        super().__init__(prefill_config, fleet_dir,
                         num_replicas=int(num_prefill) + int(num_decode),
                         **kw)
        try:
            for rep in self.replicas:
                if not rep.sup.engine.prefix_cache:
                    raise ValueError(
                        f"{rep.tier}-tier worker {rep.idx} was built "
                        "without a prefix cache — KV-block migration needs "
                        "prefix_cache engines on both tiers")
        except Exception:
            # every worker already spawned: a validation failure must not
            # leak N worker processes until interpreter exit
            self.close()
            raise
        self.stats.update(migrations=0, migration_s=0.0, migration_pages=0,
                          migration_bytes=0, migration_corrupt=0,
                          migration_deferred=0, migration_refused=0,
                          migration_reprefill=0, migration_hedges=0)
        #: per-migration wall-clock seconds, newest-last, capped — the
        #: ``serving_migration_under_loss`` bench reads p99 from here
        self.migration_samples: List[float] = []
        self._hedge = bool(decode_config.hedge)
        self._corrupt_hook = None

    def tier_of(self, idx: int) -> str:
        return "prefill" if idx < self._num_prefill else "decode"

    def _cfg_for(self, idx: int) -> ProcFleetConfig:
        # the tier's OWN config drives both the worker spec and the
        # proxy's transport knobs — a slow decode build gets decode's
        # spawn budget, and the drills' verify_crc/chaos/breaker arms
        # land on the tier they target
        return (self._prefill_cfg if idx < self._num_prefill
                else self._decode_cfg)

    def _routable(self, req):
        alive = super()._routable(req)
        pre = [r for r in alive if r.tier == "prefill"]
        return pre or alive

    def _pick_survivor(self, req, exclude=frozenset()):
        alive = [r for r in self.replicas
                 if r.state == ReplicaState.ALIVE and r.idx not in exclude]
        pool = [r for r in alive if r.tier == "prefill"] or alive
        if not pool:
            return None
        n = len(pool)
        return min(pool, key=lambda r: (r.sup.load(),
                                        (r.idx - req.rid) % n))

    # -- the migration pump (driver thread, post-tick) ---------------------
    # LOCKSTEP NOTE: this pump mirrors disagg.TieredRouter's
    # (_migrate_ready/_migrate_one/_compatible/_decode_targets) with the
    # engine-touching steps replaced by wire ops (export_migration /
    # import_migration) — a behavioral fix to either pump (new refusal
    # class, stats key, trace tag, fallback ordering) must land in BOTH.
    def step(self) -> None:
        super().step()
        self._migrate_ready()

    def _decode_targets(self, rid: int) -> List:
        # an OPEN breaker filters the replica out of the candidate list —
        # a slow peer must not eat a migration's whole deadline before
        # the hedge even starts (all breakers open -> deferred: the rid
        # keeps decoding on the prefill tier and retries next step)
        alive = [r for r in self.replicas
                 if r.state == ReplicaState.ALIVE and r.tier == "decode"
                 and not r.sup.dead
                 and r.sup.breaker_state() != "open"]
        n = max(1, len(alive))
        return sorted(alive, key=lambda r: (r.sup.load(),
                                            (r.idx - rid) % n))

    def _compatible(self, src, dst, user) -> bool:
        """Geometry gate from the workers' HELLO state PLUS the capacity
        gate from their latest reply-piggybacked ``[free slots, free
        pages]`` — a chain must never be retired from its source toward a
        worker that cannot hold it (a merely-full decode tier DEFERS: the
        candidate keeps decoding on the prefill tier and retries next
        step, instead of paying a whole re-prefill). The page estimate is
        optimistic, same as in-process — the import's ``EngineSaturated``
        fallback stays load-bearing."""
        s, d = src.sup.engine, dst.sup.engine
        if not (bool(getattr(d, "prefix_cache", False))
                and d.page_size == s.page_size
                and getattr(d, "layers", None) == getattr(s, "layers", None)
                and getattr(d, "kvh", None) == getattr(s, "kvh", None)
                and getattr(d, "hd", None) == getattr(s, "hd", None)
                and getattr(d, "dtype", None) == getattr(s, "dtype", None)
                and len(user.prompt) + user.max_new_tokens <= d.max_len):
            return False
        # engine._pages_needed, driver-side
        need = -(-(len(user.prompt) + user.max_new_tokens) // s.page_size)
        if getattr(d, "maxp", 0) < need:
            return False
        cap = dst.sup.capacity()
        return cap[0] >= 1 and cap[1] >= need

    def _reprefill_if_stranded(self, rid: int, user, src) -> None:
        """After a mid-handoff source death: if the journal adjudication
        left the rid owned by the (now dead) source and unfinished — the
        worker's ``migr-kv`` had committed, so its failover rightly
        skipped it — re-admit under resume semantics on a survivor. The
        source is dead, the target never spliced: no double-serve is
        possible, and re-running prefill beats the at-most-once drop."""
        if user.done or self._assigned.get(rid, src.idx) != src.idx:
            return
        target = self._pick_survivor(user, exclude={src.idx})
        if target is None:
            user.done = user.failed = True
            user.error = (f"PT-TIER-001: no surviving replica to re-run "
                          f"stranded migrated rid={rid} on")
            self._trace_lost(rid, user, src.idx)
            return
        self.stats["migration_reprefill"] += 1
        target.sup.submit(user, resume=True)
        self._assigned[rid] = target.idx
        self.events.append(
            ("PT-TIER-001",
             f"rid={rid} handoff interrupted by source death — prefill "
             f"re-run on replica {target.idx}"))

    def _migrate_ready(self) -> None:
        if self._corrupt_hook is None:
            from ...distributed.resilience.faults import corrupt

            self._corrupt_hook = corrupt
        for rep in self.replicas:
            if (rep.state != ReplicaState.ALIVE or rep.tier != "prefill"
                    or rep.sup.dead):
                continue
            for rid in rep.sup.migration_ready():
                user = self.requests.get(rid)
                if user is None or user.done or rep.sup.behind(rid):
                    continue
                self._migrate_one(rep, rid, user)

    def _migrate_one(self, src, rid: int, user) -> bool:
        targets = [r for r in self._decode_targets(rid)
                   if self._compatible(src, r, user)]
        if not targets:
            self.stats["migration_deferred"] += 1
            return False            # no decode capacity: decode in place
        t0 = time.monotonic()
        t0_tr = None if self.tracer is None else self.tracer.now()
        try:
            hdr, art = src.sup.export_migration(rid)
        except (KeyError, ValueError):
            return False            # finished/raced inside the worker:
        #                             nothing was retired, nothing moved
        except Exception as e:  # noqa: BLE001 — replica death boundary
            # WorkerDead, or a damaged CHAIN reply: whether the worker
            # committed its migr-kv before the failure is unknowable from
            # here — mark it dead and let the journal-backed failover
            # adjudicate from the ON-DISK truth (migr-kv committed → the
            # rid is re-admitted below, not replayed from that journal;
            # not committed → failover replays it). Same posture as the
            # in-process pump's catch-all (disagg.py _migrate_one): the
            # rid must never be stranded by an escaping exception.
            self._mark_dead(src, f"export of rid={rid} failed: "
                            f"{type(e).__name__}: {e}")
            self._handle_death(src)
            self._reprefill_if_stranded(rid, user, src)
            return True
        # in-transit hook: the kv_migration_corruption drill's site —
        # driver-side, between the two workers, exactly where real
        # transport damage would land
        art = self._corrupt_hook("serving.kv_transfer", f"rid:{rid}", art)
        placed = None
        corrupt_art = False
        from ..disagg import KVChainCorrupt
        from ..serving import EngineSaturated

        # one idempotence key per LOGICAL migration, stable across every
        # attempt and every target: a chaos-duplicated MIGRATE_IN answers
        # from the worker's idem cache instead of double-splicing, and the
        # no-hedge-target resend below dedups against a splice that DID
        # land before the reply was lost
        idem = f"mig:{rid}:{hdr['digest'][:16]}"
        # UNIFIED retry-elsewhere policy: a refusal (EngineSaturated /
        # geometry ValueError), a typed corruption (wire-transit damage is
        # per-hop — this driver still holds the artifact it exported) and
        # a clean import TIMEOUT all mean "this target didn't take it, the
        # chain is intact here": try the next-least-loaded decode replica.
        # Only the timeout arm is a HEDGE — the laggard may still splice
        # late, so the loser is rolled back below.
        timed_out: List = []
        queue = list(targets)
        i = 0
        while i < len(queue):
            rep = queue[i]
            i += 1
            try:
                rep.sup.import_migration(user, art, idem=idem)
                placed = rep
                break
            except socket.timeout:
                timed_out.append(rep)
                if not self._hedge and queue.count(rep) < 2:
                    # hedging disabled: retry the SAME replica once under
                    # the SAME idem key before considering anyone else
                    queue.insert(i, rep)
                    continue
                if i < len(queue):
                    if self._hedge:
                        # race the next-least-loaded candidate while this
                        # one lags
                        self.stats["migration_hedges"] += 1
                        if self.tracer is not None:
                            self.tracer.migration_failure(
                                rid, "hedged", tags={"replica": rep.idx})
                    continue
                if queue.count(rep) < 2:
                    # no hedge target left: resend to the SAME replica
                    # under the SAME idem key — if the first splice landed
                    # and only the reply was lost, the worker answers
                    # SPLICED from its idem cache
                    queue.append(rep)
                continue
            except KVChainCorrupt as e:
                corrupt_art = True
                self.stats["migration_corrupt"] += 1
                self.events.append(("PT-SRV-007", str(e)))
                if self.tracer is not None:
                    self.tracer.migration_failure(
                        rid, "corrupt", tags={"replica": rep.idx})
                continue
            except (EngineSaturated, ValueError):
                self.stats["migration_refused"] += 1
                if self.tracer is not None:
                    self.tracer.migration_failure(
                        rid, "refused", tags={"replica": rep.idx})
                continue
            except Exception as e:  # noqa: BLE001 — replica death boundary
                # WorkerDead, a desynced reply, an unexpected typed error
                # out of the worker: that replica's engine/stream is
                # untrusted — same catch-all as disagg.py's _migrate_one
                # ("must not escape: the rid is already retired from the
                # source"). Mark it dead, fail its work over, try the
                # next target.
                self._mark_dead(rep, f"splice of rid={rid} failed: "
                                f"{type(e).__name__}: {e}")
                self._handle_death(rep)
                if self._assigned.get(rid, src.idx) != src.idx:
                    return True     # its failover already re-placed it
                continue
        # hedge losers: any replica whose import timed out but is NOT the
        # winner may splice late — roll it back (journal migr-kv, pages
        # decref'd, allocator untouched) so the chain is live exactly
        # once. Best-effort: a loser that died or is still wedged keeps
        # its idem entry, and the rid is purged from its cache either way
        # when the cancel does land.
        for rep in timed_out:
            if rep is placed or rep.sup.dead:
                continue
            try:
                if rep.sup.migrate_cancel(rid, hdr["digest"]):
                    self.events.append(
                        ("PT-TIER-001",
                         f"rid={rid} hedge loser on replica {rep.idx} "
                         "rolled back (late splice retired)"))
            except Exception:  # noqa: BLE001 — winner already placed
                pass
        if placed is None:
            alive = self._decode_targets(rid)
            target = (alive[0] if alive
                      else self._pick_survivor(user, exclude=set()))
            if target is None:
                user.done = user.failed = True
                user.error = (f"PT-TIER-001: no surviving replica to "
                              f"place migrated rid={rid} on")
                self._trace_lost(rid, user, src.idx)
                return True
            self.stats["migration_reprefill"] += 1
            target.sup.submit(user, resume=True)
            self._assigned[rid] = target.idx
            self.events.append(
                ("PT-TIER-001",
                 f"rid={rid} chain not spliced "
                 f"({'corrupt' if corrupt_art else 'refused'}) — prefill "
                 f"re-run on replica {target.idx}"))
            return True
        self._assigned[rid] = placed.idx
        dt = time.monotonic() - t0
        self.stats["migrations"] += 1
        self.stats["migration_s"] += dt
        self.migration_samples.append(dt)
        del self.migration_samples[:-512]
        self.stats["migration_pages"] += int(hdr["pages"])
        self.stats["migration_bytes"] += len(art)
        self.events.append(
            ("PT-TIER-001",
             f"rid={rid} chain ({hdr['pages']} page(s), {len(art)} bytes) "
             f"migrated worker {src.idx} -> {placed.idx} over the wire in "
             f"{dt * 1e3:.1f}ms"))
        if self.tracer is not None:
            self.tracer.migrate(rid, src.idx, placed.idx,
                                pages=int(hdr["pages"]), nbytes=len(art),
                                t0=t0_tr, tags={"replica": placed.idx})
        return True
