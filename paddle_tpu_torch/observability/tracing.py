"""Per-request trace spans across the serving lifecycle — port of
``paddle_tpu/observability/tracing.py``.

Every span is host-side and buffered: nothing here touches a device
tensor, synchronizes the device or runs inside a captured CUDA graph. The
engine, supervisor, fleet and tiers stamp events only when a recorder is
attached (``tracer is None`` costs one attribute check per site), and read
``engine.tracer`` at run time, so a recorder swapped in after construction
(or after a graph capture) takes effect at the next stamp.

Span taxonomy:

    submit ─► admit(queue_wait) ─► prefill_chunk* ─► first_token
          └► shed                                       │
                                                  decode_block*
                                                        │
                                  finish │ evict │ fail ◄┘
          (failover / migrate edges re-open a request on another replica)

Timeline semantics: spans are HOST DISPATCH windows (CUDA launches and
graph replays are asynchronous — a decode block's span covers the host
work that queued it, not device occupancy). TTFT is stamped when the first
token is *scheduled*, matching what a streaming caller can first observe
through the engine's deferred readback.

Crash/replay discipline (recovery.py): a re-admitted request keeps its
ORIGINAL submit timestamp and first-token stamp (first wins — TTFT spans
the crash, which is what the caller experienced); every span stamped after
:meth:`TraceRecorder.mark_recovered` carries ``recovered: true``; and
streamed-token accounting is deduped against the journal high-water mark —
catch-up regeneration below the mark adds zero tokens (the caller already
has them).

Export: :meth:`TraceRecorder.export_chrome` writes chrome-trace JSON
(``{"traceEvents": [...]}``) loadable in Perfetto / chrome://tracing —
pid = replica, tid = request id (one lane per request; tid 0 is the
engine lane). SLO summaries (p50/p99 TTFT, inter-token latency, queue
wait, shed/failover rates) are computed FROM the registry histograms
(fixed buckets — bounded state), not from raw span lists. The same stamps
on the same clock give the JAX recorder's events, summaries and registry
text.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional

from .metrics import DEFAULT_LATENCY_BUCKETS_MS, MetricsRegistry

__all__ = ["TraceRecorder"]

#: terminal event names — every submitted request must reach exactly one
#: (unless it is re-opened by a failover/migration re-submit)
TERMINALS = ("finish", "evict", "shed", "fail")


class TraceRecorder:
    """Buffered host-side span recorder + SLO aggregator.

    >>> tracer = TraceRecorder()
    >>> eng = ContinuousBatchingEngine(model, ..., tracer=tracer)
    >>> ... serve ...
    >>> tracer.export_chrome("trace.json")     # open in Perfetto
    >>> tracer.slo_summary()                   # p50/p99 TTFT etc.

    ``registry``: a shared :class:`MetricsRegistry` to aggregate into
    (default: a private one). ``max_events`` bounds the chrome-trace
    buffer (oldest-first retention would reorder Perfetto lanes, so the
    buffer STOPS recording and counts drops instead — ``dropped``);
    per-request bookkeeping is bounded by ``max_requests`` with
    terminal-request eviction. ``mirror_host_events=True`` additionally
    feeds span durations into ``paddle_tpu_torch.profiler``'s host-event
    table so ``Profiler.summary()``'s OperatorView shows serving spans
    beside model scopes.
    ``clock`` is any zero-arg callable returning seconds (default
    ``time.perf_counter``; a ``VirtualClock`` for replay).
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 max_events: int = 200_000, max_requests: int = 100_000,
                 mirror_host_events: bool = False,
                 clock=time.perf_counter):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.max_events = int(max_events)
        self.max_requests = int(max_requests)
        self.mirror_host_events = bool(mirror_host_events)
        self._clock = clock
        self._t0 = clock()
        # ONE recorder is shared by every replica of a fleet — under
        # ``parallel_step`` the stamping sites run on concurrent replica
        # threads while the driver reads exports/summaries. Re-entrant
        # because public stamps
        # compose (finish -> tokens -> _terminal); host-side control
        # plane, so the lock costs nothing measurable per stamp.
        self._lock = threading.RLock()
        self.events: List[dict] = []
        self.dropped = 0
        self.gc_count = 0          # terminal rids evicted past max_requests
        # optional SLO sink (observability/slo.py SLOMonitor.attach): the
        # per-request attainment/goodput accounting that histograms cannot
        # carry (which REQUESTS met every target, and how many tokens they
        # streamed). Called under self._lock from the stamp sites, behind
        # one `is not None` check each — same discipline as the engine's
        # tracer attachment.
        self.slo = None
        # per-request bookkeeping (bounded: terminal rids are GC'd oldest
        # first past max_requests)
        self._submit_ts: Dict[int, float] = {}
        self._first_ts: Dict[int, float] = {}
        self._streamed: Dict[int, int] = {}    # dedup floor (journal hwm)
        self._tenant: Dict[int, str] = {}      # rid -> workload tenant tag
        self._recovered: set = set()           # rids past mark_recovered
        self._state: Dict[int, str] = {}       # "open" | terminal name
        self._order: List[int] = []            # rid insertion order for GC
        self.resubmits = 0
        reg = self.registry
        self._h_ttft = reg.histogram(
            "pt_serving_time_to_first_token_ms",
            "submit -> first scheduled token, ms",
            buckets=DEFAULT_LATENCY_BUCKETS_MS)
        self._h_itl = reg.histogram(
            "pt_serving_inter_token_ms",
            "mean inter-token latency per finished request, ms",
            buckets=DEFAULT_LATENCY_BUCKETS_MS)
        self._h_qwait = reg.histogram(
            "pt_serving_queue_wait_ms",
            "submit -> slot admission queue wait, ms",
            buckets=DEFAULT_LATENCY_BUCKETS_MS)
        self._c_submitted = reg.counter(
            "pt_serving_requests_submitted_total", "requests submitted")
        self._c_terminal = reg.counter(
            "pt_serving_requests_terminal_total",
            "terminal events by kind (finish/evict/shed/fail)")
        self._c_tokens = reg.counter(
            "pt_serving_tokens_streamed_total",
            "tokens newly streamed to callers (hwm-deduped)")
        self._c_failovers = reg.counter(
            "pt_serving_failovers_total", "requests failed over to another "
            "replica")
        # disaggregated-tier KV migration surface (inference/disagg.py):
        # counters + a wall-time histogram for the prefill→decode chain
        # handoff. Scrapers require them, so they register (and render at
        # zero) on every recorder, migrating fleet or not.
        self._c_migrations = reg.counter(
            "pt_migration_total",
            "finished-prefill KV chains migrated between serving tiers")
        self._c_migration_pages = reg.counter(
            "pt_migration_pages_total",
            "KV pages moved by tier migration")
        self._c_migration_failures = reg.counter(
            "pt_migration_failures_total",
            "migrations not spliced, by reason (corrupt/refused)")
        self._h_migration = reg.histogram(
            "pt_migration_time_ms",
            "export -> splice wall time per migrated chain, ms",
            buckets=DEFAULT_LATENCY_BUCKETS_MS)

    # -- low-level event plumbing ------------------------------------------
    def now(self) -> float:
        return self._clock()

    def _us(self, ts: float) -> float:
        return (ts - self._t0) * 1e6

    def _emit(self, ev: dict) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(ev)

    def _args(self, rid: Optional[int], tags: Optional[dict],
              extra: dict) -> dict:
        args = dict(tags) if tags else {}
        args.update(extra)
        if rid is not None and rid in self._recovered:
            args.setdefault("recovered", True)
        return args

    def instant(self, name: str, rid: Optional[int] = None,
                tags: Optional[dict] = None, **extra) -> None:
        tags = tags or {}
        with self._lock:
            self._emit({"name": name, "ph": "i", "ts": self._us(self.now()),
                        "pid": int(tags.get("replica", 0)),
                        "tid": int(rid or 0), "s": "t",
                        "args": self._args(rid, tags, extra)})

    def span(self, name: str, rid: Optional[int], t0: float,
             t1: Optional[float] = None, tags: Optional[dict] = None,
             **extra) -> None:
        t1 = self.now() if t1 is None else t1
        tags = tags or {}
        with self._lock:
            self._emit({"name": name, "ph": "X", "ts": self._us(t0),
                        "dur": max(0.0, (t1 - t0) * 1e6),
                        "pid": int(tags.get("replica", 0)),
                        "tid": int(rid or 0),
                        "args": self._args(rid, tags, extra)})
        if self.mirror_host_events:
            from ..profiler import _host_events

            _host_events.start(name, t0)
            _host_events.stop(name, t1)

    # -- request lifecycle -------------------------------------------------
    def _track(self, rid: int) -> None:
        if rid not in self._state:
            self._order.append(rid)
            self._gc()
        self._state[rid] = "open"

    def _gc(self) -> None:
        while len(self._order) > self.max_requests:
            for i, rid in enumerate(self._order):
                if self._state.get(rid) in TERMINALS:
                    self._order.pop(i)
                    for d in (self._submit_ts, self._first_ts,
                              self._streamed, self._state, self._tenant):
                        d.pop(rid, None)
                    self._recovered.discard(rid)
                    self.gc_count += 1
                    break
            else:
                return   # everything open — nothing safe to drop

    def submit(self, rid: int, prompt_tokens: int, max_new: int,
               tags: Optional[dict] = None) -> None:
        """Request entered an engine. Re-submission of a known rid (crash
        replay twin, fleet failover/migration) keeps the ORIGINAL submit
        timestamp — TTFT and queue wait stay caller-truthful — and
        re-opens a terminal'd request instead of double-counting it."""
        with self._lock:
            known = rid in self._state
            reopened = self._state.get(rid) in TERMINALS
            self._track(rid)
            tenant = (tags or {}).get("tenant")
            if tenant is not None:
                self._tenant[rid] = str(tenant)
            if not known:
                self._submit_ts[rid] = self.now()
                self._c_submitted.inc()
                if self.slo is not None:
                    self.slo.note_submit(rid, self._tenant.get(rid))
            else:
                self.resubmits += 1
                if reopened and self.slo is not None:
                    # a terminal'd rid coming back (fleet caught one
                    # replica's shed and routed onward): the pending shed
                    # is cancelled — the REAL terminal gets booked
                    self.slo.note_reopen(rid, self._tenant.get(rid))
            self.instant("submit" if not known else "resubmit", rid, tags,
                         prompt_tokens=int(prompt_tokens),
                         max_new=int(max_new), reopened=bool(reopened))

    def shed(self, rid: int, tags: Optional[dict] = None, **extra) -> None:
        with self._lock:
            if rid not in self._state:   # shed before any engine saw it
                self._track(rid)         # (fleet brownout): still tracked
                self._submit_ts[rid] = self.now()
                self._c_submitted.inc()
                if self.slo is not None:
                    self.slo.note_submit(rid, (tags or {}).get("tenant"))
            if self.slo is not None:
                self.slo.note_terminal(rid, "shed", 0, None)
            self._terminal(rid, "shed", tags, **extra)

    def admit(self, rid: int, queue_wait_s: float, hit_tokens: int = 0,
              miss_tokens: int = 0, tags: Optional[dict] = None) -> None:
        wait_ms = max(0.0, queue_wait_s * 1e3)
        with self._lock:
            if rid not in self._recovered:
                # a recovered/resumed re-admission's wait is operator cost,
                # not caller-visible queue wait — keep the SLO honest
                self._h_qwait.observe(wait_ms)
                if self.slo is not None:
                    self.slo.note_queue_wait(rid, wait_ms)
            self.instant("admit", rid, tags,
                         queue_wait_ms=round(wait_ms, 3),
                         hit_tokens=int(hit_tokens),
                         miss_tokens=int(miss_tokens))

    def prefill_chunk(self, rid: int, t0: float, tokens: int,
                      t1: Optional[float] = None,
                      tags: Optional[dict] = None) -> None:
        self.span("prefill_chunk", rid, t0, t1, tags, tokens=int(tokens))

    def first_token(self, rid: int, tags: Optional[dict] = None) -> None:
        """First scheduled token. First stamp wins: a crash-replay twin
        re-reaching its first token does NOT reset TTFT (the caller saw
        the original) — it records a tagged replay event instead."""
        with self._lock:
            if rid in self._first_ts:
                self.instant("first_token_replay", rid, tags)
                return
            ts = self.now()
            self._first_ts[rid] = ts
            sub = self._submit_ts.get(rid)
            ttft_ms = None
            if sub is not None:
                ttft_ms = (ts - sub) * 1e3
                self._h_ttft.observe(ttft_ms)
                if self.slo is not None:
                    self.slo.note_ttft(rid, ttft_ms)
            self.instant("first_token", rid, tags,
                         **({"ttft_ms": round(ttft_ms, 3)}
                            if ttft_ms is not None else {}))

    def tokens(self, rid: int, total: int,
               tags: Optional[dict] = None) -> None:
        """Book streamed-token progress; ``total`` is the request's
        cumulative scheduled-token count. Deduped against the journal
        high-water mark: during crash-replay catch-up the twin regenerates
        tokens the caller already has — those add nothing here."""
        with self._lock:
            prev = self._streamed.get(rid, 0)
            if total <= prev:
                return
            self._streamed[rid] = int(total)
            self._c_tokens.inc(total - prev)

    def decode_block(self, t0: float, n_steps: int, slots: int,
                     t1: Optional[float] = None,
                     tags: Optional[dict] = None,
                     tokens: Optional[int] = None) -> None:
        """Engine-lane span for one fused decode dispatch (tid 0 — block
        work is batched across requests, so it has no single rid).
        ``tokens`` carries the block's REAL emitted-token count: under
        speculative decoding a dispatch emits a variable 1..K+1 tokens per
        row, so TTFT/inter-token SLO math must read token progress off the
        span, never infer it from n_steps x slots."""
        extra = {} if tokens is None else {"tokens": int(tokens)}
        self.span("decode_block", None, t0, t1, tags,
                  n_steps=int(n_steps), slots=int(slots), **extra)

    def decode_block_batch(self, t0: float, n_steps: int, slots: int,
                           items, t1: Optional[float] = None,
                           tags: Optional[dict] = None,
                           tokens: Optional[int] = None) -> None:
        """One decode block's full stamp set — the block span plus every
        row's token progress — under a SINGLE lock acquisition (the
        big-batch step path; per-slot locking is O(slots) contention per
        block)."""
        with self._lock:
            self.decode_block(t0, n_steps, slots, t1, tags, tokens=tokens)
            if items:
                for rid, total in items:
                    self.tokens(rid, total, tags)

    def first_tokens(self, items, tags: Optional[dict] = None) -> None:
        """Batched first-token stamps for an admission wave: per rid the
        first-token instant (+TTFT) and the token progress, all under one
        lock acquisition. ``items``: ``(rid, total)`` pairs."""
        with self._lock:
            for rid, total in items:
                self.first_token(rid, tags)
                self.tokens(rid, total, tags)

    def finish(self, rid: int, n_out: int, failed: bool = False,
               error: Optional[str] = None, kind: Optional[str] = None,
               tags: Optional[dict] = None) -> None:
        """Terminal stamp. ``kind`` defaults to finish / evict (deadline)
        / fail, inferred from ``failed``+``error``. Also closes the SLO
        math: mean inter-token latency over the request's stream."""
        if kind is None:
            kind = ("evict" if failed and error and "deadline" in error
                    else "fail" if failed else "finish")
        with self._lock:
            first = self._first_ts.get(rid)
            itl_ms = None
            if kind == "finish" and first is not None and n_out > 1:
                itl_ms = (self.now() - first) / (n_out - 1) * 1e3
                self._h_itl.observe(itl_ms)
            self.tokens(rid, int(n_out), tags)
            if self.slo is not None:
                self.slo.note_terminal(rid, kind, int(n_out), itl_ms)
            self._terminal(rid, kind, tags, n_out=int(n_out),
                           **({"error": str(error)[:200]} if error else {}))

    def _terminal(self, rid: int, kind: str, tags: Optional[dict],
                  **extra) -> None:
        with self._lock:
            if rid not in self._state:
                self._track(rid)
            self._state[rid] = kind
            self._c_terminal.inc(kind=kind)
            self.instant(kind, rid, tags, **extra)

    # -- recovery / fleet edges -------------------------------------------
    def mark_recovered(self, rid: int, hwm: int,
                       tags: Optional[dict] = None) -> None:
        """A supervisor re-admitted ``rid`` via ``submit(resume=True)``
        (crash replay, failover, or drain migration). With ``hwm`` > 0
        tokens already delivered, raise the streamed-token dedup floor
        and tag everything after as recovered (and exclude the re-admit's
        queue wait from the SLO histogram — it is operator cost). A
        ``hwm == 0`` resume (e.g. a still-QUEUED request migrated by a
        rolling drain) has nothing to dedup and its wait on the new
        replica is real caller-visible queue wait — it stays untagged and
        fully counted."""
        with self._lock:
            self._track(rid)
            if rid not in self._submit_ts:
                self._submit_ts[rid] = self.now()   # restart: best known
            if hwm > 0:
                self._recovered.add(rid)
                self._streamed[rid] = max(self._streamed.get(rid, 0),
                                          int(hwm))
            self.instant("recovered", rid, tags, hwm=int(hwm),
                         recovered=hwm > 0)

    def failover(self, rid: int, from_replica: int, to_replica: int,
                 tags: Optional[dict] = None) -> None:
        self._c_failovers.inc()
        self.instant("failover", rid, tags, from_replica=int(from_replica),
                     to_replica=int(to_replica))

    def migrate(self, rid: int, from_replica: int, to_replica: int,
                pages: int, nbytes: int, t0: float,
                t1: Optional[float] = None,
                tags: Optional[dict] = None) -> None:
        """One finished-prefill KV chain handed from the prefill tier to a
        decode replica (inference/disagg.py): a span on the request's lane
        covering export -> splice, plus the ``pt_migration_*`` counters.
        The request stays OPEN — migration is an edge, not a terminal."""
        t1 = self.now() if t1 is None else t1
        with self._lock:
            self._c_migrations.inc()
            self._c_migration_pages.inc(int(pages))
            self._h_migration.observe(max(0.0, (t1 - t0) * 1e3))
            self.span("migrate", rid, t0, t1, tags,
                      from_replica=int(from_replica),
                      to_replica=int(to_replica), pages=int(pages),
                      bytes=int(nbytes))

    def migration_failure(self, rid: int, reason: str,
                          tags: Optional[dict] = None) -> None:
        """A chain that did not splice: ``corrupt`` (PT-SRV-007 crc/digest
        rejection — decode side re-runs prefill) or ``refused`` (pool
        shortfall — retried elsewhere / fallen back to re-prefill)."""
        with self._lock:
            self._c_migration_failures.inc(reason=str(reason))
            self.instant("migrate_failure", rid, tags, reason=str(reason))

    def recovery(self, t0: float, code: str, replayed: int,
                 t1: Optional[float] = None,
                 tags: Optional[dict] = None) -> None:
        self.span("recovery", None, t0, t1, tags, code=code,
                  replayed=int(replayed))

    def publish(self, t0: float, step: int, generation: int, shards: int,
                ok: bool = True, t1: Optional[float] = None,
                tags: Optional[dict] = None) -> None:
        """A checkpoint handed from training to serving (the checkpoint
        lifecycle, a later slice of the port): manifest verify -> in-place
        weight load -> rolling fleet swap, one span covering the whole
        handoff."""
        self.span("publish", None, t0, t1, tags, step=int(step),
                  generation=int(generation), shards=int(shards),
                  ok=bool(ok))

    def resume(self, t0: float, step: int, world: int,
               t1: Optional[float] = None,
               tags: Optional[dict] = None) -> None:
        """An elastic resume: checkpoint reloaded (reshard-on-load) onto
        the surviving mesh at the recorded step."""
        self.span("resume", None, t0, t1, tags, step=int(step),
                  world=int(world))

    # -- introspection / export -------------------------------------------
    def counters(self) -> dict:
        """Recorder health counters, read under the stamp lock — the
        ``tracer_collector`` source for ``pt_tracer_dropped_total`` /
        ``pt_tracer_gc_total`` (a saturated buffer or a GC'd request set
        silently under-reports TTFT tails; this makes saturation itself a
        scrapeable signal)."""
        with self._lock:
            return {"events": len(self.events), "dropped": self.dropped,
                    "gc": self.gc_count, "resubmits": self.resubmits,
                    "open": sum(1 for st in self._state.values()
                                if st == "open")}

    def is_open(self, rid: int) -> bool:
        """True while ``rid`` is submitted but has no terminal span yet —
        callers that might race the engine's own terminal stamp (e.g. the
        supervisor's replay-divergence path, where the twin may already
        have finished through ``_mark_done``) guard on this to preserve
        the one-terminal-per-lifecycle invariant."""
        with self._lock:
            return self._state.get(rid) == "open"

    def incomplete(self) -> List[int]:
        """Submitted rids with no terminal span yet — empty once a served
        wave has fully drained (the lifecycle-completeness invariant)."""
        with self._lock:
            return [rid for rid, st in self._state.items() if st == "open"]

    def lifecycle(self, rid: int) -> List[str]:
        """Ordered event names for one request — what the tests assert the
        submit -> admit -> first_token -> finish chain on."""
        with self._lock:
            return [e["name"] for e in self.events
                    if e.get("tid") == rid and rid != 0]

    def export_chrome(self, path: Optional[str] = None) -> dict:
        """Chrome-trace JSON (Perfetto / chrome://tracing loadable):
        ``{"traceEvents": [...]}`` with request lanes (tid = rid) and the
        engine lane (tid 0), pid = replica."""
        with self._lock:
            events = list(self.events)
            dropped = self.dropped
        meta = []
        pids = sorted({e.get("pid", 0) for e in events})
        for pid in pids:
            meta.append({"name": "process_name", "ph": "M", "ts": 0,
                         "pid": pid, "tid": 0,
                         "args": {"name": f"replica{pid}"}})
            meta.append({"name": "thread_name", "ph": "M", "ts": 0,
                         "pid": pid, "tid": 0,
                         "args": {"name": "engine"}})
        doc = {"traceEvents": meta + events,
               "displayTimeUnit": "ms",
               "otherData": {"dropped_events": dropped}}
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc

    def slo_summary(self) -> dict:
        """SLO rollup computed from the (fixed-bucket) histograms:
        p50/p99 TTFT, mean-inter-token-latency percentiles, queue-wait
        percentiles, shed/failover rates (``chip_smoke.py`` phase 26 prints
        p50/p99 TTFT from here)."""
        def q(h, p):
            v = h.quantile(p)
            return None if v is None else round(v, 3)

        submitted = self._c_submitted.value()
        shed = self._c_terminal.value(kind="shed")
        out = {
            "p50_time_to_first_token_ms": q(self._h_ttft, 0.50),
            "p99_time_to_first_token_ms": q(self._h_ttft, 0.99),
            "p50_inter_token_ms": q(self._h_itl, 0.50),
            "p99_inter_token_ms": q(self._h_itl, 0.99),
            "p50_queue_wait_ms": q(self._h_qwait, 0.50),
            "p99_queue_wait_ms": q(self._h_qwait, 0.99),
            "submitted": int(submitted),
            "tokens_streamed": int(self._c_tokens.value()),
            "shed_rate": (shed / submitted) if submitted else 0.0,
            "failover_rate": (self._c_failovers.value() / submitted
                              if submitted else 0.0),
        }
        return out
