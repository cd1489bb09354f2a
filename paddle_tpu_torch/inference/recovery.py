"""Crash-recoverable serving: request journal + supervisor — port of
``paddle_tpu/inference/recovery.py``.

Every admitted request is fully described by its prompt ids, sampling
params, seed and deadline, and the engine's sample draws key on ``(seed,
position)`` alone. So the recovery unit is the REQUEST, not the engine:
journal what was admitted and how far each stream got, and an engine crash
costs a rebuild + replay that is byte-identical to the uninterrupted run
(greedy and seeded sampling; warm == cold means a fresh pool and an empty
radix cache cannot change a token).

- :class:`RequestJournal` — append-only, per-record crc32-checked journal.
  One line a record, ``<crc32 8 hex> <json>``, with the JAX package's JSON
  separators: a journal written by either package loads in the other. A
  torn TAIL (a crash mid-append) is tolerated and truncated; damage earlier
  raises :class:`JournalCorrupt` naming the record. Records: ``admit``,
  ``prog`` (delivered-token deltas with the high-water mark), ``fin``,
  ``migr`` (migrated to another replica), ``migr-kv`` (the KV chain
  moved to a decode-tier replica: terminal here, with the chain digest),
  ``shed``, ``crash``/``recovered``.
  ``defer`` buffers records and ``flush`` writes them in one syscall.
- :class:`ServingSupervisor` — owns the engine via a ``build_engine``
  factory. The engine decodes into private TWIN requests; the caller's
  ``Request`` receives tokens only after the step's records are flushed
  (the flush barrier). ``step`` arms a :class:`StepWatchdog` around the
  engine step; a crash (any exception out of ``step``, e.g. the
  ``serving.step`` kill fault) or an overrun (``serving.stall``) rebuilds:
  fresh engine, fresh pool, empty radix cache, every unfinished journaled
  request re-admitted and replayed up to its delivered mark, which the
  regenerated prefix must equal byte for byte (PT-SRV-005 fails the
  request otherwise), before new tokens stream on.

On the card a rebuilt fused engine captures its CUDA graph inside
``build_engine``, before the replay steps, which run unarmed; the first
``watchdog_grace_steps`` armed steps after a rebuild are unarmed too.

The KV-chain handoff of the disaggregated tiers (``inference/disagg.py``)
is journaled on both sides: ``retire_migrated`` appends ``migr-kv`` on the
source before its slot is released, ``submit_migrated`` journals the
destination's admit and delivered mark only after the splice landed.

Tracing (``tracer=``, ``trace_tags=``): the supervisor owns the
recorder's attachment because the engine is factory-built and REBUILT on
recovery (``_attach_tracer`` after every build), so one request's spans
stay in one timeline across crashes. A resumed or replayed request is
``mark_recovered`` at its delivered mark BEFORE its twin re-admits (the
catch-up regeneration streams no token twice, and every later span carries
``recovered: true``); a recovery is one ``recovery`` span; a replay
divergence stamps the request's terminal (or a ``replay_divergence``
instant when the twin already finished).

A later slice, refused with ``NotImplementedError``: the mesh-degrade
reshard (``_degrade`` and its ``mesh_degrade`` span: tp-sharded serving).

PT-SRV codes: 001 engine crash absorbed, 002 step watchdog overrun, 003
request shed at submit, 004 journal corruption, 005 replay divergence,
008 mesh degraded.
"""

from __future__ import annotations

import json
import os
import time
import zlib
from typing import Callable, Dict, List, Optional, Set

from .._later import later_slice
from ..distributed.resilience.watchdog import StepWatchdog
from .serving import (ContinuousBatchingEngine, MeshDegraded, Request,
                      RequestShed)

__all__ = ["JournalCorrupt", "RequestJournal", "ServingSupervisor"]


class JournalCorrupt(RuntimeError):
    """PT-SRV-004: a journal record failed its crc (or decode) somewhere
    other than the torn tail — the file was damaged after it was written."""


class RequestJournal:
    """Append-only, crc-checked request journal.

    One record per line: ``<crc32 of payload, 8 hex chars> <json payload>``.
    ``append`` flushes to the OS per record; ``defer`` + ``flush`` batch
    many records into one write+flush (``fsync=True`` also forces them to
    disk).

    Loading tolerates a torn final record (a crash mid-append) by
    truncating to the last good record; a bad crc anywhere EARLIER raises
    :class:`JournalCorrupt` naming the line — silent damage never replays.
    """

    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        self.fsync = bool(fsync)
        self._buf: List[bytes] = []
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        if os.path.exists(path):
            self.records, good = self._load_bytes(path)
            # drop a torn tail NOW: appending after partial bytes would
            # weld the next record onto them
            if good < os.path.getsize(path):
                with open(path, "r+b") as f:
                    f.truncate(good)
        else:
            self.records = []
        self._fh = open(path, "ab")

    @staticmethod
    def load(path: str) -> List[dict]:
        return RequestJournal._load_bytes(path)[0]

    @staticmethod
    def _load_bytes(path: str):
        """Parse the journal; returns ``(records, good_byte_length)`` where
        the length covers every intact record (a torn tail is excluded)."""
        out: List[dict] = []
        good = 0
        with open(path, "rb") as f:
            lines = f.read().split(b"\n")
        for i, line in enumerate(lines):
            if not line:
                # the split's final element is always empty; a blank line
                # with records AFTER it is damage (skipping it would make
                # ``good`` undercount and the truncate chop a record)
                if any(lines[j] for j in range(i + 1, len(lines))):
                    raise JournalCorrupt(
                        f"PT-SRV-004: journal {path} record {i + 1}: blank "
                        "line — records after it exist, so this is damage, "
                        "not a torn append")
                break
            bad = None
            if len(line) < 10 or line[8:9] != b" ":
                bad = "malformed record"
            else:
                payload = line[9:]
                try:
                    want = int(line[:8], 16)
                except ValueError:
                    want, bad = -1, "malformed crc"
                if bad is None and (zlib.crc32(payload) & 0xFFFFFFFF) != want:
                    bad = "crc mismatch"
                if bad is None:
                    try:
                        out.append(json.loads(payload.decode("utf-8")))
                        good += len(line) + 1
                        continue
                    except (UnicodeDecodeError, json.JSONDecodeError):
                        bad = "undecodable payload"
            # damage in the tail record = torn append -> tolerated; damage
            # earlier = corruption
            if any(lines[j] for j in range(i + 1, len(lines))):
                raise JournalCorrupt(
                    f"PT-SRV-004: journal {path} record {i + 1}: {bad} — "
                    "records after it exist, so this is damage, not a torn "
                    "append")
            break
        return out, good

    def defer(self, kind: str, **fields) -> None:
        """Buffer one record in memory (visible at once in
        :attr:`records`). Nothing reaches the file until :meth:`flush`:
        flush BEFORE acting on anything a crash must be able to replay."""
        rec = {"k": kind}
        rec.update(fields)
        payload = json.dumps(rec, separators=(",", ":")).encode("utf-8")
        crc = zlib.crc32(payload) & 0xFFFFFFFF
        self._buf.append(b"%08x " % crc + payload + b"\n")
        self.records.append(rec)

    def flush(self) -> None:
        """Write every deferred record in ONE syscall and flush to the OS
        (+fsync when configured) — the durability barrier."""
        if not self._buf:
            return
        self._fh.write(b"".join(self._buf))
        self._buf.clear()
        self._fh.flush()
        if self.fsync:
            os.fsync(self._fh.fileno())

    def append(self, kind: str, **fields) -> None:
        self.defer(kind, **fields)
        self.flush()

    @staticmethod
    def pending(records: List[dict]) -> List[dict]:
        """Admit records with no matching terminal (``fin``/``migr``/
        ``migr-kv``) record — the ONE definition of the replay set, shared
        by :meth:`unfinished` and the fleet's journal-backed failover."""
        done = {r["rid"] for r in records
                if r["k"] in ("fin", "migr", "migr-kv")}
        return [r for r in records
                if r["k"] == "admit" and r["rid"] not in done]

    def unfinished(self) -> List[dict]:
        """The replay set (a migrated request is another replica's)."""
        return self.pending(self.records)

    def delivered(self, rid: int) -> List[int]:
        """Token ids journaled as delivered for ``rid`` (concatenated
        ``prog`` deltas) — the prefix replay must reproduce exactly."""
        toks: List[int] = []
        for r in self.records:
            if r["k"] == "prog" and r["rid"] == rid:
                toks.extend(r["toks"])
        return toks

    def close(self) -> None:
        self.flush()
        self._fh.close()

    def abandon(self) -> None:
        """Close WITHOUT flushing — process-death simulation: deferred
        records die with the process. The flush barrier guarantees no
        surfaced token is among them."""
        self._buf.clear()
        self._fh.close()


def _admit_record(req: Request) -> dict:
    return {"rid": req.rid, "prompt": [int(t) for t in req.prompt],
            "max_new": req.max_new_tokens, "eos": req.eos_token_id,
            "temp": req.temperature, "top_p": req.top_p, "top_k": req.top_k,
            "seed": req.seed, "deadline_s": req.deadline_s,
            "priority": req.priority, "tenant": req.tenant}


def _request_from(rec: dict) -> Request:
    r = Request(rec["prompt"], max_new_tokens=rec["max_new"],
                eos_token_id=rec["eos"], temperature=rec["temp"],
                top_p=rec["top_p"], top_k=rec["top_k"], seed=rec["seed"],
                deadline_s=rec["deadline_s"], priority=rec["priority"],
                tenant=rec.get("tenant"))
    # twins and restart reconstructions carry the ORIGINAL rid: the
    # journal, the engine bookkeeping and the fleet's routing all key on it
    r.rid = rec["rid"]
    return r


class ServingSupervisor:
    """Crash-recoverable supervisor of a :class:`ContinuousBatchingEngine`.

    >>> sup = ServingSupervisor(lambda: ContinuousBatchingEngine(model, ...),
    ...                         journal_path, step_budget_s=2.0)
    >>> sup.submit(Request(prompt, max_new_tokens=64))
    >>> done = sup.run_until_done()

    Across a crash the streams continue byte-identically. A supervisor
    constructed over an EXISTING journal (process restart) re-admits every
    unfinished request at once; their reconstructed ``Request`` objects live
    in :attr:`requests`. ``max_recoveries`` bounds the rebuild budget (0 is
    the fault drill's control arm). ``step_budget_s`` must comfortably
    exceed a WARM step: warm the engine first, then arm it with
    :meth:`set_step_budget`.
    """

    #: exceptions that are caller errors, never engine-state damage
    _SUBMIT_ERRORS = (ValueError,)

    def __init__(self, build_engine: Callable[[], ContinuousBatchingEngine],
                 journal_path: str, step_budget_s: Optional[float] = None,
                 max_recoveries: int = 2, watchdog_grace_steps: int = 4,
                 fsync: bool = False, tracer=None,
                 trace_tags: Optional[dict] = None, elastic: bool = True):
        self._build = build_engine
        # every engine this supervisor builds gets the same recorder
        self.tracer = tracer
        self.trace_tags = dict(trace_tags or {})
        # a rebuilt engine's first steps can be slow (first launches at new
        # shapes) and read as stalls: the first N steps after every
        # rebuild run unarmed
        self.watchdog_grace_steps = int(watchdog_grace_steps)
        self._grace = 0
        self.journal = RequestJournal(journal_path, fsync=fsync)
        self.requests: Dict[int, Request] = {}   # rid -> caller-facing req
        self._live: Dict[int, Request] = {}      # rid -> twin in the engine
        self._meta: Dict[int, dict] = {}         # rid -> admit record
        # rids whose twin started BEHIND the delivered mark (recovery or a
        # resume submission): the regenerated prefix must byte-match the
        # delivered one before anything new is surfaced (PT-SRV-005)
        self._verify: Set[int] = set()
        self._done: set = set()
        self._finished: Dict[int, Request] = {}
        self.events: List[tuple] = []            # (code, message)
        self.recoveries = 0
        self.max_recoveries = int(max_recoveries)
        self.watchdog = (StepWatchdog(step_budget_s)
                         if step_budget_s is not None else None)
        # elastic=False is the mesh-degrade CONTROL arm: a MeshDegraded out
        # of the engine escapes instead of resharding
        self.elastic = bool(elastic)
        self.stats = {"shed": 0, "recoveries": 0, "recovery_s": 0.0,
                      "replayed_requests": 0, "mesh_reshards": 0,
                      "mesh_degraded": 0}
        self.engine = build_engine()
        self._attach_tracer()
        # rids come from a per-process counter; a restart over an existing
        # journal resets it, so bump it past every journaled rid before any
        # submit (a collision would merge two requests' records)
        if self.journal.records:
            Request._counter[0] = max(
                Request._counter[0],
                max(r["rid"] for r in self.journal.records if "rid" in r))
        pending = self.journal.unfinished()
        if pending:
            # process restart over a live journal: replay now
            for rec in pending:
                self._meta[rec["rid"]] = rec
            self._recover("PT-SRV-001",
                          f"journal restart: {len(pending)} unfinished "
                          "request(s) found", rebuild=False)

    def _attach_tracer(self) -> None:
        if self.tracer is not None:
            self.engine.tracer = self.tracer
            self.engine.trace_tags = dict(self.trace_tags)

    # -- public API --------------------------------------------------------
    def submit(self, req: Request, resume: bool = False) -> int:
        """Journal + admit (a private twin carrying the same rid enters the
        engine). ``RequestShed`` / ``EngineSaturated`` propagate (the
        journal records sheds; a saturated queue records nothing).

        ``resume=True``: ``req.output`` already holds tokens delivered by a
        previous engine/replica (fleet failover). They are journaled as this
        supervisor's high-water mark, the twin regenerates them, and nothing
        new surfaces until the regenerated prefix byte-matches the delivered
        one (PT-SRV-005 on divergence)."""
        meta = _admit_record(req)
        twin = _request_from(meta)
        if resume and self.tracer is not None:
            # raise the streamed-token dedup floor BEFORE the twin admits:
            # catch-up regeneration below the delivered mark re-streams
            # nothing, and every span from here on carries recovered=true
            self.tracer.mark_recovered(req.rid, len(req.output),
                                       self.trace_tags)
        if resume:
            # journaled work is never refused: backpressure and feasibility
            # shedding were charged at the ORIGINAL submit
            saved_q = self.engine.max_queue
            saved_shed = self.engine.shed_infeasible
            self.engine.max_queue = None
            self.engine.shed_infeasible = False
            try:
                self.engine.add_request(twin)
            finally:
                self.engine.max_queue = saved_q
                self.engine.shed_infeasible = saved_shed
        else:
            try:
                self.engine.add_request(twin)
            except RequestShed:
                self.stats["shed"] += 1
                self.journal.append("shed", rid=req.rid)
                raise
        self.journal.defer("admit", **meta)
        if resume and req.output:
            self.journal.defer("prog", rid=req.rid, hwm=len(req.output),
                               toks=[int(t) for t in req.output])
            self._verify.add(req.rid)
        self.journal.flush()
        req._n_out = len(req.output)
        self.requests[req.rid] = req
        self._live[req.rid] = twin
        self._meta[req.rid] = meta
        return req.rid

    def step(self) -> None:
        armed = self.watchdog is not None and self._grace <= 0
        if self._grace > 0:
            self._grace -= 1
        if armed:
            self.watchdog.arm(f"step:{getattr(self.engine, '_step_idx', 0)}")
        try:
            self.engine.step()
        except self._SUBMIT_ERRORS:
            if armed:
                self.watchdog.disarm()
            raise
        except MeshDegraded as e:
            # device-group loss is distinct from an engine crash (the
            # elastic reshard); elastic=False or an exhausted budget lets
            # it escape
            if armed:
                self.watchdog.disarm()
            if not self.elastic or self.recoveries >= self.max_recoveries:
                raise
            self._degrade(e)
            return
        except Exception as e:  # engine state is untrusted from here on
            if armed:
                self.watchdog.disarm()
            if self.recoveries >= self.max_recoveries:
                raise
            self._recover(
                "PT-SRV-001",
                f"engine step raised {type(e).__name__}: {e}")
            return
        overran = self.watchdog.disarm() if armed else False
        if overran:
            tag, elapsed = self.watchdog.overruns[-1]
            if self.recoveries >= self.max_recoveries:
                raise RuntimeError(
                    f"PT-SRV-002: step {tag} stalled {elapsed:.3f}s past the "
                    f"{self.watchdog.budget_s:.3f}s budget and the recovery "
                    "budget is exhausted")
            self._recover(
                "PT-SRV-002",
                f"step {tag} overran its {self.watchdog.budget_s:.3f}s "
                f"budget ({elapsed:.3f}s) — engine presumed stuck")
            return
        self._sync_progress()

    def has_work(self) -> bool:
        return self.engine.has_work() or any(
            rid not in self._done for rid in self.requests)

    def run_until_done(self, max_steps: int = 100000) -> Dict[int, Request]:
        steps = 0
        while self.has_work() and steps < max_steps:
            self.step()
            steps += 1
        return self.finished()

    def finished(self) -> Dict[int, Request]:
        self.engine.finished()
        self._sync_progress()
        out, self._finished = self._finished, {}
        return out

    def load(self) -> int:
        """Requests currently in this supervisor's engine (queued + slotted
        + mid-prefill) — the fleet router's balancing signal."""
        eng = self.engine
        return len(eng._queue) + eng.active_slots()

    def progress(self) -> tuple:
        """Progress marker for the fleet heartbeat: changes whenever a
        stream advances, a request completes, the engine is rebuilt, or the
        load changes (idleness must not count against the wedge ttl)."""
        return (id(self.engine), self.engine._sched_tokens,
                len(self._done), self.load())

    def behind(self, rid: int) -> bool:
        """True while ``rid``'s twin has regenerated fewer tokens than the
        caller's delivered mark and is still running — the fleet
        failover's catch-up condition."""
        twin = self._live.get(rid)
        user = self.requests.get(rid)
        if twin is None or user is None:
            return False
        return twin._n_out < len(user.output) and not twin.done

    def withdraw(self, rid: int) -> Optional[dict]:
        """Pull a still-QUEUED request out of the engine (fleet drain
        migration): journals ``migr`` and returns its admit record so the
        caller can resubmit it elsewhere. None when the request is already
        active (in-flight work finishes here) or done."""
        twin = self._live.get(rid)
        if rid in self._done or twin is None:
            return None
        if not self.engine.withdraw_queued(rid):
            return None
        self.journal.append("migr", rid=rid)
        self._live.pop(rid, None)
        self._verify.discard(rid)
        self.requests.pop(rid, None)
        return self._meta.pop(rid, None)

    def submit_migrated(self, req: Request, artifact: bytes, codec) -> int:
        """Accept a migrated finished-prefill chain: splice its pages into
        this supervisor's engine (``codec.import_chain``) and resume decode
        at the recorded position. The admit and the delivered high-water
        mark are journaled AFTER the splice lands, so a refusal
        (``EngineSaturated`` on a slot or pool shortfall, ``KVChainCorrupt``
        PT-SRV-007 on damaged bytes, ``ValueError`` on another geometry)
        propagates with no journal trace.

        The twin continues the stream in place (its output starts with the
        delivered tokens): nothing is regenerated, so there is no PT-SRV-005
        window. A crash after this replays from the journaled admit: the
        rebuilt engine re-runs prefill and verifies the delivered prefix."""
        meta = _admit_record(req)
        twin = _request_from(meta)
        twin.output = [int(t) for t in req.output]
        twin._n_out = len(twin.output)
        codec.import_chain(self.engine, artifact, req=twin)
        self.journal.defer("admit", **meta)
        if req.output:
            self.journal.defer("prog", rid=req.rid, hwm=len(req.output),
                               toks=[int(t) for t in req.output])
        self.journal.flush()
        req._n_out = len(req.output)
        self.requests[req.rid] = req
        self._live[req.rid] = twin
        self._meta[req.rid] = meta
        return req.rid

    def retire_migrated(self, rid: int, digest: str) -> Optional[dict]:
        """The source side of the handoff: journal ``migr-kv`` (failover
        over this journal must not serve ``rid`` again), then release the
        ACTIVE slot (its chain was exported first). Returns the admit
        record, as :meth:`withdraw` does."""
        self.journal.append("migr-kv", rid=rid, digest=str(digest))
        self.engine.withdraw_active(rid)
        self._live.pop(rid, None)
        self._verify.discard(rid)
        self.requests.pop(rid, None)
        return self._meta.pop(rid, None)

    def set_step_budget(self, budget_s: Optional[float]) -> None:
        """(Re)arm the step watchdog — after a warm-up wave, so the budget
        can be set from the measured warm step time."""
        if self.watchdog is not None:
            self.watchdog.close()
        self.watchdog = (StepWatchdog(budget_s)
                         if budget_s is not None else None)

    def close(self) -> None:
        if self.watchdog is not None:
            self.watchdog.close()
        self.journal.close()

    def abandon(self) -> None:
        """Process-death simulation (fleet replica kill): release the fd
        and watchdog WITHOUT flushing deferred records."""
        if self.watchdog is not None:
            self.watchdog.close()
        self.journal.abandon()

    # -- progress / recovery ----------------------------------------------
    def _sync_progress(self) -> None:
        """Advance the caller-visible streams: drain the engine into the
        twins, journal the per-request deltas (ONE buffered write), flush,
        and only then splice tokens / completion into the caller's
        objects — every token a caller could have seen is on disk."""
        self.engine._drain_pending()
        self.engine._finished.clear()
        updates: List[tuple] = []
        for rid, twin in list(self._live.items()):
            if rid in self._done:
                continue
            user = self.requests.get(rid)
            if user is None:
                continue
            n_user = len(user.output)
            n_twin = len(twin.output)
            if rid in self._verify:
                if n_twin < n_user and not twin.done:
                    continue            # still catching up: surface nothing
                k = min(n_twin, n_user)
                # a twin that FAILED short of the mark (its deadline expired
                # again during the catch-up) is an ordinary failure; ending
                # early without failing, or other tokens, is divergence
                if (twin.output[:k] != user.output[:k]
                        or (twin.done and not twin.failed
                            and n_twin < n_user)):
                    err = (f"PT-SRV-005: replay diverged from the delivered "
                           f"stream at rid={rid} — {twin.output[:k][:8]}... "
                           f"vs {user.output[:8]}...")
                    self.events.append(("PT-SRV-005", err))
                    self.journal.defer("fin", rid=rid, failed=True)
                    if self.tracer is not None:
                        # a twin that never reached the engine's _mark_done
                        # needs its terminal here; one that did (done but
                        # diverged) already has one: record the divergence
                        # without a second terminal
                        if self.tracer.is_open(rid):
                            self.tracer.finish(rid, len(user.output),
                                               failed=True, error=err,
                                               kind="fail",
                                               tags=self.trace_tags)
                        else:
                            self.tracer.instant("replay_divergence", rid,
                                                self.trace_tags,
                                                error=err[:200])
                    updates.append((rid, user, [], True, True, err))
                    continue
                if n_twin >= n_user:
                    self._verify.discard(rid)
            new = twin.output[n_user:] if n_twin > n_user else []
            if new:
                self.journal.defer("prog", rid=rid, hwm=n_twin,
                                   toks=[int(t) for t in new])
            if twin.done:
                self.journal.defer("fin", rid=rid, failed=bool(twin.failed))
                updates.append((rid, user, new, True, twin.failed,
                                twin.error))
            elif new:
                updates.append((rid, user, new, False, False, None))
        # FLUSH BARRIER: nothing below becomes caller-visible until its
        # journal record is past the OS write
        self.journal.flush()
        for rid, user, new, done, failed, error in updates:
            if new:
                user.output.extend(new)
                user._n_out = len(user.output)
            if done:
                user.done = True
                user.failed = bool(failed)
                user.error = error
                self._done.add(rid)
                self._finished[rid] = user
                self._live.pop(rid, None)
                self._verify.discard(rid)

    def _degrade(self, e: MeshDegraded) -> None:
        """PT-SRV-008 reshard-and-resume: needs a tp-sharded engine."""
        raise later_slice("the mesh-degrade reshard (MeshDegraded)",
                          "tp-sharded serving", "7") from e

    def _recover(self, code: str, msg: str, rebuild: bool = True) -> None:
        """Rebuild the engine and replay every unfinished journaled request
        on it: fresh block pool, empty radix cache, deadline clocks reset.
        Blocks until each replay has caught up to its delivered high-water
        mark (verified bit-for-bit), then returns."""
        t0 = time.monotonic()
        t0_tr = None if self.tracer is None else self.tracer.now()
        self.recoveries += 1
        self.stats["recoveries"] += 1
        self._grace = self.watchdog_grace_steps
        self.events.append((code, msg))
        if rebuild:
            self.journal.append("crash", code=code, msg=msg)
            self.engine = self._build()
            self._attach_tracer()
        replaying: List[int] = []
        # shedding and backpressure were charged at the original submit
        saved_max_queue = self.engine.max_queue
        saved_shed = self.engine.shed_infeasible
        self.engine.max_queue = None
        self.engine.shed_infeasible = False
        try:
            for rec in self.journal.unfinished():
                rid = rec["rid"]
                if rid in self._done or rid not in self._meta:
                    continue
                user = self.requests.get(rid)
                if user is None:
                    # restart path: the caller-facing object and its
                    # delivered prefix come from the journal
                    user = self.requests[rid] = _request_from(
                        self._meta[rid])
                    user.output.extend(self.journal.delivered(rid))
                    user._n_out = len(user.output)
                user.done = user.failed = False
                user.error = None
                twin = _request_from(self._meta[rid])
                self._live[rid] = twin
                if user.output:
                    self._verify.add(rid)
                if self.tracer is not None:
                    self.tracer.mark_recovered(rid, len(user.output),
                                               self.trace_tags)
                self.engine.add_request(twin)
                replaying.append(rid)
        finally:
            self.engine.max_queue = saved_max_queue
            self.engine.shed_infeasible = saved_shed
        self.stats["replayed_requests"] += len(replaying)
        # catch up to the delivered marks before declaring recovery done
        guard = 0
        while any(self._live[rid]._n_out < len(self.requests[rid].output)
                  and not self._live[rid].done for rid in replaying
                  if rid in self._live):
            try:
                self.engine.step()
            except Exception as e:
                # a crash DURING the replay draws on the same budget
                if self.recoveries >= self.max_recoveries:
                    raise
                self._recover(
                    code, f"engine crashed again during replay "
                    f"({type(e).__name__}: {e})")
                return
            guard += 1
            if guard > 100000:
                raise RuntimeError(
                    "recovery replay did not reach the journaled high-water "
                    "marks — engine is not making progress")
        self._sync_progress()
        dt = time.monotonic() - t0
        self.stats["recovery_s"] += dt
        if self.tracer is not None:
            self.tracer.recovery(t0_tr, code, len(replaying),
                                 tags=self.trace_tags)
        self.journal.append("recovered", code=code, n=len(replaying),
                            seconds=round(dt, 6))
