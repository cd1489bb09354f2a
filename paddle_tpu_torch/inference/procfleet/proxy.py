"""Driver-side proxy for one replica worker — port of
``paddle_tpu/inference/procfleet/proxy.py``.

:class:`ProcReplica` conforms to the replica surface
:class:`~paddle_tpu_torch.inference.fleet.FleetRouter` consumes — submit /
step / finished / load / progress / behind / withdraw / close / abandon
plus the ``.engine`` geometry namespace — so the router, the tiered router
and the SLO autoscaler drive a process-backed fleet through the code paths
they already have.

Failure semantics:

- **Death is process death.** A worker that is SIGKILLed, segfaults,
  loses its CUDA context or raises past its recovery budget surfaces here
  as :class:`WorkerDead` (**PT-PROC-002**) out of ``step()`` — the
  router's per-replica exception boundary marks the replica dead and runs
  its JOURNAL-BACKED failover against the worker's on-disk journal. The
  proxy holds the caller-facing ``Request`` objects, so re-admitted
  streams continue byte-identically on survivors, as in the in-process
  fleet. A CUDA fault stays inside its worker's process: the other
  workers and the driver keep their contexts.
- **Timeouts are typed.** Every wire op runs under a per-op timeout; a
  worker that stops answering raises :class:`WorkerDead` naming the op
  (PT-PROC-003 in the message). Idempotent probes (PROGRESS / METRICS)
  ride ``retry_call``; mutating ops (SUBMIT/STEP/WITHDRAW) are single-shot
  — a blind retry could double-apply.
- **Heartbeats.** An optional daemon thread probes PROGRESS every
  ``heartbeat_s`` so death is noticed between driver steps
  (``pt_procfleet_heartbeats_total``).
- **Circuit breaker.** :class:`CircuitBreaker` routes around a
  slow-but-alive peer (:class:`BreakerOpen`, **PT-PROC-004**) without
  failing anything over.

Trace stamps are made DRIVER-SIDE from the token deltas (submit → admit →
first_token → tokens → finish), on the driver's tracer and its clock.
"""

from __future__ import annotations

import atexit
import os
import pickle
import signal
import socket
import subprocess
import sys
import threading
import time
from types import SimpleNamespace
from typing import Dict, List, Optional, Set, Tuple

from .transport import ChaosTransport, TcpTransport, Transport, \
    loopback_pair
from .wire import Message, WireClosed, WireCorrupt
from .worker import WorkerSpec, _refuse_mesh, worker_thread_main

__all__ = ["ProcReplica", "WorkerDead", "BreakerOpen", "CircuitBreaker",
           "MeshMismatch"]

#: the directory this package was imported from: a worker imports the
#: same code as its driver, wherever the driver was started
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))

# every live worker Popen, so an exiting driver never leaks processes —
# guarded: ProcReplica spawns/reaps from driver threads while atexit runs
# on the main thread
_LIVE_LOCK = threading.Lock()
_LIVE_WORKERS: Set[int] = set()          # pids
_ATEXIT_ARMED = [False]


def _kill_leftovers() -> None:
    with _LIVE_LOCK:
        pids = list(_LIVE_WORKERS)
        _LIVE_WORKERS.clear()
    for pid in pids:
        try:
            os.kill(pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass


def _track_worker(pid: int) -> None:
    with _LIVE_LOCK:
        if not _ATEXIT_ARMED[0]:
            atexit.register(_kill_leftovers)
            _ATEXIT_ARMED[0] = True
        _LIVE_WORKERS.add(pid)


def _untrack_worker(pid: int) -> None:
    with _LIVE_LOCK:
        _LIVE_WORKERS.discard(pid)


class WorkerDead(RuntimeError):
    """PT-PROC-002: the replica worker process is gone (SIGKILL, crash,
    fatal supervisor error) or stopped answering within the op timeout —
    the router fails its work over from the on-disk journal."""


class MeshMismatch(RuntimeError):
    """PT-PROC-005: the worker's HELLO reported an engine mesh width that
    contradicts the spec the driver spawned it with (``WorkerSpec.mesh``)
    — a preset/config skew that would otherwise serve silently at the
    wrong width (wrong capacity weighting, wrong device-group accounting,
    a PT-COMM contract recorded at a width the fleet never asked for).
    Raised at spawn, before the replica joins the fleet; the worker is
    killed and reaped."""


class BreakerOpen(RuntimeError):
    """PT-PROC-004: this replica's circuit breaker is OPEN — the peer is
    slow-but-alive (consecutive failures or a latency EMA past budget),
    so ops fail FAST and the router routes around it. Deliberately not
    :class:`WorkerDead`: nothing is failed over, no journal is replayed —
    the worker keeps its in-flight state and rejoins when a HALF_OPEN
    probe (riding the piggybacked PROGRESS tick) comes back healthy."""


class CircuitBreaker:
    """Per-peer CLOSED -> OPEN -> HALF_OPEN breaker driven from
    ``_roundtrip`` outcomes.

    Two trip conditions, both about slow-but-ALIVE peers (death has its
    own path): ``fail_threshold`` consecutive retryable failures, or a
    latency EMA above ``latency_s``. While OPEN every non-probe op
    raises :class:`BreakerOpen` without touching the wire; after
    ``cooldown_s`` the state is HALF_OPEN and exactly the idempotent
    PROGRESS/METRICS probes pass — one healthy (fast) probe closes the
    breaker, a failed or still-slow one reopens it. All methods are
    called under the proxy's ``_state_lock``."""

    def __init__(self, fail_threshold: int = 3,
                 latency_s: Optional[float] = None,
                 cooldown_s: float = 5.0, ema_alpha: float = 0.4):
        self.fail_threshold = int(fail_threshold)
        self.latency_s = None if latency_s is None else float(latency_s)
        self.cooldown_s = float(cooldown_s)
        self.ema_alpha = float(ema_alpha)
        self.state = "closed"
        self.ema_s = 0.0
        self.fails = 0
        self.trips = 0
        self._opened_at = 0.0

    def allow(self, probe: bool) -> bool:
        if self.state == "closed":
            return True
        if self.state == "open":
            if time.monotonic() - self._opened_at < self.cooldown_s:
                return False
            self.state = "half_open"
        return probe                     # HALF_OPEN: probes only

    def _trip(self) -> None:
        if self.state != "open":
            self.state = "open"
            self.trips += 1
        self._opened_at = time.monotonic()

    def record(self, ok: bool, dt_s: float) -> None:
        if not ok:
            self.fails += 1
            if self.state == "half_open" or self.fails >= self.fail_threshold:
                self._trip()
            return
        self.fails = 0
        a = self.ema_alpha
        self.ema_s = dt_s if self.ema_s == 0.0 else \
            a * dt_s + (1.0 - a) * self.ema_s
        slow = self.latency_s is not None and self.ema_s > self.latency_s
        if self.state == "half_open":
            if slow:
                self._trip()             # answered, but still past budget
            else:
                self.state = "closed"
        elif self.state == "closed" and slow:
            self._trip()


def _retry_policy():
    from ...distributed.resilience.retry import RetryPolicy

    return RetryPolicy(max_attempts=2, base_delay=0.05, max_delay=0.2,
                       retry_on=(socket.timeout,))


class ProcReplica:
    """One spawned worker process + its control socket, driven from the
    fleet router's replica slot.

    >>> rep = ProcReplica(WorkerSpec(factory="pkg.mod:factory",
    ...                              journal_path=path), idx=0)
    >>> rep.submit(req); rep.step(); rep.close()
    """

    def __init__(self, spec: WorkerSpec, idx: int = 0, tracer=None,
                 trace_tags: Optional[dict] = None,
                 op_timeout_s: float = 60.0, spawn_timeout_s: float = 240.0,
                 heartbeat_s: Optional[float] = None,
                 stats: Optional[dict] = None,
                 transport: str = "tcp", chaos: bool = False,
                 breaker: Optional[dict] = None,
                 migrate_bw_bytes_per_s: float = 32.0 * 1024 * 1024):
        if transport not in ("tcp", "loopback"):
            raise ValueError(
                f"unknown transport {transport!r} (tcp | loopback)")
        _refuse_mesh(spec)
        self.idx = int(idx)
        self.spec = spec
        self.tracer = tracer
        self.trace_tags = dict(trace_tags or {})
        self.op_timeout_s = float(op_timeout_s)
        # MIGRATE_IN/OUT deadlines scale with payload bytes over this
        # assumed bandwidth: a legitimately big int8 chain must not read
        # as a wedged worker (or trip the breaker) under the flat budget
        self._migrate_bw = float(migrate_bw_bytes_per_s)
        self._breaker = None if breaker is None else CircuitBreaker(
            **dict(breaker))
        self.transport_retries = 0      # retryable timeouts, this peer
        self._idem_counter = 0
        self.stats = stats if stats is not None else {}
        self.requests: Dict[int, "object"] = {}   # rid -> caller Request
        self._done: Set[int] = set()
        self._finished: Dict[int, "object"] = {}
        self._submit_ts: Dict[int, float] = {}
        self._streaming: Set[int] = set()         # rids past first delta
        self._io_lock = threading.Lock()          # one req/reply in flight
        self._state_lock = threading.Lock()       # heartbeat-shared state
        self._catchup: Set[int] = set()
        self._ready: List[int] = []
        self._last_sig: tuple = ()
        # reply-piggybacked worker state: every change is driver-initiated
        # (submit/step/withdraw) or rides a step reply, so these are EXACT
        # between ops — router probes (load/progress/has_work, called per
        # submit and per tick) cost zero extra roundtrips
        self._load = 0
        self._has_work = False
        self._cap = [0, 0]              # [free slots, optimistic pages]
        self._open: Set[int] = set()    # rids submitted, not yet terminal
        self._seq = 0                   # request/reply matching (io_lock)
        self._hb_count = 0
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        self.dead = False
        self.reaped = False
        self._fault_hook = None
        self._fault_cls = None

        self.process = None
        self._worker_thread: Optional[threading.Thread] = None
        self._spec_path = None
        deadline = time.monotonic() + float(spawn_timeout_s)
        if transport == "loopback":
            # in-process worker on a thread over a queue-pair transport:
            # same supervisor/journal/serve loop, no process spawn — the
            # fast arm for tests and chaos drills. "Process death" is the
            # transport closing; failover reads the journal identically.
            drv_tr, wrk_tr = loopback_pair(
                a="driver", b=f"replica:{idx}:loopback")
            base = drv_tr
            self._worker_thread = threading.Thread(
                target=worker_thread_main, args=(spec, wrk_tr),
                name=f"pt-procfleet-worker-{idx}", daemon=True)
            self._worker_thread.start()
            self.stats["proc_spawned"] = \
                self.stats.get("proc_spawned", 0) + 1
        else:
            listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            listener.bind(("127.0.0.1", 0))
            listener.listen(1)
            host, port = listener.getsockname()
            # the worker is a PLAIN subprocess (`python -m ..._spawn_main`):
            # no inherited interpreter state, no parent-__main__
            # re-execution — the spec travels as a pickle file beside the
            # journal, env vars (OMP_NUM_THREADS etc.) are set before the
            # child's first import, and the root this package was imported
            # from leads the child's path
            self._spec_path = spec.journal_path + ".spec"
            with open(self._spec_path, "wb") as f:
                f.write(pickle.dumps(spec))
            env = dict(os.environ)
            env["PYTHONPATH"] = os.pathsep.join(
                [_PKG_ROOT] + [p for p in sys.path if p]
                + [p for p in (env.get("PYTHONPATH") or "").split(os.pathsep)
                   if p])
            env.update({k: str(v) for k, v in (spec.env or {}).items()})
            self.process = subprocess.Popen(
                [sys.executable, "-m",
                 "paddle_tpu_torch.inference.procfleet._spawn_main",
                 "--spec", self._spec_path, "--host", host,
                 "--port", str(port)],
                env=env, stdin=subprocess.DEVNULL)
            _track_worker(self.process.pid)
            self.stats["proc_spawned"] = \
                self.stats.get("proc_spawned", 0) + 1
            try:
                # short accept slices with a child liveness poll: a worker
                # that dies before connecting back (spec unpickle/import
                # failure) fails the spawn NOW, not after spawn_timeout_s
                while True:
                    if self.process.poll() is not None:
                        raise WireClosed(
                            f"worker exited rc={self.process.returncode} "
                            "before connecting back")
                    listener.settimeout(
                        min(0.5, max(0.05, deadline - time.monotonic())))
                    try:
                        conn, _ = listener.accept()
                        break
                    except socket.timeout:
                        if time.monotonic() >= deadline:
                            raise
            except (socket.timeout, WireClosed) as e:
                self.kill()
                self._reap()
                listener.close()
                raise WorkerDead(
                    f"PT-PROC-002: replica {idx} worker never connected "
                    f"back within {spawn_timeout_s:.0f}s "
                    f"({type(e).__name__}: {e})") from e
            finally:
                listener.close()
            base = TcpTransport(sock=conn)
        #: stable peer address for chaos matching, retry-stat tags and the
        #: breaker-state metric — ``replica:<i>@<transport endpoint>``
        self.peer = f"replica:{idx}@{base.peer}"
        self._tr: Transport = (ChaosTransport(base, peer=self.peer)
                               if chaos else base)
        try:
            self._tr.connect()
            hello = self._tr.recv_frame(
                timeout=max(0.1, deadline - time.monotonic()))
            if isinstance(base, TcpTransport):
                base.sock.settimeout(None)
        except (socket.timeout, ConnectionError, WireCorrupt) as e:
            # no handshake ever happened: nothing to wait for — kill and
            # reap immediately (the graceful wait is close()'s courtesy
            # for workers that acknowledged a SHUTDOWN)
            self.kill()
            self._reap()
            raise WorkerDead(
                f"PT-PROC-002: replica {idx} worker never said HELLO "
                f"within {spawn_timeout_s:.0f}s ({type(e).__name__}: {e})"
            ) from e
        if hello.mtype != "HELLO":
            self.kill()
            self._reap()
            why = (f" ({hello.payload['etype']}: {hello.payload['msg']})"
                   if hello.mtype == "ERROR" else "")
            raise WorkerDead(
                f"PT-PROC-002: replica {idx} opened with {hello.mtype}, "
                f"not HELLO{why}")
        self.worker_pid = int(hello.payload["pid"])
        self.metrics_port = hello.payload["metrics_port"]
        self._apply(hello.payload["state"])
        eng = dict(hello.payload["engine"])
        self.tier = eng.pop("tier", "serving")
        pending = eng.pop("pending", [])
        # in-replica mesh width: the HELLO width is the worker's ground
        # truth and must be the spec's (1: mesh > 1 is refused above)
        eng.setdefault("mesh_tp", 1)
        if int(eng["mesh_tp"]) != 1:
            self.kill()
            self._reap()
            raise MeshMismatch(
                f"PT-PROC-005: replica {idx} worker HELLO reports engine "
                f"mesh_tp={int(eng['mesh_tp'])} but the spec asked for an "
                "unsharded worker")
        #: the geometry surface FleetRouter reads (page_size for prefix
        #: chain keys, max_batch/max_queue for the brownout depth default)
        self.engine = SimpleNamespace(**eng)
        # worker spawned over a live journal: it replayed; we own the
        # caller-facing reconstructions (mirrors ServingSupervisor.requests)
        from ..recovery import _request_from

        for entry in pending:
            user = _request_from(entry["req"])
            user.output = [int(t) for t in entry["delivered"]]
            user._n_out = len(user.output)
            self.requests[user.rid] = user
        if heartbeat_s:
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop, args=(float(heartbeat_s),),
                name=f"pt-procfleet-hb-{idx}", daemon=True)
            self._hb_thread.start()

    # -- wire plumbing -----------------------------------------------------
    @property
    def metrics_url(self) -> Optional[str]:
        if self.metrics_port is None:
            return None
        return f"http://127.0.0.1:{self.metrics_port}/metrics"

    def _raise_error(self, reply: Message, what: str):
        etype = reply.payload["etype"]
        msg = reply.payload["msg"]
        from ..serving import EngineSaturated, RequestShed

        mapped = {"EngineSaturated": EngineSaturated,
                  "RequestShed": RequestShed, "ValueError": ValueError,
                  "KeyError": KeyError, "WireCorrupt": WireCorrupt}
        if etype == "KVChainCorrupt":
            from ..disagg import KVChainCorrupt

            raise KVChainCorrupt(msg)
        cls = mapped.get(etype)
        if cls is not None:
            raise cls(msg)
        # anything untyped out of a worker is replica death (a fatal
        # supervisor error past its recovery budget reports this way)
        self._note_dead()
        raise WorkerDead(
            f"PT-PROC-002: replica {self.idx} {what} failed fatally "
            f"({etype}: {msg})")

    def _record(self, ok: bool, dt_s: float) -> None:
        if self._breaker is None:
            return
        with self._state_lock:
            self._breaker.record(ok, dt_s)

    def _roundtrip(self, msg: Message, what: str,
                   timeout: Optional[float] = None,
                   expect: Tuple[str, ...] = (),
                   fatal_timeout: bool = True,
                   probe: bool = False) -> Message:
        timeout = self.op_timeout_s if timeout is None else timeout
        if self.dead:
            raise WorkerDead(
                f"PT-PROC-002: replica {self.idx} is already dead "
                f"({what} refused)")
        if self._breaker is not None:
            with self._state_lock:
                allowed = self._breaker.allow(probe)
            if not allowed:
                raise BreakerOpen(
                    f"PT-PROC-004: replica {self.idx} breaker is "
                    f"{self._breaker.state} — {what} routed around "
                    "(peer slow, not dead)")
        t0 = time.monotonic()
        try:
            with self._io_lock:
                # every request carries a sequence id the worker echoes:
                # when a probe times out and retries, the first attempt's
                # reply may still be in flight — replies carrying a stale
                # seq are drained and discarded instead of desyncing the
                # stream (a reply WITHOUT a seq matches anything: plain
                # peers in tests, and the pre-send HELLO)
                self._seq += 1
                seq = self._seq
                msg.payload["_seq"] = seq
                self._tr.send_frame(msg)
                deadline = time.monotonic() + timeout
                while True:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise socket.timeout(f"{what} reply deadline")
                    reply = self._tr.recv_frame(timeout=remaining)
                    got = reply.payload.pop("_seq", None)
                    if got is None or got == seq:
                        break
        except socket.timeout as e:
            self._record(False, time.monotonic() - t0)
            # a timeout with NO reply bytes consumed leaves the stream
            # aligned — the seq drain absorbs the late reply, so an
            # idempotent probe (or a hedged migration) may retry. A
            # timeout MID-frame leaves the position unusable: fatal
            # regardless of the retry policy.
            if not fatal_timeout and not getattr(e, "partial_read", False):
                with self._state_lock:
                    self.transport_retries += 1
                raise        # retryable: retry_call / the hedge owns it
            self._note_dead()
            raise WorkerDead(
                f"PT-PROC-003: replica {self.idx} {what} timed out after "
                f"{timeout:.1f}s — worker presumed wedged/dead") from e
        except WireCorrupt as e:
            # damaged frame on a live stream: the position is untrusted
            # from here on — this connection (and so this replica) is done
            self._note_dead()
            raise WorkerDead(
                f"PT-PROC-002: replica {self.idx} wire corrupt during "
                f"{what}: {e}") from e
        except (WireClosed, OSError) as e:
            self._note_dead()
            raise WorkerDead(
                f"PT-PROC-002: replica {self.idx} worker gone during "
                f"{what}: {e}") from e
        # the worker ANSWERED — even an ERROR reply means the peer is
        # alive and timely; only wire-level outcomes feed the breaker
        self._record(True, time.monotonic() - t0)
        if reply.mtype == "ERROR":
            self._raise_error(reply, what)
        if expect and reply.mtype not in expect:
            self._note_dead()
            raise WorkerDead(
                f"PT-PROC-002: replica {self.idx} answered {what} with "
                f"{reply.mtype}, wanted {expect} — protocol desync")
        return reply

    def _note_dead(self) -> None:
        with self._state_lock:
            self.dead = True

    # -- replica surface (what FleetRouter consumes) -----------------------
    def submit(self, req, resume: bool = False) -> int:
        # idempotence key: unique per LOGICAL admission (a later,
        # legitimate re-admit of the same rid gets a fresh key), constant
        # across duplicate deliveries of this one frame — a chaos-doubled
        # SUBMIT answers from the worker's idem cache instead of
        # double-admitting
        with self._state_lock:
            self._idem_counter += 1
            idem = f"sub:{self.idx}:{self._idem_counter}"
        payload = {"req": _admit(req), "resume": bool(resume),
                   "delivered": [int(t) for t in req.output] if resume
                   else [], "idem": idem}
        if resume and self.tracer is not None:
            self.tracer.mark_recovered(req.rid, len(req.output),
                                       self._tags(req))
        try:
            reply = self._roundtrip(Message("SUBMIT", payload), "submit",
                                    expect=("SUBMITTED",))
        except BreakerOpen as e:
            # to the router an OPEN breaker is indistinguishable from a
            # full engine: same typed refusal, same route-elsewhere
            from ..serving import EngineSaturated

            raise EngineSaturated(str(e)) from e
        self._apply({"load": reply.payload["load"], "has_work": True})
        req._n_out = len(req.output)
        with self._state_lock:
            self.requests[req.rid] = req
            self._done.discard(req.rid)
            self._open.add(req.rid)
            if resume and req.output:
                self._catchup.add(req.rid)
            self._submit_ts[req.rid] = time.monotonic()
        if self.tracer is not None:
            self.tracer.submit(req.rid, len(req.prompt),
                               req.max_new_tokens, self._tags(req))
        return req.rid

    def step(self) -> None:
        if self._fault_hook is None:
            from ...distributed.resilience.faults import (FaultInjected,
                                                          maybe_inject)

            self._fault_hook = maybe_inject
            self._fault_cls = FaultInjected
        try:
            self._fault_hook("fleet.proc_kill",
                             f"replica:{self.idx}:pid:{self.worker_pid}")
        except self._fault_cls:
            # the fault is REAL here: SIGKILL the worker process — the
            # step below then fails on the dead socket and the router's
            # journal-backed failover takes over (the drill's point)
            self.kill()
        try:
            reply = self._roundtrip(Message("STEP"), "step",
                                    expect=("TOKENS",))
        except BreakerOpen:
            # skip the tick: the worker keeps its in-flight state and the
            # streams resume when a HALF_OPEN probe closes the breaker —
            # deliberately NOT death, nothing fails over
            return
        self._apply(reply.payload)

    def _apply(self, p: dict) -> None:
        # one lock over the whole reply application: the heartbeat thread
        # probes PROGRESS (and applies its payload) while the driver — or
        # a parallel_step replica thread — applies STEP replies; the
        # tracer's own lock is always taken INSIDE this one, never the
        # reverse, so the order is acyclic
        with self._state_lock:
            if "behind" in p:
                self._catchup = {int(r) for r in p["behind"]}
            if "ready" in p:
                self._ready = [int(r) for r in p["ready"]]
            if "sig" in p:
                self._last_sig = tuple(p["sig"])
            if "load" in p:
                self._load = int(p["load"])
            if "has_work" in p:
                self._has_work = bool(p["has_work"])
            if "cap" in p:
                self._cap = [int(c) for c in p["cap"]]
            for up in p.get("updates", ()):
                rid = int(up["rid"])
                user = self.requests.get(rid)
                if user is None:
                    continue
                new = [int(t) for t in up["toks"]]
                if new:
                    user.output.extend(new)
                    user._n_out = len(user.output)
                    self._stamp_progress(rid, user)
                if up["done"] and rid not in self._done:
                    user.done = True
                    user.failed = bool(up["failed"])
                    user.error = up.get("error")
                    self._done.add(rid)
                    self._finished[rid] = user
                    self._catchup.discard(rid)
                    self._open.discard(rid)
                    self._submit_ts.pop(rid, None)
                    self._streaming.discard(rid)
                    if self.tracer is not None:
                        self.tracer.finish(rid, len(user.output),
                                           failed=user.failed,
                                           error=user.error,
                                           tags=self._tags(user))

    def _stamp_progress(self, rid: int, user) -> None:
        if self.tracer is None:
            return
        tags = self._tags(user)
        if rid not in self._streaming:
            self._streaming.add(rid)
            wait = time.monotonic() - self._submit_ts.get(
                rid, time.monotonic())
            self.tracer.admit(rid, queue_wait_s=max(0.0, wait), tags=tags)
            self.tracer.first_token(rid, tags=tags)
        self.tracer.tokens(rid, len(user.output), tags=tags)

    def _tags(self, user) -> dict:
        tags = dict(self.trace_tags)
        tags.setdefault("replica", self.idx)
        if getattr(user, "tenant", None) is not None:
            tags.setdefault("tenant", user.tenant)
        return tags

    def _progress_probe(self, what: str) -> dict:
        from ...distributed.resilience.retry import RetryError, retry_call

        try:
            # stats tagged BY PEER: `scrape_metrics` / RetryStats then
            # show which replica's wire is flaky, not just that one is
            reply = retry_call(self._roundtrip, Message("PROGRESS"), what,
                               expect=("PROGRESS_REPLY",),
                               fatal_timeout=False, probe=True,
                               policy=_retry_policy(),
                               what=f"procfleet.{what}@{self.peer}")
        except (socket.timeout, RetryError) as e:
            self._note_dead()
            raise WorkerDead(
                f"PT-PROC-003: replica {self.idx} {what} probe kept "
                f"timing out — worker presumed wedged/dead") from e
        p = reply.payload
        self._apply(p)
        return p

    def progress(self) -> tuple:
        """The fleet heartbeat marker (mirrors
        ``ServingSupervisor.progress``): changes whenever any worker-side
        stream advances, a request completes, the engine rebuilds, or the
        load changes. Served from reply-piggybacked state — the marker
        refreshes with every STEP reply, so a worker that keeps stepping
        without advancing any stream still trips the router's staleness
        TTL, and one that stops answering dies on the STEP timeout."""
        with self._state_lock:
            return self._last_sig

    def load(self) -> int:
        with self._state_lock:
            return self._load

    def has_work(self) -> bool:
        with self._state_lock:
            return bool(self._open) or self._has_work

    def behind(self, rid: int) -> bool:
        with self._state_lock:
            return rid in self._catchup

    def capacity(self) -> List[int]:
        """``[free slots, optimistic free pages]`` from the latest
        reply — the tiered router's pre-handoff capacity gate (a chain
        must never be retired toward a worker that cannot hold it)."""
        with self._state_lock:
            return list(self._cap)

    def capacity_weight(self) -> float:
        """Relative serving capacity the fleet router divides load by:
        1.0. The JAX package lowers it after an elastic mesh degrade; the
        port's workers are unsharded (a mesh is refused at spawn), so
        nothing shrinks them."""
        return 1.0

    def migration_ready(self) -> List[int]:
        """rids whose prefill finished on this worker (populated from the
        latest STEP reply) — the tiered router's migration pump input."""
        with self._state_lock:
            return list(self._ready)

    def withdraw(self, rid: int) -> Optional[dict]:
        reply = self._roundtrip(Message("WITHDRAW", {"rid": int(rid)}),
                                "withdraw", expect=("WITHDRAWN",))
        self._apply({"load": reply.payload["load"]})
        rec = reply.payload["rec"]
        if rec is not None:
            with self._state_lock:
                self.requests.pop(rid, None)
                self._done.discard(rid)
                self._open.discard(rid)
                self._submit_ts.pop(rid, None)
        return rec

    def drain_mark(self) -> int:
        """Tell the worker to refuse NEW (non-resumed) admissions — defense
        in depth under a router drain; returns the worker's in-flight
        load."""
        reply = self._roundtrip(Message("DRAIN"), "drain",
                                expect=("DRAINING",))
        self._apply({"load": reply.payload["load"]})
        return int(reply.payload["load"])

    def metrics_text(self) -> str:
        """The worker registry's Prometheus dump over the control socket
        (the HTTP endpoint at :attr:`metrics_url` serves the same text)."""
        from ...distributed.resilience.retry import RetryError, retry_call

        try:
            reply = retry_call(self._roundtrip, Message("METRICS"),
                               "metrics", expect=("METRICS_TEXT",),
                               fatal_timeout=False, probe=True,
                               policy=_retry_policy(),
                               what=f"procfleet.metrics@{self.peer}")
        except BreakerOpen:
            return ""        # scrape must not break over a tripped peer
        except (socket.timeout, RetryError) as e:
            self._note_dead()
            raise WorkerDead(
                f"PT-PROC-003: replica {self.idx} metrics probe kept "
                "timing out — worker presumed wedged/dead") from e
        return reply.payload["text"]

    def finished(self) -> Dict[int, "object"]:
        with self._state_lock:
            out, self._finished = self._finished, {}
        return out

    # -- tiered migration over the wire ------------------------------------
    def _migration_timeout(self, nbytes: int) -> float:
        """Per-op deadline SIZED TO THE PAYLOAD: the flat budget plus the
        wire time those bytes take at the assumed bandwidth — a large int8
        chain must not read as a wedged worker under a flat timeout, and a
        small one must not get a big chain's slack."""
        return self.op_timeout_s + float(max(0, nbytes)) / self._migrate_bw

    def _chain_bytes_bound(self) -> int:
        """Upper bound on any exported chain's size, from the HELLO
        geometry (layers x K/V x heads x page x head_dim x itemsize x max
        pages); 0 when the worker has no paged pool (flat timeout)."""
        eng = self.engine
        layers = getattr(eng, "layers", None)
        if layers is None:
            return 0
        dtype = str(getattr(eng, "dtype", ""))
        itemsize = 1 if "int8" in dtype else \
            2 if ("bfloat16" in dtype or "float16" in dtype) else 4
        return (int(layers) * 2 * int(eng.kvh) * int(eng.page_size)
                * int(eng.hd) * itemsize * int(eng.maxp))

    def export_migration(self, rid: int) -> Tuple[dict, bytes]:
        """MIGRATE_OUT: the worker flushes, exports rid's KV chain,
        journals ``migr-kv`` and releases the slot; returns
        ``(header-lite, artifact bytes)``. After this returns, the rid is
        no longer this worker's responsibility."""
        reply = self._roundtrip(
            Message("MIGRATE_OUT", {"rid": int(rid)}), "migrate_out",
            timeout=self._migration_timeout(self._chain_bytes_bound()),
            expect=("CHAIN",))
        # deltas the export's flush surfaced land BEFORE ownership moves:
        # the caller's delivered prefix now equals the artifact's
        self._apply({"updates": reply.payload["updates"]})
        with self._state_lock:
            self.requests.pop(rid, None)
            self._open.discard(rid)
            self._submit_ts.pop(rid, None)
        return dict(reply.payload), reply.blob

    def import_migration(self, user, artifact: bytes,
                         idem: Optional[str] = None) -> int:
        """MIGRATE_IN: splice an exported chain into this worker and
        resume decode at the recorded position. Raises ``KVChainCorrupt``
        / ``EngineSaturated`` exactly like the in-process splice.

        The timeout is sized to ``len(artifact)`` and is NOT fatal: a
        clean deadline (no reply bytes consumed) raises ``socket.timeout``
        with the replica alive so the router can HEDGE the splice onto
        another worker — the seq drain absorbs this attempt's late
        SPLICED, and ``idem`` (stable across attempts at one target) keeps
        a chaos-duplicated frame from double-splicing."""
        payload = {"req": _admit(user),
                   "delivered": [int(t) for t in user.output]}
        if idem is not None:
            payload["idem"] = str(idem)
        reply = self._roundtrip(
            Message("MIGRATE_IN", payload, blob=artifact),
            "migrate_in",
            timeout=self._migration_timeout(len(artifact)),
            expect=("SPLICED",), fatal_timeout=False)
        user._n_out = len(user.output)
        with self._state_lock:
            self.requests[user.rid] = user
            self._done.discard(user.rid)
            self._open.add(user.rid)
            self._submit_ts.setdefault(user.rid, time.monotonic())
            # the prefill side already stamped admit/first_token — a
            # migrated stream continues, it does not re-admit
            self._streaming.add(user.rid)
        return int(reply.payload["rid"])

    def migrate_cancel(self, rid: int, digest: str) -> bool:
        """Roll back a hedge-loser's splice: if ``rid`` is still live on
        this worker from a MIGRATE_IN carrying ``digest``, the worker
        retires it (journal ``migr-kv``, pages decref'd — its allocator
        ends where it started). Returns whether anything was rolled
        back. Best-effort at call sites: the WINNER is already placed."""
        reply = self._roundtrip(
            Message("MIGRATE_CANCEL",
                    {"rid": int(rid), "digest": str(digest)}),
            "migrate_cancel", expect=("CANCELLED",))
        return bool(reply.payload["rolled_back"])

    def breaker_state(self) -> str:
        """``closed`` / ``open`` / ``half_open`` (``closed`` when no
        breaker is configured) — the ``pt_transport_breaker_state``
        gauge and the router's hedge-target filter read this."""
        with self._state_lock:
            return "closed" if self._breaker is None else \
                self._breaker.state

    # -- lifecycle ---------------------------------------------------------
    def _alive(self) -> bool:
        if self.process is None:
            t = self._worker_thread
            return t is not None and t.is_alive()
        return self.process.poll() is None

    def _wait(self, timeout: float) -> bool:
        if self.process is None:
            t = self._worker_thread
            if t is None:
                return True
            t.join(timeout=timeout)
            return not t.is_alive()
        try:
            self.process.wait(timeout=timeout)
            return True
        except subprocess.TimeoutExpired:
            return False

    def kill(self) -> None:
        """SIGKILL the worker — real process death (fault drills; also the
        wedged-worker arm of ``abandon``). In loopback mode the kill is
        slamming the transport shut: the worker thread's serve loop reads
        WireClosed, abandons (no flush) and exits — failover reads the
        journal identically to a killed process."""
        if self.process is None:
            try:
                self._tr.close()
            except (OSError, AttributeError):
                pass
            self._wait(5.0)
            self._note_dead()
            return
        if self._alive():
            os.kill(self.process.pid, signal.SIGKILL)
            self._wait(10.0)
        self._note_dead()

    def close(self) -> None:
        """Graceful reap: SHUTDOWN (worker flushes + closes its journal),
        wait for exit, reap. Falls back to a kill if the worker does not
        comply in time."""
        if self.reaped:
            return
        acked = False
        if not self.dead and self._alive():
            try:
                self._roundtrip(Message("SHUTDOWN"), "shutdown",
                                timeout=self.op_timeout_s, expect=("BYE",))
                acked = True
            except (WorkerDead, WireCorrupt, BreakerOpen):
                pass    # an OPEN breaker at teardown falls back to kill
        if not acked:
            # the worker never acknowledged a shutdown: waiting for a
            # voluntary exit is a dead 5s — kill like abandon() does
            self.kill()
        self._reap(force=True)

    def abandon(self) -> None:
        """Ungraceful release (router ``_mark_dead``): no SHUTDOWN, no
        flush, no grace — SIGKILL whatever is left and reap immediately
        (a wedged worker must not stall the fleet's failover for a
        termination courtesy it will never answer). The on-disk journal
        is what failover trusts, exactly like the in-process path."""
        self.kill()
        self._reap()

    def _reap(self, force: bool = False) -> None:
        if self.reaped:
            return
        self._hb_stop.set()
        self._note_dead()
        if self.process is not None:
            if self._alive() and not self._wait(5.0) and force:
                self.process.terminate()
                if not self._wait(5.0):
                    os.kill(self.process.pid, signal.SIGKILL)
                    self._wait(5.0)
            _untrack_worker(self.process.pid)
        try:
            self._tr.close()
        except (OSError, AttributeError):
            pass
        if self.process is None:
            # thread-worker: the transport close above IS the kill; give
            # the serve loop a beat to unwind
            self._wait(5.0)
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2.0)
        if self._spec_path is not None:
            try:
                os.unlink(self._spec_path)
            except OSError:
                pass
        self.reaped = True
        with self._state_lock:
            # stats is shared with the heartbeat and step threads
            self.stats["proc_reaped"] = \
                self.stats.get("proc_reaped", 0) + 1

    def heartbeat_count(self) -> int:
        with self._state_lock:
            return self._hb_count

    def _heartbeat_loop(self, interval_s: float) -> None:
        while not self._hb_stop.wait(interval_s):
            if self.dead:
                return
            try:
                self._progress_probe("heartbeat")
            except BreakerOpen:
                continue     # cooling down: routed around, not dead
            except Exception:  # noqa: BLE001 — probe failure = death signal
                self._note_dead()
                return
            with self._state_lock:
                self._hb_count += 1


def _admit(req) -> dict:
    from ..recovery import _admit_record

    return _admit_record(req)
