"""Replica worker: one process owning one ServingSupervisor — port of
``paddle_tpu/inference/procfleet/worker.py``.

``worker_main`` is the spawn target (spawn → hello → serve → drain →
reap). The worker

- builds a :class:`~paddle_tpu_torch.inference.recovery.ServingSupervisor`
  from the spec's picklable engine factory: its OWN model, its OWN CUDA
  context and device memory — process-per-replica is what makes replica
  death process death, and what keeps a CUDA fault in one replica from
  poisoning the others,
- journals to the driver-shared on-disk path in the ``RequestJournal``
  format, so the driver's journal-backed failover reads a SIGKILLed
  worker's journal exactly like an in-process replica's,
- serves the PT-PROC message loop over a localhost socket (``wire.py``),
  single-threaded: the supervisor, engine and journal are only ever
  touched from this loop,
- exposes its own :class:`~paddle_tpu_torch.observability.MetricsServer`
  on an ephemeral port, reported in its HELLO (the driver aggregates every
  worker's ``/metrics`` under ``replica=i`` labels).

Failure posture: a worker whose supervisor cannot be built (a factory that
raises, no CUDA device) sends a typed ERROR and exits 3 — it never falls
back to another device. A supervisor step that raises past its recovery
budget is replica death: the worker sends a typed ERROR, abandons (no
journal flush beyond what the flush barrier already guaranteed) and exits
3; the driver fails its work over from the on-disk journal. A SIGKILL
skips even the ERROR — the driver sees the stream close (``WireClosed``)
and takes the same path.

The in-replica tensor-parallel mesh (``WorkerSpec.mesh`` > 1,
``device_group``) waits for tp-sharded serving and is refused.
"""

from __future__ import annotations

import collections
import dataclasses
import importlib
import os
import pickle
import socket
import sys
from typing import Callable, Dict, List, Optional, Tuple, Union

from ..._later import later_slice
from .transport import TcpTransport, Transport
from .wire import Message, WireClosed, WireCorrupt

__all__ = ["WorkerSpec", "resolve_factory", "worker_main",
           "worker_thread_main"]

#: idempotence-key dedup depth: a duplicated/retried delivery arrives
#: within one op window of the original, so a small bounded cache is the
#: whole contract (the JOURNAL carries single-serve across crashes; this
#: carries it across the wire)
_IDEM_CACHE = 128


@dataclasses.dataclass
class WorkerSpec:
    """Everything a worker process needs to become a serving replica.

    - ``factory``: engine factory the CHILD imports — a module-level
      callable (pickled by reference) or a ``"module:qualname"`` string;
      called with ``factory_kwargs`` and must return a
      ``ContinuousBatchingEngine``. Factories seed their own weights so
      every replica builds bit-identical ones (``presets.py``).
    - ``journal_path``: the driver-shared on-disk journal (the SAME
      ``replica{i}.g{gen}.jrnl`` naming the in-process fleet uses).
    - ``sup_kwargs``: forwarded to ``ServingSupervisor`` (step_budget_s,
      max_recoveries, fsync, watchdog_grace_steps).
    - ``metrics_port``: 0 binds an ephemeral port (reported in HELLO);
      ``None`` disables the worker's metrics endpoint.
    - ``env``: extra environment of the child process (e.g.
      ``OMP_NUM_THREADS=1`` for CPU workers), set before it imports torch.
    - ``tier``: informational tag echoed in telemetry.
    - ``mesh`` / ``device_group``: the in-replica tensor-parallel width
      and its device indices. Unsharded (None or 1) only: tp-sharded
      serving is a later slice of the port and a width above 1 or a
      device group raises ``NotImplementedError``.
    - ``verify_crc``: worker-side KV-chain verification
      (``KVChainCodec(verify_crc=...)``); False is a fault drill's control
      arm only.
    """

    factory: Union[str, Callable]
    journal_path: str
    factory_kwargs: dict = dataclasses.field(default_factory=dict)
    sup_kwargs: dict = dataclasses.field(default_factory=dict)
    metrics_port: Optional[int] = 0
    env: dict = dataclasses.field(default_factory=dict)
    tier: str = "serving"
    mesh: Optional[int] = None
    device_group: Optional[Tuple[int, ...]] = None
    verify_crc: bool = True


def _refuse_mesh(spec: WorkerSpec) -> None:
    if (spec.mesh is not None and int(spec.mesh) > 1) or \
            spec.device_group is not None:
        raise later_slice("a mesh-sharded procfleet worker "
                          "(WorkerSpec.mesh > 1, device_group)",
                          "tp-sharded serving", "7")


def resolve_factory(spec: WorkerSpec) -> Callable:
    _refuse_mesh(spec)
    fac = spec.factory
    if isinstance(fac, str):
        mod, _, qual = fac.partition(":")
        if not mod or not qual:
            raise ValueError(
                f"factory reference {fac!r} must be 'module:qualname'")
        obj = importlib.import_module(mod)
        for part in qual.split("."):
            obj = getattr(obj, part)
        fac = obj
    if not callable(fac):
        raise TypeError(f"worker factory {fac!r} is not callable")
    kwargs = dict(spec.factory_kwargs)
    return lambda: fac(**kwargs)


def _engine_hello(engine) -> dict:
    """The geometry the driver-side proxy mirrors as ``.engine`` (the
    surface FleetRouter reads: page_size for prefix-chain keys, max_batch/
    max_queue for the brownout depth default) plus the pool shape the
    tiered router's migration pre-check needs. ``dtype`` is the chain
    header's name (``"bfloat16"``, as the JAX package writes it)."""
    from ...ops.paged_attention import chain_dtype_name

    out = {"page_size": int(engine.page_size),
           "max_batch": int(engine.max_batch),
           "max_queue": (None if engine.max_queue is None
                         else int(engine.max_queue)),
           "max_len": int(engine.max_len),
           "prefix_cache": engine.prefix_cache is not None,
           # in-replica mesh width: 1, the port's engines are unsharded
           "mesh_tp": 1}
    if engine.prefix_cache is not None:
        kv = engine.caches["kv"]
        kvh, page, hd = (int(d) for d in kv[0][0].shape[1:])
        out.update(layers=len(kv), kvh=kvh, hd=hd,
                   dtype=chain_dtype_name(kv[0][0].dtype),
                   maxp=int(engine._maxp),
                   num_blocks=int(engine._alloc.num_blocks))
    return out


class _WorkerLoop:
    """The serve loop, factored for testability (handlers take/return
    Messages; ``worker_main`` owns the socket + process lifecycle)."""

    def __init__(self, sup, registry=None, verify_crc: bool = True):
        self.sup = sup
        self.registry = registry
        self.draining = False
        self.verify_crc = bool(verify_crc)
        # rid -> tokens already wired, for OPEN rids only: entries are
        # pruned when the done update ships (or the rid withdraws /
        # migrates out), so the per-step scan is O(live), not O(lifetime)
        # — same discipline recovery.py's _sync_progress documents
        self._sent: Dict[int, int] = {}
        # idempotence keys already served -> their success reply. A
        # duplicated or retried SUBMIT/MIGRATE_IN is answered from here
        # without touching the supervisor: at-most-once ADMISSION per key
        # (the reply's piggybacked load may be stale; admission may not)
        self._idem: "collections.OrderedDict[str, Message]" = \
            collections.OrderedDict()
        self._codec = None

    # -- per-type handlers -------------------------------------------------
    def handle(self, msg: Message) -> Message:
        from ..serving import EngineSaturated, RequestShed

        try:
            fn = getattr(self, "_on_" + msg.mtype.lower())
        except AttributeError:
            return Message("ERROR", {
                "etype": "WireCorrupt",
                "msg": f"PT-PROC-001: {msg.mtype} is not a request the "
                       "worker serves"})
        try:
            return fn(msg)
        except (EngineSaturated, RequestShed, ValueError, KeyError) as e:
            # typed refusals: the proxy re-raises the named class — the
            # router's fall-through routing depends on the distinction
            return Message("ERROR", {"etype": type(e).__name__,
                                     "msg": str(e)})

    def _idem_hit(self, msg: Message) -> Optional[Message]:
        key = msg.payload.get("idem")
        cached = None if key is None else self._idem.get(key)
        if cached is None:
            return None
        # a fresh copy: the serve loop stamps each reply with ITS
        # request's _seq, and the cache must stay seq-free
        return Message(cached.mtype, dict(cached.payload), cached.blob)

    def _idem_store(self, msg: Message, reply: Message) -> None:
        key = msg.payload.get("idem")
        if key is None:
            return
        self._idem[key] = Message(reply.mtype, dict(reply.payload),
                                  reply.blob)
        while len(self._idem) > _IDEM_CACHE:
            self._idem.popitem(last=False)

    def _on_submit(self, msg: Message) -> Message:
        from ..recovery import _request_from
        from ..serving import EngineSaturated

        dup = self._idem_hit(msg)
        if dup is not None:
            return dup
        if self.draining and not msg.payload["resume"]:
            raise EngineSaturated(
                "worker is draining — new admissions refused (resumed/"
                "migrated work still lands)")
        user = _request_from(msg.payload["req"])
        delivered = [int(t) for t in msg.payload["delivered"]]
        if msg.payload["resume"]:
            user.output = list(delivered)
            user._n_out = len(delivered)
        self.sup.submit(user, resume=bool(msg.payload["resume"]))
        self._sent[user.rid] = len(delivered)
        reply = Message("SUBMITTED", {"rid": int(user.rid),
                                      "load": int(self.sup.load())})
        self._idem_store(msg, reply)
        return reply

    def _updates(self) -> List[dict]:
        ups = []
        for rid, sent in list(self._sent.items()):
            user = self.sup.requests.get(rid)
            if user is None:
                self._sent.pop(rid, None)
                continue
            new = user.output[sent:]
            if not new and not user.done:
                continue
            up = {"rid": int(rid), "toks": [int(t) for t in new],
                  "done": bool(user.done), "failed": bool(user.failed),
                  "error": user.error, "n_out": len(user.output)}
            if user.done:
                self._sent.pop(rid, None)   # terminal shipped: stop
                #                             tracking (O(live) scan)
            else:
                self._sent[rid] = len(user.output)
            ups.append(up)
        return ups

    def _behind(self) -> List[int]:
        return [int(rid) for rid in list(self.sup._live)
                if self.sup.behind(rid)]

    def _ready(self) -> List[int]:
        eng = self.sup.engine
        if eng.prefix_cache is None:
            return []
        return [int(rid) for rid in eng.migration_ready()
                if rid in self.sup._live and rid not in self.sup._verify]

    def _capacity(self) -> List[int]:
        """``[free_slots, optimistic free pages]`` for the tiered
        router's pre-handoff capacity gate (mirrors the in-process
        ``_compatible``: free + radix-registered is optimistic — the
        import's EngineSaturated fallback stays load-bearing)."""
        eng = self.sup.engine
        if eng.prefix_cache is None:
            return [0, 0]
        return [len(eng._free_slots),
                int(eng._alloc.free_blocks) + len(eng._radix)]

    def _on_step(self, msg: Message) -> Message:
        self.sup.step()
        payload = {
            "updates": self._updates(), "load": int(self.sup.load()),
            "sig": list(self.sup.progress()), "behind": self._behind(),
            "ready": self._ready(), "cap": self._capacity(),
            "has_work": bool(self.sup.has_work())}
        return Message("TOKENS", payload)

    def _on_progress(self, msg: Message) -> Message:
        return Message("PROGRESS_REPLY", {
            "sig": list(self.sup.progress()), "load": int(self.sup.load()),
            "has_work": bool(self.sup.has_work()),
            "behind": self._behind()})

    def _on_withdraw(self, msg: Message) -> Message:
        rid = int(msg.payload["rid"])
        rec = self.sup.withdraw(rid)
        if rec is not None:
            self._sent.pop(rid, None)
        return Message("WITHDRAWN", {"rec": rec,
                                     "load": int(self.sup.load())})

    def _on_drain(self, msg: Message) -> Message:
        self.draining = True
        return Message("DRAINING", {"load": int(self.sup.load())})

    def _on_metrics(self, msg: Message) -> Message:
        text = "" if self.registry is None else self.registry.dump()
        return Message("METRICS_TEXT", {"text": text})

    def _on_shutdown(self, msg: Message) -> Message:
        return Message("BYE", {})

    # -- tiered migration (inference/disagg.py over the wire) --------------
    def _codec_(self):
        if self._codec is None:
            from ..disagg import KVChainCodec

            self._codec = KVChainCodec(verify_crc=self.verify_crc)
        return self._codec

    def _on_migrate_out(self, msg: Message) -> Message:
        rid = int(msg.payload["rid"])
        codec = self._codec_()
        # flush-before-surface, then export; retire ONLY once the bytes
        # are safely built — a failure above leaves the rid owned here
        self.sup._sync_progress()
        twin = self.sup._live.get(rid)
        if twin is None or twin.done:
            raise KeyError(f"rid {rid} is not exportable (done or gone)")
        art = codec.export_chain(self.sup.engine, rid)
        hdr = codec.peek(art)
        # wire everything the flush just surfaced BEFORE the chain leaves:
        # the driver's delivered prefix must equal the artifact's
        # (collected only once export cannot fail anymore — _updates()
        # advances the sent marks, so a later refusal would lose deltas)
        ups = self._updates()
        self.sup.retire_migrated(rid, hdr["digest"])
        self._sent.pop(rid, None)
        return Message("CHAIN", {"rid": rid, "digest": str(hdr["digest"]),
                                 "pages": int(hdr["n_written"]),
                                 "updates": ups},
                       blob=art)

    def _on_migrate_in(self, msg: Message) -> Message:
        from ..disagg import KVChainCorrupt
        from ..recovery import _request_from

        dup = self._idem_hit(msg)
        if dup is not None:
            return dup
        user = _request_from(msg.payload["req"])
        delivered = [int(t) for t in msg.payload["delivered"]]
        user.output = list(delivered)
        user._n_out = len(delivered)
        try:
            self.sup.submit_migrated(user, msg.blob, self._codec_())
        except KVChainCorrupt as e:
            return Message("ERROR", {"etype": "KVChainCorrupt",
                                     "msg": str(e)})
        self._sent[user.rid] = len(delivered)
        reply = Message("SPLICED", {"rid": int(user.rid)})
        self._idem_store(msg, reply)
        return reply

    def _on_migrate_cancel(self, msg: Message) -> Message:
        """Hedged migration's loser side: the driver placed this rid's
        chain elsewhere first. If the MIGRATE_IN actually landed here
        (the race's ambiguous outcome), retire it — journal ``migr-kv``,
        ACTIVE slot released, pages decref'd: the allocator is exactly
        where it was before the splice. Idempotent: an rid that never
        landed (or already left) rolls back nothing."""
        rid = int(msg.payload["rid"])
        twin = self.sup._live.get(rid)
        rolled = False
        if twin is not None and not twin.done:
            self.sup.retire_migrated(rid, str(msg.payload["digest"]))
            self._sent.pop(rid, None)
            rolled = True
        # the key that admitted it must not answer a later duplicate
        # with SPLICED for work this worker no longer owns
        for key in [k for k, v in self._idem.items()
                    if v.payload.get("rid") == rid]:
            self._idem.pop(key, None)
        return Message("CANCELLED", {"rid": rid,
                                     "rolled_back": rolled})


def _hello_msg(spec: WorkerSpec, sup, loop: _WorkerLoop,
               metrics_port: Optional[int]) -> Message:
    """The HELLO frame, including journal-restart pending work (a worker
    (re)started over a live journal replays it in the supervisor
    constructor): the reconstructed admits + delivered marks let the
    driver-side proxy own the caller-facing objects."""
    from ..recovery import _admit_record

    pending = []
    for rid, user in sup.requests.items():
        loop._sent[rid] = len(user.output)
        pending.append({"req": _admit_record(user),
                        "delivered": [int(t) for t in user.output]})
    return Message("HELLO", {
        "pid": int(os.getpid()), "metrics_port": metrics_port,
        "journal_path": str(spec.journal_path),
        "engine": dict(_engine_hello(sup.engine), tier=str(spec.tier),
                       pending=pending),
        "state": {"load": int(sup.load()),
                  "sig": list(sup.progress()),
                  "has_work": bool(sup.has_work()),
                  "cap": loop._capacity()}})


def _serve(tr: Transport, sup, loop: _WorkerLoop) -> int:
    """The message loop over any transport. Returns the worker's exit
    code: 0 = clean SHUTDOWN, 2 = driver gone / stream damaged, 3 =
    fatal handler failure (replica death). Codes 2/3 abandon the
    supervisor — no journal flush beyond what the flush barrier already
    guaranteed, exactly the recovery contract failover replays."""
    while True:
        try:
            msg = tr.recv_frame()
        except (WireClosed, WireCorrupt):
            # driver gone (or stream damaged — same retreat)
            sup.abandon()
            return 2
        if msg.mtype == "SHUTDOWN":
            sup.close()
            bye = Message("BYE", {})
            if "_seq" in msg.payload:
                bye.payload["_seq"] = msg.payload["_seq"]
            tr.send_frame(bye)
            return 0
        try:
            reply = loop.handle(msg)
        except Exception as e:  # noqa: BLE001 — replica death boundary
            # a step crash past the recovery budget (or any unexpected
            # handler failure): this replica is DEAD — tell the driver
            # why if the pipe still works, then exit without flushing
            try:
                tr.send_frame(Message(
                    "ERROR", {"etype": type(e).__name__,
                              "msg": f"worker fatal: {e}"}))
            except (WireClosed, WireCorrupt, OSError):
                pass
            sup.abandon()
            return 3
        # echo the request's sequence id: a driver that timed out and
        # retried matches replies to attempts and discards stale ones
        if "_seq" in msg.payload:
            reply.payload["_seq"] = msg.payload["_seq"]
        tr.send_frame(reply)


def _fatal(tr: Transport, e: BaseException) -> None:
    """Tell the driver why this worker dies, if the stream still works."""
    try:
        tr.send_frame(Message("ERROR", {"etype": type(e).__name__,
                                        "msg": f"worker fatal: {e}"}))
    except Exception:           # noqa: BLE001 — already dying
        pass


def worker_main(spec_bytes: bytes, host: str, port: int) -> None:
    """Worker entry: connect back to the driver, build the supervisor,
    HELLO, serve until SHUTDOWN / driver loss / fatal supervisor error.
    Launched as ``python -m paddle_tpu_torch.inference.procfleet.
    _spawn_main`` by :class:`~.proxy.ProcReplica` (a plain subprocess: no
    inherited interpreter state). A supervisor that cannot be built (no
    CUDA device, a factory that raises) is an ERROR frame and exit code 3,
    never a build elsewhere."""
    spec: WorkerSpec = pickle.loads(spec_bytes)
    for k, v in (spec.env or {}).items():
        os.environ[k] = str(v)
    sock = socket.create_connection((host, int(port)), timeout=30)
    sock.settimeout(None)
    tr = TcpTransport(sock=sock)
    server = None
    try:
        try:
            from ...observability import (MetricsRegistry, MetricsServer,
                                          retry_collector,
                                          supervisor_collector)
            from ..recovery import ServingSupervisor

            build = resolve_factory(spec)
            sup = ServingSupervisor(build, spec.journal_path,
                                    **dict(spec.sup_kwargs))
            registry = MetricsRegistry()
            registry.register_collector(supervisor_collector(sup))
            registry.register_collector(retry_collector())
            g = registry.gauge("pt_procfleet_worker_up",
                               "1 while this worker process serves")
            g.set(1.0, tier=str(spec.tier))
            metrics_port = None
            if spec.metrics_port is not None:
                server = MetricsServer(registry,
                                       port=int(spec.metrics_port))
                metrics_port = server.port
            loop = _WorkerLoop(sup, registry, verify_crc=spec.verify_crc)
        except Exception as e:  # noqa: BLE001 — replica death boundary
            _fatal(tr, e)
            if server is not None:
                server.close()
            tr.close()
            os._exit(3)
        tr.send_frame(_hello_msg(spec, sup, loop, metrics_port))
        code = _serve(tr, sup, loop)
        if code != 0:
            os._exit(code)
    finally:
        if server is not None:
            server.close()
        tr.close()
    sys.exit(0)


def worker_thread_main(spec: WorkerSpec, tr: Transport) -> None:
    """Loopback twin of :func:`worker_main`: the same supervisor, journal
    format, HELLO and serve loop, over an in-process
    :class:`~.transport.LoopbackTransport` on this thread — the fast arm
    for tests and drills that would otherwise pay a process spawn per
    case. Differences are exactly the process boundary: ``spec.env`` is
    NOT applied (one shared interpreter), there is no per-worker metrics
    server (the driver's registry already sees this process), the engines
    share this process's CUDA context (``serving._DEVICE_LOCK`` serializes
    their device work) and "process death" is the transport closing,
    which failover reads through the journal identically. The supervisor,
    engine and journal are touched only from this thread."""
    try:
        from ..recovery import ServingSupervisor

        build = resolve_factory(spec)
        sup = ServingSupervisor(build, spec.journal_path,
                                **dict(spec.sup_kwargs))
        loop = _WorkerLoop(sup, None, verify_crc=spec.verify_crc)
        tr.send_frame(_hello_msg(spec, sup, loop, None))
        _serve(tr, sup, loop)
    except (WireClosed, WireCorrupt):
        pass                    # driver closed while we were replying
    except Exception as e:  # noqa: BLE001 — replica death boundary
        # construction failed (bad factory, journal IO): tell the driver
        # like the process worker's fatal path would
        _fatal(tr, e)
    finally:
        tr.close()


def _cli(argv: Optional[List[str]] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="procfleet replica worker (spawned by ProcReplica)")
    ap.add_argument("--spec", required=True,
                    help="path to the pickled WorkerSpec")
    ap.add_argument("--host", required=True)
    ap.add_argument("--port", required=True, type=int)
    args = ap.parse_args(argv)
    with open(args.spec, "rb") as f:
        spec_bytes = f.read()
    worker_main(spec_bytes, args.host, args.port)


if __name__ == "__main__":
    _cli()
