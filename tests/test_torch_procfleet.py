"""Port process fleet (``paddle_tpu_torch.inference.procfleet``) against the
JAX package's (tests/test_procfleet.py, class by class).

Host cases run through both packages and must agree:

- wire: for every message type ``encode`` gives the JAX package's bytes
  and each package decodes the other's frames; every damage case raises
  the same typed ``WireCorrupt`` with the same text; a seeded fuzz of
  damaged frames has the same outcome per frame;
- the proxy against a scripted peer (typed refusals, death, timeouts,
  probe retries, stale-reply drain, token splicing), the worker serve loop
  over a stub supervisor (the same reply bytes), worker specs, the chaos
  transport (the same ``plan.log`` and the same delivered bytes for every
  ``net.*`` action), the circuit breaker on a fake clock (the same state
  sequence) and the idempotence cache;
- the fleet router's capacity-weighted routing: stub supervisors of
  weights 1.0 and 0.5 take the same rids in both packages.

Process cases spawn the port's real worker processes on the CPU
(``device="cpu"``, ``OMP_NUM_THREADS=1``), each worker loading the JAX
tiny model's weights from a state file; greedy streams must equal the JAX
engine's on those weights, seeded ones one in-process port engine's. They
cover a SIGKILL of 1 of 2 (the pid really gone) and its no-failover arm,
a rolling restart, the autoscaler spawning and reaping a worker, the
remote scrape, tiers with wire migration, the loopback seeded-chaos byte
identity, and a spawned worker's ``sys.modules`` holding neither ``jax``
nor ``paddle_tpu``. Each is bounded by the router's spawn and op timeouts
and reaps its workers in a ``finally``.
"""

import dataclasses
import json
import os
import pickle
import random
import socket
import struct
import threading
import time
import types
import zlib

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.resilience import faults as jfaults
from paddle_tpu.inference import fleet as jfleet
from paddle_tpu.inference import procfleet as jpf
from paddle_tpu.inference import recovery as jrecovery
from paddle_tpu.inference import serving as jserving
from paddle_tpu.inference.procfleet import proxy as jproxy
from paddle_tpu.inference.procfleet import worker as jworker
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.distributed.resilience import faults as tfaults
from paddle_tpu_torch.inference import fleet as tfleet
from paddle_tpu_torch.inference import procfleet as tpf
from paddle_tpu_torch.inference import recovery as trecovery
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.inference.procfleet import presets as tpresets
from paddle_tpu_torch.inference.procfleet import proxy as tproxy
from paddle_tpu_torch.inference.procfleet import worker as tworker
from paddle_tpu_torch.weights import state_from_jax_layer

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
PRESETS = "paddle_tpu_torch.inference.procfleet.presets"
ENGINE = dict(max_batch=2, max_len=32, page_size=8, block_size=2)
#: bounds every process case: a wedged or dead worker fails the test
SPAWN_S, OP_S = 120.0, 60.0


class _Pkg:
    def __init__(self, name, pf, proxy, worker, serving, recovery, faults,
                 fleet):
        self.name = name
        self.pf, self.proxy, self.worker = pf, proxy, worker
        self.wire = pf.wire
        self.s, self.r, self.f, self.fl = serving, recovery, faults, fleet


JAX = _Pkg("jax", jpf, jproxy, jworker, jserving, jrecovery, jfaults, jfleet)
TORCH = _Pkg("torch", tpf, tproxy, tworker, tserving, trecovery, tfaults,
             tfleet)


@pytest.fixture(params=[JAX, TORCH], ids=["jax", "torch"])
def pk(request):
    return request.param


def _rid_base():
    """A rid base past both packages' Request counters."""
    return max(jserving.Request._counter[0],
               tserving.Request._counter[0]) + 1


def _same_rids(base):
    """Both packages' Request counters at ``base``: the next rids agree."""
    jserving.Request._counter[0] = tserving.Request._counter[0] = base


def _outcome(fn):
    """``("ok", value)`` or ``(exception class name, message)``."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the outcome is the datum
        return (type(e).__name__, str(e))


# ---------------------------------------------------------------------------
# wire codec
# ---------------------------------------------------------------------------

SAMPLES = {
    "HELLO": {"pid": 7, "metrics_port": None, "journal_path": "/tmp/j",
              "engine": {"page_size": 8},
              "state": {"load": 0, "sig": [], "has_work": False}},
    "SUBMIT": {"req": {"rid": 3}, "resume": True, "delivered": [1, 2]},
    "SUBMITTED": {"rid": 3, "load": 1},
    "STEP": {},
    "TOKENS": {"updates": [], "load": 0, "sig": [1, 2, 0, 0],
               "behind": [], "ready": [], "cap": [0, 0], "has_work": False},
    "WITHDRAW": {"rid": 9},
    "WITHDRAWN": {"rec": None, "load": 0},
    "DRAIN": {},
    "DRAINING": {"load": 4},
    "PROGRESS": {},
    "PROGRESS_REPLY": {"sig": [1], "load": 2, "has_work": True,
                       "behind": [5]},
    "METRICS": {},
    "METRICS_TEXT": {"text": "pt_up 1\n"},
    "SHUTDOWN": {},
    "BYE": {},
    "ERROR": {"etype": "EngineSaturated", "msg": "full"},
    "MIGRATE_OUT": {"rid": 1},
    "CHAIN": {"rid": 1, "digest": "ab", "pages": 2, "updates": []},
    "MIGRATE_IN": {"req": {"rid": 1}, "delivered": [4]},
    "SPLICED": {"rid": 1},
    "MIGRATE_CANCEL": {"rid": 1, "digest": "ab"},
    "CANCELLED": {"rid": 1, "rolled_back": True},
}


def _sample(mtype):
    payload = dict(SAMPLES[mtype])
    if mtype in ("SUBMIT", "MIGRATE_IN"):
        payload["idem"] = "sub:0:1"          # the optional key rides too
    blob = b"\x01\x02" * 37 if mtype in ("CHAIN", "MIGRATE_IN") else b""
    return payload, blob


def _damage_cases():
    """``name -> fn(wire module) -> outcome`` for every damage the JAX
    tests pin."""
    def frame(w, mtype, payload, blob=b""):
        return w.encode(w.Message(mtype, payload, blob))

    def flip(data, pos, bit):
        b = bytearray(data)
        b[pos] ^= bit
        return bytes(b)

    huge = struct.pack(">4sBBIII", b"PTPF", 1, 4, 2 ** 30, 2 ** 30, 0)
    return {
        "crc": lambda w: w.decode_bytes(flip(frame(
            w, "SUBMITTED", {"rid": 1, "load": 0}), -1, 0x20)),
        "blob_crc": lambda w: w.decode_bytes(flip(frame(
            w, "MIGRATE_IN", {"req": {}, "delivered": []}, b"x" * 64),
            -10, 0x04)),
        "trunc_3": lambda w: w.decode_bytes(frame(
            w, "METRICS_TEXT", {"text": "x" * 100})[:3]),
        "trunc_10": lambda w: w.decode_bytes(frame(
            w, "METRICS_TEXT", {"text": "x" * 100})[:10]),
        "trunc_last": lambda w: w.decode_bytes(frame(
            w, "METRICS_TEXT", {"text": "x" * 100})[:-1]),
        "trailing": lambda w: w.decode_bytes(frame(w, "STEP", {}) + b"zz"),
        "magic": lambda w: w.decode_bytes(
            b"XXXX" + frame(w, "STEP", {})[4:]),
        "version": lambda w: w.decode_bytes(
            flip(frame(w, "STEP", {}), 4, 99 ^ 1)),
        "type_id": lambda w: w.decode_bytes(
            flip(frame(w, "STEP", {}), 5, 222 ^ 4)),
        "length": lambda w: w.decode(huge),
        "missing_field": lambda w: w.encode(
            w.Message("SUBMIT", {"req": {}, "resume": False})),
        "wrong_type": lambda w: w.encode(
            w.Message("SUBMITTED", {"rid": "three"})),
        "bool_not_int": lambda w: w.encode(
            w.Message("SUBMITTED", {"rid": True})),
        "unknown_type": lambda w: w.encode(w.Message("NOPE", {})),
        "nan": lambda w: w.encode(
            w.Message("METRICS_TEXT", {"text": "t", "x": float("nan")})),
        "not_object": lambda w: w.decode_bytes(
            w._HEADER.pack(b"PTPF", 1, 4, 2, 0,
                           zlib.crc32(b"[]")) + b"[]"),
        "prefix_magic": lambda w: w.decode(b"PX"),
    }


DAMAGE = _damage_cases()


class TestWireCodec:
    @pytest.mark.parametrize("mtype", sorted(SAMPLES))
    def test_encode_equals_jax_and_cross_decodes(self, mtype):
        """Every message type: the same frame bytes from both packages;
        each package decodes the other's frame to the same message."""
        assert set(SAMPLES) == set(tpf.wire.SCHEMAS) == set(jpf.wire.SCHEMAS)
        payload, blob = _sample(mtype)
        jb = jpf.wire.encode(jpf.Message(mtype, payload, blob))
        tb = tpf.wire.encode(tpf.Message(mtype, payload, blob))
        assert tb == jb
        got = tpf.wire.decode_bytes(jb)
        assert (got.mtype, got.payload, got.blob) == (mtype, payload, blob)
        back = jpf.wire.decode_bytes(tb)
        assert (back.mtype, back.payload, back.blob) == (mtype, payload,
                                                         blob)

    def test_payload_key_order_and_unicode_bytes_equal(self):
        payload = {"text": "é — ✓ \u0000", "z": 1, "a": [1.5, None]}
        m = ("METRICS_TEXT", payload)
        assert tpf.wire.encode(tpf.Message(*m)) == \
            jpf.wire.encode(jpf.Message(*m))

    @pytest.mark.parametrize("case", sorted(DAMAGE))
    def test_damage_same_typed_error(self, case):
        j = _outcome(lambda: DAMAGE[case](jpf.wire))
        t = _outcome(lambda: DAMAGE[case](tpf.wire))
        assert t == j
        if case != "prefix_magic":
            assert t[0] == "WireCorrupt" and "PT-PROC-001" in t[1]

    def test_incremental_decode_waits_for_full_frame(self):
        full = tpf.wire.encode(tpf.Message("STEP"))
        assert tpf.wire.decode(full[:5]) == (None, 0)
        msg, used = tpf.wire.decode(full + b"tail")
        assert msg.mtype == "STEP" and used == len(full)

    def test_socket_cross_package_send_recv_and_eof(self):
        a, b = socket.socketpair()
        try:
            jpf.wire.send_msg(a, jpf.Message("DRAINING", {"load": 2}))
            got = tpf.wire.recv_msg(b, timeout=2.0)
            assert got.payload["load"] == 2
            tpf.wire.send_msg(b, tpf.Message("SUBMITTED",
                                             {"rid": 4, "load": 1}))
            assert jpf.wire.recv_msg(a, timeout=2.0).payload["rid"] == 4
            a.close()
            with pytest.raises(tpf.WireClosed):
                tpf.wire.recv_msg(b, timeout=2.0)
        finally:
            b.close()

    def test_mid_frame_eof_is_death_not_damage(self):
        a, b = socket.socketpair()
        try:
            frame = jpf.wire.encode(jpf.Message("METRICS_TEXT",
                                                {"text": "y" * 50}))
            a.sendall(frame[: len(frame) - 7])
            a.close()
            with pytest.raises(tpf.WireClosed, match="process death"):
                tpf.wire.recv_msg(b, timeout=2.0)
        finally:
            b.close()


# ---------------------------------------------------------------------------
# proxy behaviors against a scripted peer (both packages)
# ---------------------------------------------------------------------------

def _bare_proxy(pk, sock, op_timeout_s=0.5, breaker=None):
    """A ProcReplica wired to a socketpair end instead of a spawned
    worker — the wire-facing surface, none of the process lifecycle."""
    p = pk.proxy.ProcReplica.__new__(pk.proxy.ProcReplica)
    p.idx = 0
    p.spec = None
    p.tracer = None
    p.trace_tags = {}
    p.op_timeout_s = op_timeout_s
    p._migrate_bw = 32.0 * 1024 * 1024
    p._breaker = breaker
    p.transport_retries = 0
    p._idem_counter = 0
    p.stats = {}
    p.requests = {}
    p._done = set()
    p._finished = {}
    p._submit_ts = {}
    p._streaming = set()
    p._io_lock = threading.Lock()
    p._state_lock = threading.Lock()
    p._catchup = set()
    p._ready = []
    p._last_sig = ()
    p._load = 0
    p._has_work = False
    p._cap = [0, 0]
    p._open = set()
    p._seq = 0
    p._hb_count = 0
    p._hb_stop = threading.Event()
    p._hb_thread = None
    p.dead = False
    p.reaped = False
    p._fault_hook = None
    p._fault_cls = None
    p.process = None
    p._worker_thread = None
    p._spec_path = None
    tr = pk.pf.TcpTransport(sock=sock)
    p.peer = f"replica:0@{tr.peer}"
    p._tr = tr
    p.worker_pid = 0
    return p


class _ScriptedPeer:
    """Serves scripted replies on the other socketpair end."""

    def __init__(self, pk, replies):
        self.pk = pk
        self.sock, self.peer = socket.socketpair()
        self.replies = list(replies)
        self.requests = []
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        w = self.pk.wire
        try:
            while self.replies:
                msg = w.recv_msg(self.peer, timeout=5.0)
                self.requests.append(msg)
                reply = self.replies.pop(0)
                if reply is None:
                    continue            # swallow: the client must time out
                w.send_msg(self.peer, w.Message(*reply))
        except (w.WireClosed, w.WireCorrupt, socket.timeout, OSError):
            pass

    def close(self):
        self.peer.close()
        self.sock.close()
        self.thread.join(timeout=2.0)


def _req(pk, n=4, new=2):
    return pk.s.Request(np.arange(n, dtype=np.int32), max_new_tokens=new)


class TestProxyWireBehaviors:
    def test_typed_errors_re_raise(self, pk):
        peer = _ScriptedPeer(pk, [
            ("ERROR", {"etype": "EngineSaturated", "msg": "full"}),
            ("ERROR", {"etype": "RequestShed", "msg": "infeasible"}),
        ])
        p = _bare_proxy(pk, peer.sock, op_timeout_s=2.0)
        req = _req(pk)
        with pytest.raises(pk.s.EngineSaturated, match="full"):
            p.submit(req)
        with pytest.raises(pk.s.RequestShed, match="infeasible"):
            p.submit(req)
        assert not p.dead
        peer.close()

    def test_fatal_error_and_desync_are_death(self, pk):
        peer = _ScriptedPeer(pk, [("ERROR", {"etype": "RuntimeError",
                                             "msg": "worker fatal: boom"})])
        p = _bare_proxy(pk, peer.sock, op_timeout_s=2.0)
        with pytest.raises(pk.pf.WorkerDead, match="PT-PROC-002.*boom"):
            p.step()
        assert p.dead
        peer.close()
        peer2 = _ScriptedPeer(pk, [("BYE", {})])
        p2 = _bare_proxy(pk, peer2.sock, op_timeout_s=2.0)
        with pytest.raises(pk.pf.WorkerDead, match="protocol desync"):
            p2.step()
        peer2.close()

    def test_step_timeout_is_typed_death(self, pk):
        peer = _ScriptedPeer(pk, [None, ("BYE", {})])
        p = _bare_proxy(pk, peer.sock, op_timeout_s=0.2)
        t0 = time.monotonic()
        with pytest.raises(pk.pf.WorkerDead, match="PT-PROC-003"):
            p.step()
        assert time.monotonic() - t0 < 2.0
        assert p.dead
        with pytest.raises(pk.pf.WorkerDead, match="already dead"):
            p.step()
        peer.close()

    def test_progress_probe_retries_then_succeeds(self, pk):
        ok = ("PROGRESS_REPLY", {"sig": [1, 2], "load": 1,
                                 "has_work": True, "behind": []})
        peer = _ScriptedPeer(pk, [None, ok])
        p = _bare_proxy(pk, peer.sock, op_timeout_s=0.2)
        assert p._progress_probe("heartbeat")["sig"] == [1, 2]
        assert p.progress() == (1, 2)
        assert p.load() == 1
        assert not p.dead
        assert len(peer.requests) == 2
        assert p.transport_retries == 1     # pt_transport_retries source
        peer.close()

    def test_stale_reply_after_timeout_is_discarded_not_desync(self, pk):
        w = pk.wire
        a, b = socket.socketpair()
        served = []

        def peer():
            try:
                m1 = w.recv_msg(b, timeout=5.0)
                served.append(m1.mtype)
                time.sleep(0.45)
                w.send_msg(b, w.Message("PROGRESS_REPLY", {
                    "sig": [1], "load": 1, "has_work": True, "behind": [],
                    "_seq": m1.payload["_seq"]}))
                m2 = w.recv_msg(b, timeout=5.0)
                served.append(m2.mtype)
                w.send_msg(b, w.Message("PROGRESS_REPLY", {
                    "sig": [2], "load": 2, "has_work": True, "behind": [],
                    "_seq": m2.payload["_seq"]}))
                m3 = w.recv_msg(b, timeout=5.0)
                served.append(m3.mtype)
                w.send_msg(b, w.Message("TOKENS", {
                    "updates": [], "load": 0, "sig": [3], "behind": [],
                    "ready": [], "cap": [0, 0], "has_work": False,
                    "_seq": m3.payload["_seq"]}))
            except (w.WireClosed, socket.timeout, OSError):
                pass

        t = threading.Thread(target=peer, daemon=True)
        t.start()
        p = _bare_proxy(pk, a, op_timeout_s=0.3)
        assert p._progress_probe("heartbeat")["sig"] == [2]
        p.step()
        assert p.progress() == (3,)
        assert not p.dead
        assert served == ["PROGRESS", "PROGRESS", "STEP"]
        t.join(timeout=2.0)
        a.close()
        b.close()

    def test_progress_probe_exhaustion_is_death(self, pk):
        peer = _ScriptedPeer(pk, [None, None])
        p = _bare_proxy(pk, peer.sock, op_timeout_s=0.2)
        with pytest.raises(pk.pf.WorkerDead, match="PT-PROC-003"):
            p._progress_probe("heartbeat")
        assert p.dead
        peer.close()

    def test_peer_gone_mid_step_is_death(self, pk):
        a, b = socket.socketpair()
        p = _bare_proxy(pk, a, op_timeout_s=2.0)
        b.close()
        with pytest.raises(pk.pf.WorkerDead, match="PT-PROC-002"):
            p.step()
        a.close()

    def test_token_updates_splice_and_finish(self, pk):
        req = _req(pk, new=4)
        rid = int(req.rid)
        peer = _ScriptedPeer(pk, [
            ("SUBMITTED", {"rid": rid, "load": 1}),
            ("TOKENS", {"updates": [{"rid": rid, "toks": [5, 6],
                                     "done": False, "failed": False,
                                     "error": None, "n_out": 2}],
                        "load": 1, "sig": [1], "behind": [], "ready": [],
                        "cap": [1, 8], "has_work": True}),
            ("TOKENS", {"updates": [{"rid": rid, "toks": [7], "done": True,
                                     "failed": False, "error": None,
                                     "n_out": 3}],
                        "load": 0, "sig": [2], "behind": [], "ready": [],
                        "cap": [1, 8], "has_work": True}),
        ])
        p = _bare_proxy(pk, peer.sock, op_timeout_s=2.0)
        p.submit(req)
        sent = peer.requests[0].payload
        assert sent["idem"] == "sub:0:1" and not sent["resume"]
        p.step()
        assert req.output == [5, 6] and not req.done
        p.step()
        assert req.output == [5, 6, 7] and req.done and not req.failed
        assert p.finished() == {req.rid: req}
        assert p.finished() == {}
        assert p.capacity() == [1, 8]
        peer.close()

    def test_resume_submit_tracks_catchup(self, pk):
        req = _req(pk, new=4)
        req.output = [9, 9]
        rid = int(req.rid)
        peer = _ScriptedPeer(pk, [
            ("SUBMITTED", {"rid": rid, "load": 1}),
            ("TOKENS", {"updates": [], "load": 1, "sig": [1],
                        "behind": [rid], "ready": [], "cap": [1, 8],
                        "has_work": True}),
            ("TOKENS", {"updates": [], "load": 1, "sig": [2],
                        "behind": [], "ready": [], "cap": [1, 8],
                        "has_work": True}),
        ])
        p = _bare_proxy(pk, peer.sock, op_timeout_s=2.0)
        p.submit(req, resume=True)
        assert peer.requests[0].payload["delivered"] == [9, 9]
        assert p.behind(req.rid)
        p.step()
        assert p.behind(req.rid)
        p.step()
        assert not p.behind(req.rid)
        peer.close()

    def test_submit_frames_byte_equal_across_packages(self):
        """The SUBMIT and MIGRATE_IN frames the two proxies put on the
        wire for the same request are the same bytes (seq included)."""
        frames = {}
        base = _rid_base()
        for pk in (JAX, TORCH):
            _same_rids(base)
            peer = _ScriptedPeer(pk, [
                ("SUBMITTED", {"rid": 0, "load": 1}),
                ("SPLICED", {"rid": 0})])
            p = _bare_proxy(pk, peer.sock, op_timeout_s=2.0)
            req = pk.s.Request(np.arange(5, dtype=np.int32),
                               max_new_tokens=3, temperature=0.5, seed=9,
                               eos_token_id=2)
            req.output = [4, 5]
            p.submit(req, resume=True)
            p.import_migration(req, b"chain" * 9, idem="mig:1:ab")
            peer.close()
            frames[pk.name] = [pk.wire.encode(m) for m in peer.requests]
        assert frames["torch"] == frames["jax"]


# ---------------------------------------------------------------------------
# worker units
# ---------------------------------------------------------------------------

class TestWorkerSpec:
    def test_resolve_string_reference(self):
        spec = tpf.WorkerSpec(factory=f"{PRESETS}:tiny_llama_engine",
                              journal_path="/tmp/j",
                              factory_kwargs={"max_batch": 3})
        assert callable(tworker.resolve_factory(spec))

    def test_resolve_callable_reference(self):
        spec = tpf.WorkerSpec(factory=tpresets.tiny_llama_engine,
                              journal_path="/tmp/j")
        assert callable(tworker.resolve_factory(spec))

    def test_bad_references_raise_as_jax(self):
        for fac, exc in (("nocolon", ValueError),
                         (f"{PRESETS}:__doc__", TypeError)):
            t = _outcome(lambda: tworker.resolve_factory(tpf.WorkerSpec(
                factory=fac, journal_path="/tmp/j")))
            j = _outcome(lambda: jworker.resolve_factory(jpf.WorkerSpec(
                factory=fac.replace("paddle_tpu_torch", "paddle_tpu"),
                journal_path="/tmp/j")))
            assert t[0] == j[0] == exc.__name__
            assert t[1].split(" ")[0] == j[1].split(" ")[0]
            if exc is ValueError:
                assert t[1] == j[1]

    def test_spec_pickles(self):
        spec = tpf.WorkerSpec(factory=f"{PRESETS}:tiny_llama_engine",
                              journal_path="/x", sup_kwargs={"fsync": False},
                              env={"OMP_NUM_THREADS": "1"}, tier="decode")
        assert pickle.loads(pickle.dumps(spec)) == spec
        assert [f.name for f in dataclasses.fields(spec)] == \
            [f.name for f in dataclasses.fields(jpf.WorkerSpec(
                factory="m:f", journal_path="/x"))]

    def test_mesh_waits_for_item_7(self, tmp_path):
        with pytest.raises(NotImplementedError, match="item 7"):
            tworker.resolve_factory(tpf.WorkerSpec(
                factory=f"{PRESETS}:tiny_llama_engine",
                journal_path="/tmp/j", mesh=2))
        with pytest.raises(NotImplementedError, match="item 7"):
            tworker.resolve_factory(tpf.WorkerSpec(
                factory=f"{PRESETS}:tiny_llama_engine",
                journal_path="/tmp/j", device_group=(0,)))
        with pytest.raises(NotImplementedError, match="item 7"):
            tpresets.tiny_llama_mesh_engine()
        # refused at spawn, before any process exists
        with pytest.raises(NotImplementedError, match="item 7"):
            tpf.ProcFleetRouter(tpf.ProcFleetConfig(
                factory=f"{PRESETS}:tiny_llama_engine", mesh=2),
                str(tmp_path), num_replicas=1)
        assert tworker.resolve_factory(tpf.WorkerSpec(
            factory=f"{PRESETS}:tiny_llama_engine", journal_path="/tmp/j",
            mesh=1)) is not None

    def test_engine_hello_matches_jax(self, carried):
        """HELLO's geometry (dtype in numpy's name) equals the JAX
        engine's on the same config, prefix cache off and on."""
        for prefix in (False, True):
            t = tworker._engine_hello(tpresets.tiny_llama_engine(
                device="cpu", state_path=carried.state_path,
                prefix_cache=prefix))
            j = jworker._engine_hello(jserving.ContinuousBatchingEngine(
                carried.jm, prefix_cache=prefix, **ENGINE))
            assert t == j


class _StubSup:
    """Minimal supervisor surface for serve-loop handler units."""

    def __init__(self):
        self.requests = {}
        self._live = {}
        self._verify = set()
        self.submitted = []
        self.engine = types.SimpleNamespace(prefix_cache=None)

    def submit(self, req, resume=False):
        self.submitted.append((req, resume))
        self.requests[req.rid] = req
        return req.rid

    def load(self):
        return len(self.requests)

    def progress(self):
        return (1, 2, 3, self.load())

    def has_work(self):
        return bool(self.requests)

    def behind(self, rid):
        return False

    def withdraw(self, rid):
        rec = {"rid": rid} if rid in self.requests else None
        self.requests.pop(rid, None)
        return rec

    def step(self):
        pass


class TestWorkerLoop:
    def test_submit_and_updates(self, pk):
        loop = pk.worker._WorkerLoop(_StubSup())
        req = _req(pk)
        reply = loop.handle(pk.wire.Message(
            "SUBMIT", {"req": pk.r._admit_record(req), "resume": False,
                       "delivered": []}))
        assert reply.mtype == "SUBMITTED" and reply.payload["rid"] == req.rid
        user, resume = loop.sup.submitted[0]
        assert not resume and list(user.prompt) == list(req.prompt)
        user.output.extend([4, 5])
        (up,) = loop.handle(pk.wire.Message("STEP")).payload["updates"]
        assert up["toks"] == [4, 5] and not up["done"]
        user.output.append(6)
        user.done = True
        (up,) = loop.handle(pk.wire.Message("STEP")).payload["updates"]
        assert up["toks"] == [6] and up["done"] and not up["failed"]
        assert loop.handle(pk.wire.Message("STEP")).payload["updates"] == []

    def test_resume_submit_dedups_delivered(self, pk):
        loop = pk.worker._WorkerLoop(_StubSup())
        req = _req(pk, new=4)
        loop.handle(pk.wire.Message("SUBMIT", {
            "req": pk.r._admit_record(req), "resume": True,
            "delivered": [7, 8]}))
        user, resume = loop.sup.submitted[0]
        assert resume and user.output == [7, 8]
        user.output.append(9)
        (up,) = loop.handle(pk.wire.Message("STEP")).payload["updates"]
        assert up["toks"] == [9]

    def test_drain_refuses_new_but_not_resumed(self, pk):
        loop = pk.worker._WorkerLoop(_StubSup())
        assert loop.handle(pk.wire.Message("DRAIN")).mtype == "DRAINING"
        meta = pk.r._admit_record(_req(pk))
        reply = loop.handle(pk.wire.Message(
            "SUBMIT", {"req": meta, "resume": False, "delivered": []}))
        assert reply.mtype == "ERROR"
        assert reply.payload["etype"] == "EngineSaturated"
        reply = loop.handle(pk.wire.Message(
            "SUBMIT", {"req": meta, "resume": True, "delivered": []}))
        assert reply.mtype == "SUBMITTED"

    def test_reply_bytes_equal_across_packages(self):
        """One message sequence through both serve loops over stub
        supervisors: every reply frame is the same bytes."""
        out = {}
        base = _rid_base()
        for pk in (JAX, TORCH):
            _same_rids(base)
            loop = pk.worker._WorkerLoop(_StubSup())
            reqs = [_req(pk, n=3 + i) for i in range(2)]
            seq = [pk.wire.Message("SUBMIT", {
                "req": pk.r._admit_record(r), "resume": False,
                "delivered": [], "idem": f"sub:0:{i}"})
                for i, r in enumerate(reqs)]
            replies = [loop.handle(m) for m in seq]
            replies.append(loop.handle(seq[0]))         # idem hit
            loop.sup.submitted[0][0].output.extend([3, 4])
            loop.sup.submitted[1][0].output.append(1)
            loop.sup.submitted[1][0].done = True
            for mt, pl in (("STEP", {}), ("PROGRESS", {}),
                           ("WITHDRAW", {"rid": int(reqs[0].rid)}),
                           ("WITHDRAW", {"rid": 10 ** 6}), ("METRICS", {}),
                           ("DRAIN", {}),
                           ("MIGRATE_CANCEL", {"rid": 42, "digest": "ab"}),
                           ("TOKENS", SAMPLES["TOKENS"])):
                replies.append(loop.handle(pk.wire.Message(mt, pl)))
            out[pk.name] = [pk.wire.encode(m) for m in replies]
        assert out["torch"] == out["jax"]


# ---------------------------------------------------------------------------
# frame fuzz
# ---------------------------------------------------------------------------

def _fuzz_frames(w, rng, n):
    msgs = []
    for i in range(n):
        pick = i % 4
        if pick == 0:
            msgs.append(w.Message("STEP"))
        elif pick == 1:
            msgs.append(w.Message(
                "METRICS_TEXT", {"text": "x" * rng.randrange(0, 200)}))
        elif pick == 2:
            msgs.append(w.Message(
                "MIGRATE_IN", {"req": {"rid": i}, "delivered": []},
                blob=bytes(rng.getrandbits(8)
                           for _ in range(rng.randrange(0, 300)))))
        else:
            msgs.append(w.Message("SUBMITTED", {"rid": i, "load": i % 5}))
    return msgs


def _mutate(data, rng):
    op = rng.randrange(5)
    if op == 0 and data:
        b = bytearray(data)
        b[rng.randrange(len(b))] ^= 1 << rng.randrange(8)
        return bytes(b)
    if op == 1:
        return data[:rng.randrange(len(data) + 1)]
    if op == 2:
        return data + bytes(rng.getrandbits(8)
                            for _ in range(rng.randrange(1, 9)))
    if op == 3 and data:
        i = rng.randrange(len(data))
        return data[:i] + bytes([rng.getrandbits(8)]) + data[i + 1:]
    return data


class TestFrameFuzz:
    def test_seeded_fuzz_same_outcome_per_frame(self):
        """600 seeded damaged frames: ``decode`` and ``decode_bytes`` of
        both packages give the same message or the same typed error."""
        outs = {}
        for pk in (JAX, TORCH):
            rng = random.Random(0xF00D)
            w = pk.wire
            res = []
            for m in _fuzz_frames(w, rng, 600):
                data = _mutate(w.encode(m), rng)

                def inc():
                    msg, used = w.decode(data)
                    return None if msg is None else (w.encode(msg), used)

                res.append((_outcome(inc),
                            _outcome(lambda: w.encode(w.decode_bytes(data)))))
            outs[pk.name] = res
        assert outs["torch"] == outs["jax"]
        kinds = {o[0][0] for o in outs["torch"]}
        assert {"ok", "WireCorrupt"} <= kinds

    def test_randomized_chunk_boundaries_reassemble(self):
        rng = random.Random(0xF00D)
        msgs = _fuzz_frames(tpf.wire, rng, 24)
        stream = b"".join(tpf.wire.encode(m) for m in msgs)
        drv, wrk = tpf.loopback_pair()
        i = 0
        while i < len(stream):
            n = rng.randrange(1, 14)
            wrk.send_bytes(stream[i:i + n])
            i += n
        assert [drv.recv_frame(timeout=5.0) for _ in msgs] == msgs

    def test_every_torn_prefix_is_typed_never_short(self):
        for m in (tpf.Message("STEP"),
                  tpf.Message("CHAIN", {"rid": 1, "digest": "ab",
                                        "pages": 1, "updates": []},
                              blob=b"p" * 40)):
            full = tpf.wire.encode(m)
            for cut in range(1, len(full)):
                assert tpf.wire.decode(full[:cut]) == (None, 0)
                with pytest.raises(tpf.WireCorrupt, match="PT-PROC-001"):
                    tpf.wire.decode_bytes(full[:cut])

    def test_torn_prefix_then_close_is_wireclosed(self):
        drv, wrk = tpf.loopback_pair()
        full = tpf.wire.encode(tpf.Message("STEP"))
        wrk.send_bytes(full[: len(full) - 3])
        wrk.close()
        with pytest.raises(tpf.WireClosed, match="mid-frame"):
            drv.recv_frame(timeout=2.0)

    def test_torn_prefix_timeout_flags_partial_read(self):
        drv, wrk = tpf.loopback_pair()
        wrk.send_bytes(tpf.wire.encode(tpf.Message("STEP"))[:7])
        t0 = time.monotonic()
        with pytest.raises(socket.timeout) as ei:
            drv.recv_frame(timeout=0.05)
        assert time.monotonic() - t0 < 2.0
        assert ei.value.partial_read is True
        drv2, _ = tpf.loopback_pair()
        with pytest.raises(socket.timeout) as ei2:
            drv2.recv_frame(timeout=0.05)
        assert ei2.value.partial_read is False

    def test_torn_prefix_misaligns_next_frame_into_typed_corrupt(self):
        drv, wrk = tpf.loopback_pair()
        full = tpf.wire.encode(tpf.Message("STEP"))
        wrk.send_bytes(full[: len(full) - 3])
        wrk.send_bytes(full)
        with pytest.raises(tpf.WireCorrupt):
            drv.recv_frame(timeout=2.0)


# ---------------------------------------------------------------------------
# chaos transport: equal plan.log and equal delivered bytes
# ---------------------------------------------------------------------------

def _drain(pk, wrk):
    """Every frame the worker end can read now, as bytes or an outcome."""
    got = []
    while True:
        o = _outcome(lambda: pk.wire.encode(wrk.recv_frame(timeout=0.05)))
        got.append(o)
        if o[0] != "ok":
            return got


def _blob_frame(pk, mtype="MIGRATE_IN", n=64):
    return pk.wire.Message(mtype, {"req": {"rid": 1}, "delivered": [2]},
                           blob=bytes(range(256))[:n] * 2)


CHAOS = {
    "drop_then_duplicate": (
        [("net.send", "drop", 0, 1, 0.0, "STEP"),
         ("net.send", "duplicate", 1, 1, 0.0, "STEP")],
        lambda pk: [pk.wire.Message("STEP")] * 3),
    "torn": ([("net.send", "torn", 0, 1, 0.0, "STEP")],
             lambda pk: [pk.wire.Message("STEP")] * 2),
    "send_bitflip_blob": (
        [("net.send", "bitflip", 1, 2, 4.0, "MIGRATE_IN")],
        lambda pk: [_blob_frame(pk)] * 4),
    "send_truncate_garbage_blob": (
        [("net.send", "truncate", 0, 1, 0.0, "MIGRATE_IN"),
         ("net.send", "garbage", 2, 1, 0.0, "MIGRATE_IN")],
        lambda pk: [_blob_frame(pk, n=40)] * 3),
    "send_body_damage_no_blob": (
        [("net.send", "bitflip", 0, 1, 3.0, "SUBMITTED")],
        lambda pk: [pk.wire.Message("SUBMITTED", {"rid": 1, "load": 2})]),
    "blackhole": ([("net.send", "blackhole", 1, 1, 0.0, "")],
                  lambda pk: [pk.wire.Message("STEP")] * 3),
    "match_filters_peer": (
        [("net.send", "drop", 0, -1, 0.0, "replica:9:")],
        lambda pk: [pk.wire.Message("STEP")] * 2),
}


class TestChaosTransport:
    @pytest.mark.parametrize("case", sorted(CHAOS))
    def test_send_actions_equal_log_and_bytes(self, case):
        specs, frames = CHAOS[case]
        out = {}
        for pk in (JAX, TORCH):
            drv, wrk = pk.pf.loopback_pair(a="driver", b="replica:0")
            chaos = pk.pf.ChaosTransport(drv, peer="replica:0")
            plan = pk.f.FaultPlan(seed=3, specs=[pk.f.FaultSpec(*s)
                                                 for s in specs])
            with plan:
                for m in frames(pk):
                    chaos.send_frame(m)
            out[pk.name] = (plan.log, _drain(pk, wrk))
        assert out["torch"] == out["jax"]
        log, got = out["torch"]
        assert log or case == "match_filters_peer"

    @pytest.mark.parametrize("action", ["drop", "bitflip", "garbage",
                                        "truncate", "blackhole"])
    def test_recv_actions_equal_log_and_bytes(self, action):
        out = {}
        for pk in (JAX, TORCH):
            drv, wrk = pk.pf.loopback_pair(a="driver", b="replica:0")
            chaos = pk.pf.ChaosTransport(drv, peer="replica:0")
            for i in range(3):
                wrk.send_frame(_blob_frame(pk) if i != 1 else
                               pk.wire.Message("SUBMITTED",
                                               {"rid": i, "load": 0}))
            plan = pk.f.FaultPlan(seed=11, specs=[pk.f.FaultSpec(
                "net.recv", action, at=0, count=2, arg=5.0)])
            got = []
            with plan:
                for _ in range(3):
                    o = _outcome(lambda: pk.wire.encode(
                        chaos.recv_frame(timeout=0.2)))
                    got.append(o[0] if o[0] != "ok" else o)
            out[pk.name] = (plan.log, got)
        assert out["torch"] == out["jax"]

    def test_connect_actions(self):
        out = {}
        for pk in (JAX, TORCH):
            res = []
            for action in ("kill", "drop", "error", "blackhole", "delay"):
                drv, _ = pk.pf.loopback_pair()
                chaos = pk.pf.ChaosTransport(drv, peer="replica:2")
                plan = pk.f.FaultPlan(seed=1, specs=[pk.f.FaultSpec(
                    "net.connect", action, arg=0.01)])
                with plan:
                    res.append((_outcome(chaos.connect)[0], plan.log))
            out[pk.name] = res
        assert out["torch"] == out["jax"]

    def test_bitflip_damages_blob_under_valid_frame_crc(self):
        drv, wrk = tpf.loopback_pair(a="driver", b="replica:0")
        chaos = tpf.ChaosTransport(drv, peer="replica:0")
        blob = b"\x00" * 64
        plan = tfaults.FaultPlan(seed=3, specs=[tfaults.FaultSpec(
            "net.send", "bitflip", at=0, count=1, arg=4,
            match="MIGRATE_IN")])
        with plan:
            chaos.send_frame(tpf.Message(
                "MIGRATE_IN", {"req": {}, "delivered": []}, blob=blob))
        got = wrk.recv_frame(timeout=2.0)
        assert got.mtype == "MIGRATE_IN"
        assert got.blob != blob and len(got.blob) == len(blob)

    def test_recv_drop_consumes_frame_and_stays_aligned(self):
        drv, wrk = tpf.loopback_pair(a="driver", b="replica:0")
        chaos = tpf.ChaosTransport(drv, peer="replica:0")
        wrk.send_frame(tpf.Message("SUBMITTED", {"rid": 1, "load": 0}))
        wrk.send_frame(tpf.Message("SUBMITTED", {"rid": 2, "load": 0}))
        plan = tfaults.FaultPlan(seed=3, specs=[tfaults.FaultSpec(
            "net.recv", "drop", at=0, count=1)])
        with plan:
            with pytest.raises(socket.timeout) as ei:
                chaos.recv_frame(timeout=2.0)
        assert ei.value.partial_read is False
        assert chaos.recv_frame(timeout=2.0).payload["rid"] == 2

    def test_wire_faults_hook_as_jax(self):
        assert tfaults.wire_faults("net.send", "x") == []
        assert "wire_faults" in tfaults.__all__
        plans = [pk.f.FaultPlan(seed=0, specs=[pk.f.FaultSpec(
            "net.send", "drop", at=1, count=2, match="A")])
            for pk in (JAX, TORCH)]
        res = []
        for pk, plan in zip((JAX, TORCH), plans):
            with plan:
                res.append([[s.action for s in pk.f.wire_faults(
                    "net.send", d)] for d in ("A", "B", "A", "A", "A")])
        assert res[0] == res[1] == [[], [], ["drop"], ["drop"], []]


# ---------------------------------------------------------------------------
# circuit breaker on a fake clock, proxy breaker, idempotence
# ---------------------------------------------------------------------------

BREAKER_SCRIPT = [
    ("allow", False), ("rec", False, 0.1), ("rec", False, 0.1),
    ("allow", False), ("allow", True), ("tick", 61.0), ("allow", False),
    ("allow", True), ("rec", True, 0.01), ("allow", False),
    ("rec", True, 0.5), ("rec", True, 0.04), ("rec", False, 0.2),
    ("rec", False, 0.2), ("rec", False, 0.2), ("tick", 1.0),
    ("allow", True), ("rec", False, 0.1), ("tick", 100.0), ("allow", True),
    ("rec", True, 3.0), ("rec", True, 9.0), ("tick", 100.0),
    ("allow", True),
    ("rec", True, 0.001), ("allow", False)]


class TestCircuitBreaker:
    @pytest.mark.parametrize("kw", [
        dict(fail_threshold=2, cooldown_s=60.0),
        dict(fail_threshold=3, latency_s=0.05, cooldown_s=0.0,
             ema_alpha=1.0),
        dict(fail_threshold=99, latency_s=2.5, cooldown_s=1.0,
             ema_alpha=0.4)])
    def test_same_state_sequence_on_fake_clock(self, kw, monkeypatch):
        seqs = {}
        for pk in (JAX, TORCH):
            now = [1000.0]
            monkeypatch.setattr(pk.proxy, "time", types.SimpleNamespace(
                monotonic=lambda: now[0]))
            b = pk.pf.CircuitBreaker(**kw)
            seq = []
            for op in BREAKER_SCRIPT:
                if op[0] == "tick":
                    now[0] += op[1]
                    continue
                r = b.allow(op[1]) if op[0] == "allow" else \
                    b.record(op[1], op[2])
                seq.append((r, b.state, b.trips, b.fails, b.ema_s))
            seqs[pk.name] = seq
        assert seqs["torch"] == seqs["jax"]
        assert {s[1] for s in seqs["torch"]} >= {"closed", "open"}

    def test_consecutive_failures_trip_and_cooldown_gates(self):
        p = tpf.CircuitBreaker(fail_threshold=2, cooldown_s=60.0)
        assert p.state == "closed" and p.allow(False)
        p.record(False, 0.1)
        assert p.state == "closed"
        p.record(False, 0.1)
        assert p.state == "open" and p.trips == 1
        assert not p.allow(False) and not p.allow(True)
        p._opened_at -= 61.0
        assert not p.allow(False) and p.state == "half_open"
        assert p.allow(True)
        p.record(True, 0.01)
        assert p.state == "closed" and p.allow(False)

    def test_latency_ema_trips_slow_but_alive(self):
        p = tpf.CircuitBreaker(fail_threshold=99, latency_s=0.05,
                               cooldown_s=0.0, ema_alpha=1.0)
        p.record(True, 0.01)
        assert p.state == "closed"
        p.record(True, 0.5)
        assert p.state == "open" and p.trips == 1
        assert p.allow(True)
        p.record(True, 0.5)
        assert p.state == "open" and p.trips == 2
        assert p.allow(True)
        p.record(True, 0.001)
        assert p.state == "closed"


class TestProxyBreaker:
    def test_open_breaker_routes_around_without_wire_io(self, pk):
        peer = _ScriptedPeer(pk, [])
        br = pk.pf.CircuitBreaker(fail_threshold=1, cooldown_s=60.0)
        p = _bare_proxy(pk, peer.sock, op_timeout_s=2.0, breaker=br)
        br._trip()
        assert p.breaker_state() == "open"
        with pytest.raises(pk.s.EngineSaturated, match="PT-PROC-004"):
            p.submit(_req(pk))
        p.step()
        assert p.metrics_text() == ""
        assert not p.dead
        assert peer.requests == []
        peer.close()

    def test_half_open_probe_closes_breaker(self, pk):
        peer = _ScriptedPeer(pk, [("PROGRESS_REPLY", {
            "sig": [7], "load": 0, "has_work": False, "behind": []})])
        br = pk.pf.CircuitBreaker(fail_threshold=1, cooldown_s=0.0)
        p = _bare_proxy(pk, peer.sock, op_timeout_s=2.0, breaker=br)
        br._trip()
        assert p._progress_probe("heartbeat")["sig"] == [7]
        assert p.breaker_state() == "closed"
        assert not p.dead
        peer.close()


class TestWorkerIdempotence:
    def test_duplicate_submit_served_from_idem_cache(self, pk):
        loop = pk.worker._WorkerLoop(_StubSup())
        req = _req(pk)
        m = pk.wire.Message("SUBMIT", {"req": pk.r._admit_record(req),
                                       "resume": False, "delivered": [],
                                       "idem": "sub:0:1"})
        r1 = loop.handle(m)
        r2 = loop.handle(pk.wire.Message("SUBMIT", dict(m.payload)))
        assert r1.mtype == r2.mtype == "SUBMITTED"
        assert r1.payload["rid"] == r2.payload["rid"]
        assert len(loop.sup.submitted) == 1
        loop.handle(pk.wire.Message("SUBMIT", dict(m.payload,
                                                   idem="sub:0:2")))
        assert len(loop.sup.submitted) == 2
        assert len(loop._idem) == 2
        for i in range(300):                # bounded at _IDEM_CACHE
            loop._idem_store(pk.wire.Message("SUBMIT", {"idem": str(i)}),
                             r1)
        assert len(loop._idem) == pk.worker._IDEM_CACHE == 128

    def test_cancel_unknown_rid_rolls_back_nothing(self, pk):
        loop = pk.worker._WorkerLoop(_StubSup())
        reply = loop.handle(pk.wire.Message(
            "MIGRATE_CANCEL", {"rid": 42, "digest": "ab"}))
        assert reply.mtype == "CANCELLED"
        assert reply.payload["rolled_back"] is False

    def test_cancel_live_rid_retires_and_purges_idem(self, pk):
        sup = _StubSup()
        retired = []
        sup.retire_migrated = lambda rid, digest: (
            retired.append((rid, digest)), sup._live.pop(rid, None))
        twin = _req(pk)
        sup._live[twin.rid] = twin
        loop = pk.worker._WorkerLoop(sup)
        loop._idem["mig:k"] = pk.wire.Message("SPLICED",
                                              {"rid": int(twin.rid)})
        loop._sent[twin.rid] = 0
        reply = loop.handle(pk.wire.Message(
            "MIGRATE_CANCEL", {"rid": int(twin.rid), "digest": "dg"}))
        assert reply.payload["rolled_back"] is True
        assert retired == [(twin.rid, "dg")]
        assert "mig:k" not in loop._idem
        reply = loop.handle(pk.wire.Message(
            "MIGRATE_CANCEL", {"rid": int(twin.rid), "digest": "dg"}))
        assert reply.payload["rolled_back"] is False


# ---------------------------------------------------------------------------
# the routing repair: capacity-weighted load, as the JAX router
# ---------------------------------------------------------------------------

class _WeightedSup:
    """A replica surface whose load counts its submissions and whose
    capacity weight is fixed (a process replica after a mesh degrade)."""

    def __init__(self, weight):
        self.weight = weight
        self.n = 0
        self.engine = types.SimpleNamespace(page_size=8, max_batch=2,
                                            max_queue=None)

    def submit(self, req, resume=False):
        self.n += 1
        return req.rid

    def load(self):
        return self.n

    def capacity_weight(self):
        return self.weight

    def progress(self):
        return (self.n,)

    def has_work(self):
        return False

    def step(self):
        pass

    def finished(self):
        return {}

    def close(self):
        pass

    abandon = close


def test_route_order_divides_load_by_capacity_weight(tmp_path):
    """Stub supervisors of weights 1.0 and 0.5: both packages' routers
    send the same rids to the same replicas, and the half-capacity
    replica takes about a third of the traffic (unweighted least-loaded
    routing would split it evenly)."""
    assigned = {}
    base = _rid_base()
    for pk in (JAX, TORCH):
        weights = [1.0, 0.5]

        class Router(pk.fl.FleetRouter):
            def _make_sup(self, idx, path):
                return _WeightedSup(weights[idx])

        _same_rids(base)
        fleet = Router(None, str(tmp_path / pk.name), num_replicas=2,
                       config=pk.fl.FleetConfig(affinity=False,
                                                brownout_depth=10 ** 9))
        for i in range(12):
            fleet.submit(pk.s.Request(np.arange(3 + i % 5, dtype=np.int32),
                                      max_new_tokens=2))
        assigned[pk.name] = sorted(fleet._assigned.items())
    assert assigned["torch"] == assigned["jax"]
    per = [sum(1 for _, i in assigned["torch"] if i == r) for r in (0, 1)]
    assert per == [8, 4]


# ---------------------------------------------------------------------------
# process cases: the port's workers on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """The JAX preset's tiny model (seed 13, 1 layer), its weights in a
    state file the port's workers load, and the JAX engines' greedy
    reference streams on the test wave (legacy and prefix cache)."""
    c = types.SimpleNamespace()
    paddle.seed(13)
    c.jm = JaxLlama(JaxConfig.tiny(num_hidden_layers=1))
    c.state_path = str(tmp_path_factory.mktemp("carried") / "tiny.npz")
    np.savez(c.state_path, **state_from_jax_layer(c.jm))
    c.refs = {}
    for prefix in (False, True):
        eng = jserving.ContinuousBatchingEngine(c.jm, prefix_cache=prefix,
                                                **ENGINE)
        reqs = [jserving.Request(**kw) for kw in _wave_kwargs()
                if "temperature" not in kw]
        for r in reqs:
            eng.add_request(r)
        eng.run_until_done(max_steps=500)
        c.refs[prefix] = [list(r.tokens) for r in reqs]
    return c


def _wave_kwargs(n=6):
    rng = np.random.default_rng(41)
    kws = []
    for i in range(n):
        p = rng.integers(0, 256, (6,)).astype(np.int32)
        kw = dict(prompt_ids=p, max_new_tokens=8, seed=200 + i)
        if i % 3 == 2:
            kw.update(temperature=0.9)
        kws.append(kw)
    return kws


def _port_refs(carried, prefix=False, n=6):
    """Greedy streams from the JAX engine; sampled ones from one
    in-process port engine on the carried weights."""
    eng = tpresets.tiny_llama_engine(device="cpu", prefix_cache=prefix,
                                     state_path=carried.state_path)
    kws = _wave_kwargs(n)
    reqs = [tserving.Request(**kw) for kw in kws]
    for r in reqs:
        eng.add_request(r)
    eng.run_until_done(max_steps=500)
    greedy = iter(carried.refs[prefix])
    out = []
    for kw, r in zip(kws, reqs):
        if "temperature" in kw:
            out.append(list(r.tokens))
        else:
            g = next(greedy)
            assert list(r.tokens) == g      # the in-process port == JAX
            out.append(g)
    return out


def _cfg(carried, prefix=False, factory=None, **extra):
    fn = "tiny_llama_prefix_engine" if prefix else "tiny_llama_engine"
    return tpf.ProcFleetConfig(
        factory=factory or f"{PRESETS}:{fn}",
        factory_kwargs={"device": "cpu", "state_path": carried.state_path},
        env={"OMP_NUM_THREADS": "1"}, spawn_timeout_s=SPAWN_S,
        op_timeout_s=OP_S, **extra)


def _serve(router, kws, plan=None, max_steps=500):
    reqs = [tserving.Request(**kw) for kw in kws]
    if plan is not None:
        plan.install()
    try:
        for r in reqs:
            router.submit(r)
        router.run_until_done(max_steps=max_steps)
    finally:
        if plan is not None:
            plan.uninstall()
    return reqs


def _gone(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


class TestProcKill:
    def test_sigkill_one_of_two_streams_equal_jax(self, tmp_path, carried):
        """A real SIGKILL mid-decode: the dead worker's journal feeds
        re-admission on the survivor; every stream equals the
        uninterrupted run (greedy: the JAX engine's)."""
        refs = _port_refs(carried)
        plan = tfaults.FaultPlan(seed=5, specs=[tfaults.FaultSpec(
            "fleet.proc_kill", "kill", at=2, count=1, match="replica:0:")])
        fleet = tpf.ProcFleetRouter(_cfg(carried), str(tmp_path),
                                    num_replicas=2)
        try:
            pid0 = fleet.replicas[0].sup.worker_pid
            assert pid0 != os.getpid()
            reqs = _serve(fleet, _wave_kwargs(), plan)
        finally:
            fleet.close()
        assert plan.log == [("fleet.proc_kill", f"replica:0:pid:{pid0}",
                             "kill")]
        assert fleet.stats["replica_deaths"] == 1
        assert _gone(pid0)
        assert not [r.rid for r in reqs if r.failed or not r.done]
        assert [list(r.output) for r in reqs] == refs
        assert fleet.stats["failover_requests"] >= 1
        assert [c for c, _ in fleet.events] == ["PT-FLT-001", "PT-FLT-001"]

    def test_no_failover_control_arm_loses_streams(self, tmp_path, carried):
        plan = tfaults.FaultPlan(seed=5, specs=[tfaults.FaultSpec(
            "fleet.proc_kill", "kill", at=2, count=1, match="replica:0:")])
        fleet = tpf.ProcFleetRouter(_cfg(carried), str(tmp_path),
                                    num_replicas=2, failover=False)
        try:
            reqs = _serve(fleet, _wave_kwargs(), plan)
        finally:
            fleet.close()
        lost = [r for r in reqs if r.failed]
        assert lost
        assert all("PT-FLT-001" in (r.error or "") for r in lost)


class TestProcLifecycle:
    def test_rolling_restart_over_processes(self, tmp_path, carried):
        refs = _port_refs(carried)
        fleet = tpf.ProcFleetRouter(_cfg(carried), str(tmp_path),
                                    num_replicas=2)
        try:
            pids0 = [rep.sup.worker_pid for rep in fleet.replicas]
            reqs = [tserving.Request(**kw) for kw in _wave_kwargs()]
            for r in reqs:
                fleet.submit(r)
            fleet.step()
            fleet.rolling_restart(max_steps=500)
            fleet.run_until_done(max_steps=500)
            pids1 = [rep.sup.worker_pid for rep in fleet.replicas]
        finally:
            fleet.close()
        assert [list(r.output) for r in reqs] == refs
        assert fleet.stats["restarts"] >= 2
        assert set(pids0).isdisjoint(pids1)
        assert fleet.stats["proc_spawned"] == fleet.stats["proc_reaped"] == 4
        assert all(_gone(p) for p in pids0 + pids1)

    def test_autoscaler_spawns_and_reaps_processes(self, tmp_path, carried):
        from paddle_tpu_torch.inference.autoscale import (AutoscaleConfig,
                                                          SLOAutoscaler)

        class _Mon:
            class config:
                target_attainment = 0.9

            window = None

            def last_window(self):
                return self.window

        fleet = tpf.ProcFleetRouter(_cfg(carried), str(tmp_path),
                                    num_replicas=1)
        mon = _Mon()
        scaler = SLOAutoscaler(fleet, mon, AutoscaleConfig(
            min_replicas=1, max_replicas=2, up_after=1, down_after=1,
            cooldown_windows=0))
        try:
            mon.window = {"window": 0, "attainment": 0.5, "finished": 8}
            assert scaler.tick() == "scale_up"
            assert len(fleet.replicas) == 2
            new = fleet.replicas[1].sup
            assert isinstance(new, tpf.ProcReplica) and new.worker_pid > 0
            assert fleet.stats["proc_spawned"] == 2
            reqs = _serve(fleet, _wave_kwargs(n=4))
            assert all(r.done and not r.failed for r in reqs)
            assert {fleet._assigned[r.rid] for r in reqs} == {0, 1}
            mon.window = {"window": 1, "attainment": 1.0, "finished": 8}
            assert scaler.tick() == "scale_down"
            guard = 0
            while (fleet.replicas[1].state != tfleet.ReplicaState.RETIRED
                   and guard < 200):
                fleet.step()
                guard += 1
            assert fleet.replicas[1].state == tfleet.ReplicaState.RETIRED
            assert new.reaped and _gone(new.worker_pid)
        finally:
            fleet.close()


class TestProcScrape:
    def test_driver_aggregates_worker_metrics(self, tmp_path, carried):
        """procfleet_collector fetches each worker's own /metrics and
        merges its families under replica=i labels; after close() it
        reports zero live workers and the scrape still answers."""
        from paddle_tpu_torch.observability import (MetricsRegistry,
                                                    parse_prometheus_text,
                                                    procfleet_collector)

        fleet = tpf.ProcFleetRouter(_cfg(carried, heartbeat_s=0.2),
                                    str(tmp_path), num_replicas=1)
        registry = MetricsRegistry()
        registry.register_collector(procfleet_collector(fleet))
        try:
            _serve(fleet, _wave_kwargs(n=2))
            deadline = time.monotonic() + 30.0
            while fleet.heartbeat_total() < 1 and \
                    time.monotonic() < deadline:
                time.sleep(0.05)
            fams = parse_prometheus_text(registry.dump())
            assert fams["pt_procfleet_spawned_total"].samples[0][2] == 1.0
            assert fams["pt_procfleet_workers_alive"].samples[0][2] == 1.0
            assert fams["pt_procfleet_heartbeats_total"].samples[0][2] >= 1
            assert fams["pt_procfleet_scrape_errors"].samples[0][2] == 0.0
            eng = fams["pt_engine_scheduled_tokens_total"]
            assert any(s[1].get("replica") == "0" and s[2] > 0
                       for s in eng.samples)
            up = fams["pt_procfleet_worker_up"]
            assert [(s[1], s[2]) for s in up.samples] == [
                ({"tier": "serving", "replica": "0"}, 1.0)]
            text = fleet.replicas[0].sup.metrics_text()
            assert "pt_procfleet_worker_up" in text
        finally:
            fleet.close()
        fams = parse_prometheus_text(registry.dump())
        assert fams["pt_procfleet_workers_alive"].samples[0][2] == 0.0
        assert fams["pt_procfleet_reaped_total"].samples[0][2] == 1.0

    def test_in_process_fleet_text_equals_jax(self, tmp_path, carried):
        """Over an in-process fleet the collector renders the same text
        as the JAX package's, zeros included."""
        from paddle_tpu.observability import MetricsRegistry as JReg
        from paddle_tpu.observability import procfleet_collector as jcol
        from paddle_tpu_torch.observability import MetricsRegistry as TReg
        from paddle_tpu_torch.observability import procfleet_collector as tcol

        tm = tpresets.tiny_llama_engine(device="cpu",
                                        state_path=carried.state_path).model
        texts = []
        for reg, col, fleet in (
                (JReg(), jcol, jfleet.FleetRouter(
                    lambda: jserving.ContinuousBatchingEngine(
                        carried.jm, **ENGINE), str(tmp_path / "j"), 2)),
                (TReg(), tcol, tfleet.FleetRouter(
                    lambda: tserving.ContinuousBatchingEngine(
                        tm, device="cpu", **ENGINE), str(tmp_path / "t"),
                    2))):
            reg.register_collector(col(fleet))
            texts.append(reg.dump())
            fleet.close()
        assert texts[1] == texts[0]
        assert "pt_transport_breaker_state" in texts[1]

    def test_spawned_worker_imports_neither_jax_nor_reference(self, tmp_path,
                                                              carried):
        """A spawned worker's sys.modules holds no jax and no paddle_tpu
        (the probe factory writes them out before building its engine)."""
        out = str(tmp_path / "modules.json")
        cfg = _cfg(carried, factory="torch_procfleet_probe:probed_engine")
        cfg.factory_kwargs["modules_path"] = out
        fleet = tpf.ProcFleetRouter(cfg, str(tmp_path / "f"), num_replicas=1)
        try:
            pid = fleet.replicas[0].sup.worker_pid
        finally:
            fleet.close()
        with open(out) as f:
            probe = json.load(f)
        assert probe["pid"] == pid != os.getpid()
        assert "paddle_tpu_torch.inference.procfleet.worker" in \
            probe["modules"]
        assert [m for m in probe["modules"]
                if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")] == []

    def test_worker_that_cannot_build_sends_error_and_exits_3(self, tmp_path,
                                                             carried):
        """No fallback: a worker whose engine cannot be built (here: a
        CUDA device asked for where none exists) says why and exits 3."""
        if torch.cuda.is_available():
            pytest.skip("needs a machine without a CUDA device")
        cfg = _cfg(carried)
        cfg.factory_kwargs["device"] = "cuda"
        with pytest.raises(tpf.WorkerDead,
                           match="opened with ERROR.*CUDA") as ei:
            tpf.ProcFleetRouter(cfg, str(tmp_path), num_replicas=1)
        assert "RuntimeError" in str(ei.value)


class TestProcTiered:
    def test_wire_migration_streams_equal_jax(self, tmp_path, carried):
        refs = _port_refs(carried, prefix=True, n=4)
        tiered = tpf.ProcTieredRouter(_cfg(carried, prefix=True),
                                      _cfg(carried, prefix=True),
                                      str(tmp_path), num_prefill=1,
                                      num_decode=1)
        try:
            assert tiered.replicas[0].sup.engine.dtype == "float32"
            reqs = _serve(tiered, _wave_kwargs(n=4))
        finally:
            tiered.close()
        assert [list(r.output) for r in reqs] == refs
        assert tiered.stats["migrations"] >= 1
        assert tiered.stats["migration_bytes"] > 0
        recs = trecovery.RequestJournal.load(tiered.replicas[0].journal_path)
        assert any(r["k"] == "migr-kv" for r in recs)

    def test_prefixless_tier_refused_and_reaped(self, tmp_path, carried):
        with pytest.raises(ValueError, match="prefix cache"):
            tpf.ProcTieredRouter(_cfg(carried), _cfg(carried, prefix=True),
                                 str(tmp_path), num_prefill=1, num_decode=1,
                                 config=tfleet.FleetConfig())


class TestLoopbackChaosByteIdentity:
    """A tiered loopback fleet under a seeded chaos plan (a dropped and a
    bitflipped MIGRATE_IN) gives the fault-free run's streams: idempotent
    resends, typed-corruption retry-elsewhere and hedging through the
    real routers."""

    def _cfg(self, carried):
        return tpf.ProcFleetConfig(
            factory=f"{PRESETS}:tiny_llama_prefix_engine",
            factory_kwargs={"device": "cpu",
                            "state_path": carried.state_path},
            transport="loopback", chaos=True, op_timeout_s=1.0)

    def _run(self, path, carried, kws, plan=None):
        tiered = tpf.ProcTieredRouter(self._cfg(carried), self._cfg(carried),
                                      path, num_prefill=1, num_decode=2)
        try:
            reqs = _serve(tiered, kws, plan)
        finally:
            tiered.close()
        assert all(r.done and not r.failed for r in reqs)
        return [list(r.output) for r in reqs], dict(tiered.stats)

    def test_seeded_chaos_streams_equal_fault_free_run(self, tmp_path,
                                                       carried):
        kws = _wave_kwargs(n=4)
        refs, clean = self._run(str(tmp_path / "clean"), carried, kws)
        assert clean["migrations"] >= 1
        plan = tfaults.FaultPlan(seed=7, specs=[
            tfaults.FaultSpec("net.send", "drop", at=0, count=1,
                              match="MIGRATE_IN"),
            tfaults.FaultSpec("net.send", "bitflip", at=1, count=1, arg=64,
                              match="MIGRATE_IN")])
        outs, stats = self._run(str(tmp_path / "chaos"), carried, kws, plan)
        assert sorted(a for _, _, a in plan.log) == ["bitflip", "drop"]
        assert outs == refs
        assert stats["migration_hedges"] >= 1
        assert stats["migration_corrupt"] >= 1
