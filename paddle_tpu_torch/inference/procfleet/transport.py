"""Pluggable frame transport for the process fleet, and its chaos twin —
port of ``paddle_tpu/inference/procfleet/transport.py``.

Everything above this seam — :class:`~.proxy.ProcReplica`, the worker
serve loop, the routers — moves whole :class:`~.wire.Message` frames
through four verbs (``connect``/``send_frame``/``recv_frame``/``close``)
and never sees a socket.

Three implementations:

- :class:`TcpTransport` — a localhost socket: a send timeout or vanished
  peer is :class:`WireClosed`, a recv timeout propagates
  ``socket.timeout`` carrying the ``partial_read`` flag (False only when
  ZERO frame bytes were read, so callers know whether the stream position
  is still aligned).
- :class:`LoopbackTransport` — an in-process queue pair built by
  :func:`loopback_pair`. Frames still travel as encoded BYTES through the
  real codec (chunk boundaries and torn prefixes behave exactly like
  TCP), but the worker lives on a thread of this process.
- :class:`ChaosTransport` — a decorator over either, consulting the
  installed :class:`FaultPlan` at three sites (``net.connect``,
  ``net.send``, ``net.recv``). Control actions (``stall``/``delay``/
  ``kill``/``error``) behave as everywhere else; data actions
  (``bitflip``/``truncate``/``garbage``) damage the PAYLOAD and then
  re-frame, so the frame crc is valid over corrupt bytes — the silent
  network damage only end-to-end checks (the KV chain's per-page crc32)
  catch; net actions are frame-level: ``drop`` loses the frame,
  ``duplicate`` delivers it twice, ``torn`` ships a prefix (the
  receiver's next read misaligns into a typed ``WireCorrupt``),
  ``blackhole`` swallows every later frame to or from that peer.

Determinism: every fault decision comes from the installed plan's
per-spec counters and seeded rng (``faults.wire_faults``, draws from
``plan.rng`` in the JAX package's order), so the same plan over the same
frame stream damages the same bytes in both packages.
"""

from __future__ import annotations

import queue
import socket
import threading
import time
from typing import Optional, Tuple

from ...distributed.resilience.faults import FaultInjected, active_plan, \
    wire_faults
from . import wire
from .wire import Message, WireClosed

__all__ = ["Transport", "TcpTransport", "LoopbackTransport",
           "ChaosTransport", "loopback_pair"]


class Transport:
    """One end of a framed, ordered, reliable-until-faulted byte stream.

    The contract every implementation (and every chaos decorator) keeps:

    - ``send_frame`` either ships one whole frame or raises
      :class:`WireClosed` (the outgoing stream position is unusable).
    - ``recv_frame`` returns exactly one validated :class:`Message`,
      raises ``socket.timeout`` (with ``partial_read``) when the peer is
      silent, :class:`WireClosed` on peer death, :class:`WireCorrupt` on
      damaged bytes.
    - ``close`` is idempotent and unblocks the peer's pending recv.
    """

    peer: str = "?"

    def connect(self) -> None:
        """Establish the stream (no-op for already-connected ends)."""

    def send_frame(self, msg: Message) -> None:
        self.send_bytes(wire.encode(msg), msg.mtype)

    def send_bytes(self, data: bytes, mtype: str = "?") -> None:
        raise NotImplementedError

    def recv_frame(self, timeout: Optional[float] = None) -> Message:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError


class TcpTransport(Transport):
    """A localhost socket behind the seam. Wraps an already-connected
    socket (driver accept side / worker connect-back side) or an
    ``(host, port)`` address to dial on :meth:`connect`."""

    def __init__(self, sock: Optional[socket.socket] = None,
                 addr: Optional[Tuple[str, int]] = None,
                 connect_timeout_s: float = 30.0):
        if sock is None and addr is None:
            raise ValueError("TcpTransport needs a socket or an address")
        self._sock = sock
        self._addr = addr
        self._connect_timeout_s = connect_timeout_s
        if sock is not None:
            try:
                name = sock.getpeername()
                # AF_UNIX socketpairs (tests) name peers with a str/bytes
                self.peer = ("%s:%d" % name[:2] if isinstance(name, tuple)
                             else (str(name) or "socketpair"))
            except OSError:
                self.peer = "tcp:?"
        else:
            self.peer = "%s:%d" % tuple(addr)

    def connect(self) -> None:
        if self._sock is None:
            self._sock = socket.create_connection(
                self._addr, timeout=self._connect_timeout_s)

    @property
    def sock(self) -> socket.socket:
        if self._sock is None:
            raise WireClosed(f"transport to {self.peer} never connected")
        return self._sock

    def send_frame(self, msg: Message) -> None:
        wire.send_msg(self.sock, msg)

    def send_bytes(self, data: bytes, mtype: str = "?") -> None:
        # same death mapping as wire.send_msg — raw-frame sends are how
        # the chaos decorator ships torn/duplicated bytes
        try:
            self.sock.sendall(data)
        except socket.timeout as e:
            raise WireClosed(
                f"send of {mtype} stalled (frame possibly partially "
                "written — stream unusable)") from e
        except (BrokenPipeError, ConnectionResetError, OSError) as e:
            raise WireClosed(f"peer gone during send of {mtype}: "
                             f"{e}") from e

    def recv_frame(self, timeout: Optional[float] = None) -> Message:
        return wire.recv_msg(self.sock, timeout)

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass


class LoopbackTransport(Transport):
    """In-process transport: encoded frame bytes over a queue pair.

    Bytes, not Message objects, deliberately — the full codec runs on
    both ends, chunk reassembly included, so loopback tests exercise the
    exact frame path TCP does (a torn prefix in the buffer misaligns the
    next frame into ``WireCorrupt``, like a real stream)."""

    _CLOSE = None          # queue sentinel: peer closed

    def __init__(self, rx: "queue.Queue", tx: "queue.Queue", peer: str):
        self._rx = rx
        self._tx = tx
        self.peer = peer
        self._buf = bytearray()
        # close() runs on the driver thread while the loopback worker is
        # blocked in recv_frame — _closed crosses threads
        self._lock = threading.Lock()
        self._closed = False

    def send_bytes(self, data: bytes, mtype: str = "?") -> None:
        with self._lock:
            closed = self._closed
        if closed:
            raise WireClosed(
                f"send of {mtype} on a closed loopback transport")
        self._tx.put(bytes(data))

    def recv_frame(self, timeout: Optional[float] = None) -> Message:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self._buf:
                msg, used = wire.decode(bytes(self._buf))
                if msg is not None:
                    del self._buf[:used]
                    return msg
            with self._lock:
                closed = self._closed
            if closed:
                raise WireClosed("loopback transport closed"
                                 + (" mid-frame" if self._buf else ""))
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    e = socket.timeout(
                        f"loopback recv from {self.peer} exceeded its "
                        "deadline")
                    e.partial_read = bool(self._buf)
                    raise e
            try:
                chunk = self._rx.get(timeout=remaining)
            except queue.Empty:
                e = socket.timeout(
                    f"loopback recv from {self.peer} timed out")
                e.partial_read = bool(self._buf)
                raise e from None
            if chunk is self._CLOSE:
                if self._buf:
                    raise WireClosed(
                        f"peer {self.peer} closed the stream mid-frame "
                        f"({len(self._buf)} buffered bytes) — death")
                raise WireClosed(f"peer {self.peer} closed the stream")
            self._buf += chunk

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._tx.put(self._CLOSE)


def loopback_pair(a: str = "driver", b: str = "worker"
                  ) -> Tuple[LoopbackTransport, LoopbackTransport]:
    """Two connected loopback ends: frames sent on one arrive on the
    other. ``a``/``b`` become each end's ``peer`` name (what the OTHER
    end calls it)."""
    ab: "queue.Queue" = queue.Queue()
    ba: "queue.Queue" = queue.Queue()
    return (LoopbackTransport(rx=ba, tx=ab, peer=b),
            LoopbackTransport(rx=ab, tx=ba, peer=a))


def _damage(data: bytes, action: str, arg: float, rng) -> bytes:
    """The faults.corrupt bit/byte rules, driven by an already-fired
    spec (firing ``corrupt()`` here would advance the plan's counters a
    second time for one wire event)."""
    if action == "truncate":
        n = int(arg) or max(1, len(data) // 2)
        return data[: max(0, len(data) - n)]
    if action == "garbage":
        return bytes(rng.getrandbits(8) for _ in range(len(data)))
    buf = bytearray(data)
    if not buf:
        return data
    nbits = int(arg) or 1
    lo, hi = len(buf) // 4, max(len(buf) // 4 + 1, (3 * len(buf)) // 4)
    for _ in range(nbits):
        pos = rng.randrange(lo, hi)
        buf[pos] ^= 1 << rng.randrange(8)
    return bytes(buf)


class ChaosTransport(Transport):
    """Seeded network-fault decorator over any :class:`Transport`.

    Fires the installed :class:`FaultPlan` once per wire event —
    ``net.connect`` (detail = peer), ``net.send`` (detail =
    ``peer:MSGTYPE``), ``net.recv`` (detail = peer) — and interprets the
    due specs (module docstring for the action catalogue). With no plan
    installed every call is one global read plus the inner op."""

    def __init__(self, inner: Transport, peer: Optional[str] = None):
        self.inner = inner
        self.peer = peer if peer is not None else inner.peer
        # sticky blackhole is flipped by whichever thread's wire event
        # drew the fault and read by every subsequent send/recv
        self._lock = threading.Lock()
        self._blackholed = False

    # -- verbs ---------------------------------------------------------
    def connect(self) -> None:
        for s in wire_faults("net.connect", self.peer):
            if s.action in ("stall", "delay"):
                time.sleep(s.arg)
            elif s.action in ("kill", "drop"):
                raise FaultInjected(
                    f"fault injected: connect to {self.peer} refused")
            elif s.action == "error":
                raise RuntimeError(
                    f"fault injected: error connecting to {self.peer}")
            elif s.action == "blackhole":
                with self._lock:
                    self._blackholed = True
        self.inner.connect()

    def send_frame(self, msg: Message) -> None:
        dup = torn = False
        blob, body_damage = msg.blob, None
        for s in wire_faults("net.send", f"{self.peer}:{msg.mtype}"):
            if s.action in ("stall", "delay"):
                time.sleep(s.arg)
            elif s.action == "kill":
                raise FaultInjected(
                    f"fault injected: kill on send of {msg.mtype} to "
                    f"{self.peer}")
            elif s.action == "error":
                raise RuntimeError(
                    f"fault injected: error on send of {msg.mtype}")
            elif s.action == "blackhole":
                with self._lock:
                    self._blackholed = True
            elif s.action == "drop":
                return                      # the frame is simply gone
            elif s.action == "duplicate":
                dup = True
            elif s.action == "torn":
                torn = True
            elif s.action in ("bitflip", "truncate", "garbage"):
                plan = active_plan()
                if blob:
                    # payload damage UNDER the frame crc: the wire-level
                    # check passes, only end-to-end integrity catches it
                    blob = _damage(blob, s.action, s.arg, plan.rng)
                else:
                    body_damage = s
        with self._lock:
            blackholed = self._blackholed
        if blackholed:
            return
        if blob is not msg.blob:
            msg = Message(msg.mtype, msg.payload, blob)
        data = wire.encode(msg)
        if body_damage is not None:
            # no blob to damage: hit the framed bytes themselves (crc now
            # wrong — the receiver's typed WireCorrupt path)
            plan = active_plan()
            head = data[:wire._HEADER.size]
            data = head + _damage(data[wire._HEADER.size:],
                                  body_damage.action, body_damage.arg,
                                  plan.rng)
        if torn:
            self.inner.send_bytes(data[: max(1, len(data) // 2)],
                                  msg.mtype)
            return
        self.inner.send_bytes(data, msg.mtype)
        if dup:
            self.inner.send_bytes(data, msg.mtype)

    def send_bytes(self, data: bytes, mtype: str = "?") -> None:
        with self._lock:
            blackholed = self._blackholed
        if blackholed:
            return
        self.inner.send_bytes(data, mtype)

    def recv_frame(self, timeout: Optional[float] = None) -> Message:
        drop = False
        damage = []
        for s in wire_faults("net.recv", self.peer):
            if s.action in ("stall", "delay"):
                time.sleep(s.arg)
            elif s.action == "kill":
                raise FaultInjected(
                    f"fault injected: kill on recv from {self.peer}")
            elif s.action == "error":
                raise RuntimeError(
                    f"fault injected: error on recv from {self.peer}")
            elif s.action == "blackhole":
                with self._lock:
                    self._blackholed = True
            elif s.action == "drop":
                drop = True
            elif s.action in ("bitflip", "truncate", "garbage"):
                damage.append(s)
        with self._lock:
            blackholed = self._blackholed
        if blackholed:
            e = socket.timeout(
                f"peer {self.peer} blackholed — nothing will arrive")
            e.partial_read = False
            raise e
        msg = self.inner.recv_frame(timeout)
        if drop:
            # the reply existed but was lost in flight: consume it so the
            # stream stays aligned, then look like a silent peer
            e = socket.timeout(
                f"fault injected: recv from {self.peer} dropped "
                f"{msg.mtype}")
            e.partial_read = False
            raise e
        for s in damage:
            plan = active_plan()
            if plan is not None and msg.blob:
                msg = Message(msg.mtype, msg.payload,
                              _damage(msg.blob, s.action, s.arg, plan.rng))
        return msg

    def close(self) -> None:
        self.inner.close()
