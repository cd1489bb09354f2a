"""PT-PROC wire protocol: length-prefixed, crc32-framed, versioned
messages — port of ``paddle_tpu/inference/procfleet/wire.py``.

The process-per-replica fleet exchanges control messages between the
driver and each replica worker over a localhost stream. Every frame is
crc-checked and damage raises a TYPED error naming what broke, so corrupt
bytes never reach a supervisor.

Frame layout (big-endian)::

    b"PTPF" | version u8 | type u8 | json_len u32 | blob_len u32 | crc u32
    <json payload> <binary blob>

- ``crc`` is crc32 over json+blob. A mismatch, a bad magic, an unknown
  version/type, an oversized length, or a frame truncated mid-payload
  raises :class:`WireCorrupt` (**PT-PROC-001**).
- The ``blob`` carries opaque binary payloads (PTKV1 KV-chain artifacts
  for tiered migration) beside the json control fields.
- Schemas are STRICT both ways: :func:`encode` and :func:`decode` check
  that a message carries its type's required fields with the expected json
  types, so a frame that round-trips is one both ends agree on.

The wire is an interface shared with the JAX package: the json is compact
(``separators=(",", ":")``) in the payload's own key order, so for the same
:class:`Message` both packages' :func:`encode` give the same bytes, and
each decodes the other's frames.

Stream death vs damage: a stream that EOFs (the worker was SIGKILLed, the
driver went away) raises :class:`WireClosed` — process death, the fleet's
failover trigger, not corruption. Only damaged BYTES are PT-PROC-001.
"""

from __future__ import annotations

import json
import socket
import struct
import time
import zlib
from typing import Dict, Optional, Tuple

__all__ = ["Message", "WireClosed", "WireCorrupt", "decode", "decode_bytes",
           "encode", "recv_msg", "send_msg", "MSG_TYPES", "WIRE_VERSION"]

MAGIC = b"PTPF"
WIRE_VERSION = 1
_HEADER = struct.Struct(">4sBBIII")
#: frames larger than this are damage, not data (a corrupted length field
#: must not make recv_msg try to allocate gigabytes)
MAX_FRAME = 256 * 1024 * 1024


class WireCorrupt(RuntimeError):
    """PT-PROC-001: a frame failed its crc32, carried a bad magic/version/
    type/length, or violated its message schema — the bytes were damaged
    (or the peer speaks a different protocol). Never retried blindly: the
    stream position is untrusted from here on."""


class WireClosed(ConnectionError):
    """The peer closed the stream (clean EOF or mid-frame cut) — process
    death, the fleet failover trigger. Distinct from :class:`WireCorrupt`:
    a SIGKILL'd worker is an expected operational event, damaged bytes on
    a live stream are not."""


#: message types. Requests flow driver -> worker, replies worker -> driver;
#: ERROR is a typed refusal (the proxy re-raises the named exception class).
MSG_TYPES = {
    "HELLO": 1,        # worker -> driver, once: pid, metrics port, geometry
    "SUBMIT": 2,       # admit one request (resume=True carries delivered)
    "SUBMITTED": 3,
    "STEP": 4,         # one supervisor step
    "TOKENS": 5,       # step reply: per-rid deltas + progress marker
    "WITHDRAW": 6,     # pull a still-queued rid (drain migration)
    "WITHDRAWN": 7,
    "DRAIN": 8,        # stop admitting new work (in-flight finishes)
    "DRAINING": 9,
    "PROGRESS": 10,    # heartbeat probe / progress marker query
    "METRICS": 11,     # registry dump over the control socket
    "METRICS_TEXT": 12,
    "SHUTDOWN": 13,    # graceful close: flush journal, stop, exit 0
    "BYE": 14,
    "ERROR": 15,       # typed refusal: {etype, msg}
    "MIGRATE_OUT": 16,  # export + retire a finished-prefill KV chain
    "CHAIN": 17,        # reply: header json + artifact blob
    "MIGRATE_IN": 18,   # splice a migrated chain (artifact in the blob)
    "SPLICED": 19,
    "PROGRESS_REPLY": 20,   # PROGRESS answered with state
    "MIGRATE_CANCEL": 21,   # roll back a hedge-loser's spliced chain
    "CANCELLED": 22,
}
_TYPE_NAMES = {v: k for k, v in MSG_TYPES.items()}

#: required json fields per type: {field: type-or-types}. ``None`` in the
#: tuple marks an optional-null field. Strictness is the point — a frame
#: that decodes is a frame whose shape both ends agree on.
_OPT = type(None)
SCHEMAS: Dict[str, Dict[str, tuple]] = {
    # ``state`` mirrors the worker's load/progress marker/has_work so the
    # driver can answer router probes WITHOUT extra roundtrips: every
    # state change is driver-initiated (submit/step/withdraw) or rides a
    # step reply, so reply-piggybacked state is exact between ops
    "HELLO": {"pid": (int,), "metrics_port": (int, _OPT),
              "journal_path": (str,), "engine": (dict,), "state": (dict,)},
    # SUBMIT/MIGRATE_IN may additionally carry ``idem`` (a str idempotence
    # key, riding like the ``_seq`` stamp outside the required set): a
    # retried or chaos-duplicated delivery with a key the worker already
    # served is answered from its dedup cache, never served twice
    "SUBMIT": {"req": (dict,), "resume": (bool,), "delivered": (list,)},
    "SUBMITTED": {"rid": (int,), "load": (int,)},
    "STEP": {},
    "TOKENS": {"updates": (list,), "load": (int,), "sig": (list,),
               "behind": (list,), "ready": (list,), "has_work": (bool,),
               "cap": (list,)},
    "WITHDRAW": {"rid": (int,)},
    "WITHDRAWN": {"rec": (dict, _OPT), "load": (int,)},
    "DRAIN": {},
    "DRAINING": {"load": (int,)},
    "PROGRESS": {},
    "METRICS": {},
    "METRICS_TEXT": {"text": (str,)},
    "SHUTDOWN": {},
    "BYE": {},
    "ERROR": {"etype": (str,), "msg": (str,)},
    "MIGRATE_OUT": {"rid": (int,)},
    # ``updates``: token deltas the export's flush surfaced worker-side
    # that the driver has not seen yet — applied before the chain travels,
    # so the driver's delivered prefix always matches the artifact's
    "CHAIN": {"rid": (int,), "digest": (str,), "pages": (int,),
              "updates": (list,)},
    "MIGRATE_IN": {"req": (dict,), "delivered": (list,)},
    "SPLICED": {"rid": (int,)},
    "PROGRESS_REPLY": {"sig": (list,), "load": (int,),
                       "has_work": (bool,), "behind": (list,)},
    # hedged migration's loser side: if ``rid`` is still live from a
    # MIGRATE_IN with this chain digest, retire it (journal ``migr-kv``,
    # pages decref'd — allocator back where it started)
    "MIGRATE_CANCEL": {"rid": (int,), "digest": (str,)},
    "CANCELLED": {"rid": (int,), "rolled_back": (bool,)},
}


class Message:
    """One typed wire message: ``mtype`` (a :data:`MSG_TYPES` name), a json
    ``payload`` dict matching the type's schema, and an optional binary
    ``blob`` (KV-chain artifacts)."""

    __slots__ = ("mtype", "payload", "blob")

    def __init__(self, mtype: str, payload: Optional[dict] = None,
                 blob: bytes = b""):
        self.mtype = mtype
        self.payload = dict(payload or {})
        self.blob = bytes(blob)

    def __eq__(self, other):
        return (isinstance(other, Message) and self.mtype == other.mtype
                and self.payload == other.payload and self.blob == other.blob)

    def __repr__(self):
        return (f"Message({self.mtype!r}, {self.payload!r}"
                + (f", blob[{len(self.blob)}B]" if self.blob else "") + ")")


def _check_schema(msg: Message) -> None:
    schema = SCHEMAS.get(msg.mtype)
    if schema is None:
        raise WireCorrupt(
            f"PT-PROC-001: unknown message type {msg.mtype!r}")
    for field, kinds in schema.items():
        if field not in msg.payload:
            raise WireCorrupt(
                f"PT-PROC-001: {msg.mtype} frame missing required field "
                f"{field!r}")
        val = msg.payload[field]
        # bool is an int subclass — an int field must not accept True
        if isinstance(val, bool) and bool not in kinds:
            raise WireCorrupt(
                f"PT-PROC-001: {msg.mtype}.{field} is bool, schema wants "
                f"{tuple(k.__name__ for k in kinds)}")
        if not isinstance(val, kinds):
            raise WireCorrupt(
                f"PT-PROC-001: {msg.mtype}.{field} is "
                f"{type(val).__name__}, schema wants "
                f"{tuple(k.__name__ for k in kinds)}")


def encode(msg: Message) -> bytes:
    """Message -> framed bytes (schema-validated before a byte is built)."""
    _check_schema(msg)
    tid = MSG_TYPES[msg.mtype]
    try:
        body = json.dumps(msg.payload, separators=(",", ":"),
                          allow_nan=False).encode("utf-8")
    except (TypeError, ValueError) as e:
        raise WireCorrupt(
            f"PT-PROC-001: {msg.mtype} payload is not wire-encodable: "
            f"{e}") from None
    crc = zlib.crc32(msg.blob, zlib.crc32(body)) & 0xFFFFFFFF
    return _HEADER.pack(MAGIC, WIRE_VERSION, tid, len(body),
                        len(msg.blob), crc) + body + msg.blob


def decode_bytes(data: bytes) -> Message:
    """Strict offline decode of EXACTLY one frame (tests, buffers already
    read in full): truncation anywhere — header or payload — and trailing
    garbage are both PT-PROC-001."""
    msg, used = decode(data)
    if msg is None:
        raise WireCorrupt(
            f"PT-PROC-001: truncated frame ({len(data)} bytes)")
    if used != len(data):
        raise WireCorrupt(
            f"PT-PROC-001: {len(data) - used} trailing byte(s) after the "
            "frame")
    return msg


def decode(buf: bytes) -> Tuple[Optional[Message], int]:
    """Incremental decode: ``(message, bytes_consumed)``, or ``(None, 0)``
    when ``buf`` holds less than one complete frame. Damage (bad magic /
    version / type / length / crc / schema) raises :class:`WireCorrupt`."""
    if len(buf) < _HEADER.size:
        if buf and not MAGIC.startswith(bytes(buf[:4])[:len(buf)]):
            raise WireCorrupt("PT-PROC-001: bad frame magic "
                              f"{bytes(buf[:4])!r}")
        return None, 0
    magic, ver, tid, jlen, blen, crc = _HEADER.unpack_from(buf)
    if magic != MAGIC:
        raise WireCorrupt(f"PT-PROC-001: bad frame magic {magic!r}")
    if ver != WIRE_VERSION:
        raise WireCorrupt(
            f"PT-PROC-001: wire version {ver} (this end speaks "
            f"{WIRE_VERSION}) — driver and worker builds must match")
    if tid not in _TYPE_NAMES:
        raise WireCorrupt(f"PT-PROC-001: unknown message type id {tid}")
    if jlen + blen > MAX_FRAME:
        raise WireCorrupt(
            f"PT-PROC-001: frame length {jlen + blen} exceeds the "
            f"{MAX_FRAME}-byte ceiling — corrupted length field")
    total = _HEADER.size + jlen + blen
    if len(buf) < total:
        return None, 0
    body = bytes(buf[_HEADER.size:_HEADER.size + jlen])
    blob = bytes(buf[_HEADER.size + jlen:total])
    if (zlib.crc32(blob, zlib.crc32(body)) & 0xFFFFFFFF) != crc:
        raise WireCorrupt(
            f"PT-PROC-001: {_TYPE_NAMES[tid]} frame failed its crc32 — "
            "bytes damaged in transit")
    try:
        payload = json.loads(body.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError):
        raise WireCorrupt(
            f"PT-PROC-001: {_TYPE_NAMES[tid]} frame crc passed but the "
            "payload does not parse — encoder bug, not line noise"
        ) from None
    if not isinstance(payload, dict):
        raise WireCorrupt(
            f"PT-PROC-001: {_TYPE_NAMES[tid]} payload is not an object")
    msg = Message(_TYPE_NAMES[tid], payload, blob)
    _check_schema(msg)
    return msg, total


# -- socket helpers ---------------------------------------------------------

def send_msg(sock: socket.socket, msg: Message) -> None:
    """Frame + send one message. A peer that vanished mid-send raises
    :class:`WireClosed` (death, not damage). A SEND timeout (the socket
    may carry a leftover recv timeout) is also :class:`WireClosed`: the
    frame may be partially written, so the outgoing stream position is
    unusable — the connection is done either way."""
    try:
        sock.sendall(encode(msg))
    except socket.timeout as e:
        raise WireClosed(
            f"send of {msg.mtype} stalled (frame possibly partially "
            "written — stream unusable)") from e
    except (BrokenPipeError, ConnectionResetError, OSError) as e:
        raise WireClosed(f"peer gone during send of {msg.mtype}: "
                         f"{e}") from e


def _recv_exact(sock: socket.socket, n: int, what: str,
                deadline: Optional[float] = None) -> bytes:
    """Read exactly ``n`` bytes. ``deadline`` (a ``time.monotonic``
    stamp) bounds the WHOLE read, not each chunk — a peer trickling one
    byte per interval must still trip the op budget, or the PT-PROC-003
    wedged-worker timeout is a fiction."""
    # a timeout AFTER any frame byte was consumed leaves the stream
    # position mid-frame — callers must NOT retry on such a socket; the
    # flag lets them distinguish "no reply yet" (stream still aligned,
    # retry + seq-drain is safe) from "reply half-read" (connection done)
    partial = what != "header"
    chunks = []
    got = 0
    while got < n:
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                e = socket.timeout(
                    f"frame {what} read exceeded its deadline "
                    f"({got}/{n} bytes)")
                e.partial_read = partial or got > 0
                raise e
            sock.settimeout(remaining)
        try:
            chunk = sock.recv(min(n - got, 1 << 20))
        except socket.timeout as e:
            # surfaced distinctly: the peer may be alive
            e.partial_read = partial or got > 0
            raise
        except (ConnectionResetError, OSError) as e:
            raise WireClosed(f"peer gone mid-{what}: {e}") from e
        if not chunk:
            if got == 0 and what == "header":
                raise WireClosed("peer closed the stream")
            raise WireClosed(
                f"peer closed the stream mid-{what} "
                f"({got}/{n} bytes) — process death")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recv_msg(sock: socket.socket,
             timeout: Optional[float] = None) -> Message:
    """Read exactly one frame. ``timeout`` (seconds) bounds the whole
    read — header through last payload byte, across however many chunks;
    ``socket.timeout`` propagates so callers can treat a silent peer
    differently from a dead one. EOF raises :class:`WireClosed`, damage
    raises :class:`WireCorrupt`."""
    deadline = None
    if timeout is not None:
        sock.settimeout(timeout)
        deadline = time.monotonic() + timeout
    head = _recv_exact(sock, _HEADER.size, "header", deadline)
    magic, ver, tid, jlen, blen, crc = _HEADER.unpack_from(head)
    # validate BEFORE the body read so a garbage length cannot stall us
    if magic != MAGIC or ver != WIRE_VERSION or tid not in _TYPE_NAMES \
            or jlen + blen > MAX_FRAME:
        decode(head)                     # raises the precise WireCorrupt
        raise WireCorrupt("PT-PROC-001: malformed frame header")
    body = _recv_exact(sock, jlen + blen, "payload", deadline)
    return decode_bytes(head + body)
