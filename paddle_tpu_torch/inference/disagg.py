"""Disaggregated prefill/decode serving tiers with KV-block migration —
port of ``paddle_tpu/inference/disagg.py``.

Serving at heavy traffic splits prefill (compute-bound, bursty) from decode
(latency-bound, steady) onto separate replicas: the prefill tier packs
prompts, and each finished chain moves to the decode tier, so decode never
stalls behind a long prompt. The engines already have every primitive
(chunked and packed prefill, refcounted pages, journal-backed re-admission,
radix-affinity routing); this module moves a finished prefill's KV pages
between replica pools:

- :class:`KVChainCodec` — serializes a slot's finished-prefill state (the
  page chain in block-table order, the absolute position, the prompt ids,
  the delivered tokens, the sampling state) into a PTKV1 artifact with a
  crc32 per page and a chain digest, and splices one into a destination
  engine's pool: fresh pages at refcount 1 written IN PLACE (a captured
  CUDA graph holds the pool pointers), the table row mapped, the position
  and last-token carry restored, the prompt chain radix-inserted. A slot or
  pool shortfall raises ``EngineSaturated`` (the router tries elsewhere); a
  crc or digest mismatch raises :class:`KVChainCorrupt` (**PT-SRV-007**)
  before anything touches the engine.
- :class:`TieredRouter` — a :class:`~paddle_tpu_torch.inference.fleet.
  FleetRouter` whose replicas form a PREFILL tier (new submissions) and a
  DECODE tier: after every fleet tick each finished prefill migrates to the
  least-loaded decode replica, which resumes decode at the recorded
  position. Sample keys depend on (seed, position) alone and the spliced
  pages are byte-identical, so the continued stream is byte-identical
  (greedy and seeded) to one engine's.
- Crash safety — the handoff is journaled on both sides: the source
  appends ``migr-kv`` (with the chain digest) before its slot is released,
  so its failover never serves the rid again, and the destination journals
  the admit and the delivered mark after the splice, so ITS failover
  re-runs prefill and verifies the delivered prefix (PT-SRV-005). The order
  is at-most-once: a whole-process crash between the two journal writes
  drops the rid on restart rather than serving it twice.

PTKV1 is a wire format shared with the JAX package, byte for byte::

    b"PTKV1" + <8-hex header length> + <header json> + <page payload>

The header is compact JSON (``separators=(",", ":")``) with the admit
record's keys, then ``v``, ``pos``, ``delivered``, ``page_size``,
``layers``, ``kvh``, ``hd``, ``dtype`` (numpy's name: ``"bfloat16"``),
``n_blocks``, ``n_written``, ``page_crc``, ``kv_scales`` (int8 pools) and
``digest`` (blake2b-16 over the sorted-keys header without the digest,
then the payload). The payload is each layer's k then v pages of the
written prefix. A chain exported by one package imports into the other,
and an import followed at once by a re-export gives the same bytes.

Failure edges:

====================  ===================================================
pool/slot shortfall   ``EngineSaturated`` at import → next decode replica
                      → prefill re-run under resume semantics (never
                      refused)
corrupt in transit    ``KVChainCorrupt`` (PT-SRV-007) → prefill re-run on
                      the decode side, delivered prefix verified
decode replica dies   journal-backed failover (PT-FLT-001): prefill re-run
                      on a survivor, verified, streams on
prefill replica dies  its journal's ``migr-kv`` records keep migrated rids
                      out of the replay set
no decode tier left   candidates decode in place on the prefill tier
====================  ===================================================

Tracing (``tracer=``, through :class:`FleetRouter`): each spliced chain
is one ``migrate`` span on the request's lane (export to splice, with
from/to replica, pages and bytes, tagged with the decode replica) feeding
the ``pt_migration_*`` counters and the ``pt_migration_time_ms``
histogram; a chain refused by a target is a ``migrate_failure`` instant
with reason ``corrupt`` (PT-SRV-007) or ``refused`` (saturated or another
geometry), and a rid no replica can take gets its terminal.
"""

from __future__ import annotations

import hashlib
import json
import time
import zlib
from typing import Callable, List, Optional, Set

import numpy as np
import torch

from ..distributed.resilience.faults import corrupt
from ..ops.paged_attention import (CHAIN_DTYPES, chain_dtype_name,
                                   gather_chain_pages, gather_chain_scales,
                                   scatter_chain_pages)
from .fleet import FleetRouter, ReplicaState, _Replica
from .recovery import _admit_record, _request_from
from .serving import ContinuousBatchingEngine, EngineSaturated, Request

__all__ = ["KVChainCodec", "KVChainCorrupt", "TieredRouter"]


class KVChainCorrupt(RuntimeError):
    """PT-SRV-007: a migrated KV-chain artifact failed its per-page crc32,
    its chain digest, or structural validation — the bytes were damaged in
    transit. The splice is refused with the destination engine untouched;
    the router re-runs prefill on the decode side instead."""


def _byte_view(t: torch.Tensor) -> memoryview:
    """A contiguous CPU tensor's bytes, without a copy."""
    return memoryview(t.contiguous().view(torch.uint8).reshape(-1).numpy())


class KVChainCodec:
    """Serialize / splice a slot's finished-prefill KV state (PTKV1, the
    module docstring). The header carries the full admit record, the
    absolute resume position, the delivered token ids, the pool geometry
    and the chain shape (``n_blocks`` in all, ``n_written`` pages of real
    k/v), a crc32 per written page (over every layer's k and v bytes of
    that page) and the chain digest, which protects header fields
    (delivered tokens, sampling state) exactly like the page bytes.

    ``verify_crc=False`` is a fault drill's control arm only: it splices
    whatever bytes arrive. Never disable it in production.
    """

    MAGIC = b"PTKV1"

    def __init__(self, verify_crc: bool = True):
        self.verify_crc = bool(verify_crc)

    # -- export ------------------------------------------------------------
    def export_chain(self, engine: ContinuousBatchingEngine,
                     rid: int) -> bytes:
        """Serialize ``rid``'s slot state from a prefix-cache engine. The
        slot must be decoding (prefill complete, >= 1 token scheduled); the
        source engine is not disturbed — callers release the slot
        (``withdraw_active``) only after the bytes are out."""
        if engine.prefix_cache is None:
            raise ValueError("KV-chain export needs a prefix-cache engine")
        slot = engine.slot_of(rid)
        if slot is None:
            raise KeyError(f"rid {rid} holds no active slot")
        req = engine._slots[slot]
        engine._drain_pending()
        if req._n_out < 1 or len(req.output) < req._n_out:
            raise RuntimeError(
                f"rid {rid}: export before the first token materialized "
                f"({len(req.output)}/{req._n_out})")
        pos = int(engine._pos[slot])
        page = engine.page_size
        blocks = [int(b) for b in engine._slot_blocks[slot]]
        n_cached = pos - 1                  # tokens already in the cache
        n_written = -(-n_cached // page)
        kv = engine.caches["kv"]
        # the host copy comes after every write queued on the engine's
        # stream (prefill, first token, replays): gather_chain_pages
        pages = gather_chain_pages(kv, blocks[:n_written])
        # int8 pools: the payload is the RAW int8 page bytes; the per-block
        # scales ride the header, protected by the chain digest
        scales = gather_chain_scales(kv, blocks[:n_written])
        kvh, _, hd = pages[0][0].shape[1:]
        page_bytes = int(kvh) * page * int(hd) * pages[0][0].element_size()
        pieces = [_byte_view(t) for pair in pages for t in pair]
        page_crc: List[int] = []
        for j in range(n_written):
            crc = 0
            off = j * page_bytes
            for side in pieces:
                crc = zlib.crc32(side[off:off + page_bytes], crc)
            page_crc.append(crc & 0xFFFFFFFF)
        hdr = dict(_admit_record(req))
        hdr.update(v=1, pos=pos,
                   delivered=[int(t) for t in req.output],
                   page_size=page, layers=len(kv), kvh=int(kvh),
                   hd=int(hd), dtype=chain_dtype_name(pages[0][0].dtype),
                   n_blocks=len(blocks), n_written=n_written,
                   page_crc=page_crc)
        if scales is not None:
            hdr["kv_scales"] = [[s.numpy().astype(np.float32).tolist()
                                 for s in pair] for pair in scales]
        hdr["digest"] = self._digest(hdr, pieces)
        hj = json.dumps(hdr, separators=(",", ":")).encode("utf-8")
        return self.MAGIC + (b"%08x" % len(hj)) + hj + b"".join(pieces)

    @staticmethod
    def _digest(hdr: dict, payload_parts) -> str:
        """blake2b over the canonical (sorted-keys, digest-less) header
        json + the payload bytes: export and verify share it, so the wire
        header's json round trip cannot skew the comparison."""
        probe = {k: v for k, v in hdr.items() if k != "digest"}
        dig = hashlib.blake2b(digest_size=16)
        dig.update(json.dumps(probe, sort_keys=True,
                              separators=(",", ":")).encode("utf-8"))
        for part in payload_parts:
            dig.update(part)
        return dig.hexdigest()

    # -- parsing / verification -------------------------------------------
    def peek(self, artifact: bytes) -> dict:
        """Header only (structural validation, no crc work)."""
        return self._parse(artifact)[0]

    def _parse(self, artifact):
        """Split an artifact into (header dict, payload memoryview)."""
        m = len(self.MAGIC)
        if not isinstance(artifact, (bytes, bytearray, memoryview)):
            raise KVChainCorrupt(
                "PT-SRV-007: not a KV-chain artifact (bad magic)")
        mv = memoryview(artifact)
        if len(mv) < m + 8 or bytes(mv[:m]) != self.MAGIC:
            raise KVChainCorrupt(
                "PT-SRV-007: not a KV-chain artifact (bad magic)")
        try:
            hlen = int(bytes(mv[m:m + 8]), 16)
        except ValueError:
            raise KVChainCorrupt(
                "PT-SRV-007: malformed header length") from None
        if hlen <= 0 or m + 8 + hlen > len(mv):
            raise KVChainCorrupt("PT-SRV-007: header length out of range")
        try:
            hdr = json.loads(bytes(mv[m + 8:m + 8 + hlen]).decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError):
            raise KVChainCorrupt(
                "PT-SRV-007: undecodable artifact header") from None
        payload = mv[m + 8 + hlen:]
        try:
            itemsize = CHAIN_DTYPES[hdr["dtype"]].itemsize
            expect = (hdr["layers"] * 2 * hdr["n_written"] * hdr["kvh"]
                      * hdr["page_size"] * hdr["hd"] * itemsize)
            if not hdr["delivered"] or hdr["n_written"] < 1:
                raise KVChainCorrupt(
                    "PT-SRV-007: artifact carries no finished prefill")
        except (KeyError, TypeError, ValueError):
            raise KVChainCorrupt(
                "PT-SRV-007: artifact header missing chain fields") from None
        if len(payload) != expect:
            raise KVChainCorrupt(
                f"PT-SRV-007: payload is {len(payload)} bytes, header "
                f"promises {expect}")
        return hdr, payload

    def _verify(self, hdr: dict, payload) -> None:
        """Per-page crc32 + chain digest — names the damaged page."""
        itemsize = CHAIN_DTYPES[hdr["dtype"]].itemsize
        page_bytes = hdr["kvh"] * hdr["page_size"] * hdr["hd"] * itemsize
        side_bytes = hdr["n_written"] * page_bytes
        crcs = list(hdr.get("page_crc") or ())
        if len(crcs) != hdr["n_written"]:
            raise KVChainCorrupt(
                "PT-SRV-007: per-page crc table does not cover the chain")
        for j in range(hdr["n_written"]):
            crc = 0
            for layer in range(hdr["layers"]):
                base = layer * 2 * side_bytes
                for side in range(2):
                    off = base + side * side_bytes + j * page_bytes
                    crc = zlib.crc32(payload[off:off + page_bytes], crc)
            if (crc & 0xFFFFFFFF) != crcs[j]:
                raise KVChainCorrupt(
                    f"PT-SRV-007: chain page {j} failed its crc32 — "
                    f"rid={hdr.get('rid')} artifact corrupted in transit")
        if self._digest(hdr, (payload,)) != hdr.get("digest"):
            raise KVChainCorrupt(
                f"PT-SRV-007: chain digest mismatch — rid={hdr.get('rid')} "
                "header (prompt/delivered/sampling state) and pages must "
                "arrive exactly as exported")

    def _unpack(self, hdr: dict, payload, pin: bool = False):
        """The payload as per-layer (k, v) host tensors of the pool dtype,
        views of one writable copy (pinned for a CUDA destination, so the
        upload does not stall the stream)."""
        buf = torch.empty(len(payload), dtype=torch.uint8, pin_memory=pin)
        buf.numpy()[:] = np.frombuffer(payload, np.uint8)
        pages = buf.view(CHAIN_DTYPES[hdr["dtype"]]).reshape(
            hdr["layers"], 2, hdr["n_written"], hdr["kvh"],
            hdr["page_size"], hdr["hd"])
        return [(pages[li, 0], pages[li, 1]) for li in range(hdr["layers"])]

    # -- import ------------------------------------------------------------
    def import_chain(self, engine: ContinuousBatchingEngine,
                     artifact: bytes,
                     req: Optional[Request] = None) -> Request:
        """Splice a chain into ``engine``: verify (unless the drill's
        control arm disabled it), allocate ``n_blocks`` fresh pages
        (LRU-evicting idle cached blocks on a shortfall), write the page
        bytes in place, and resume the request at the recorded position
        through ``admit_migrated``. Raises ``EngineSaturated`` on a slot
        or pool shortfall with the engine untouched,
        :class:`KVChainCorrupt` on damage, ``ValueError`` on another pool
        geometry."""
        hdr, payload = self._parse(artifact)
        if self.verify_crc:
            self._verify(hdr, payload)
        if engine.prefix_cache is None:
            raise ValueError("KV-chain splice needs a prefix-cache engine")
        kv = engine.caches["kv"]
        pool_shape = tuple(int(d) for d in kv[0][0].shape[1:])
        want = (hdr["kvh"], hdr["page_size"], hdr["hd"])
        dtype = chain_dtype_name(kv[0][0].dtype)
        if (engine.page_size != hdr["page_size"] or len(kv) != hdr["layers"]
                or pool_shape != want or dtype != hdr["dtype"]):
            raise ValueError(
                f"destination pool geometry {len(kv)}x{pool_shape} "
                f"({dtype}) cannot hold chain "
                f"{hdr['layers']}x{want} ({hdr['dtype']}) — tiers must "
                "share the serving config")
        if engine._maxp < hdr["n_blocks"]:
            raise ValueError(
                f"chain spans {hdr['n_blocks']} pages but the destination "
                f"table holds {engine._maxp} per slot")
        if not engine._free_slots:
            raise EngineSaturated(
                f"no free slot on splice target for rid={hdr['rid']}")
        scales = None
        if hdr["dtype"] == "int8":
            # validated BEFORE any allocator state moves: a damaged scale
            # table refuses the splice with the engine untouched
            raw = hdr.get("kv_scales")
            if (not isinstance(raw, list) or len(raw) != hdr["layers"]
                    or any(len(pair) != 2 for pair in raw)):
                raise KVChainCorrupt(
                    "PT-SRV-007: int8 chain without a per-layer "
                    "kv_scales table — the block format needs its dequant "
                    "scales to travel with the page bytes")
            scales = [tuple(np.asarray(s, np.float32) for s in pair)
                      for pair in raw]
        blocks = engine._alloc.alloc(hdr["n_blocks"],
                                     evict=engine._radix.evict_lru)
        if blocks is None:
            raise EngineSaturated(
                f"splice pool shortfall for rid={hdr['rid']}: chain needs "
                f"{hdr['n_blocks']} blocks, {engine._alloc.free_blocks} "
                "free after LRU eviction — retry another decode replica")
        try:
            scatter_chain_pages(
                kv, blocks[:hdr["n_written"]],
                self._unpack(hdr, payload,
                             pin=engine.device.type == "cuda"),
                scales=scales)
            if req is None:
                req = _request_from(hdr)
                req.output = [int(t) for t in hdr["delivered"]]
                req._n_out = len(req.output)
            engine.admit_migrated(req, blocks, hdr["pos"],
                                  last_tok=int(hdr["delivered"][-1]))
        except Exception:
            engine._alloc.decref(blocks)
            raise
        return req


class TieredRouter(FleetRouter):
    """Disaggregated prefill/decode tiers over the fleet substrate.

    >>> tiered = TieredRouter(build_prefill, build_decode, fleet_dir,
    ...                       num_prefill=1, num_decode=2)
    >>> tiered.submit(Request(prompt, max_new_tokens=64))
    >>> done = tiered.run_until_done()

    Replicas ``0..num_prefill-1`` form the prefill tier (new submissions
    route only there), the rest the decode tier. After every fleet tick the
    router migrates each finished prefill of the prefill tier to the
    least-loaded compatible decode replica through :class:`KVChainCodec`
    (module docstring for the failure edges). All of
    :class:`FleetRouter`'s machinery — journal-backed failover, progress
    heartbeats, drain and rolling restart, brownout shedding — runs over
    both tiers.
    """

    def __init__(self, build_prefill: Callable[[], ContinuousBatchingEngine],
                 build_decode: Callable[[], ContinuousBatchingEngine],
                 fleet_dir: str, num_prefill: int = 1, num_decode: int = 1,
                 codec: Optional[KVChainCodec] = None, **kw):
        if num_prefill < 1 or num_decode < 1:
            raise ValueError("each tier needs at least one replica")
        self._build_prefill = build_prefill
        self._build_decode = build_decode
        self._num_prefill = int(num_prefill)
        self.codec = codec if codec is not None else KVChainCodec()
        super().__init__(build_prefill, fleet_dir,
                         num_replicas=int(num_prefill) + int(num_decode),
                         **kw)
        # fail at construction, not at the first finished prefill: both
        # sides of the handoff need dynamic block tables over the
        # refcounted pool
        for rep in self.replicas:
            if rep.sup.engine.prefix_cache is None:
                self.close()
                raise ValueError(
                    f"{rep.tier}-tier replica {rep.idx} was built without "
                    "a prefix cache — KV-block migration needs "
                    "prefix_cache engines on both tiers")
        # migration_deferred counts STEPS a ready candidate waited for a
        # compatible decode replica with room; migration_refused counts
        # splice refusals at import (per target tried)
        self.stats.update(migrations=0, migration_s=0.0, migration_pages=0,
                          migration_bytes=0, migration_corrupt=0,
                          migration_deferred=0, migration_refused=0,
                          migration_reprefill=0, migration_hedges=0)
        #: seconds of each migration, newest last, the last 512 (hedges
        #: never fire in-process: no wire, no timeouts)
        self.migration_samples: List[float] = []

    # -- tier membership (fleet.py hooks) ----------------------------------
    def _builder(self, idx: int):
        return (self._build_prefill if idx < self._num_prefill
                else self._build_decode)

    def tier_of(self, idx: int) -> str:
        return "prefill" if idx < self._num_prefill else "decode"

    def _routable(self, req: Request) -> List[_Replica]:
        """New submissions take the prefill tier; with no prefill replica
        alive the decode tier absorbs them (every engine runs the whole
        path: tiers are an optimization, not a capability split)."""
        alive = super()._routable(req)
        pre = [r for r in alive if r.tier == "prefill"]
        return pre or alive

    def _pick_survivor(self, req: Request,
                       exclude: Set[int] = frozenset()) -> Optional[_Replica]:
        """Failover re-runs prefill, so prefill-tier survivors come first;
        once the prefill finishes again the chain migrates as usual."""
        alive = [r for r in self.replicas
                 if r.state == ReplicaState.ALIVE and r.idx not in exclude]
        pool = [r for r in alive if r.tier == "prefill"] or alive
        if not pool:
            return None
        n = len(pool)
        return min(pool, key=lambda r: (r.sup.load(),
                                        (r.idx - req.rid) % n))

    # -- the migration pump ------------------------------------------------
    def step(self) -> None:
        super().step()
        self._migrate_ready()

    def _decode_targets(self, rid: int) -> List[_Replica]:
        alive = [r for r in self.replicas
                 if r.state == ReplicaState.ALIVE and r.tier == "decode"]
        n = max(1, len(alive))
        return sorted(alive, key=lambda r: (r.sup.load(),
                                            (r.idx - rid) % n))

    def _migrate_ready(self) -> None:
        """Migrate every finished prefill off the prefill tier. Runs on the
        thread that steps the router, after the fleet tick (never inside
        ``parallel_step`` threads), so every engine is between steps."""
        for rep in self.replicas:
            if rep.state != ReplicaState.ALIVE or rep.tier != "prefill":
                continue
            for rid in rep.sup.engine.migration_ready():
                user = self.requests.get(rid)
                if (user is None or user.done
                        or rep.sup._live.get(rid) is None):
                    continue
                if rid in rep.sup._verify:
                    # a recovery catch-up twin verifies the delivered mark
                    # here before its chain travels
                    continue
                self._migrate_one(rep, rid, user)

    def _compatible(self, src_engine, dst_engine, user: Request,
                    need: int) -> bool:
        """Pool geometry and capacity, checked BEFORE ownership moves: a
        chain is never retired toward a destination that cannot hold it."""
        if (dst_engine.prefix_cache is None
                or dst_engine.page_size != src_engine.page_size
                or dst_engine._maxp < need
                or len(user.prompt) + user.max_new_tokens
                > dst_engine.max_len):
            return False
        src_kv, dst_kv = src_engine.caches["kv"], dst_engine.caches["kv"]
        if (len(dst_kv) != len(src_kv)
                or dst_kv[0][0].shape[1:] != src_kv[0][0].shape[1:]
                or dst_kv[0][0].dtype != src_kv[0][0].dtype):
            return False
        # free + radix-registered is an optimistic estimate (registered
        # blocks may be pinned by live tables): the import's
        # EngineSaturated arm stays load-bearing
        return bool(dst_engine._free_slots) and (
            dst_engine._alloc.free_blocks
            + len(dst_engine._radix)) >= need

    def _migrate_one(self, src: _Replica, rid: int, user: Request) -> bool:
        # a decode tier that is merely full (or of another geometry) is no
        # failure: the candidate decodes on the prefill tier and retries
        # next step
        need = src.sup.engine._pages_needed(len(user.prompt),
                                            user.max_new_tokens)
        targets = [r for r in self._decode_targets(rid)
                   if self._compatible(src.sup.engine, r.sup.engine, user,
                                       need)]
        if not targets:
            self.stats["migration_deferred"] += 1
            return False
        t0 = time.monotonic()
        t0_tr = None if self.tracer is None else self.tracer.now()
        # flush before surfacing: everything delivered so far is journaled
        # and in the caller's object before the chain travels
        src.sup._sync_progress()
        twin = src.sup._live.get(rid)
        if twin is None or twin.done:
            return False            # finished inside that sync
        art = self.codec.export_chain(src.sup.engine, rid)
        hdr = self.codec.peek(art)
        # in transit: FaultPlan site ``serving.kv_transfer``
        art = corrupt("serving.kv_transfer", f"rid:{rid}", art)
        # ownership leaves the prefill journal BEFORE the splice lands
        # (``migr-kv`` + slot release): a fault on either side now re-runs
        # prefill, from the decode admit or this router's resume fallback
        src.sup.retire_migrated(rid, hdr["digest"])
        placed = None
        corrupt_art = False
        for rep in targets:
            try:
                rep.sup.submit_migrated(user, art, self.codec)
                placed = rep
                break
            except KVChainCorrupt as e:
                # the retry-elsewhere arm of a refusal; in-process the bytes
                # are shared, so later targets refuse them too and the
                # re-prefill fallback below runs
                corrupt_art = True
                self.stats["migration_corrupt"] += 1
                self.events.append(("PT-SRV-007", str(e)))
                if self.tracer is not None:
                    self.tracer.migration_failure(
                        rid, "corrupt", tags={"replica": rep.idx})
                continue
            except (EngineSaturated, ValueError):
                # saturated at import (the pre-check's estimate was
                # optimistic) or a geometry refusal: the bytes are fine,
                # try the next target
                self.stats["migration_refused"] += 1
                if self.tracer is not None:
                    self.tracer.migration_failure(
                        rid, "refused", tags={"replica": rep.idx})
                continue
            except Exception as e:  # noqa: BLE001 — replica death boundary
                # an unexpected splice failure leaves that engine untrusted:
                # mark the replica dead and fail its work over. It must not
                # escape: the rid is already retired from the source
                self._mark_dead(rep, f"splice of rid={rid} raised "
                               f"{type(e).__name__}: {e}")
                self._handle_death(rep)
                if self._assigned.get(rid, src.idx) != src.idx:
                    # the replica had journaled the admit before dying: its
                    # failover already placed the rid
                    return True
                continue
        if placed is None:
            # every decode replica refused (or the bytes are corrupt):
            # re-run prefill under resume semantics on the least-loaded
            # survivor (decode tier first); the delivered prefix is
            # regenerated and verified before anything new streams
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
        self.stats["migration_pages"] += int(hdr["n_written"])
        self.stats["migration_bytes"] += len(art)
        self.events.append(
            ("PT-TIER-001",
             f"rid={rid} chain ({hdr['n_written']} page(s), {len(art)} "
             f"bytes) migrated replica {src.idx} -> {placed.idx} in "
             f"{dt * 1e3:.1f}ms"))
        if self.tracer is not None:
            self.tracer.migrate(rid, src.idx, placed.idx,
                                pages=int(hdr["n_written"]),
                                nbytes=len(art), t0=t0_tr,
                                tags={"replica": placed.idx})
        return True
