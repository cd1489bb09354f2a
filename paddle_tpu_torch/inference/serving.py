"""Continuous-batching serving engine over paged KV caches — port of the
legacy path of ``paddle_tpu/inference/serving.py``.

Design (the JAX engine's legacy programs, run eagerly on the device):
  - ``max_batch`` slots share per-layer page pools sized
    ``max_batch * ceil(max_len / page)`` pages; slot i statically owns
    pages ``[i * maxp, (i + 1) * maxp)`` (``_init_paged_caches``).
  - ADMIT: queued requests prefill their slots in one batched call per
    (prompt bucket, padded?) group. With ``prompt_buckets`` the prompt is
    right-padded to the nearest bucket; the padded chunk fills the cache,
    then the last REAL token is re-stepped at its true position so the
    first sampled token sees exactly the real prompt. Exact-length rows
    take the no-restep path.
  - STEP: a block of ``n`` decode steps advances EVERY slot — a Python loop
    of ``paged_token_step`` calls over all ``max_batch`` rows, per-row
    positions flowing into the paged decode kernel; inactive slots decode
    at position 0 over their own pages and their output is ignored.
    Without eos the schedule is deterministic, so the engine runs toward
    the next completion event (block lengths ``block_size * 2^k``), chains
    the last-token carry on the device and reads tokens back lazily
    (``_drain_pending``): the decode loop makes no host round trip.
    eos-carrying batches pace at ``block_size`` and read each block back.
  - SAMPLE: per-request temperature / top-p / top-k / seed. Each sampled
    row draws with a generator seeded from ``(seed, token position)``, so
    a request's stream is independent of batching and arrival order.
    temperature == 0 is greedy.
  - FINISH: eos or max_new_tokens frees the slot; its pages are reused by
    the next admission.

Greedy token streams equal the JAX engine's on the same weights (fp32, CPU
tests). The prefix cache, the fused mega-step, speculative decode, int8 KV,
the tp mesh, brownout and tracing are later slices: asking for any of them
raises ``NotImplementedError``, and so does a configuration where the JAX
engine would turn the fused mega-step on by itself (``max_batch >= 32``) —
the port never serves a different path than the JAX engine would.
"""

from __future__ import annotations

import collections
import time as _time
import warnings
import weakref
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..models.generation_utils import fold_keys, sample_rows, \
    validate_sampling

__all__ = ["ContinuousBatchingEngine", "EngineSaturated", "Request",
           "RequestShed"]


class EngineSaturated(RuntimeError):
    """add_request refused: the engine's wait queue is at its high-water
    mark (``max_queue``). Callers shed load, retry with backoff, or scale
    out; the engine never hides an unbounded backlog."""


class RequestShed(RuntimeError):
    """add_request refused at SUBMIT time (PT-SRV-003): the request's
    ``deadline_s`` cannot be met at the engine's measured decode
    throughput. Shedding happens before the request touches any engine
    state, so running requests' streams are unchanged."""


class Request:
    """One generation request tracked by the engine.

    ``temperature=0`` (default) is greedy; otherwise temperature + optional
    top-p (nucleus) + top-k filter. ``seed`` (default: the request id) makes
    the request's sample stream reproducible regardless of batching or
    arrival order.

    ``deadline_s`` (measured from enqueue) bounds the request's total life.
    A request past its deadline is evicted at the next engine step:
    ``done=True, failed=True``, ``error`` names the deadline, its slot is
    freed, other slots are untouched. A deadline the engine can already see
    is infeasible at submit time is refused with :class:`RequestShed`.

    ``priority`` orders admission: lower values admit first; FIFO within a
    class. Admitted slots are never preempted.
    """

    PRIORITY_HIGH = 0
    PRIORITY_NORMAL = 1
    PRIORITY_LOW = 2

    _counter = [0]

    def __init__(self, prompt_ids, max_new_tokens: int = 32,
                 eos_token_id: Optional[int] = None,
                 temperature: float = 0.0, top_p: float = 1.0,
                 top_k: int = 0, seed: Optional[int] = None,
                 deadline_s: Optional[float] = None,
                 priority: int = PRIORITY_NORMAL):
        validate_sampling(temperature, top_p, top_k)
        Request._counter[0] += 1
        self.rid = Request._counter[0]
        if isinstance(prompt_ids, torch.Tensor):
            prompt_ids = prompt_ids.detach().cpu().numpy()
        self.prompt = np.asarray(prompt_ids).reshape(-1).astype(np.int32)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        self.top_k = int(top_k)
        self.seed = int(seed if seed is not None else self.rid)
        self.deadline_s = None if deadline_s is None else float(deadline_s)
        self.priority = int(priority)
        self.output: List[int] = []
        self.done = False
        self.failed = False
        self.error: Optional[str] = None
        self._enqueued_at: Optional[float] = None  # set by add_request
        # tokens SCHEDULED so far (device-side results may still be pending
        # materialization — without eos the schedule is deterministic)
        self._n_out = 0
        self._engine = None  # weakref, set by add_request

    @property
    def tokens(self) -> List[int]:
        """Materialized output tokens: drains the engine's pending readbacks
        first, so it is complete once ``done`` is True."""
        eng = self._engine() if self._engine is not None else None
        if eng is not None:
            eng._drain_pending()
        elif len(self.output) < self._n_out:
            raise RuntimeError(
                f"request {self.rid}: {self._n_out - len(self.output)} "
                "scheduled tokens were never materialized and the engine has "
                "been garbage-collected — keep the engine alive (or call its "
                "finished()) before dropping it")
        return self.output


def _later_slice(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: it arrives with the {slice_name} slice "
        "of the port (ROADMAP Queue 1, serving engine); this slice serves "
        "the legacy continuous-batching path only")


class ContinuousBatchingEngine:
    """Legacy continuous batching (module docstring) on ``device`` (default:
    the CUDA device; raises without one unless ``device="cpu"``). The model
    must already live on that device."""

    def __init__(self, model, max_batch: int = 8, max_len: int = 512,
                 page_size: int = 64, block_size: int = 8,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 max_queue: Optional[int] = None,
                 prefix_cache=False,
                 compile_cache_cap: int = 64,
                 shed_infeasible: bool = True,
                 brownout=None,
                 fused: Optional[bool] = None,
                 speculative=None,
                 kv_cache=None,
                 mesh=None,
                 tracer=None,
                 device=None):
        if prefix_cache:
            raise _later_slice("prefix_cache", "prefix-cache")
        if speculative:
            raise _later_slice("speculative decoding", "speculative-decode")
        kv_dtype = getattr(kv_cache, "dtype", kv_cache)
        if kv_dtype == "int8":
            raise _later_slice("kv_cache='int8'", "int8-KV")
        if kv_dtype not in (None, "param"):
            raise ValueError(f"unsupported KV cache dtype {kv_dtype!r}")
        if mesh is not None:
            raise _later_slice("mesh-sharded serving", "tp-sharded serving")
        if brownout:
            raise _later_slice("brownout", "prefix-cache")
        if tracer is not None:
            raise _later_slice("request tracing", "serving observability")
        # the JAX engine turns the fused mega-step on by itself at
        # max_batch >= 32; refusing here keeps the port from silently
        # serving a different path than the reference would
        if (max_batch >= 32) if fused is None else bool(fused):
            raise _later_slice(
                "the fused mega-step (fused=True, or the default at "
                "max_batch >= 32)", "fused mega-step")
        self.device = resolve_device(device)
        p = next(model.parameters())
        if p.device != self.device:
            raise ValueError(f"model lives on {p.device}, engine on "
                             f"{self.device}")
        self.model = model
        self.max_batch = max_batch
        self.max_len = max_len
        self.page_size = page_size
        self.block_size = max(1, int(block_size))
        # bounded-queue backpressure: add_request raises EngineSaturated
        # past this many waiting requests (None = unbounded)
        self.max_queue = None if max_queue is None else max(0, int(max_queue))
        self.prompt_buckets = (sorted(int(b) for b in prompt_buckets)
                               if prompt_buckets else None)
        if self.prompt_buckets and self.prompt_buckets[-1] > max_len:
            raise ValueError(f"prompt bucket {self.prompt_buckets[-1]} "
                             f"exceeds max_len {max_len}")
        # bound on distinct dispatch shapes (prefill groups, decode blocks)
        # — the programs a captured-graph engine compiles one each of;
        # warned past, as the JAX engine warns on its compile cache
        self.compile_cache_cap = max(1, int(compile_cache_cap))
        self._programs: set = set()
        # deadline-feasibility shedding (PT-SRV-003): armed once the engine
        # has measured a decode rate
        self.shed_infeasible = bool(shed_infeasible)
        # EMA of scheduled-tokens/s across engine steps (updated only on
        # steps that scheduled tokens)
        self._ema_tok_s: Optional[float] = None
        self._sched_tokens = 0
        self.caches = model._init_paged_caches(max_batch, max_len, page_size,
                                               device=self.device)
        self._slots: List[Optional[Request]] = [None] * max_batch
        self._occupied: Dict[int, Request] = {}
        self._free_slots: collections.deque = collections.deque(
            range(max_batch))
        # per-slot NEXT write position (== tokens currently in the cache)
        self._pos = np.zeros(max_batch, np.int32)
        # last emitted token per slot, on the device: the decode chain never
        # round-trips token values through the host
        self._last_tok = torch.zeros(max_batch, dtype=torch.long,
                                     device=self.device)
        self._pending: List[tuple] = []
        self._temps = np.zeros(max_batch, np.float32)
        self._tops = np.ones(max_batch, np.float32)
        self._topks = np.zeros(max_batch, np.int32)
        self._seeds = np.zeros(max_batch, np.int64)
        # device copies of the sampling params, re-uploaded only when an
        # admission changes them
        self._samp_dev = None
        self._queue: collections.deque = collections.deque()
        self._finished: Dict[int, Request] = {}
        # deadline-carrying requests in the system: the expiry scan is a
        # single int check when zero
        self._n_deadlined = 0
        # host-side accounting (admission vs decode dispatch time) and work
        # counts: prefill groups dispatched and decode steps run
        self.stats = {"admit_host_s": 0.0, "decode_host_s": 0.0,
                      "compile_cache_entries": 0, "shed": 0,
                      "prefill_groups": 0, "decode_steps": 0}

    # ---- public API ----
    def add_request(self, req: Request) -> int:
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            raise EngineSaturated(
                f"engine queue at high-water mark ({self.max_queue} waiting, "
                f"{len(self._occupied)}/{self.max_batch} "
                "slots busy) — shed load or scale out")
        if len(req.prompt) + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt {len(req.prompt)} + max_new {req.max_new_tokens} "
                f"exceeds engine max_len {self.max_len}")
        if self.prompt_buckets and len(req.prompt) > self.prompt_buckets[-1]:
            raise ValueError(
                f"prompt {len(req.prompt)} exceeds largest prompt bucket "
                f"{self.prompt_buckets[-1]}")
        if len(req.prompt) == 0:
            raise ValueError("empty prompt")
        vocab = self.model.config.vocab_size
        if req.prompt.min() < 0 or req.prompt.max() >= vocab:
            raise ValueError(f"prompt token ids must lie in [0, {vocab})")
        self._shed_check(req)
        req._engine = weakref.ref(self)
        req._enqueued_at = _time.monotonic()
        if req.deadline_s is not None:
            self._n_deadlined += 1
        # lower priority value admits first; FIFO within a class
        q = self._queue
        i = len(q)
        while i > 0 and q[i - 1].priority > req.priority:
            i -= 1
        if i == len(q):
            q.append(req)
        else:
            q.insert(i, req)
        return req.rid

    def _shed_check(self, req: Request):
        """Deadline-feasibility admission control (PT-SRV-003): refuse at
        SUBMIT a request whose deadline cannot be met at the measured decode
        throughput. No measured rate or no deadline means no shedding."""
        if (not self.shed_infeasible or req.deadline_s is None
                or self._ema_tok_s is None or self._ema_tok_s <= 0.0):
            return
        backlog = req.max_new_tokens
        for r in self._queue:
            if r.priority <= req.priority:
                backlog += r.max_new_tokens - r._n_out
        for r in self._occupied.values():
            backlog += max(0, r.max_new_tokens - r._n_out)
        est = backlog / self._ema_tok_s
        if est > req.deadline_s:
            self.stats["shed"] += 1
            raise RequestShed(
                f"PT-SRV-003: request rid={req.rid} shed at submit — "
                f"{backlog} backlog tokens at {self._ema_tok_s:.1f} tok/s "
                f"needs ~{est:.3f}s, past its {req.deadline_s:.3f}s deadline")

    def has_work(self) -> bool:
        return bool(self._queue) or bool(self._occupied)

    def active_slots(self) -> int:
        """Occupied slots."""
        return len(self._occupied)

    def step(self):
        """Advance active slots by one decode block, then admit new
        requests (decode-first, so admission's host work overlaps the
        in-flight block). When all slots are idle, admission runs first."""
        t0 = _time.perf_counter()
        sched0 = self._sched_tokens
        try:
            with torch.no_grad():
                self._step_inner()
        finally:
            dt = _time.perf_counter() - t0
            d = self._sched_tokens - sched0
            if d > 0 and dt > 0:
                rate = d / dt
                self._ema_tok_s = (rate if self._ema_tok_s is None
                                   else 0.7 * self._ema_tok_s + 0.3 * rate)

    def _step_inner(self):
        self._evict_expired()
        if not self._occupied:
            t0 = _time.perf_counter()
            self._admit_legacy()
            self.stats["admit_host_s"] += _time.perf_counter() - t0
            self._decode_block()
            return
        self._decode_block()
        t0 = _time.perf_counter()
        self._admit_legacy()
        self.stats["admit_host_s"] += _time.perf_counter() - t0

    def _evict_expired(self):
        """Deadline enforcement: fail-and-free requests past ``deadline_s``
        (active slots AND queued requests). Tokens already scheduled for an
        evicted slot stay in the pending readbacks."""
        if not self._n_deadlined:
            return
        now = _time.monotonic()

        def expired(r):
            return (r.deadline_s is not None and r._enqueued_at is not None
                    and now - r._enqueued_at > r.deadline_s)

        def fail(r):
            r.done = True
            r.failed = True
            r.error = (f"deadline exceeded: {now - r._enqueued_at:.3f}s > "
                       f"{r.deadline_s:.3f}s ({r._n_out} tokens scheduled)")
            self._mark_done(r)

        for i, req in sorted(self._occupied.items()):
            if expired(req):
                fail(req)
                self._release_slot(i)
        if any(expired(r) for r in self._queue):
            keep = collections.deque()
            for r in self._queue:
                if expired(r):
                    fail(r)
                else:
                    keep.append(r)
            self._queue = keep

    def _decode_block(self):
        t0 = _time.perf_counter()
        try:
            self._decode_block_inner()
        finally:
            self.stats["decode_host_s"] += _time.perf_counter() - t0

    def _decode_block_inner(self):
        live = sorted(self._occupied.items())
        if not live:
            return
        # block length: never decode past a request's max_new_tokens or the
        # engine max_len
        cap = min(min(r.max_new_tokens - r._n_out for _, r in live),
                  min(self.max_len - int(self._pos[i]) for i, _ in live))
        n = min(self.block_size, cap)
        async_ok = all(r.eos_token_id is None for _, r in live)
        if async_ok:
            # run toward the next completion event; lengths block_size * 2^k
            stretch = self.block_size
            while stretch * 2 <= cap:
                stretch *= 2
            n = max(n, cap if cap <= self.block_size else stretch)
        n = max(1, n)
        do_sample = any(r.temperature > 0.0 for _, r in live)
        active = np.zeros(self.max_batch, bool)
        for i, _ in live:
            active[i] = True
        # parked rows decode at position 0 over their own slot's pages
        pos_np = (np.where(active, self._pos, 1) - 1).astype(np.int32)
        out = self._run_decode(pos_np, n, do_sample)
        if async_ok:
            entries = []
            for i, req in live:
                took = min(n, req.max_new_tokens - req._n_out)
                entries.append((i, req, took))
                req._n_out += took
                self._sched_tokens += took
                self._pos[i] += took
                if req._n_out >= req.max_new_tokens:
                    req.done = True
                    self._mark_done(req)
                    self._release_slot(i)
            self._pending.append((out, entries))
            return
        # eos path: materialize (in generation order — older pendings first)
        self._drain_pending()
        out = out.cpu().numpy()
        for i, req in live:
            took = 0
            for j in range(n):
                tok = int(out[i, j])
                req.output.append(tok)
                req._n_out += 1
                took = j + 1
                if ((req.eos_token_id is not None and tok == req.eos_token_id)
                        or req._n_out >= req.max_new_tokens):
                    req.done = True
                    break
            self._pos[i] += took
            self._sched_tokens += took
            if req.done:
                self._mark_done(req)
                self._release_slot(i)

    def _run_decode(self, pos_np, n: int, do_sample: bool):
        """``n`` decode steps over every slot; returns the tokens
        [max_batch, n] on the device and advances the last-token carry."""
        self._note_program(("decode", n, do_sample))
        self.stats["decode_steps"] += n
        if do_sample and self._samp_dev is None:
            self._samp_dev = (self._to_device(self._temps),
                              self._to_device(self._tops),
                              self._to_device(self._topks))
        toks = self._last_tok
        pos = self._to_device(pos_np)
        outs = []
        for j in range(n):
            logits, self.caches = self.model.paged_token_step(
                toks, self.caches, pos)
            if do_sample:
                toks = self._sample(logits, pos_np + j + 1)
            else:
                toks = logits.argmax(-1)
            outs.append(toks)
            pos = pos + 1
        self._last_tok = toks
        return torch.stack(outs, dim=1)

    def _sample(self, logits, positions, slots=None):
        """Sample the next token of each row (greedy rows take the argmax);
        ``positions`` are the sampled tokens' positions, ``slots`` the rows'
        slots (default: every slot)."""
        temps, tops, topks = self._samp_dev
        if slots is not None:
            idx = self._to_device(np.asarray(slots, np.int64))
            temps, tops, topks = temps[idx], tops[idx], topks[idx]
        else:
            slots = range(self.max_batch)
        keys = fold_keys([self._seeds[s] for s in slots], positions)
        keys = [k if self._temps[s] > 0.0 else None
                for k, s in zip(keys, slots)]
        return sample_rows(logits, keys, temps, tops, topks)

    def run_until_done(self, max_steps: int = 100000):
        steps = 0
        while self.has_work() and steps < max_steps:
            self.step()
            steps += 1
        return self.finished()

    def finished(self) -> Dict[int, Request]:
        self._drain_pending()
        out, self._finished = self._finished, {}
        return out

    def _mark_done(self, req: Request):
        """Single chokepoint for request completion."""
        if req.deadline_s is not None:
            self._n_deadlined = max(0, self._n_deadlined - 1)
        self._finished[req.rid] = req

    def _drain_pending(self):
        """Materialize deferred token blocks into request outputs."""
        for arr_dev, entries in self._pending:
            arr = arr_dev.cpu().numpy()
            for row, req, took in entries:
                if arr.ndim == 1:           # prefill firsts [g]
                    req.output.append(int(arr[row]))
                else:                       # decode block [slots, n]
                    req.output.extend(int(t) for t in arr[row, :took])
        self._pending.clear()

    # ---- internals ----
    def _to_device(self, arr):
        """Host array -> device tensor without stalling the stream: CUDA
        copies go through pinned memory, non-blocking."""
        t = torch.from_numpy(np.array(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _note_program(self, key):
        if key in self._programs:
            return
        self._programs.add(key)
        n = self.stats["compile_cache_entries"] = len(self._programs)
        if n > self.compile_cache_cap:
            warnings.warn(
                f"PT-TRACE-001: serving engine dispatches {n} distinct "
                f"program shapes (cap {self.compile_cache_cap}) — pin "
                "prompt_buckets or raise compile_cache_cap", RuntimeWarning,
                stacklevel=3)

    def _release_slot(self, i: int):
        """Free slot ``i``; its pages are reused by the next admission."""
        if self._slots[i] is not None:
            self._occupied.pop(i, None)
            self._free_slots.append(i)
        self._slots[i] = None
        self._pos[i] = 0
        self._temps[i] = 0.0

    def _admit_legacy(self):
        """Admit queued requests into free slots — ONE batched prefill call
        per (prompt bucket, padded?) group."""
        if not self._queue:
            return
        take = []
        while self._free_slots and self._queue:
            take.append((self._free_slots.popleft(), self._queue.popleft()))
        if not take:
            return
        # group by (bucket, padded?): exact-length rows take the no-restep
        # path, so their first token comes from the prefill-chunk logits
        groups: Dict[tuple, list] = {}
        for slot, req in take:
            b = self._bucket(len(req.prompt))
            groups.setdefault((b, len(req.prompt) != b), []).append(
                (slot, req))
        for slot, req in take:
            self._temps[slot] = req.temperature
            self._tops[slot] = req.top_p
            self._topks[slot] = req.top_k
            self._seeds[slot] = req.seed
        self._samp_dev = None   # sampling params changed -> re-upload lazily
        for (padded, _), grp in groups.items():
            firsts_dev = self._prefill_group(padded, grp)
            any_eos = any(r.eos_token_id is not None for _, r in grp)
            firsts = firsts_dev.cpu().numpy() if any_eos else None
            entries = []
            for row, (slot, req) in enumerate(grp):
                self._slots[slot] = req
                self._occupied[slot] = req
                req._n_out += 1
                self._sched_tokens += 1
                self._pos[slot] = len(req.prompt) + 1
                if firsts is not None:
                    req.output.append(int(firsts[row]))
                else:
                    entries.append((row, req, 1))
            for row, (slot, req) in enumerate(grp):
                if ((firsts is not None and req.eos_token_id is not None
                     and int(firsts[row]) == req.eos_token_id)
                        or req._n_out >= req.max_new_tokens):
                    req.done = True
                    self._mark_done(req)
                    self._release_slot(slot)
            if entries:
                self._pending.append((firsts_dev, entries))

    def _bucket(self, n: int) -> int:
        if not self.prompt_buckets:
            return n
        for b in self.prompt_buckets:
            if b >= n:
                return b
        return n  # unreachable: add_request validates against the last bucket

    def _prefill_group(self, padded: int, grp):
        """Prefill a GROUP of slots sharing one padded prompt length; returns
        the first sampled token per slot (on the device) and stores it into
        the last-token carry. Padded rows re-step their last real token at
        its true position, so the first token sees exactly the real
        prompt."""
        slots = [s for s, _ in grp]
        reqs = [r for _, r in grp]
        restep = any(len(r.prompt) != padded for r in reqs)
        do_sample = any(r.temperature > 0.0 for r in reqs)
        self._note_program(("prefill", padded, len(grp), restep, do_sample))
        self.stats["prefill_groups"] += 1
        ids = np.stack([
            np.concatenate([r.prompt,
                            np.zeros(padded - len(r.prompt), np.int32)])
            for r in reqs])
        true_len_np = np.asarray([len(r.prompt) for r in reqs], np.int32)
        ids = self._to_device(ids)
        slots_d = self._to_device(np.asarray(slots, np.int64))
        sub = {"kv": self.caches["kv"], "tables": self.caches["tables"][slots_d]}
        logits, sub = self.model._decode_chunk(ids, sub, 0, None, None)
        if restep:
            # re-step the last REAL token at its true position: identical
            # k/v rewrite, logits over the real prompt only (pad columns
            # beyond true_len are not attended)
            true_len = self._to_device(true_len_np)
            last = ids.gather(1, (true_len.long() - 1)[:, None])[:, 0]
            logits, sub = self.model.paged_token_step(last, sub, true_len - 1)
        if do_sample:
            if self._samp_dev is None:
                self._samp_dev = (self._to_device(self._temps),
                                  self._to_device(self._tops),
                                  self._to_device(self._topks))
            nxt = self._sample(logits, true_len_np, slots)
        else:
            nxt = logits.argmax(-1)
        self._last_tok[slots_d] = nxt
        return nxt
