"""Continuous-batching serving engine over paged KV caches — port of
``paddle_tpu/inference/serving.py`` (the legacy engine, the prefix cache
with chunked prefill, the fused mega-step, speculative decoding, the int8
KV block format and brownout), for dense and MoE Llama models.

Design (the JAX engine's programs, run on the device):
  - ``max_batch`` slots share per-layer page pools sized
    ``max_batch * ceil(max_len / page)`` pages; without a prefix cache slot
    i statically owns pages ``[i * maxp, (i + 1) * maxp)``.
  - ADMIT (legacy): queued requests prefill their slots in one batched call
    per (prompt bucket, padded?) group. With ``prompt_buckets`` the prompt
    is right-padded to the nearest bucket; the padded chunk fills the
    cache, then the last REAL token is re-stepped at its true position so
    the first sampled token sees exactly the real prompt.
  - ADMIT (``prefix_cache=PrefixCacheConfig(...)``): a radix prefix cache
    over a refcounted block pool. A prompt maps the already-filled blocks
    of its longest cached prefix into its table and prefills only the
    uncached suffix, one chunk per step interleaved with the decode batch;
    a full-prompt hit copies its last block (copy-on-write) before the
    first-token re-step. FIFO with head-of-line blocking when the pool
    cannot serve the queue head. Warm and cold admissions of a prompt emit
    the same tokens (greedy and seeded): prefill attention masks by
    absolute position (``ops.paged_prefill_attention``).
  - STEP: a block of ``n`` decode steps advances EVERY slot, per-row
    positions flowing into the paged decode kernel; inactive rows decode
    at position 0 and their output is ignored. Without eos the schedule is
    deterministic, so the engine runs toward the next completion event
    (block lengths ``block_size * 2^k``), chains the last-token carry on
    the device and reads tokens back lazily (``_drain_pending``).
    eos-carrying batches pace at ``block_size`` and read each block back.
  - FUSED (``fused=True``; on by itself at ``max_batch >= 32``, as in the
    JAX engine): block tables, positions, the active mask and the sampling
    parameters live on the device and change only in place, through
    ``_queue_update`` -> ``_flush_updates`` (``index_copy_`` from a fresh
    pinned buffer each flush). One greedy token step over all rows is
    captured once as a CUDA graph (``_capture``) and a block of ``n``
    tokens is ``n`` replays: admission and release never recapture. On the
    CPU the same step runs eagerly; on the card a block with a sampled row
    runs it eagerly too (the sampler seeds a host generator per row).
    Packed prefill (``_run_pack``) advances several (slot, chunk) rows in
    one call.
  - SPEC (``speculative=SpecConfig(k=...)``, fused engines): a block
    whose live rows are all greedy and have room for a K+1 window runs one
    speculative dispatch instead (``_spec_step``): a device-resident
    n-gram drafter proposes K tokens from each row's history ring, the
    window runs through the model's ``paged_verify_step`` and the longest
    draft prefix equal to the verify argmaxes, plus one bonus token, is
    emitted. On the card the step is a second CUDA graph captured beside
    the greedy one; each dispatch reads back only the [B] emit vector.
    Other blocks take the ordinary step.
  - INT8 KV (``kv_cache="int8"`` or ``KVCacheConfig(dtype="int8")``): the
    pools are ``QuantizedKVPool`` (int8 pages, one absmax scale per (page,
    kv head)), quantized on append and dequantized on read; the decode
    kernel K4 dequantizes inside its loop. Freshly allocated blocks are
    cleared of their previous scales (``_reset_quant_blocks``), so
    recycled pages never shape a new request's quantization. Streams are
    deterministic, and may differ from an fp engine's (int8 is lossy).
  - SAMPLE: per-request temperature / top-p / top-k / seed. Each sampled
    row draws with a generator seeded from ``(seed, token position)``, so
    a request's stream is independent of batching and arrival order.
    temperature == 0 is greedy.
  - FINISH: eos or max_new_tokens frees the slot; with a prefix cache its
    blocks are decref'd (a block another table or the radix cache still
    references is never freed).
  - BROWNOUT (``brownout=True`` or ``BrownoutConfig(...)``; with a prefix
    cache only): after ``enter_after`` consecutive steps that deferred an
    admission, idle cached blocks are flushed, admission stops matching
    and registering prefix chains and chunked prefill runs each prompt
    whole in its first tick; it exits after ``exit_after`` pressure-free
    steps with ``exit_free_frac`` of the pool free (``_brownout_tick``).
    Host bookkeeping only: a fused engine's graph is never recaptured.
  - FAULT SITES (``distributed.resilience.faults``): ``serving.stall``,
    ``serving.step`` and ``device.loss`` at the top of every ``step()``
    (detail ``step:<n>``), ``serving.block_pool`` before each prefix-cache
    admission's allocation (detail ``rid:<id>``), in the JAX engine's
    order, so one plan fires at the same events in both packages. The
    crash-recovery supervisor and the fleet router sit above
    (``inference/recovery.py``, ``inference/fleet.py``).
  - MIGRATION (prefix-cache engines; ``inference/disagg.py``):
    ``migration_ready`` lists slots whose prefill is complete,
    ``withdraw_active`` releases one without terminal bookkeeping once its
    chain was exported, and ``admit_migrated`` resumes a spliced chain at
    its position (table row, sampling state, last-token carry in place,
    the drafter ring re-seeded from prompt + delivered tokens).
  - MoE (``num_experts > 1``): every hook runs the model's MoE layer at
    the step's rows (decode: one token a slot; prefill: the chunk or the
    pack), under any of its dispatches. ``pgmm`` pads the (token, choice)
    rows into 512-row expert tiles for K5 (8 experts: 4608 rows for any
    decode step of up to 512 choices); the fused step captures K5 with the
    rest, and each replay moves ``ops.pgmm.launches`` by the launches it
    replays, as it moves K4's.

Greedy token streams equal the JAX engine's of the same kind on the same
weights (fp32, CPU tests), with and without the prefix cache and the
fused step, with speculative decoding, with int8 pools, with brownout and
on MoE models. Under the capacity dispatches (``einsum``, ``scatter``,
``auto``) a token's dropped choices depend on the other rows of its step,
so streams differ between engine kinds and slot counts, in the JAX engine
as in the port; the dropless ``pgmm`` and ``ragged`` keep fused == legacy
and warm == cold. The tp mesh is a later slice: asking for it raises
``NotImplementedError``.

TRACING (``tracer=``, a ``paddle_tpu_torch.observability.TraceRecorder``;
``trace_tags`` ride every stamp): the stamp sites are the JAX engine's
(submit/shed at ``add_request``, admit, prefill chunks and groups, first
tokens, one ``decode_block`` span per block with every row's token
progress under one recorder lock, finish/evict at ``_mark_done``). They
are host-side only: the decode span is taken around the launch or the
graph replays, before any readback, and no stamp synchronizes the device
or sits inside ``_fused_step`` / ``_spec_step`` (the captured steps).
``engine.tracer`` is read at every stamp, so a recorder attached or
swapped after construction (the supervisor's ``_attach_tracer``) needs no
recapture.

Speculative == non-speculative greedy streams. The JAX package pins them
byte-identical; in the port it holds where both paths compute the same
logits. On the CPU in fp32 they share the gather math, and the streams are
equal byte for byte (tests). On the card the two differ: a decode step
runs K4, the verify step the plain prefill gather, and the verify
matrix products run at M = B * (K+1) rows against B. In fp32 the streams
are still required to be equal (a card test at a small model). In bf16 the
logits differ in their last bits and near-ties can flip a token: the
contract there is the teacher-forced check (every emitted token within a
margin of its position's maximum logit), and the count of streams that
differ is reported beside the card's name (``chip_smoke.py``).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import threading
import time as _time
import warnings
import weakref
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .._later import later_slice
from ..device import resolve_device
from ..distributed.resilience.faults import (device_loss, maybe_inject,
                                             resource_hold)
from ..distributed.resilience.retry import retry_stats
from ..models.generation_utils import fold_keys, sample_rows, \
    validate_sampling
from ..ops.grouped_matmul import pgmm, pgmm_dw
from ..ops.paged_attention import (BlockAllocator, RadixPrefixCache,
                                   copy_pages, paged_decode_attention)

__all__ = ["BlockAllocator", "BrownoutConfig", "ContinuousBatchingEngine",
           "EngineSaturated", "KVCacheConfig", "MeshDegraded",
           "PrefixCacheConfig", "RadixPrefixCache", "Request", "RequestShed",
           "SpecConfig", "ngram_draft", "spec_accept"]


def __getattr__(name):
    # the SLO-pressure autoscaler (autoscale.py), re-exported lazily as the
    # JAX serving module does: importing serving must not pull the control
    # loop in
    if name in ("SLOAutoscaler", "AutoscaleConfig"):
        from . import autoscale

        return getattr(autoscale, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class MeshDegraded(RuntimeError):
    """PT-SRV-008: the engine's tp device group lost devices mid-serve.
    Carries ``lost`` (devices gone) and ``survivors`` (devices still
    usable). The port serves on one device (tp-sharded serving is a later
    slice), so nothing raises it yet; the supervisor catches it as the JAX
    package's does."""

    def __init__(self, msg: str, lost: int = 0, survivors: int = 1):
        super().__init__(msg)
        self.lost = int(lost)
        self.survivors = max(0, int(survivors))


class EngineSaturated(RuntimeError):
    """add_request refused: the engine's wait queue is at its high-water
    mark (``max_queue``). Callers shed load, retry with backoff, or scale
    out; the engine never hides an unbounded backlog."""


class RequestShed(RuntimeError):
    """add_request refused at SUBMIT time (PT-SRV-003): the request's
    ``deadline_s`` cannot be met at the engine's measured decode
    throughput. Shedding happens before the request touches any engine
    state, so running requests' streams are unchanged."""


@dataclasses.dataclass
class PrefixCacheConfig:
    """Knobs for the paged-KV prefix cache and chunked prefill
    (``ContinuousBatchingEngine(prefix_cache=...)``).

    - ``prefill_chunk``: tokens prefilled per engine step per admitted slot
      (rounded up to a page multiple; default ``min(max_len, 8 * page)``).
    - ``extra_blocks``: pool headroom beyond the ``max_batch *
      pages_per_seq`` working set, kept for cached prefixes.
    - ``pack_rows``: fused-mode packing budget, the most (slot, chunk) rows
      a packed prefill call carries (default ``max(8, min(max_batch,
      32))``; a pack always covers one chunk of every mid-prefill slot)."""

    prefill_chunk: Optional[int] = None
    extra_blocks: int = 0
    pack_rows: Optional[int] = None


@dataclasses.dataclass
class SpecConfig:
    """Knobs for speculative multi-token decoding in the fused engine
    (``ContinuousBatchingEngine(speculative=...)``).

    - ``k``: draft tokens proposed and verified per dispatch; a dispatch
      emits 1 to k + 1 tokens a row (the accepted draft prefix plus one
      bonus token from the verify logits).
    - ``ngram``: match length of the device-resident prompt-lookup
      drafter: the row's last ``ngram`` tokens are searched in its history
      ring, and the tokens after the most recent match become the draft.
    - ``history``: per-slot ring length (tokens) the drafter searches,
      seeded from the prompt at activation.
    - ``_unsafe_accept_all``: test-only: skip the argmax verification and
      trust every draft, which shows the silent greedy divergence the
      verify exists to prevent. Never enable.

    Greedy output equals the non-speculative step's as far as the two
    paths compute the same logits: drafts change how many tokens a
    dispatch emits, never which (see the engine's docstring for where the
    two paths' bf16 logits differ on the card). Blocks with a sampled row
    keep the ordinary step. With ``KVCacheConfig(dtype="int8")`` rejected
    drafts' appends feed the blocks' monotone scales, so spec+int8 streams
    may differ from non-spec int8 streams in the last quantization bit;
    identical spec+int8 engines and warm re-admissions still reproduce the
    same bytes."""

    k: int = 4
    ngram: int = 2
    history: int = 64
    _unsafe_accept_all: bool = False


@dataclasses.dataclass
class KVCacheConfig:
    """Paged-KV pool storage format (``ContinuousBatchingEngine(
    kv_cache=...)``). ``dtype="int8"`` switches every pool to the int8
    block format (``ops.paged_attention.QuantizedKVPool``: int8 pages with
    one absmax scale per (page, kv head), quantize-on-append,
    dequantize-on-read): pool bytes drop to about half of bf16's. Composes
    with copy-on-write (the scales copy with the page) and the radix
    prefix cache."""

    dtype: Optional[str] = None

    def __post_init__(self):
        if self.dtype not in (None, "param", "int8"):
            raise ValueError(f"unsupported KV cache dtype {self.dtype!r} "
                             "(supported: None/'param', 'int8')")


@dataclasses.dataclass
class BrownoutConfig:
    """Hysteretic degraded mode under sustained KV-pool pressure
    (``ContinuousBatchingEngine(brownout=...)``; the JAX package's
    ``BrownoutConfig``).

    After ``enter_after`` consecutive steps with a deferred admission (the
    pool could not serve the queue head even after LRU eviction) the engine
    enters brownout: idle cached blocks are flushed back to the pool,
    prefix-cache admission stops matching and registering chains, and
    chunked prefill collapses to whole-prompt prefill, the cache-off
    serving behaviour (warm == cold, so the streams do not change, only
    the memory and throughput shape). Brownout exits only after
    ``exit_after`` consecutive pressure-free steps with at least
    ``exit_free_frac`` of the pool free: hysteresis, so a workload at the
    edge does not flap the cache on and off."""

    enter_after: int = 2
    exit_free_frac: float = 0.5
    exit_after: int = 4


def ngram_draft(hist, hlen, last_tok, k: int, n: int):
    """Device-resident prompt-lookup drafter (no draft model, no host
    read): ``k`` draft tokens per row from its history ring.

    ``hist`` [B, H] ring of emitted tokens (global index g at slot g % H),
    ``hlen`` [B] tokens written so far, ``last_tok`` [B] the newest token
    (not yet in the ring: the sequence is ``hist-window ++ last_tok``). The
    row's last ``n`` tokens are matched against every earlier window; the
    ``k`` tokens after the MOST RECENT match are the draft. No match (or
    under ``n`` tokens of history) repeats ``last_tok``: drafts change how
    many tokens a dispatch emits, never which. Fixed shapes and no host
    read, so a CUDA graph can capture it. Returns [B, k] in
    ``last_tok``'s dtype."""
    H = hist.shape[1]
    dev = hist.device
    last_tok = last_tok.to(hist.dtype)
    g = hlen.long()[:, None] - H + torch.arange(H, device=dev)[None, :]
    # torch.remainder takes the divisor's sign, as jnp.mod does (fmod
    # would not)
    lin = hist.gather(1, torch.remainder(g, H))
    lin = torch.cat([lin, last_tok[:, None]], dim=1)          # [B, H + 1]
    L = H + 1
    tail = lin[:, L - n:]                                     # the n-gram
    J = L - n                                                 # starts
    win_idx = (torch.arange(J, device=dev)[:, None]
               + torch.arange(n, device=dev)[None, :])
    wins = lin[:, win_idx]                                    # [B, J, n]
    match = (wins == tail[:, None, :]).all(dim=-1)            # [B, J]
    valid = (g >= 0)[:, :J]
    jv = torch.where(match & valid, torch.arange(J, device=dev)[None, :],
                     -1)
    jbest = jv.amax(dim=1)
    has = (jbest >= 0) & (hlen >= n)
    cont = (jbest[:, None] + n
            + torch.arange(k, device=dev)[None, :]).clamp(0, L - 1)
    drafts = lin.gather(1, cont)
    return torch.where(has[:, None], drafts, last_tok[:, None])


def spec_accept(drafts, targets, caps):
    """Accept/reject of greedy speculative decoding, on the device.

    ``drafts`` [B, K] proposed tokens, ``targets`` [B, K+1] the argmax
    token after each verify-window position (draft i is right iff it
    equals ``targets[:, i]`` and every earlier draft was right), ``caps``
    [B] >= 0 the per-row emission budget (0 masks a row). Returns ``(out
    [B, K+1], emit [B], n_acc [B])``: the emitted tokens are
    ``out[:, :emit]``, the accepted drafts plus ONE bonus token (the
    model's own next token after the last accepted one)."""
    K = drafts.shape[1]
    match = drafts == targets[:, :K]
    n_acc = torch.cumprod(match.long(), dim=1).sum(dim=1)     # [B] 0..K
    emit = torch.minimum(n_acc + 1, caps.long().clamp_min(0))
    bonus = targets.gather(1, n_acc[:, None])
    padded = torch.cat([drafts, bonus], dim=1)                # [B, K+1]
    keep = (torch.arange(K + 1, device=drafts.device)[None, :]
            < n_acc[:, None])
    return torch.where(keep, padded, bonus), emit, n_acc


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

    ``tenant`` is a workload tag that the journal carries across recovery
    and failover; the engine's trace stamps carry it, and the SLO monitor
    splits attainment by it.
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
                 priority: int = PRIORITY_NORMAL,
                 tenant: Optional[str] = None):
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
        self.tenant = None if tenant is None else str(tenant)
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


def _kernel_counts():
    """The launch counters a captured step can move: K4 (any pool), K4 on
    int8 pools, K5, K6."""
    return (paged_decode_attention.launches,
            paged_decode_attention.int8_launches, pgmm.launches,
            pgmm_dw.launches)


def _set_counts(counts):
    (paged_decode_attention.launches, paged_decode_attention.int8_launches,
     pgmm.launches, pgmm_dw.launches) = counts


def _add_counts(delta, times: int = 1):
    """Credit the kernels with ``times`` replays of a graph that captured
    ``delta`` launches."""
    _set_counts(tuple(c + times * d
                      for c, d in zip(_kernel_counts(), delta)))


# Engines of one process share its device. Their device work (construction
# with the graph capture, steps, readbacks) runs one engine at a time, so
# a capture never sees another thread's CUDA call (the default "global"
# capture mode refuses those) and the launch counters stay exact when a
# FleetRouter steps replicas in threads (parallel_step=True).
_DEVICE_LOCK = threading.RLock()


def _serialized(fn):
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with _DEVICE_LOCK:
            return fn(*args, **kwargs)
    return run


# One warm-up stream per device for every capture: cuBLAS keeps a workspace
# for each (handle, stream) it has run on for the life of the process, so a
# fresh stream per engine held 32 MiB more device memory per rebuilt engine
# (H100, chip_smoke.py phase 23).
_CAPTURE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _capture_stream(device):
    if device not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[device]


class ContinuousBatchingEngine:
    """Continuous batching (module docstring) on ``device`` (default: the
    CUDA device; raises without one unless ``device="cpu"``). The model
    must already live on that device.

    ``speculative=SpecConfig(k=4)`` (needs ``fused=True``) and
    ``kv_cache="int8"`` compose with each other and with the prefix cache;
    ``brownout=True`` (or a ``BrownoutConfig``) acts only with a prefix
    cache.
    Speculative greedy streams equal the non-speculative engine's byte for
    byte on the CPU and on the card in fp32; in bf16 on the card they may
    differ at near-ties of the last logit bits (module docstring)."""

    @_serialized
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
                 trace_tags: Optional[Dict] = None,
                 device=None,
                 _unsafe_overcommit: bool = False):
        if mesh is not None:
            raise later_slice("mesh-sharded serving", "tp-sharded serving",
                              "7")
        # per-request trace spans: every stamp site is host-side, behind
        # one `is not None` check; assignable after construction (the
        # supervisor attaches one to factory-built engines)
        self.tracer = tracer
        self.trace_tags = dict(trace_tags or {})
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
        if prefix_cache is True:
            prefix_cache = PrefixCacheConfig()
        elif not prefix_cache:
            prefix_cache = None
        self.prefix_cache = prefix_cache
        if brownout is True:
            brownout = BrownoutConfig()
        elif not brownout:
            brownout = None
        # brownout acts on the prefix cache: without one it is off
        self._brownout_cfg = brownout if prefix_cache is not None else None
        self._brownout_active = False
        self._pressure_steps = self._clear_steps = 0
        # set by a step whose admission deferred the queue head
        self._deferred_step = False
        # the JAX engine's default: the fused mega-step at big batch
        self._fused = (max_batch >= 32) if fused is None else bool(fused)
        # speculative decoding: a device-resident n-gram drafter and one
        # K+1-wide verify step per dispatch, over the fused engine's state
        if speculative is True:
            speculative = SpecConfig()
        elif not speculative:
            speculative = None
        self._spec = speculative
        if speculative is not None:
            if not self._fused:
                raise ValueError(
                    "speculative decoding needs the fused mega-step "
                    "(fused=True): the drafter and verify state live on the "
                    "device")
            if speculative.k < 1 or speculative.ngram < 1:
                raise ValueError("SpecConfig.k and .ngram must be >= 1")
            if speculative.history < speculative.ngram + speculative.k:
                raise ValueError(
                    f"SpecConfig.history {speculative.history} too short for "
                    f"ngram {speculative.ngram} + k {speculative.k}")
        # the int8 paged-KV block format (QuantizedKVPool pools)
        if isinstance(kv_cache, str):
            kv_cache = KVCacheConfig(dtype=kv_cache)
        elif kv_cache is None:
            kv_cache = KVCacheConfig()
        self._kv_dtype = "int8" if kv_cache.dtype == "int8" else None
        # bound on distinct dispatch shapes (prefill groups, chunk widths,
        # decode blocks), warned past, as the JAX engine warns on its
        # compile cache
        self.compile_cache_cap = max(1, int(compile_cache_cap))
        self._programs: set = set()
        # deadline-feasibility shedding (PT-SRV-003): armed once the engine
        # has measured a decode rate
        self.shed_infeasible = bool(shed_infeasible)
        # EMA of scheduled-tokens/s across engine steps (updated only on
        # steps that scheduled tokens)
        self._ema_tok_s: Optional[float] = None
        self._sched_tokens = 0
        self._maxp = -(-max_len // page_size)
        # On the card every prefill, first-token and re-step call carries a
        # fixed row count: cuBLAS picks its kernel (and with it the order of
        # a row's sums) by the row count, so a prompt's k/v and first token
        # would depend on the requests admitted beside it, and a crash
        # replay, which re-admits them in other groups, would diverge
        # (PERF.md §6). Decode steps already run every slot. The CPU
        # keeps the JAX engine's power-of-two buckets (its sums do not
        # depend on the row count).
        self._fixed_rows = self.device.type == "cuda"
        # test-only knob: allocate past pool capacity by taking blocks out
        # of the radix cache while live tables still map them — the
        # corruption the refcounted path exists to prevent. Never enable.
        self._overcommit = bool(_unsafe_overcommit)
        if prefix_cache is not None:
            c = prefix_cache.prefill_chunk or min(max_len, 8 * page_size)
            self._chunk_tokens = -(-int(c) // page_size) * page_size
            n_blocks = (max_batch * self._maxp
                        + max(0, int(prefix_cache.extra_blocks)))
            # +1 page: parked decode rows (free or still-prefilling slots)
            # write their dummy token into a parking page, never into a
            # block another request may share
            self.caches = model._init_paged_caches(
                max_batch, max_len, page_size, num_blocks=n_blocks + 1,
                kv_dtype=self._kv_dtype, device=self.device)
            self._park = n_blocks
            self._alloc = BlockAllocator(n_blocks)
            self._radix = RadixPrefixCache(page_size, self._alloc)
            if not self._fused:
                # legacy engines upload this table when it changed
                self._tables_host = np.full((max_batch, self._maxp),
                                            self._park, np.int32)
                self._tables_dirty = True
            self._slot_rows: List[Optional[np.ndarray]] = [None] * max_batch
            self._slot_blocks: List[Optional[List[int]]] = [None] * max_batch
            # slot -> next uncached prompt position (mid-prefill slots)
            self._prefill_next: Dict[int, int] = {}
            self._pack_rows = (max(8, min(max_batch, 32))
                               if prefix_cache.pack_rows is None
                               else max(1, int(prefix_cache.pack_rows)))
        else:
            self.caches = model._init_paged_caches(max_batch, max_len,
                                                   page_size,
                                                   kv_dtype=self._kv_dtype,
                                                   device=self.device)
        self._slots: List[Optional[Request]] = [None] * max_batch
        self._occupied: Dict[int, Request] = {}
        self._free_slots: collections.deque = collections.deque(
            range(max_batch))
        # per-slot NEXT write position (== tokens in the cache + 1 once the
        # first token is out: the carry token is written at pos - 1)
        self._pos = np.zeros(max_batch, np.int32)
        # last emitted token per slot, on the device: the decode chain never
        # round-trips token values through the host. The fused engine
        # updates it only in place (its captured graph reads it).
        self._last_tok = torch.zeros(max_batch, dtype=torch.long,
                                     device=self.device)
        self._pending: List[tuple] = []
        self._temps = np.zeros(max_batch, np.float32)
        self._tops = np.ones(max_batch, np.float32)
        self._topks = np.zeros(max_batch, np.int32)
        self._seeds = np.zeros(max_batch, np.int64)
        self._graph = None
        self._spec_graph = None
        # kernel launches one replay of each graph runs (_kernel_counts)
        self._graph_counts = self._spec_graph_counts = (0, 0, 0, 0)
        if self._fused:
            # device-resident step state, changed only in place by
            # _flush_updates: positions, active mask, sampling params (and,
            # with a prefix cache, the block table, all parked at first)
            dev = self.device
            self._dev_pos = torch.zeros(max_batch, dtype=torch.int32,
                                        device=dev)
            self._dev_act = torch.zeros(max_batch, dtype=torch.bool,
                                        device=dev)
            self._dev_samp = (torch.zeros(max_batch, dtype=torch.float32,
                                          device=dev),
                              torch.ones(max_batch, dtype=torch.float32,
                                         device=dev),
                              torch.zeros(max_batch, dtype=torch.int32,
                                          device=dev))
            self._upd: Dict[int, tuple] = {}
            if prefix_cache is not None:
                self.caches["tables"] = torch.full(
                    (max_batch, self._maxp), self._park, dtype=torch.int32,
                    device=dev)
            # the step's token output [max_batch, max_len] and the in-graph
            # step index it writes at
            self._out = torch.zeros((max_batch, max_len), dtype=torch.long,
                                    device=dev)
            self._step_i = torch.zeros(1, dtype=torch.long, device=dev)
            if self._spec is not None:
                # drafter state: per-slot history ring with one spare
                # column (index ``history``), where the spec step sends the
                # ring writes of tokens it does not emit, and the written
                # count; the emission caps, filled in place before each
                # dispatch; and the step's outputs
                K, H = self._spec.k, self._spec.history
                self._dev_hist = torch.zeros((max_batch, H + 1),
                                             dtype=torch.long, device=dev)
                self._dev_hlen = torch.zeros(max_batch, dtype=torch.long,
                                             device=dev)
                self._dev_caps = torch.zeros(max_batch, dtype=torch.int32,
                                             device=dev)
                self._spec_out = torch.zeros((max_batch, K + 1),
                                             dtype=torch.long, device=dev)
                self._spec_emit = torch.zeros(max_batch, dtype=torch.long,
                                              device=dev)
        self._queue: collections.deque = collections.deque()
        self._finished: Dict[int, Request] = {}
        # deadline-carrying requests in the system: the expiry scan is a
        # single int check when zero
        self._n_deadlined = 0
        # engine steps so far: the detail of the step fault sites
        self._step_idx = 0
        # host-side accounting (admission vs decode dispatch time) and work
        # counts. decode_steps == graph_replays + eager_decode_steps, and
        # spec_steps == spec_graph_replays + eager_spec_steps.
        self.stats = {"admit_host_s": 0.0, "decode_host_s": 0.0,
                      "compile_cache_entries": 0, "shed": 0,
                      # the retry_call registry's attempts and give-ups,
                      # copied in at finished()
                      "retry_attempts": 0, "retry_giveups": 0,
                      "prefill_groups": 0, "decode_steps": 0,
                      "fused_updates": 0, "graph_captures": 0,
                      "graph_replays": 0, "eager_decode_steps": 0,
                      "spec_proposed": 0, "spec_accepted": 0,
                      "spec_steps": 0, "spec_graph_captures": 0,
                      "spec_graph_replays": 0, "eager_spec_steps": 0}
        # pool pages held in the int8 block format (0 on fp engines)
        self._kv_quant_blocks = (int(self.caches["kv"][0][0].shape[0])
                                 if self._kv_dtype == "int8" else 0)
        if prefix_cache is not None:
            self.stats.update(hit_tokens=0, miss_tokens=0, cow_copies=0,
                              evictions=0, prefill_host_s=0.0,
                              brownouts=0, brownout_steps=0, packed_rows=0)
        if self._fused and self.device.type == "cuda":
            self._capture()

    def _req_tags(self, req: Request) -> Dict:
        """Stamp tags of the per-request sites (submit / shed / admit): the
        engine's tags plus the request's workload tenant, so SLO attainment
        and the queue-wait events split per tenant."""
        if req.tenant is None:
            return self.trace_tags
        tags = dict(self.trace_tags)
        tags["tenant"] = req.tenant
        return tags

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
        # the family's own length limit (GPT's learned position table), the
        # check generate() applies (JAX serving.py:864-867)
        validate = getattr(self.model, "_validate_generate", None)
        if validate is not None:
            validate(len(req.prompt), len(req.prompt) + req.max_new_tokens)
        if self.tracer is not None:
            # stamp AFTER the caller-error validations (a refused request
            # never entered the system) but BEFORE the shed check (a shed
            # is a real terminal outcome of a real submission)
            self.tracer.submit(req.rid, len(req.prompt), req.max_new_tokens,
                               self._req_tags(req))
            try:
                self._shed_check(req)
            except RequestShed:
                self.tracer.shed(req.rid, self._req_tags(req))
                raise
        else:
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
        """Occupied slots (decoding and mid-prefill)."""
        return len(self._occupied)

    @_serialized
    def step(self):
        """Advance active slots by one decode block, then admit new
        requests (decode-first, so admission's host work overlaps the
        in-flight block). When all slots are idle, admission runs first.
        With a prefix cache every mid-prefill slot also advances one chunk
        and newly complete prompts take their first token.

        Fault sites, before any work of the step (one global read each
        when no plan is installed): ``serving.stall`` sleeps the step past
        its wall-clock budget (StepWatchdog / PT-SRV-002), ``serving.step``
        kills the engine mid-wave (ServingSupervisor rebuild-from-journal /
        PT-SRV-001), ``device.loss`` removes devices from a tp mesh; the
        port serves unsharded, so a loss is ignored, as the JAX engine
        ignores it without a mesh."""
        self._step_idx += 1
        maybe_inject("serving.stall", f"step:{self._step_idx}")
        maybe_inject("serving.step", f"step:{self._step_idx}")
        device_loss(f"step:{self._step_idx}")
        t0 = _time.perf_counter()
        sched0 = self._sched_tokens
        self._deferred_step = False
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
            if self._brownout_cfg is not None:
                self._brownout_tick()

    def _brownout_tick(self):
        """The hysteretic brownout state machine, once a step (:1001-1031):
        sustained admission deferrals enter the degraded mode (idle cached
        blocks flushed; matching, registration and chunked prefill off); a
        sustained pressure-free streak with real pool headroom exits it."""
        cfg = self._brownout_cfg
        if self._brownout_active:
            self.stats["brownout_steps"] += 1
            free_frac = self._alloc.free_blocks / max(1, self._alloc.num_blocks)
            if not self._deferred_step and free_frac >= cfg.exit_free_frac:
                self._clear_steps += 1
                if self._clear_steps >= cfg.exit_after:
                    self._brownout_active = False
                    self._pressure_steps = self._clear_steps = 0
            else:
                self._clear_steps = 0
            return
        if self._deferred_step:
            self._pressure_steps += 1
            if self._pressure_steps >= cfg.enter_after:
                self._brownout_active = True
                self._clear_steps = 0
                self.stats["brownouts"] += 1
                # under pressure the working set outranks reuse: reclaimed
                # pages go straight back to the pool the deferred head
                # waits on
                self._radix.evict_lru(self._alloc.num_blocks)
                self.stats["evictions"] = self._radix.evictions
        else:
            self._pressure_steps = 0

    def _step_inner(self):
        self._evict_expired()
        if self.prefix_cache is not None:
            decoding = len(self._occupied) > len(self._prefill_next)
            if decoding:
                self._decode_block()
            t0 = _time.perf_counter()
            self._admit_prefix()
            self._prefill_tick()
            self.stats["admit_host_s"] += _time.perf_counter() - t0
            if not decoding:
                self._decode_block()
            return
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
        (active and mid-prefill slots, and queued requests). Tokens already
        scheduled for an evicted slot stay in the pending readbacks."""
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
                # prefix mode: decrefs (never frees) blocks other tables or
                # the radix cache still reference
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
        if self._fused:
            # every admission and release queued since the last block lands
            # in the device state in place
            self._flush_updates()
        elif self.prefix_cache is not None and self._tables_dirty:
            # decode-ready rows map their (possibly shared) pages; free and
            # mid-prefill rows point at the parking page. _to_device copies
            # the host table, which later releases mutate.
            self.caches = {"kv": self.caches["kv"],
                           "tables": self._to_device(self._tables_host)}
            self._tables_dirty = False
        live = [(i, r) for i, r in sorted(self._occupied.items())
                if not (self.prefix_cache is not None
                        and i in self._prefill_next)]
        if not live:
            return
        if (self._spec is not None
                and not any(r.temperature > 0.0 for _, r in live)
                and all(self.max_len - int(self._pos[i]) >= self._spec.k
                        for i, _ in live)):
            # an all-greedy block with room for the K+1 window on every row
            # (it writes k/v at positions pos-1 .. pos-1+K): one speculative
            # dispatch. Sampled rows and rows near max_len take the
            # ordinary step.
            return self._decode_spec_block(live)
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
        # parked rows decode at position 0 (their own slot's pages, or the
        # parking page with a prefix cache)
        pos_np = (np.where(active, self._pos, 1) - 1).astype(np.int32)
        # the block's span covers the host work that queued it (launches or
        # graph replays), read before any readback: no stamp synchronizes
        tracer = self.tracer
        t0_tr = None if tracer is None else tracer.now()
        if self._fused:
            out = self._run_fused(pos_np, n, do_sample)
        else:
            out = self._run_decode(pos_np, n, do_sample)
        t1_tr = None if tracer is None else tracer.now()
        if async_ok:
            entries = []
            tok_marks = [] if tracer is not None else None
            for i, req in live:
                took = min(n, req.max_new_tokens - req._n_out)
                entries.append((i, req, took))
                req._n_out += took
                self._sched_tokens += took
                if tok_marks is not None:
                    tok_marks.append((req.rid, req._n_out))
                self._pos[i] += took
                if req._n_out >= req.max_new_tokens:
                    req.done = True
                    self._mark_done(req)
                    self._release_slot(i)
            if tracer is not None:
                # ONE recorder-lock acquisition for the whole block's stamps
                tracer.decode_block_batch(
                    t0_tr, n, len(live), tok_marks, t1=t1_tr,
                    tags=self.trace_tags,
                    tokens=sum(e[2] for e in entries))
            self._pending.append((out, entries))
            return
        # eos path: materialize (in generation order — older pendings first)
        self._drain_pending()
        out = out.cpu().numpy()
        tok_marks = [] if tracer is not None else None
        block_tokens = 0
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
            block_tokens += took
            if tok_marks is not None:
                tok_marks.append((req.rid, req._n_out))
            if req.done:
                self._mark_done(req)
                self._release_slot(i)
        if tracer is not None:
            tracer.decode_block_batch(t0_tr, n, len(live), tok_marks,
                                      t1=t1_tr, tags=self.trace_tags,
                                      tokens=block_tokens)

    def _run_decode(self, pos_np, n: int, do_sample: bool):
        """Legacy engines: ``n`` decode steps over every slot, eagerly;
        returns the tokens [max_batch, n] on the device and advances the
        last-token carry."""
        self._note_program(("decode", n, do_sample))
        self.stats["decode_steps"] += n
        self.stats["eager_decode_steps"] += n
        if do_sample:
            params = self._slot_params(range(self.max_batch))
        toks = self._last_tok
        pos = self._to_device(pos_np)
        outs = []
        for j in range(n):
            logits, self.caches = self.model.paged_token_step(
                toks, self.caches, pos)
            if do_sample:
                toks = self._sample(logits, pos_np + j + 1, params)
            else:
                toks = logits.argmax(-1)
            outs.append(toks)
            pos = pos + 1
        self._last_tok = toks
        return torch.stack(outs, dim=1)

    # -- fused mega-step -------------------------------------------------
    def _fused_step(self, positions=None):
        """One token step over all ``max_batch`` rows on the device-resident
        state, entirely in place: the step a CUDA graph captures. Inactive
        rows step position j at the block's step j (the parking page with a
        prefix cache), as the JAX engine's scan advances them: an MoE
        layer's capacity dispatches route them with the live rows.
        ``positions`` (host, the sampled tokens' positions) switches the
        argmax for the sampler, which cannot be captured."""
        pos_vec = torch.where(self._dev_act, self._dev_pos - 1,
                              self._step_i.to(torch.int32))
        logits, _ = self.model.paged_token_step(self._last_tok, self.caches,
                                                pos_vec)
        if positions is None:
            nxt = logits.argmax(-1)
        else:
            nxt = self._sample(logits, positions, self._dev_samp)
        self._last_tok.copy_(nxt)
        self._out.index_copy_(1, self._step_i, nxt[:, None])
        self._dev_pos.add_(self._dev_act.to(torch.int32))
        self._step_i.add_(1)

    def _capture(self):
        """Capture the greedy ``_fused_step`` as a CUDA graph, once, and on
        spec engines ``_spec_step`` as a second graph in the same memory
        pool. Runs at construction, while every row is inactive, so the
        warm-up steps (cuBLAS handles, the rope tables, K4's
        once-per-instantiation cluster query) write only dummy tokens at
        the first positions of parked rows, and spec steps emit nothing. A
        capture that fails raises."""
        steps = [self._fused_step]
        if self._spec is not None:
            steps.append(self._spec_step)
        cur = torch.cuda.current_stream(self.device)
        side = _capture_stream(self.device)
        side.wait_stream(cur)
        graphs = []
        with torch.no_grad():
            with torch.cuda.stream(side):
                for _ in range(2):
                    for fn in steps:
                        fn()
            cur.wait_stream(side)
            pool = None
            for fn in steps:
                before = _kernel_counts()
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, pool=pool):
                    fn()
                pool = graph.pool()
                # the capture recorded these launches without running them:
                # the counts move by them at each replay instead
                graphs.append((graph, tuple(
                    b - a for a, b in zip(before, _kernel_counts()))))
                _set_counts(before)
        self._last_tok.zero_()
        self._step_i.zero_()
        self._graph, self._graph_counts = graphs[0]
        self.stats["graph_captures"] += 1
        if self._spec is not None:
            self._spec_graph, self._spec_graph_counts = graphs[1]
            self._dev_hist.zero_()
            self._dev_hlen.zero_()
            self.stats["spec_graph_captures"] += 1

    def _run_fused(self, pos_np, n: int, do_sample: bool):
        """``n`` steps of the fused engine: ``n`` replays of the captured
        graph, or the same step run eagerly (on the CPU, or for a block with
        a sampled row). Returns the tokens [max_batch, n]."""
        self._note_program(("fused_step", do_sample))
        self.stats["decode_steps"] += n
        self._step_i.zero_()
        if self._graph is not None and not do_sample:
            for _ in range(n):
                self._graph.replay()
            _add_counts(self._graph_counts, n)
            self.stats["graph_replays"] += n
        else:
            for j in range(n):
                self._fused_step(pos_np + j + 1 if do_sample else None)
            self.stats["eager_decode_steps"] += n
        return self._out[:, :n].clone()

    # -- speculative decoding ---------------------------------------------
    def _spec_step(self):
        """ONE speculative dispatch over all ``max_batch`` rows, on the
        device-resident state and entirely in place (the step the second
        CUDA graph captures): draft K tokens from each row's history ring
        (:func:`ngram_draft`), run the window [last token, drafts] through
        ``paged_verify_step``, keep the longest draft prefix equal to the
        verify argmaxes plus one bonus token (:func:`spec_accept`), and
        append the old last token and the emitted tokens but the newest to
        the ring (the newest rides the last-token carry). Rejected drafts'
        k/v needs no rollback: positions advance over emitted tokens only,
        so it lies past every row's length and is overwritten later.
        Inactive rows emit nothing (caps 0) and write only at the parking
        page or their own slot's first positions. Outputs land in
        ``_spec_out`` [B, K+1] and ``_spec_emit`` [B]."""
        spec = self._spec
        K, H = spec.k, spec.history
        act = self._dev_act
        toks = self._last_tok
        hlen = self._dev_hlen
        pos_vec = torch.where(act, self._dev_pos, 1) - 1
        drafts = ngram_draft(self._dev_hist[:, :H], hlen, toks, K, spec.ngram)
        window = torch.cat([toks[:, None], drafts], dim=1)
        logits, _ = self.model.paged_verify_step(window, self.caches, pos_vec)
        targets = logits.argmax(-1)
        if spec._unsafe_accept_all:
            targets = torch.cat([drafts, targets[:, K:]], dim=1)
        out, emit, _ = spec_accept(drafts, targets,
                                   torch.where(act, self._dev_caps, 0))
        emit = torch.where(act, emit, 0)
        last = out.gather(1, (emit - 1).clamp(0, K)[:, None])[:, 0]
        last = torch.where(emit > 0, last, toks)
        vals = torch.cat([toks[:, None], out[:, :K]], dim=1)
        j = torch.arange(K + 1, device=toks.device)[None, :]
        # tokens not emitted go to the spare column H, which no draft reads
        widx = torch.where(j < emit[:, None], (hlen[:, None] + j) % H, H)
        self._dev_hist.scatter_(1, widx, vals)
        hlen.add_(emit)
        self._dev_pos.add_(emit.to(torch.int32))
        self._last_tok.copy_(last)
        self._spec_out.copy_(out)
        self._spec_emit.copy_(emit)

    def _decode_spec_block(self, live):
        """One speculative dispatch (a replay of the captured spec step, or
        the step run eagerly on the CPU) and its per-row bookkeeping.
        Acceptance depends on the data, so the [B] emit vector is read back
        synchronously, once per dispatch; the token matrix stays a deferred
        readback (``_drain_pending``) unless an eos-carrying row needs its
        values."""
        K = self._spec.k
        caps = np.zeros(self.max_batch, np.int32)
        for i, r in live:
            caps[i] = min(r.max_new_tokens - r._n_out,
                          self.max_len - int(self._pos[i]))
        tracer = self.tracer
        t0_tr = None if tracer is None else tracer.now()
        self._note_program(("spec_step",))
        self._dev_caps.copy_(self._to_device(caps))
        if self._spec_graph is not None:
            self._spec_graph.replay()
            _add_counts(self._spec_graph_counts)
            self.stats["spec_graph_replays"] += 1
        else:
            self._spec_step()
            self.stats["eager_spec_steps"] += 1
        out_dev = self._spec_out.clone()
        emit = self._spec_emit.cpu().numpy()     # the one synchronous read
        self.stats["spec_proposed"] += K * len(live)
        self.stats["spec_steps"] += 1
        t1_tr = None if tracer is None else tracer.now()
        out = None
        if any(r.eos_token_id is not None for _, r in live):
            # materialize in generation order (older pendings first)
            self._drain_pending()
            out = out_dev.cpu().numpy()
        entries = []
        tok_marks = [] if tracer is not None else None
        total = 0
        for i, req in live:
            took = int(emit[i])
            if out is not None:
                used = 0
                for jj in range(took):
                    tok = int(out[i, jj])
                    req.output.append(tok)
                    req._n_out += 1
                    used = jj + 1
                    if (req.eos_token_id is not None
                            and tok == req.eos_token_id):
                        req.done = True
                        break
                took = used
            else:
                entries.append((i, req, took))
                req._n_out += took
            # every delivered token past a dispatch's first is an accepted
            # draft (eos and cap truncation included)
            self.stats["spec_accepted"] += max(0, took - 1)
            self._pos[i] += took
            self._sched_tokens += took
            total += took
            if tok_marks is not None:
                tok_marks.append((req.rid, req._n_out))
            if req._n_out >= req.max_new_tokens:
                req.done = True
            if req.done:
                self._mark_done(req)
                self._release_slot(i)
        if tracer is not None:
            # the block's REAL emitted-token count rides the span: a spec
            # dispatch emits 1..K+1 tokens a row
            tracer.decode_block_batch(t0_tr, K + 1, len(live), tok_marks,
                                      t1=t1_tr, tags=self.trace_tags,
                                      tokens=total)
        if entries:
            self._pending.append((out_dev, entries))

    def _hist_seed(self, req):
        """The drafter seed of ``req``'s activation (None without spec)."""
        return None if self._spec is None else self._spec_seed(req.prompt)

    def _spec_seed(self, prompt, extra=()):
        """Drafter seed for a slot's activation: the last ``history``
        tokens of the prompt (and, for a migrated chain, of the delivered
        tokens ``extra`` after it) in ring order, global index g at slot
        g % H, so the spec step's ring arithmetic continues from it; and
        the count written. The current last token stays out: it rides the
        last-token carry and enters the ring at the next spec step."""
        H = self._spec.history
        toks = np.asarray(prompt, np.int32).reshape(-1)
        if len(extra):
            toks = np.concatenate(
                [toks, np.asarray(extra, np.int32).reshape(-1)])
        hlen = len(toks)
        row = np.zeros(H, np.int32)
        tail = toks[max(0, hlen - H):]
        if len(tail):
            row[np.arange(hlen - len(tail), hlen) % H] = tail
        return row, hlen

    def _reset_quant_blocks(self, blocks):
        """int8 pools: zero the bytes AND the scales of freshly allocated
        blocks, in place. A recycled page keeps its previous occupant's
        scale, and quantize-on-append only grows scales (scatter-max):
        without the reset a new request's tokens would quantize under a
        stale, larger scale, and a warm re-admission through recycled pages
        would emit other bytes than its cold run. Only the real blocks are
        indexed."""
        if self._kv_dtype != "int8" or not len(blocks):
            return
        idx = self._to_device(np.asarray(blocks, np.int64))
        for k, v in self.caches["kv"]:
            for pool in (k, v):
                pool.data.index_fill_(0, idx, 0)
                pool.scale.index_fill_(0, idx, 0.0)

    def _queue_update(self, slot: int, row, pos: int, act: bool,
                      temp: float = 0.0, top_p: float = 1.0, top_k: int = 0,
                      hist=None):
        """Queue one slot's device-state change (activation or release).
        The latest update per slot wins; all land at the next
        ``_flush_updates``. ``row=None`` is the parking row with a prefix
        cache (release) and leaves a static slot-owned table unchanged
        without one. ``hist`` (spec engines) is the slot's drafter seed
        ``(ring row, count)`` from :meth:`_spec_seed`; None empties the
        ring."""
        self._upd[slot] = (row, int(pos), bool(act), float(temp),
                           float(top_p), int(top_k), hist)

    def _flush_updates(self):
        """Apply the queued slot updates to the device-resident state in
        place (``index_copy_``), so a captured graph keeps its pointers. The
        values travel in one fresh pinned buffer per flush: a host buffer
        reused while its copy is in flight would let the device read
        values a later update already changed."""
        if not self._upd:
            return
        items = sorted(self._upd.items())
        self._upd.clear()
        tables = self.prefix_cache is not None
        # columns: slot, pos, act, top_k | table row | ring row + spare
        # column, ring count
        t0 = 4
        h0 = t0 + (self._maxp if tables else 0)
        H1 = 0 if self._spec is None else self._spec.history + 1
        ints = np.zeros((len(items), h0 + H1 + (1 if H1 else 0)), np.int32)
        floats = np.zeros((len(items), 2), np.float32)
        for j, (slot, (row, pos, act, temp, top_p, top_k, hist)) in \
                enumerate(items):
            ints[j, :t0] = (slot, pos, act, top_k)
            if tables:
                ints[j, t0:h0] = self._park if row is None else row
            if H1 and hist is not None:
                ints[j, h0:h0 + H1 - 1] = hist[0]
                ints[j, -1] = hist[1]
            floats[j] = (temp, top_p)
        ints_d = self._to_device(ints)
        floats_d = self._to_device(floats)
        idx = ints_d[:, 0].long()
        self._dev_pos.index_copy_(0, idx, ints_d[:, 1].contiguous())
        self._dev_act.index_copy_(0, idx, ints_d[:, 2] != 0)
        temps, tops, topks = self._dev_samp
        temps.index_copy_(0, idx, floats_d[:, 0].contiguous())
        tops.index_copy_(0, idx, floats_d[:, 1].contiguous())
        topks.index_copy_(0, idx, ints_d[:, 3].contiguous())
        if tables:
            self.caches["tables"].index_copy_(0, idx,
                                              ints_d[:, t0:h0].contiguous())
        if H1:
            self._dev_hist.index_copy_(0, idx, ints_d[:, h0:h0 + H1].long())
            self._dev_hlen.index_copy_(0, idx, ints_d[:, -1].long())
        self.stats["fused_updates"] += len(items)

    # -- sampling ----------------------------------------------------------
    def _sample(self, logits, positions, params, slots=None):
        """Sample the next token of each row (greedy rows take the argmax).
        ``positions`` are the sampled tokens' positions; ``params`` the
        rows' (temperatures, top-p, top-k) on the device; ``slots`` the
        rows' slots (default: every slot)."""
        if slots is None:
            slots = range(self.max_batch)
        keys = fold_keys([self._seeds[s] for s in slots], positions)
        keys = [k if self._temps[s] > 0.0 else None
                for k, s in zip(keys, slots)]
        return sample_rows(logits, keys, *params)

    def _slot_params(self, slots):
        """(temperatures, top-p, top-k) of ``slots`` on the device, from the
        host arrays."""
        idx = np.asarray(list(slots), np.int64)
        return (self._to_device(self._temps[idx]),
                self._to_device(self._tops[idx]),
                self._to_device(self._topks[idx]))

    def run_until_done(self, max_steps: int = 100000):
        steps = 0
        while self.has_work() and steps < max_steps:
            self.step()
            steps += 1
        return self.finished()

    @_serialized
    def finished(self) -> Dict[int, Request]:
        self._drain_pending()
        if self._fused:
            # land queued releases, so a drained engine's device state is
            # drained too, not pending the next decode block
            self._flush_updates()
        # the retry registry's snapshot rides here (control plane), not in
        # step(), as in the JAX engine
        rs = retry_stats()
        self.stats["retry_attempts"] = rs["attempts"]
        self.stats["retry_giveups"] = rs["giveups"]
        out, self._finished = self._finished, {}
        return out

    def _mark_done(self, req: Request):
        """Single chokepoint for request completion: surfaces the request
        in ``_finished``, retires its deadline from the expiry scan, and
        stamps the terminal span (finish / evict / fail — the tracer infers
        the kind from failed + error)."""
        if req.deadline_s is not None:
            self._n_deadlined = max(0, self._n_deadlined - 1)
        self._finished[req.rid] = req
        if self.tracer is not None:
            self.tracer.finish(req.rid, req._n_out, failed=req.failed,
                               error=req.error, tags=self.trace_tags)

    def withdraw_queued(self, rid: int) -> bool:
        """Remove a still-WAITING request from the queue (never an admitted
        slot): the fleet's drain-migration primitive. Returns False when
        the request is not in the queue."""
        for i, r in enumerate(self._queue):
            if r.rid == rid:
                del self._queue[i]
                if r.deadline_s is not None:
                    self._n_deadlined = max(0, self._n_deadlined - 1)
                return True
        return False

    # -- disaggregated-tier hooks (inference/disagg.py) --------------------
    def slot_of(self, rid: int) -> Optional[int]:
        """Slot currently serving ``rid`` (None when queued or finished)."""
        for i, r in self._occupied.items():
            if r.rid == rid:
                return i
        return None

    def migration_ready(self) -> List[int]:
        """rids whose prefill is COMPLETE (first token scheduled, slot in
        the decode set) with decode work left: the prefill tier's
        migration candidates. Mid-prefill slots are not exportable: their
        cache holds a partial prompt and nothing has been sampled."""
        out = []
        for i, r in sorted(self._occupied.items()):
            if self.prefix_cache is not None and i in self._prefill_next:
                continue
            if r._n_out >= 1 and not r.done:
                out.append(r.rid)
        return out

    def withdraw_active(self, rid: int) -> bool:
        """Release ``rid``'s ACTIVE slot without terminal bookkeeping: the
        source half of a KV-chain handoff (the request is neither done nor
        failed here). Export the chain FIRST: the decref'd pages may be
        mapped by the very next admission."""
        slot = self.slot_of(rid)
        if slot is None:
            return False
        if self._slots[slot].deadline_s is not None:
            self._n_deadlined = max(0, self._n_deadlined - 1)
        self._release_slot(slot)
        return True

    @_serialized
    def admit_migrated(self, req: Request, blocks: Sequence[int],
                       pos: int, last_tok: int) -> int:
        """Resume-at-position admission of a migrated finished-prefill
        chain whose pages the caller (``KVChainCodec``) has allocated at
        refcount 1 and filled with the exported bytes.

        Maps the table row, restores the position, the sampling state and
        the last-token carry, and registers the prompt's full pages in the
        radix cache (first writer wins). Decode continues through the
        ordinary steps: sample keys depend on (seed, position) alone, so
        on the same page bytes the stream continues as if it had never
        moved. The carry is written IN PLACE (the fused engine's graph
        reads ``_last_tok``); spec engines re-seed the drafter ring from
        prompt + delivered tokens. Raises :class:`EngineSaturated` with no
        free slot: the caller still owns ``blocks``."""
        if self.prefix_cache is None:
            raise ValueError("KV-chain splice needs a prefix-cache engine "
                             "(dynamic block tables over the refcounted "
                             "pool)")
        if not self._free_slots:
            raise EngineSaturated(
                f"no free slot for migrated rid={req.rid} "
                f"({len(self._occupied)}/{self.max_batch} busy)")
        slot = self._free_slots.popleft()
        # int8: the chain's written prefix arrived with its scales; the
        # tail blocks it will decode into are recycled pages
        if self._kv_dtype == "int8":
            n_written = max(0, -(-(int(pos) - 1) // self.page_size))
            self._reset_quant_blocks(list(blocks)[n_written:])
        row = np.full(self._maxp, self._park, np.int32)
        row[: len(blocks)] = blocks
        self._slot_rows[slot] = row
        self._slot_blocks[slot] = list(blocks)
        self._slots[slot] = req
        self._occupied[slot] = req
        req._engine = weakref.ref(self)
        # the deadline clock restarts at re-admission, as after recovery
        req._enqueued_at = _time.monotonic()
        if req.deadline_s is not None:
            self._n_deadlined += 1
        self._pos[slot] = int(pos)
        self._temps[slot] = req.temperature
        self._tops[slot] = req.top_p
        self._topks[slot] = req.top_k
        self._seeds[slot] = req.seed
        self._last_tok[slot] = int(last_tok)
        if self._fused:
            self._queue_update(slot, row, int(pos), True, req.temperature,
                               req.top_p, req.top_k,
                               hist=(self._spec_seed(req.prompt,
                                                     extra=req.output[:-1])
                                     if self._spec is not None else None))
        else:
            self._tables_host[slot] = row
            self._tables_dirty = True
        n_full = len(req.prompt) // self.page_size
        if n_full and not self._brownout_active:
            self._radix.insert(req.prompt[: n_full * self.page_size],
                               list(blocks)[:n_full])
        return slot

    @_serialized
    def _drain_pending(self):
        """Materialize deferred token blocks into request outputs."""
        for arr_dev, entries in self._pending:
            arr = arr_dev.cpu().numpy()
            for row, req, took in entries:
                if arr.ndim == 1:           # first tokens [g]
                    req.output.append(int(arr[row]))
                else:                       # decode block [slots, n]
                    req.output.extend(int(t) for t in arr[row, :took])
        self._pending.clear()

    # ---- internals ----
    def _to_device(self, arr):
        """Host array -> device tensor without stalling the stream: CUDA
        copies go through a fresh pinned buffer, non-blocking."""
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
        """Free slot ``i``. With a prefix cache, DECREF the slot's blocks (a
        shared block stays alive while another table or the radix cache
        references it) and park its decode-table row: freed pages may be
        mapped by the very next admission, and the inactive row's dummy
        append must never touch them."""
        if self._slots[i] is not None:
            self._occupied.pop(i, None)
            self._free_slots.append(i)
        self._slots[i] = None
        self._pos[i] = 0
        self._temps[i] = 0.0
        if self.prefix_cache is not None:
            blocks = self._slot_blocks[i]
            if blocks:
                self._alloc.decref(blocks)
            self._slot_blocks[i] = None
            self._slot_rows[i] = None
            self._prefill_next.pop(i, None)
            if not self._fused:
                self._tables_host[i] = self._park
                self._tables_dirty = True
        if self._fused:
            self._queue_update(i, None, 0, False)

    # -- legacy admission ------------------------------------------------
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
        # int8: slot i statically owns pages [i * maxp, (i + 1) * maxp);
        # clear the admitted slots' pages of their previous scales
        self._reset_quant_blocks([s * self._maxp + j for s, _ in take
                                  for j in range(self._maxp)])
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
        tracer = self.tracer
        for (padded, _), grp in groups.items():
            t0_tr = None if tracer is None else tracer.now()
            firsts_dev = self._prefill_group(padded, grp)
            if tracer is not None:
                tracer.span("prefill_group", None, t0_tr,
                            tags=self.trace_tags, tokens=padded * len(grp),
                            slots=len(grp))
            any_eos = any(r.eos_token_id is not None for _, r in grp)
            firsts = firsts_dev.cpu().numpy() if any_eos else None
            entries = []
            ft_marks = [] if tracer is not None else None
            for row, (slot, req) in enumerate(grp):
                self._slots[slot] = req
                self._occupied[slot] = req
                req._n_out += 1
                self._sched_tokens += 1
                if tracer is not None:
                    now = _time.monotonic()
                    tracer.admit(req.rid, now - (req._enqueued_at or now),
                                 miss_tokens=len(req.prompt),
                                 tags=self._req_tags(req))
                    ft_marks.append((req.rid, req._n_out))
                self._pos[slot] = len(req.prompt) + 1
                if self._fused:
                    # static slot-owned tables: activation flips only the
                    # position, the active flag and the sampling params
                    self._queue_update(slot, None, len(req.prompt) + 1, True,
                                       req.temperature, req.top_p, req.top_k,
                                       hist=self._hist_seed(req))
                if firsts is not None:
                    req.output.append(int(firsts[row]))
                else:
                    entries.append((row, req, 1))
            if ft_marks:
                # one recorder-lock acquisition for the group's first tokens
                tracer.first_tokens(ft_marks, tags=self.trace_tags)
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
            pos = true_len - 1
            g = len(grp)
            if self._fixed_rows and g < self.max_batch:
                # max_batch rows: copies of row 0 write its own k/v bytes
                # again at the same place
                idx = self._to_device(np.concatenate([
                    np.arange(g), np.zeros(self.max_batch - g, np.int64)]))
                last, pos = last[idx], pos[idx]
                sub = {"kv": sub["kv"], "tables": sub["tables"][idx]}
            logits, _ = self.model.paged_token_step(last, sub, pos)
            logits = logits[:g]
        if do_sample:
            nxt = self._sample(logits, true_len_np, self._slot_params(slots),
                               slots)
        else:
            nxt = logits.argmax(-1)
        self._last_tok[slots_d] = nxt
        return nxt

    # -- prefix-cache admission and chunked prefill ------------------------
    def _pages_needed(self, prompt_len: int, max_new: int) -> int:
        return -(-(prompt_len + max_new) // self.page_size)

    def _admit_prefix(self):
        """Admission with radix prefix matching over the refcounted pool.

        FIFO with head-of-line blocking on pool exhaustion: when the queue
        head cannot get its blocks (even after LRU eviction of idle cached
        blocks) it stays queued and later arrivals wait behind it; the
        allocator never overcommits shared blocks."""
        if not self._queue:
            return
        cow_wave = [] if self._fused else None
        while self._free_slots and self._queue:
            req = self._queue[0]
            # fault site: seeded pool exhaustion before the allocation
            held = resource_hold("serving.block_pool", f"rid:{req.rid}")
            if held:
                self._alloc.hold(held)
            if not self._try_admit_prefix(self._free_slots[0], req, cow_wave):
                # the pool could not serve the head even after LRU
                # eviction: the brownout pressure signal
                self._deferred_step = True
                break
            self._queue.popleft()
            self._free_slots.popleft()
        if cow_wave:
            self._cow_copy_batch(cow_wave)
        self.stats["evictions"] = self._radix.evictions

    def _try_admit_prefix(self, slot: int, req: Request,
                          cow_wave=None) -> bool:
        page = self.page_size
        prompt = req.prompt
        n_full = len(prompt) // page
        # brownout: admission does not consult the radix cache; every block
        # is fresh (the cache-off working-set shape)
        matched = (self._radix.match(prompt[: n_full * page])
                   if n_full and not self._brownout_active else [])
        cow_src = None
        if matched and len(matched) * page == len(prompt):
            # FULL-prompt hit: nothing to prefill, but the first-token
            # re-step rewrites position L-1 inside the last shared block —
            # copy it into a private page first
            cow_src = matched[-1]
            matched = matched[:-1]
        need = self._pages_needed(len(prompt), req.max_new_tokens)
        fresh_n = need - len(matched)          # includes the COW copy
        # pin the matched chain (and the COW source) BEFORE the
        # eviction-capable alloc: refcount-0 cached-idle blocks could
        # otherwise be evicted and handed back as `fresh`, mapping one
        # block twice in this slot's table
        pinned = matched + ([cow_src] if cow_src is not None else [])
        self._alloc.incref(pinned)
        fresh = self._alloc.alloc(fresh_n, evict=self._radix.evict_lru)
        if fresh is None and self._overcommit:
            fresh = self._steal_blocks(fresh_n, avoid=set(pinned))
        if fresh is None:
            self._alloc.decref(pinned)
            return False                       # pool exhausted — defer
        # int8: before any write (the COW copy below included), recycled
        # pages lose their previous occupant's scales
        self._reset_quant_blocks(fresh)
        cached = len(matched) * page
        if cow_src is not None:
            dst = fresh[0]
            if cow_wave is None:
                self._cow_copy(cow_src, dst)
                self._alloc.decref([cow_src])  # copy done — unpin the source
            else:
                # fused: the wave's copies run in one call; the source
                # stays pinned until then so eviction cannot reclaim it
                cow_wave.append((cow_src, dst))
            self.stats["cow_copies"] += 1
            blocks = matched + [dst] + fresh[1:]
            cached = len(prompt)
        else:
            blocks = matched + fresh
        row = np.full(self._maxp, self._park, np.int32)
        row[: len(blocks)] = blocks
        self._slot_rows[slot] = row
        self._slot_blocks[slot] = blocks
        self._slots[slot] = req
        self._occupied[slot] = req
        # next uncached write position; == len(prompt) means straight to
        # the first-token re-step. The slot joins the decode batch (and its
        # row the decode table) only once prefill completes.
        self._prefill_next[slot] = cached
        self.stats["hit_tokens"] += cached
        self.stats["miss_tokens"] += len(prompt) - cached
        if self.tracer is not None:
            now = _time.monotonic()
            self.tracer.admit(
                req.rid, now - (req._enqueued_at or now),
                hit_tokens=cached, miss_tokens=len(prompt) - cached,
                tags=self._req_tags(req))
        return True

    def _steal_blocks(self, n: int, avoid=()):
        """``_unsafe_overcommit`` only: what an allocator without refcounts
        does under exhaustion — take LRU radix leaves out of the cache and
        hand them to the new request although live tables still map them.
        Production admission defers instead."""
        legit = list(self._alloc.alloc(min(n, self._alloc.free_blocks)) or [])
        stolen = []
        victims = sorted(self._radix._by_block.values(),
                         key=lambda nd: nd.last_used)
        for nd in victims:
            if len(legit) + len(stolen) >= n:
                break
            if nd.block in avoid or nd.children:
                continue
            nd.parent.children.pop(nd.key, None)
            del self._radix._by_block[nd.block]
            self._alloc._ref[nd.block] = self._alloc._ref.get(nd.block, 0) + 1
            stolen.append(nd.block)
        if len(legit) + len(stolen) < n:
            self._alloc.decref(stolen + legit)
            return None
        # stolen pages first: they become the thief's PROMPT blocks, so its
        # next prefill overwrites a page the victim still reads
        return stolen + legit

    def _cow_copy(self, src: int, dst: int):
        for k, v in self.caches["kv"]:
            copy_pages(k, v, src, dst)

    def _cow_copy_batch(self, pairs):
        """All of an admission wave's COW copies in one call per layer; the
        sources stay pinned (incref'd by ``_try_admit_prefix``) until the
        copy is queued, so an eviction under a later admission of the same
        wave cannot reclaim them first."""
        src = self._to_device(np.asarray([s for s, _ in pairs], np.int64))
        dst = self._to_device(np.asarray([d for _, d in pairs], np.int64))
        for k, v in self.caches["kv"]:
            copy_pages(k, v, src, dst)
        self._alloc.decref([s for s, _ in pairs])

    def _prefill_tick(self):
        """One chunk of prefill per mid-prefill slot (packed in fused
        mode), then the first-token re-step (and radix registration) for
        slots whose prompts are fully written."""
        if not self._prefill_next:
            return
        t0 = _time.perf_counter()
        try:
            chunkers = [(s, self._slots[s]) for s in sorted(self._prefill_next)
                        if self._prefill_next[s] < len(self._slots[s].prompt)]
            # brownout turns chunked interleaving off: each prompt
            # prefills whole in this tick, through the same chunk calls
            run = self._run_pack if self._fused else self._run_chunk
            while chunkers:
                run(chunkers)
                if not self._brownout_active:
                    break
                chunkers = [(s, r) for s, r in chunkers
                            if self._prefill_next[s] < len(r.prompt)]
            ready = [(s, self._slots[s]) for s in sorted(self._prefill_next)
                     if self._prefill_next[s] >= len(self._slots[s].prompt)]
            if ready:
                self._first_token(ready)
        finally:
            self.stats["prefill_host_s"] += _time.perf_counter() - t0

    def _prefill_row(self, s: int, req: Request):
        """Table row for a prefill chunk: the slot's REAL prompt pages,
        everything beyond them (its decode-headroom blocks) parked, so a
        chunk's pad tail never writes into the slot's future decode
        blocks."""
        row = np.full(self._maxp, self._park, np.int32)
        n_real = -(-len(req.prompt) // self.page_size)
        row[:n_real] = self._slot_rows[s][:n_real]
        return row

    def _prefill_chunk(self, ids, starts, rows):
        """One ``paged_prefill_chunk`` call over host arrays ids [g, C],
        starts [g] and table rows [g, maxp]."""
        self._note_program(("chunk", ids.shape[0]))
        self.stats["prefill_groups"] += 1
        sub = {"kv": self.caches["kv"], "tables": self._to_device(rows)}
        self.model.paged_prefill_chunk(self._to_device(ids), sub,
                                       self._to_device(starts))

    def _run_chunk(self, group):
        """Legacy engines: one chunk of every mid-prefill slot, one row
        each."""
        C = self._chunk_tokens
        t0_tr = None if self.tracer is None else self.tracer.now()
        # on the card max_batch rows (``_fixed_rows``), the rest parked
        g = self.max_batch if self._fixed_rows else len(group)
        ids = np.zeros((g, C), np.int32)
        starts = np.zeros(g, np.int32)
        rows = np.full((g, self._maxp), self._park, np.int32)
        for r, (s, req) in enumerate(group):
            rows[r] = self._prefill_row(s, req)
            nxt = self._prefill_next[s]
            chunk = req.prompt[nxt: nxt + C]
            ids[r, : len(chunk)] = chunk
            starts[r] = nxt
        self._prefill_chunk(ids, starts, rows)
        for s, req in group:
            nxt = self._prefill_next[s]
            self._prefill_next[s] = min(nxt + C, len(req.prompt))
            if self.tracer is not None:
                # one span per slot per chunk (host dispatch window), with
                # the real (unpadded) token count the chunk advanced
                self.tracer.prefill_chunk(
                    req.rid, t0_tr, self._prefill_next[s] - nxt,
                    tags=self.trace_tags)

    def _run_pack(self, group):
        """Packed prefill (fused mode): (slot, chunk) pairs flattened into
        the rows of ONE ``paged_prefill_chunk`` call, so several short
        prompts finish, and a long prompt advances several chunks, in one
        call. Every row's k/v is appended before any row gathers and a
        query attends exactly the keys at positions <= its own, so a later
        chunk of a prompt reads the earlier chunk's pages written in the
        same call, as if the chunks ran one after the other. Rows go out
        breadth-first (one chunk per slot per pass), so every mid-prefill
        slot advances at least one chunk a step; ``pack_rows`` bounds the
        extra rows. The row count is bucketed to a power of two with
        parked dummy rows; on the card the rows go out in calls of one fixed
        count (``_pack_group``)."""
        C = self._chunk_tokens
        budget = max(len(group), self._pack_rows)
        offs = {s: self._prefill_next[s] for s, _ in group}
        rows = []
        progress = True
        while len(rows) < budget and progress:
            progress = False
            for s, req in group:
                if len(rows) >= budget:
                    break
                if offs[s] < len(req.prompt):
                    rows.append((s, req, offs[s]))
                    offs[s] = min(offs[s] + C, len(req.prompt))
                    progress = True
        g = self._pack_group(len(rows))
        t0_tr = None if self.tracer is None else self.tracer.now()
        for lo in range(0, len(rows), g):
            ids = np.zeros((g, C), np.int32)
            starts = np.zeros(g, np.int32)
            trows = np.full((g, self._maxp), self._park, np.int32)
            for r, (s, req, off) in enumerate(rows[lo:lo + g]):
                chunk = req.prompt[off: off + C]
                ids[r, : len(chunk)] = chunk
                starts[r] = off
                trows[r] = self._prefill_row(s, req)
            self._prefill_chunk(ids, starts, trows)
        self.stats["packed_rows"] += len(rows)
        for s, req in group:
            nxt = self._prefill_next[s]
            if offs[s] > nxt:
                self._prefill_next[s] = offs[s]
                if self.tracer is not None:
                    self.tracer.prefill_chunk(req.rid, t0_tr, offs[s] - nxt,
                                              tags=self.trace_tags)

    def _pack_group(self, n: int) -> int:
        """Rows of a packed prefill call for ``n`` (slot, chunk) rows: the
        next power of two, as the JAX engine buckets them. On the card
        (``_fixed_rows``) every call carries the power of two at or above
        ``pack_rows``, and a pack of more rows runs as several calls."""
        if self._fixed_rows:
            n = self._pack_rows
        return 1 << (n - 1).bit_length()

    def _first_token_group(self, n: int) -> int:
        """Rows of the first-token step for ``n`` ready slots. Fused engines
        step a power-of-two group, as the JAX engine does: the dummy rows
        re-step token 0 at position 0 of the parking page (an MoE layer's
        capacity dispatches route them with the real rows); their tokens
        are dropped. On the card every engine steps ``max_batch`` rows
        (``_fixed_rows``)."""
        if self._fixed_rows:
            return self.max_batch
        return 1 << (n - 1).bit_length() if self._fused else n

    def _first_token(self, ready):
        """Re-step the last REAL prompt token at its true position (k/v
        rewritten into a private or COW block, logits over exactly the
        prompt) and sample the first token; then register the prompt's full
        blocks in the radix cache and promote the slot into the decode
        batch (fused mode: through the next ``_flush_updates``)."""
        slots = [s for s, _ in ready]
        do_sample = any(r.temperature > 0.0 for _, r in ready)
        self._note_program(("first", do_sample))
        for s, req in ready:
            self._temps[s] = req.temperature
            self._tops[s] = req.top_p
            self._topks[s] = req.top_k
            self._seeds[s] = req.seed
        g = self._first_token_group(len(ready))
        true_len = np.ones(g, np.int32)
        last = np.zeros(g, np.int64)
        rows = np.full((g, self._maxp), self._park, np.int32)
        for r, (s, req) in enumerate(ready):
            true_len[r] = len(req.prompt)
            last[r] = req.prompt[-1]
            rows[r] = self._slot_rows[s]
        sub = {"kv": self.caches["kv"], "tables": self._to_device(rows)}
        logits, _ = self.model.paged_token_step(
            self._to_device(last), sub, self._to_device(true_len - 1))
        logits = logits[:len(ready)]
        true_len = true_len[:len(ready)]
        if do_sample:
            firsts_dev = self._sample(logits, true_len,
                                      self._slot_params(slots), slots)
        else:
            firsts_dev = logits.argmax(-1)
        self._last_tok[self._to_device(np.asarray(slots, np.int64))] = \
            firsts_dev
        any_eos = any(r.eos_token_id is not None for _, r in ready)
        firsts = firsts_dev.cpu().numpy() if any_eos else None
        entries = []
        ft_marks = [] if self.tracer is not None else None
        for row, (slot, req) in enumerate(ready):
            n_full = len(req.prompt) // self.page_size
            if n_full and not self._brownout_active:
                # register once the whole prompt (and the re-step's
                # rewrite) is queued: later admissions run behind these
                # writes on the device; first writer wins on duplicates.
                # Brownout registers nothing: blocks go back to the pool
                # when the request ends
                self._radix.insert(req.prompt[: n_full * self.page_size],
                                   self._slot_blocks[slot][:n_full])
            del self._prefill_next[slot]
            req._n_out += 1
            self._sched_tokens += 1
            if ft_marks is not None:
                ft_marks.append((req.rid, req._n_out))
            self._pos[slot] = len(req.prompt) + 1
            if self._fused:
                self._queue_update(slot, self._slot_rows[slot],
                                   len(req.prompt) + 1, True,
                                   req.temperature, req.top_p, req.top_k,
                                   hist=self._hist_seed(req))
            else:
                self._tables_host[slot] = self._slot_rows[slot]
                self._tables_dirty = True
            if firsts is not None:
                req.output.append(int(firsts[row]))
            else:
                entries.append((row, req, 1))
        if ft_marks:
            # one recorder-lock acquisition for the wave's first tokens
            self.tracer.first_tokens(ft_marks, tags=self.trace_tags)
        for row, (slot, req) in enumerate(ready):
            if ((firsts is not None and req.eos_token_id is not None
                 and int(firsts[row]) == req.eos_token_id)
                    or req._n_out >= req.max_new_tokens):
                req.done = True
                self._mark_done(req)
                self._release_slot(slot)
        if entries:
            self._pending.append((firsts_dev, entries))
