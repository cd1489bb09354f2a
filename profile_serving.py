#!/usr/bin/env python3
"""Where the port's serving time goes on one CUDA card.

    python3 profile_serving.py            # from the root of a checkout
    python3 profile_serving.py --spec     # the spec / int8 section only
    python3 profile_serving.py --recovery # crash replay: row counts, time

Builds chip_smoke.py's serving configuration (llama-750M class, bf16,
random weights) and measures the engine's programs at the waves' shapes —
the legacy engine's prefill of a group of 4 bucket-length prompts and its
decode step of 8 rows at context 576, and the fused 128-slot engine's
decode step (chip_smoke.FUSED_ENGINE: 128 rows from context 88) replayed
from its CUDA graph and run eagerly — three ways:

  - device span: CUDA events around N back-to-back calls (what a caller
    waits for);
  - host enqueue: the host clock around the same N calls without a
    synchronise (what Python and the launches cost);
  - device busy: torch.profiler's device time of every kernel in the
    window, summed (kernels on one stream do not overlap), and the top
    kernels by device time.

busy / span is the device's busy share; where host enqueue is close to the
span, the host, not the card, sets the pace. Last, chip_smoke.py's fused
wave (256 requests, cold: the radix cache emptied first) runs once
unprofiled (its wall time) and once under the profiler (device busy over
the whole wave, its busy share and top kernels). Then the speculative /
int8-KV arm (chip_smoke.SPEC_ENGINE: 8 slots, max_len 128, the prefix
cache): the replayed greedy step of a bf16 and of an int8 engine and the
replayed spec step (k = 4) of a spec and a spec + int8 engine, 8 rows from
context 96, each one token emitted a call, the same three ways. Exits
non-zero without a CUDA device.

``--recovery`` instead looks at crash replay (chip_smoke.py phase 23):
  - row invariance of the model's products: for each weight of layer 0
    and the lm head, in the model's bf16 and in fp32, how many rows of
    ``x[:m] @ w`` differ in any bit from the same rows computed at the
    largest m, for m = g x 128 tokens (packed prefill rows of 128) and
    for m = 1..128 rows (first-token and re-step groups);
  - phase 23's fused kill arm with the engines' fixed row counts off
    (``_fixed_rows = False``: the JAX engine's power-of-two buckets) and
    on: how many of the 256 streams differ from the clean run and how
    many requests fail with PT-SRV-005;
  - where the kill's recovery time goes: the rebuild (engine and graph
    capture), the replay's engine steps, and the rest (re-admission,
    journal, the final sync).
"""

import sys
import time

import chip_smoke

STEPS = 20


def measure(torch, name, fn, n, top=8, reset=None):
    """``reset`` (optional) runs before the warm-up, the timed calls and the
    profiled calls, outside them."""
    from torch.profiler import ProfilerActivity, profile

    reset = reset or (lambda: None)
    reset()
    for _ in range(3):
        fn()
    reset()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / n
    end.record()
    torch.cuda.synchronize()
    span_ms = start.elapsed_time(end) / n
    reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    launches = sum(e.count for e in kernels) / n
    busy = (f"device_busy_ms={busy_ms:.4f} busy_share="
            f"{busy_ms / span_ms:.3f}" if busy_ms > 0 else
            "device_busy_ms=not measured (the profiler saw no device time)")
    print(f"{name}: device_span_ms={span_ms:.4f} host_enqueue_ms="
          f"{enqueue_ms:.4f} {busy} kernels_per_call={launches:.0f}",
          flush=True)
    kernels.sort(key=lambda e: -e.self_device_time_total)
    for e in kernels[:top]:
        print(f"  {e.self_device_time_total / 1e3 / n:9.4f} ms/call "
              f"x{e.count / n:5.0f}  {e.key[:90]}", flush=True)


def profile_wave(torch, np, eng, Request, top=12):
    """The fused cold wave: wall time unprofiled, then device busy time and
    top kernels under the profiler (the radix cache emptied before each)."""
    from torch.profiler import ProfilerActivity, profile

    prompts, news = chip_smoke._fused_wave(np, eng.model.config.vocab_size)

    def wave():
        eng._radix.evict_lru(eng._alloc.num_blocks)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p, k in zip(prompts, news):
            eng.add_request(Request(p, max_new_tokens=k))
        eng.run_until_done()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    wave()                                  # warm-up
    wall_ms = wave()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall_ms = wave()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    print(f"fused wave cold [{len(prompts)} requests, "
          f"{sum(news)} tokens]: wall_ms={wall_ms:.1f} (profiled "
          f"{prof_wall_ms:.1f}) device_busy_ms={busy_ms:.1f} busy_share="
          f"{busy_ms / prof_wall_ms:.3f} of the profiled wall, "
          f"{busy_ms / wall_ms:.3f} of the unprofiled; kernels={launches}",
          flush=True)
    kernels.sort(key=lambda e: -e.self_device_time_total)
    for e in kernels[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms x{e.count:6d}  "
              f"{e.key[:90]}", flush=True)


def profile_spec(torch, np, model):
    """The spec / int8 arm's steps: every row active at
    chip_smoke.SPEC_STEP_CTX over its own pages, one token emitted a spec
    step (the verify window is computed whole whatever the caps)."""
    from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                    PrefixCacheConfig,
                                                    SpecConfig)

    ctx = chip_smoke.SPEC_STEP_CTX
    for name, kw in (("bf16", {}), ("int8", dict(kv_cache="int8"))):
        for spec in (False, True):
            eng = ContinuousBatchingEngine(
                model, prefix_cache=PrefixCacheConfig(
                    extra_blocks=chip_smoke.SPEC_EXTRA_BLOCKS),
                speculative=SpecConfig(k=chip_smoke.SPEC_K) if spec
                else None, **chip_smoke.SPEC_ENGINE, **kw)
            for i in range(eng.max_batch):
                eng._queue_update(i, np.arange(i * eng._maxp,
                                               (i + 1) * eng._maxp), ctx,
                                  True, hist=eng._spec_seed(np.arange(64))
                                  if spec else None)
            eng._flush_updates()
            if spec:
                eng._dev_caps.fill_(1)

            def reset(eng=eng):
                eng._dev_pos.fill_(ctx)
                eng._step_i.zero_()

            step = eng._spec_graph if spec else eng._graph
            what = (f"spec step k={chip_smoke.SPEC_K}" if spec
                    else "greedy step")
            with torch.no_grad():
                measure(torch, f"{name} {what} replayed [{eng.max_batch} "
                        f"rows, from context {ctx}]", step.replay, STEPS,
                        top=10, reset=reset)
            del eng


def row_invariance(torch, model):
    """Rows of ``x[:m] @ w`` that differ from the same rows at the largest
    m, per weight, dtype and m (docstring)."""
    named = dict(model.named_parameters())
    ws = {n.split("layers.0.")[1]: p for n, p in named.items()
          if n.startswith("model.layers.0.") and p.dim() == 2}
    ws["lm_head"] = model._lm_head_w()
    for dtype in (torch.bfloat16, torch.float32):
        for name, w in ws.items():
            w = w.detach().to(dtype)
            g = torch.Generator(device="cuda").manual_seed(0)
            x = torch.randn(16384, w.shape[0], device="cuda",
                            generator=g).to(dtype)
            full, head = x @ w, x[:128] @ w
            packs = {m: int((x[:m * 128] @ w != full[:m * 128]).any(-1)
                            .sum()) for m in (1, 2, 4, 8, 16, 32, 64, 128)}
            rows = {m: int((x[:m] @ w != head[:m]).any(-1).sum())
                    for m in (1, 2, 3, 4, 8, 16, 32, 64, 128)}
            print(f"rows differing, {str(dtype)[6:]} {name} "
                  f"{tuple(w.shape)}: at g x 128 tokens (against 16384) "
                  f"{packs}; at m rows (against 128) {rows}", flush=True)
        torch.cuda.empty_cache()


def profile_recovery(torch, np, model):
    """Phase 23's fused kill arm with fixed row counts off and on, and the
    recovery time split (module docstring)."""
    from paddle_tpu_torch.distributed.resilience import FaultPlan, FaultSpec
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            PrefixCacheConfig, Request,
                                            ServingSupervisor)

    prompts, kws = chip_smoke._recovery_wave(np, model.config.vocab_size)
    path = chip_smoke._scratch_dir("profile_recovery")
    for fixed in (False, True):
        spans = {"rebuild": 0.0, "steps": 0.0}

        def build():
            t0 = time.perf_counter()
            eng = ContinuousBatchingEngine(
                model, prefix_cache=PrefixCacheConfig(
                    extra_blocks=chip_smoke.FUSED_EXTRA_BLOCKS),
                **chip_smoke.FUSED_ENGINE)
            eng._fixed_rows = fixed
            step = eng.step

            def timed():
                t1 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                if sup_ref and sup_ref[0].recovering:
                    spans["steps"] += time.perf_counter() - t1

            eng.step = timed
            torch.cuda.synchronize()
            spans["rebuild"] += time.perf_counter() - t0
            return eng

        sup_ref = []
        sup = ServingSupervisor(build, f"{path}/fixed{int(fixed)}.jrnl")
        sup.recovering = False
        sup_ref.append(sup)
        recover = sup._recover

        def recovering(*args, **kwargs):
            sup.recovering = True
            try:
                recover(*args, **kwargs)
            finally:
                sup.recovering = False

        sup._recover = recovering
        chip_smoke._run_sup(sup, [Request(p, max_new_tokens=4)
                                  for p in prompts[-2:]])
        chip_smoke._cold(sup.engine)
        schedule = []
        reqs = [Request(p, **kw) for p, kw in zip(prompts, kws)]
        chip_smoke._run_sup(sup, reqs, schedule)
        ref = [list(r.output) for r in reqs]
        k = chip_smoke._mid_wave(schedule,
                                 chip_smoke.FUSED_ENGINE["max_batch"] // 2)
        chip_smoke._cold(sup.engine)
        reqs = [Request(p, **kw) for p, kw in zip(prompts, kws)]
        spans.update(rebuild=0.0, steps=0.0)
        with FaultPlan(seed=7, specs=[FaultSpec("serving.step", "kill",
                                                at=k)]):
            chip_smoke._run_sup(sup, reqs)
        rec = sup.stats["recovery_s"]
        differ = sum(list(r.output) != o for r, o in zip(reqs, ref))
        diverged = sum(c == "PT-SRV-005" for c, _ in sup.events)
        print(f"recovery, fixed row counts {'on' if fixed else 'off'}: "
              f"kill at step {k}; {differ} of {len(reqs)} streams differ "
              f"from the clean run, {diverged} failed with PT-SRV-005; "
              f"recovery_s={rec:.4f} = rebuild {spans['rebuild']:.4f} + "
              f"replay steps {spans['steps']:.4f} + the rest "
              f"{rec - spans['rebuild'] - spans['steps']:.4f} "
              f"({sup.stats['replayed_requests']} requests replayed)",
              flush=True)
        del sup._recover
        sup.close()
        del sup, sup_ref[:]
        torch.cuda.empty_cache()


def main():
    import torch

    if not torch.cuda.is_available():
        print("profile_serving: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                    PrefixCacheConfig,
                                                    Request)
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    card = chip_smoke.card_line()
    print(card, flush=True)
    cfg = LlamaConfig(**chip_smoke.SERVE_CONFIG)
    if "--spec" in sys.argv[1:]:
        profile_spec(torch, np, LlamaForCausalLM(cfg, seed=0))
        return 0
    if "--recovery" in sys.argv[1:]:
        model = LlamaForCausalLM(cfg, seed=0)
        row_invariance(torch, model)
        profile_recovery(torch, np, model)
        return 0
    eng_cfg = chip_smoke.ENGINE
    slots, bucket = eng_cfg["max_batch"], eng_cfg["prompt_buckets"][0]
    model = LlamaForCausalLM(cfg, seed=0)
    caches = model._init_paged_caches(slots, eng_cfg["max_len"],
                                      eng_cfg["page_size"])
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, bucket)))
    ids = ids.cuda()
    sub = {"kv": caches["kv"], "tables": caches["tables"][:4]}
    ctx = bucket + chip_smoke.WAVE_NEW[1]
    toks = torch.zeros(slots, dtype=torch.long, device="cuda")
    pos = torch.full((slots,), ctx - 1, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        measure(torch, f"prefill [4 x {bucket}]",
                lambda: model._decode_chunk(ids, sub, 0, None, None), 5)
        measure(torch, f"decode step [{slots} rows, context {ctx}]",
                lambda: model.paged_token_step(toks, caches, pos), STEPS)
    del caches
    # the fused engine: its wave, then its step with every row active over
    # its own pages (which overwrites the cache)
    eng = ContinuousBatchingEngine(
        model, prefix_cache=PrefixCacheConfig(
            extra_blocks=chip_smoke.FUSED_EXTRA_BLOCKS),
        **chip_smoke.FUSED_ENGINE)
    with torch.no_grad():
        profile_wave(torch, np, eng, Request)
    ctx = chip_smoke.FUSED_STEP_CTX
    for i in range(eng.max_batch):
        eng._queue_update(i, np.arange(i * eng._maxp, (i + 1) * eng._maxp),
                          ctx, True)
    eng._flush_updates()

    def reset():
        eng._dev_pos.fill_(ctx)
        eng._step_i.zero_()

    rows = eng.max_batch
    with torch.no_grad():
        measure(torch, f"fused decode step replayed [{rows} rows, from "
                f"context {ctx}]", eng._graph.replay, STEPS, reset=reset)
        measure(torch, f"fused decode step eager [{rows} rows, from "
                f"context {ctx}]", eng._fused_step, STEPS, reset=reset)
    del eng
    profile_spec(torch, np, model)
    return 0


if __name__ == "__main__":
    sys.exit(main())
