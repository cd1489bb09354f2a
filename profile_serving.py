#!/usr/bin/env python3
"""Where the port's serving time goes on one CUDA card.

    python3 profile_serving.py        # from the root of a checkout

Builds chip_smoke.py's serving configuration (llama-750M class, bf16, 8
slots, random weights) and measures the engine's two programs at the
wave's shapes — the prefill of a group of 4 bucket-length prompts and one
decode step of 8 rows at context 576 — three ways:

  - device span: CUDA events around N back-to-back calls (what a caller
    waits for);
  - host enqueue: the host clock around the same N calls without a
    synchronise (what Python and the launches cost);
  - device busy: torch.profiler's device time of every kernel in the
    window, summed (kernels on one stream do not overlap), and the top
    kernels by device time.

busy / span is the device's busy share; where host enqueue is close to the
span, the host, not the card, sets the pace. Exits non-zero without a
CUDA device.
"""

import sys
import time

import chip_smoke

STEPS = 20


def measure(torch, name, fn, n, top=8):
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
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


def main():
    import torch

    if not torch.cuda.is_available():
        print("profile_serving: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    card = chip_smoke.card_line()
    print(card, flush=True)
    cfg = LlamaConfig(**chip_smoke.SERVE_CONFIG)
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
