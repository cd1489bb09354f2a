#!/usr/bin/env python3
"""Smoke run of paddle_tpu_torch on one CUDA card.

    python3 chip_smoke.py        # from the root of a checkout

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. the card's name and power limit; build every kernel from ops/csrc.
  2. K1 (flash attention forward, csrc/flash_fwd.cu) against its plain
     PyTorch version at the serving prefill shape and at GQA, ragged and
     end-aligned shapes, in bf16 (max abs error <= 2e-2) and fp32 (<= 1e-4),
     with kernel, plain and SDPA times and the roofline bound.
  3. K4 (paged decode, csrc/paged_decode.cu) the same way, with lengths
     0, 1, one page, one 4-page chunk and up to 640.
  4. serving: the llama-750M-class config at full width (12 layers), random
     weights from seed 0, through the legacy ContinuousBatchingEngine: a
     wave of 16 greedy requests with both exact and re-stepped prompts and
     one eos request. Checks token counts, that both kernels carried the
     wave (launch counts), and a teacher-forced check of every emitted token
     against the dense forward.
The second-to-last line is a JSON object listing each kernel; the last is
{"ok": true, "device": {...}}. Without a CUDA device, or outside a checkout
of the repository, it exits non-zero before printing any result.
"""

import json
import subprocess
import sys
import time

DEVICE = "cuda"
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # H100 SXM, dense
PEAK_BYTES = 3.35e12                                  # H100 SXM HBM3
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# Teacher-forced check: every emitted token's logit must lie within this
# margin of the maximum logit at its position. Greedy decode picks the
# maximum of its own bf16 logits; the dense forward recomputes them through
# other kernels with other bf16 rounding over 12 layers, so an emitted token
# may trail the recomputed maximum by a few bf16 steps of a logit (0.0156
# at |logit| in [2, 4), 0.031 in [4, 8)): the first H100 run measured a
# worst trail of 0.047. The margin, 0.1, is about a ninth of this random
# model's logit standard deviation (~0.9) and below the median gap between
# its top two logits (~0.15); a wrong token trails by about a standard
# deviation or more.
MARGIN = 0.1
# K1 cases: name, batch, s_q, s_kv, q heads, kv heads, head_dim, causal
K1_CASES = [
    ("prefill", 8, 512, 512, 16, 16, 128, True),   # the serving prefill
    ("gqa", 2, 1024, 1024, 16, 4, 128, True),
    ("ragged", 2, 77, 77, 16, 16, 128, False),
    ("end_aligned", 2, 200, 520, 16, 4, 64, True),
]
# K4 case: rows, q heads, head_dim, page, pages per row, lengths
K4_CASE = (8, 16, 128, 16, 40, [0, 1, 16, 64, 100, 333, 512, 640])
# the repo's serving design point (bench.py bench_serving, llama-750M
# class) at full width and depth
SERVE_CONFIG = dict(vocab_size=32000, hidden_size=2048,
                    intermediate_size=5632, num_hidden_layers=12,
                    num_attention_heads=16, num_key_value_heads=16,
                    max_position_embeddings=2048, dtype="bfloat16")
ENGINE = dict(max_batch=8, max_len=640, page_size=16, block_size=16,
              prompt_buckets=[512])
# the wave: 4 prompts of exactly the bucket length and 12 of 3/4 bucket to
# bucket - 1 (re-stepped), max_new_tokens cycling through WAVE_NEW
WAVE_NEW = (32, 64, 96, 128)


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def sync():
    import torch

    torch.cuda.synchronize()


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` in ms (CUDA events over ``iters`` runs,
    after ``warmup`` runs)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_k1(torch, F, ops):
    """K1 against its plain version; returns the main-path (prefill) row."""
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    row = None
    for dname in ("bfloat16", "float32"):
        dtype = getattr(torch, dname)
        for name, b, s_q, s_kv, hq, hkv, d, causal in K1_CASES:
            q = torch.randn(b, s_q, hq, d, device=DEVICE, generator=gen).to(dtype)
            k = torch.randn(b, s_kv, hkv, d, device=DEVICE, generator=gen).to(dtype)
            v = torch.randn(b, s_kv, hkv, d, device=DEVICE, generator=gen).to(dtype)
            out = ops.flash_attention(q, k, v, causal=causal)
            ref = ops.flash_attention_reference(q, k, v, causal)
            sync()
            err = (out.float() - ref.float()).abs().max().item()
            ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=causal))
            plain_ms = cuda_ms(
                lambda: ops.flash_attention_reference(q, k, v, causal), 5, 1)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            if causal and s_q != s_kv:
                # SDPA's is_causal is top-left aligned; pass the end-aligned
                # mask explicitly
                mask = torch.ones(s_q, s_kv, dtype=torch.bool,
                                  device=DEVICE).tril(s_kv - s_q)
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    qt, kt, vt, attn_mask=mask, enable_gqa=hq != hkv)
            else:
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    qt, kt, vt, is_causal=causal, enable_gqa=hq != hkv)
            library_ms = cuda_ms(lib)
            rows = torch.arange(s_q, dtype=torch.float64)
            if causal:
                pairs = (rows + s_kv - s_q + 1).clamp(0, s_kv).sum().item()
            else:
                pairs = float(s_q * s_kv)
            flops = 4 * d * hq * b * pairs
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
            bound_ms, bound_by = bound(flops, nbytes, dname)
            print(f"k1 case={name} dtype={dname} shape=[{b},{s_q}/{s_kv},"
                  f"{hq}/{hkv},{d}] causal={causal} max_abs_err={err:.3e} "
                  f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"library_ms={library_ms:.4f} bound_ms={bound_ms:.5f} "
                  f"bound_by={bound_by}", flush=True)
            if not err <= TOL[dname]:
                raise AssertionError(f"K1 {name} {dname}: max abs error "
                                     f"{err} > {TOL[dname]}")
            if name == "prefill" and dname == "bfloat16":
                row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by,
                           library_ms=library_ms)
            del q, k, v, out, ref
    return row


def phase_k4(torch, ops):
    """K4 against its plain version; returns the main-path row (bf16, 16 kv
    heads, the serving shape)."""
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    b, hq, d, page, maxp, lens_list = K4_CASE
    npages = b * maxp
    row = None
    for dname in ("bfloat16", "float32"):
        dtype = getattr(torch, dname)
        for hkv in (16, 4):
            q = torch.randn(b, hq, d, device=DEVICE, generator=gen).to(dtype)
            kc = torch.randn(npages, hkv, page, d, device=DEVICE,
                             generator=gen).to(dtype)
            vc = torch.randn(npages, hkv, page, d, device=DEVICE,
                             generator=gen).to(dtype)
            tables = torch.randperm(npages, device=DEVICE, generator=gen)
            tables = tables.reshape(b, maxp).to(torch.int32)
            lens = torch.tensor(lens_list, dtype=torch.int32, device=DEVICE)
            args = (q, kc, vc, tables, lens)
            out = ops.paged_decode_attention(*args)
            ref = ops.paged_decode_reference(*args)
            sync()
            err = (out.float() - ref.float()).abs().max().item()
            if out[0].abs().max().item() != 0.0:
                raise AssertionError("K4: a length-0 row is not zero")
            ms = cuda_ms(lambda: ops.paged_decode_attention(*args), 50, 5)
            plain_ms = cuda_ms(lambda: ops.paged_decode_reference(*args), 5, 1)
            ntok = sum(lens_list)
            flops = 4 * d * hq * ntok
            nbytes = (2 * ntok * hkv * d * kc.element_size()
                      + 2 * q.numel() * q.element_size()
                      + tables.numel() * 4 + lens.numel() * 4)
            bound_ms, bound_by = bound(flops, nbytes, dname)
            print(f"k4 dtype={dname} rows={b} heads={hq}/{hkv} d={d} "
                  f"page={page} lens={lens_list} max_abs_err={err:.3e} "
                  f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms=null "
                  f"bound_ms={bound_ms:.5f} bound_by={bound_by}", flush=True)
            if not err <= TOL[dname]:
                raise AssertionError(f"K4 {dname} hkv={hkv}: max abs error "
                                     f"{err} > {TOL[dname]}")
            if dname == "bfloat16" and hkv == 16:
                row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by,
                           library_ms=None)
    return row


def phase_serving(torch, np, ops, card):
    from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                    Request)
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(**SERVE_CONFIG)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=DEVICE, seed=0)
    eng = ContinuousBatchingEngine(model, device=DEVICE, **ENGINE)
    sync()
    print(f"serving setup: {cfg.num_params() / 1e6:.1f}M params, "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    rng = np.random.default_rng(0)

    def prompt(n):
        return rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)

    bucket = ENGINE["prompt_buckets"][0]
    # warm-up (cuBLAS handles, first launches), not counted
    for n in (bucket, bucket - 1):
        eng.add_request(Request(prompt(n), max_new_tokens=4))
    eng.run_until_done()

    lens = [bucket] * 4 + [int(x) for x in
                           rng.integers(bucket * 3 // 4, bucket, 12)]
    news = [WAVE_NEW[i % 4] for i in range(16)]
    eos_id = 7
    reqs = [Request(prompt(n), max_new_tokens=k,
                    eos_token_id=eos_id if i == 5 else None)
            for i, (n, k) in enumerate(zip(lens, news))]
    eng.stats.update(prefill_groups=0, decode_steps=0)
    ops.flash_attention.launches = 0
    ops.paged_decode_attention.launches = 0
    sync()
    t0 = time.perf_counter()
    for r in reqs:
        eng.add_request(r)
    done = eng.run_until_done()
    sync()
    wall = time.perf_counter() - t0
    k1_launches = ops.flash_attention.launches
    k4_launches = ops.paged_decode_attention.launches
    groups, steps = eng.stats["prefill_groups"], eng.stats["decode_steps"]
    L = cfg.num_hidden_layers
    print(f"serving wave: {len(done)} requests, prefill_groups={groups} "
          f"decode_steps={steps} k1_launches={k1_launches} "
          f"k4_launches={k4_launches}", flush=True)
    if len(done) != len(reqs):
        raise AssertionError(f"{len(done)} of {len(reqs)} requests finished")
    for r in reqs:
        out = r.output
        if r.eos_token_id is None or eos_id not in out:
            ok = len(out) == r.max_new_tokens
        else:
            ok = out.index(eos_id) == len(out) - 1
        if not ok or r.failed:
            raise AssertionError(f"request {r.rid}: {len(out)} tokens for "
                                 f"max_new {r.max_new_tokens}")
    if k1_launches < groups * L or k4_launches < steps * L:
        raise AssertionError(
            f"kernels did not carry the wave: K1 {k1_launches} < "
            f"{groups}x{L} or K4 {k4_launches} < {steps}x{L}")
    useful = sum(len(r.output) for r in reqs)

    # teacher-forced check against the dense forward (flash kernel path)
    worst, gaps, spread, top1 = 0.0, [], [], 0
    with torch.no_grad():
        for r in reqs:
            seq = np.concatenate([r.prompt, np.asarray(r.output, np.int32)])
            ids = torch.from_numpy(seq[None, :-1]).to(DEVICE)
            logits = model(ids)[0, len(r.prompt) - 1:].float()
            top2 = logits.topk(2, dim=-1).values
            gaps.append((top2[:, 0] - top2[:, 1]).median().item())
            emitted = logits.gather(
                1, torch.from_numpy(np.asarray(r.output)).to(DEVICE)[:, None])[:, 0]
            worst = max(worst, (top2[:, 0] - emitted).max().item())
            top1 += (emitted >= top2[:, 0]).sum().item()
            spread.append(logits.std(dim=-1).mean().item())
    print(f"teacher-forced: worst (max logit - emitted logit) = {worst:.4f} "
          f"(margin {MARGIN}); emitted token is the dense argmax for {top1} "
          f"of {useful}; median top1-top2 gap {np.median(gaps):.4f}; "
          f"mean logit std {np.mean(spread):.4f}", flush=True)
    if not worst <= MARGIN:
        raise AssertionError(f"teacher-forced check: an emitted token trails "
                             f"the maximum logit by {worst} > {MARGIN}")

    # device times of the engine's two programs at the wave's shapes
    caches = eng.caches
    tables = caches["tables"]
    ids = torch.from_numpy(np.stack([prompt(bucket) for _ in range(4)]))
    sub = {"kv": caches["kv"], "tables": tables[:4]}
    prefill_ms = cuda_ms(lambda: model._decode_chunk(ids.to(DEVICE), sub, 0,
                                                     None, None), 5, 1)
    slots = ENGINE["max_batch"]
    ctx = bucket + WAVE_NEW[1]
    toks = torch.zeros(slots, dtype=torch.long, device=DEVICE)
    pos = torch.full((slots,), ctx - 1, dtype=torch.int32, device=DEVICE)
    step_ms = cuda_ms(lambda: model.paged_token_step(toks, caches, pos), 20, 3)
    print(f"serving [{card}]: useful_tokens_per_s={useful / wall:.1f} "
          f"({useful} tokens in {wall:.3f}s, {len(reqs)} requests, {slots} "
          f"slots) prefill_ms={prefill_ms:.3f} (4 x {bucket} tokens, {L} "
          f"layers) decode_ms_per_step={step_ms:.3f} ({slots} rows at "
          f"context {ctx})", flush=True)
    return k1_launches, k4_launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np
    import torch.nn.functional as F

    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.2f}s", flush=True)
    for name in _build.KERNELS:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    k1 = phase_k1(torch, F, ops)
    k4 = phase_k4(torch, ops)
    k1_launches, k4_launches = phase_serving(torch, np, ops, card)

    kernels = [
        dict(name="flash_fwd", route="cuda",
             source="paddle_tpu_torch/ops/csrc/flash_fwd.cu",
             replaces="paddle_tpu/ops/flash_attention.py:117",
             launches=k1_launches, **k1),
        dict(name="paged_decode", route="cuda",
             source="paddle_tpu_torch/ops/csrc/paged_decode.cu",
             replaces="paddle_tpu/ops/paged_attention.py:174",
             launches=k4_launches, **k4),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
