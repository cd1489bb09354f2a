#!/usr/bin/env python3
"""Smoke run of paddle_tpu_torch on one CUDA card.

    python3 chip_smoke.py        # from the root of a checkout

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. the card's name and power limit; build every kernel from ops/csrc.
  2. K1 (flash attention forward, csrc/flash_fwd.cu) against its plain
     PyTorch version at the serving prefill shape and at GQA, ragged,
     end-aligned and strided (q, k, v as views of one [b, s, 3, h, d]
     buffer) shapes, in bf16 (max abs error <= 2e-2) and fp32 (<= 1e-4),
     with kernel, plain and SDPA times, the roofline bound and the
     kernel's own device time (device_ms: the chained calls queued behind
     a spin kernel and timed by CUDA events, so without the host's gaps).
  3. K4 (paged decode, csrc/paged_decode.cu) the same way, with lengths
     0, 1, one page, one 4-page chunk and up to 640, and device_ms of its
     split and merge kernels.
  4. K1 with its lse output (the training forward) against its plain
     version at the K1 cases, the training shape [2, 4096, 16/4, 128] and
     the MoE step's [8, 2048, 16/4, 64] (lse max abs error <= 5e-3 bf16 /
     1e-4 fp32, out as in 2), timed beside the no-lse path and SDPA's
     forward, with device_ms.
  5. K2/K3 (flash backward, csrc/flash_bwd.cu) against the plain backward
     on the same (q, k, v, o, lse, dout): the training shape and the MoE
     step's [8, 2048, 16/4, 64] (bf16), MHA, ragged 77 (not causal),
     end-aligned 200/520 at head_dim 64 and q, k, v as strided views of one
     [b, s, 3, h, d] buffer, each also in fp32; max abs error <= tol x
     max(1, max |plain|); at the training shape two runs must be bitwise
     equal; K2 and K3 times beside their bounds, the plain backward and
     SDPA's backward.
  6. serving: the llama-750M-class config at full width (12 layers), random
     weights from seed 0, through the legacy ContinuousBatchingEngine: a
     wave of 16 greedy requests with both exact and re-stepped prompts and
     one eos request. Checks token counts, that both kernels carried the
     wave (launch counts), that no training kernel ran (no autograd graph),
     and a teacher-forced check of every emitted token against the dense
     forward.
  7. training parity: a small fp32 Llama (hidden 512, 4/2 heads of 128, 2
     layers, vocab 1024, seq 200) takes 3 Engine steps on the card and on
     the CPU from the same weights; losses, parameters and AdamW moments
     must agree.
  8. training at full width and depth: the headline config of bench.py
     (bench_llama, llama_pretrain_tokens_per_sec_per_chip: 853M params,
     seq 4096, batch 2, bf16, fused CE, no remat), random weights from
     seed 0, Engine(lr=1e-4, clip 1.0): 2 warm-up and 8 timed steps on
     fresh batches (tokens/s, MFU, ms per step, peak memory), then 6 steps
     at lr 1e-3 on one batch whose loss must fall. The K1-lse, K2 and K3
     counters must show 16 launches a step, the serving K1 counter none.
  9. K5 (padded grouped matmul, csrc/grouped_matmul.cu), forward and its
     trans_w (dx) mode, and K6 (its dw) against their plain versions on a
     seeded skewed routing that leaves one expert without a token: the MoE
     step's shapes (x [36864, 1024] against w [8, 1024, 2816], [36864,
     2816] against [8, 2816, 1024], bf16), a small case (fp32 and bf16) and
     one whose k and n a 128 tile does not divide; error <= tol x max
     |plain|, the tileless expert's dw exactly 0; kernel, plain and
     library (torch._grouped_mm, or a per-expert torch.mm loop) times and
     the bound.
 10. MoE training parity: a small fp32 MoE Llama (4 experts, top-2, pgmm)
     takes 3 Engine steps on the card and on the CPU from the same
     weights; the same expert choices, and losses, parameters and moments
     within phase 7's tolerances.
 11. MoE training at full width and depth: the Mixtral-class config of
     bench.py bench_moe (640M params, 225M activated: 8 layers, hidden 1024,
     8 swiglu experts of 2816, top-2 GShard, batch 8 x seq 2048, bf16) with
     moe_dispatch="pgmm", Engine(lr=1e-4, clip 1.0): 2 warm-up and 8 timed
     steps on fresh batches (tokens/s, activated MFU, ms per step, peak
     memory, launches per step: K5 48, K6 24, K1-lse/K2/K3 8 each, serving
     K1 0), one step under set_sync_debug_mode (no synchronizing
     operation), then 6 steps at lr 1e-3 on one batch whose loss must fall.
The second-to-last line is a JSON object listing each kernel; the last is
{"ok": true, "device": {...}}. Without a CUDA device, or outside a checkout
of the repository, it exits non-zero before printing any result.
"""

import importlib
import json
import re
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
    ("strided", 2, 1024, 1024, 16, 16, 128, True),
]
# the train step's attention shape (bench.py:2013-2019 at batch 2)
TRAIN_SHAPE = ("train", 2, 4096, 4096, 16, 4, 128, True)
LSE_TOL = {"bfloat16": 5e-3, "float32": 1e-4}
# the MoE step's attention shape (MOE_CONFIG below: batch 8 x seq 2048, 16 q
# / 4 kv heads of 64)
MOE_ATTN_SHAPE = ("moe", 8, 2048, 2048, 16, 4, 64, True)
# K2/K3 cases; the training and MoE shapes run in bf16 only. "strided" (here
# and in K1_CASES) takes q, k and v as strided views of one [b, s, 3, h, d]
# buffer.
BWD_CASES = [
    TRAIN_SHAPE,
    MOE_ATTN_SHAPE,
    ("mha", 2, 1024, 1024, 16, 16, 128, True),
    ("ragged", 2, 77, 77, 16, 16, 128, False),
    ("end_aligned", 2, 200, 520, 16, 4, 64, True),
    ("strided", 2, 1024, 1024, 16, 16, 128, True),
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
# the headline training config (bench.py:2013-2019) at full width and
# depth; bench_llama's batch, sequence and step counts
TRAIN_CONFIG = dict(vocab_size=32000, hidden_size=2048,
                    intermediate_size=5632, num_hidden_layers=16,
                    num_attention_heads=16, num_key_value_heads=4,
                    max_position_embeddings=4096, dtype="bfloat16",
                    recompute=False, fused_ce=True, fused_ce_chunk=1024)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_WARMUP, TRAIN_STEPS = 2, 4096, 2, 8
# the card-vs-CPU parity config (fp32; seq 200 is ragged against 64-row
# tiles)
PARITY_CONFIG = dict(vocab_size=1024, hidden_size=512, intermediate_size=1024,
                     num_hidden_layers=2, num_attention_heads=4,
                     num_key_value_heads=2, max_position_embeddings=256)
PARITY_BATCH, PARITY_SEQ, PARITY_STEPS, PARITY_LR = 2, 200, 3, 1e-3
# the Mixtral-class MoE train step of bench.py bench_moe (:1749-1754) at
# full width and depth, with the dropless pgmm dispatch (docs/MOE_AB.md's
# pgmm arm): 8 swiglu experts, top-2 GShard gate; batch 8 x seq 2048
MOE_CONFIG = dict(vocab_size=32000, hidden_size=1024, intermediate_size=2816,
                  num_hidden_layers=8, num_attention_heads=16,
                  num_key_value_heads=4, max_position_embeddings=2048,
                  dtype="bfloat16", num_experts=8, moe_topk=2,
                  moe_dispatch="pgmm")
MOE_BATCH, MOE_SEQ, MOE_WARMUP, MOE_STEPS = 8, 2048, 2, 8
# K5/K6 cases: name, routed rows, experts, k, n, tile_m, dtypes; "main" is
# the train step's: 8 x 2048 tokens x top-2 = 32768 rows, padded to 36864
PGMM_CASES = [
    ("main", MOE_BATCH * MOE_SEQ * 2, 8, 1024, 2816, 512, ("bfloat16",)),
    ("small", 3000, 4, 256, 384, 512, ("float32", "bfloat16")),
    ("edge", 1000, 4, 136, 200, 256, ("float32", "bfloat16")),
]
# the MoE card-vs-CPU parity config (fp32, 4 experts, seq 200)
MOE_PARITY_CONFIG = dict(vocab_size=1024, hidden_size=256,
                         intermediate_size=512, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2,
                         max_position_embeddings=256, num_experts=4,
                         moe_dispatch="pgmm")


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _kernel_name(mangled):
    """'_ZN<n><namespace><n>dkv_tc_kernelILi128EEEv...' ->
    'dkv_tc_kernel<128>' (a kernel inside a namespace, as nvcc mangles
    the anonymous one; anything else is returned cut to 60 characters)."""
    m = re.match(r"_ZN(\d+)", mangled)
    i = m.end() + int(m.group(1)) if m else 0
    n = re.match(r"(\d+)", mangled[i:]) if m else None
    if n is None:
        return mangled[:60]
    j = i + n.end()
    name, rest = mangled[j:j + int(n.group(1))], mangled[j + int(n.group(1)):]
    args = (["float"] if rest.startswith("If") else []) + \
        (["bf16"] if rest.startswith("I13__nv_bfloat16") else []) + \
        re.findall(r"Li(\d+)E", rest.split("EEv")[0])
    return f"{name}<{','.join(args)}>"


def ptxas_summary(log):
    """(kernel, registers, spill-store bytes) for each function in an nvcc
    -Xptxas -v log."""
    out, fn, spill = [], "?", 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = _kernel_name(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append((fn, int(m.group(1)), spill))
    return out


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


def device_ms(torch, fn, iters=20, warmup=3):
    """The device time of ``fn`` per call, in ms, without the host's gaps
    between calls (which cuda_ms counts): a spin kernel holds the stream
    (about 0.1 s) while the host queues ``iters`` calls between two CUDA
    events, so the card runs them back to back. Raises if the card had
    reached the calls before the host had queued them all, since the time
    would then include the host again."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    queued = not start.query()
    torch.cuda.synchronize()
    if not queued:
        raise AssertionError("device_ms: the spin kernel ended before the "
                             "host had queued every call")
    return start.elapsed_time(end) / iters


def bound(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def causal_pairs(s_q, s_kv, causal):
    """(q, k) pairs a head attends: end-aligned causal rows see
    min(row + s_kv - s_q + 1, s_kv) columns."""
    if not causal:
        return float(s_q * s_kv)
    return float(sum(min(max(r + s_kv - s_q + 1, 0), s_kv)
                     for r in range(s_q)))


def sdpa(F, q, k, v, causal):
    """torch's SDPA on [b, s, h, d] tensors (the timed yardstick; the port
    never calls it), with the end-aligned causal mask."""
    import torch

    s_q, s_kv = q.shape[1], k.shape[1]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    gqa = q.shape[2] != k.shape[2]
    if causal and s_q != s_kv:
        # SDPA's is_causal is top-left aligned; pass the end-aligned mask
        mask = torch.ones(s_q, s_kv, dtype=torch.bool,
                          device=q.device).tril(s_kv - s_q)
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=gqa)
    return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                          enable_gqa=gqa)


def phase_k1(torch, F, ops):
    """K1 against its plain version; returns the main-path (prefill) row."""
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    row = None
    for dname in ("bfloat16", "float32"):
        dtype = getattr(torch, dname)
        for name, b, s_q, s_kv, hq, hkv, d, causal in K1_CASES:
            q, k, v = _case_inputs(torch, gen, dtype, name, b, s_q, s_kv, hq,
                                   hkv, d)
            out = ops.flash_attention(q, k, v, causal=causal)
            ref = ops.flash_attention_reference(q, k, v, causal)
            sync()
            err = (out.float() - ref.float()).abs().max().item()
            ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=causal))
            dev_ms = device_ms(
                torch, lambda: ops.flash_attention(q, k, v, causal=causal))
            plain_ms = cuda_ms(
                lambda: ops.flash_attention_reference(q, k, v, causal), 5, 1)
            library_ms = cuda_ms(lambda: sdpa(F, q, k, v, causal))
            pairs = causal_pairs(s_q, s_kv, causal)
            flops = 4 * d * hq * b * pairs
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
            bound_ms, bound_by = bound(flops, nbytes, dname)
            print(f"k1 case={name} dtype={dname} shape=[{b},{s_q}/{s_kv},"
                  f"{hq}/{hkv},{d}] causal={causal} max_abs_err={err:.3e} "
                  f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"library_ms={library_ms:.4f} bound_ms={bound_ms:.5f} "
                  f"bound_by={bound_by} device_ms={dev_ms:.4f}", flush=True)
            if not err <= TOL[dname]:
                raise AssertionError(f"K1 {name} {dname}: max abs error "
                                     f"{err} > {TOL[dname]}")
            if name == "prefill" and dname == "bfloat16":
                row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by,
                           library_ms=library_ms, device_ms=dev_ms)
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
            dev_ms = device_ms(torch, lambda: ops.paged_decode_attention(*args),
                               50, 5)
            plain_ms = cuda_ms(lambda: ops.paged_decode_reference(*args), 5, 1)
            ntok = sum(lens_list)
            flops = 4 * d * hq * ntok
            nbytes = (2 * ntok * hkv * d * kc.element_size()
                      + 2 * q.numel() * q.element_size()
                      + tables.numel() * 4 + lens.numel() * 4)
            bound_ms, bound_by = bound(flops, nbytes, dname)
            print(f"k4 dtype={dname} rows={b} heads={hq}/{hkv} d={d} "
                  f"page={page} lens={lens_list} max_abs_err={err:.3e} "
                  f"ms={ms:.4f} device_ms={dev_ms:.4f} plain_ms="
                  f"{plain_ms:.4f} library_ms=null bound_ms={bound_ms:.5f} "
                  f"bound_by={bound_by}", flush=True)
            if not err <= TOL[dname]:
                raise AssertionError(f"K4 {dname} hkv={hkv}: max abs error "
                                     f"{err} > {TOL[dname]}")
            if dname == "bfloat16" and hkv == 16:
                row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by,
                           library_ms=None, device_ms=dev_ms)
    return row


def _inputs(torch, gen, dtype, b, s_q, s_kv, hq, hkv, d):
    def rnd(*shape):
        return torch.randn(*shape, device=DEVICE, generator=gen).to(dtype)
    return (rnd(b, s_q, hq, d), rnd(b, s_kv, hkv, d), rnd(b, s_kv, hkv, d))


def _case_inputs(torch, gen, dtype, name, b, s_q, s_kv, hq, hkv, d):
    """q, k, v of a kernel case; "strided" takes them as strided views of
    one [b, s, 3, h, d] buffer (s_q = s_kv, hq = hkv)."""
    if name == "strided":
        qkv = torch.randn(b, s_q, 3, hq, d, device=DEVICE,
                          generator=gen).to(dtype)
        return qkv.unbind(2)
    return _inputs(torch, gen, dtype, b, s_q, s_kv, hq, hkv, d)


def phase_k1_lse(torch, F, ops):
    """K1 with its lse output against the plain forward-with-lse; returns
    the main-path (training shape) row."""
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    row = None
    cases = [(c, dn) for dn in ("bfloat16", "float32") for c in K1_CASES]
    cases += [(TRAIN_SHAPE, "bfloat16"), (MOE_ATTN_SHAPE, "bfloat16")]
    for (name, b, s_q, s_kv, hq, hkv, d, causal), dname in cases:
        dtype = getattr(torch, dname)
        q, k, v = _case_inputs(torch, gen, dtype, name, b, s_q, s_kv, hq,
                               hkv, d)
        out, lse = ops.flash_attention_forward(q, k, v, causal=causal)
        ref, ref_lse = ops.flash_attention_reference_lse(q, k, v, causal)
        sync()
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        del ref, ref_lse
        ms = cuda_ms(lambda: ops.flash_attention_forward(q, k, v, causal=causal))
        dev_ms = device_ms(
            torch, lambda: ops.flash_attention_forward(q, k, v, causal=causal))
        nolse_ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=causal))
        plain_ms = cuda_ms(
            lambda: ops.flash_attention_reference_lse(q, k, v, causal), 5, 1)
        library_ms = cuda_ms(lambda: sdpa(F, q, k, v, causal))
        flops = 4 * d * hq * b * causal_pairs(s_q, s_kv, causal)
        nbytes = ((2 * q.numel() + k.numel() + v.numel()) * q.element_size()
                  + lse.numel() * 4)
        bound_ms, bound_by = bound(flops, nbytes, dname)
        print(f"k1_lse case={name} dtype={dname} shape=[{b},{s_q}/{s_kv},"
              f"{hq}/{hkv},{d}] causal={causal} max_abs_err={err:.3e} "
              f"lse_max_abs_err={lse_err:.3e} ms={ms:.4f} "
              f"no_lse_ms={nolse_ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={library_ms:.4f} bound_ms={bound_ms:.5f} "
              f"bound_by={bound_by} device_ms={dev_ms:.4f}", flush=True)
        if not (err <= TOL[dname] and lse_err <= LSE_TOL[dname]):
            raise AssertionError(f"K1-lse {name} {dname}: out error {err} "
                                 f"(tol {TOL[dname]}), lse error {lse_err} "
                                 f"(tol {LSE_TOL[dname]})")
        if name == "train":
            row = dict(max_abs_err=max(err, lse_err), ms=ms,
                       plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=library_ms,
                       device_ms=dev_ms)
        del q, k, v, out, lse
    torch.cuda.empty_cache()
    return row


def phase_k2k3(torch, F, ops):
    """K2 and K3 against the plain backward on the same (q, k, v, o, lse,
    dout); returns the main-path (training shape, bf16) rows."""
    # the module (the package attribute of that name is the function)
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    rows = None
    cases = [(c, dn) for c in BWD_CASES for dn in ("bfloat16", "float32")
             if not (c in (TRAIN_SHAPE, MOE_ATTN_SHAPE) and dn == "float32")]
    for (name, b, s_q, s_kv, hq, hkv, d, causal), dname in cases:
        dtype = getattr(torch, dname)
        q, k, v = _case_inputs(torch, gen, dtype, name, b, s_q, s_kv, hq,
                               hkv, d)
        do = torch.randn(b, s_q, hq, d, device=DEVICE, generator=gen).to(dtype)
        o, lse = ops.flash_attention_forward(q, k, v, causal=causal)
        grads = ops.flash_attention_backward(q, k, v, o, lse, do,
                                             causal=causal)
        refs = ops.flash_attention_backward_reference(q, k, v, o, lse, do,
                                                      causal)
        sync()
        same = None
        if name == "train":   # K2 and K3 again on the same inputs: bitwise
            again = ops.flash_attention_backward(q, k, v, o, lse, do,
                                                 causal=causal)
            same = all(torch.equal(a, r) for a, r in zip(grads, again))
            del again
        errs = {}
        for gname, a, r in zip(("dq", "dk", "dv"), grads, refs):
            raw = (a.float() - r.float()).abs().max().item()
            scale_ = max(1.0, r.float().abs().max().item())
            errs[gname] = (raw, raw / scale_)
        del grads, refs
        scale = d ** -0.5
        _, delta = fa._launch_dq(q, k, v, o, lse, do, causal, scale)
        dq_ms = cuda_ms(lambda: fa._launch_dq(q, k, v, o, lse, do, causal,
                                              scale))
        dkv_ms = cuda_ms(lambda: fa._launch_dkv(q, k, v, do, lse, delta,
                                                causal, scale))
        plain_ms = cuda_ms(lambda: ops.flash_attention_backward_reference(
            q, k, v, o, lse, do, causal), 3, 1)
        qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q, k, v))
        lib_out = sdpa(F, qg, kg, vg, causal)
        do_t = do.transpose(1, 2)
        library_ms = cuda_ms(lambda: lib_out.backward(do_t,
                                                      retain_graph=True))
        del qg, kg, vg, lib_out
        pairs = causal_pairs(s_q, s_kv, causal)
        es = q.element_size()
        row_bytes = b * hq * s_q * 4          # lse or delta, fp32
        dq_bytes = ((4 * q.numel() + k.numel() + v.numel()) * es
                    + 2 * row_bytes)          # q, o, dO, dQ; k, v; lse, d
        dkv_bytes = ((2 * q.numel() + 4 * k.numel()) * es
                     + 2 * row_bytes)         # q, dO; k, v, dK, dV
        dq_bound = bound(6 * d * pairs * hq * b, dq_bytes, dname)
        dkv_bound = bound(8 * d * pairs * hq * b, dkv_bytes, dname)
        err_text = " ".join(f"{g}_err={r:.3e} {g}_rel={rel:.3e}"
                            for g, (r, rel) in errs.items())
        print(f"k2k3 case={name} dtype={dname} shape=[{b},{s_q}/{s_kv},"
              f"{hq}/{hkv},{d}] causal={causal} {err_text} "
              f"dq_ms={dq_ms:.4f} dkv_ms={dkv_ms:.4f} plain_ms={plain_ms:.4f}"
              f" library_ms={library_ms:.4f} (SDPA backward, dq+dk+dv) "
              f"dq_bound_ms={dq_bound[0]:.5f} ({dq_bound[1]}) "
              f"dkv_bound_ms={dkv_bound[0]:.5f} ({dkv_bound[1]})"
              + ("" if same is None else f" bitwise_deterministic={same}"),
              flush=True)
        worst = max(rel for _, rel in errs.values())
        if not worst <= TOL[dname]:
            raise AssertionError(f"K2/K3 {name} {dname}: relative max abs "
                                 f"error {worst} > {TOL[dname]}")
        if same is False:
            raise AssertionError(f"K2/K3 {name}: two runs on the same inputs "
                                 f"differ")
        if name == "train":
            rows = (dict(max_abs_err=errs["dq"][0], ms=dq_ms,
                         plain_ms=plain_ms, bound_ms=dq_bound[0],
                         bound_by=dq_bound[1], library_ms=library_ms),
                    dict(max_abs_err=max(errs["dk"][0], errs["dv"][0]),
                         ms=dkv_ms, plain_ms=plain_ms, bound_ms=dkv_bound[0],
                         bound_by=dkv_bound[1], library_ms=library_ms))
        del q, k, v, do, o, lse, delta
        torch.cuda.empty_cache()
    return rows


def _engine_steps(torch, Engine, model, batches, lr):
    eng = Engine(model, lr=lr)
    losses = [eng.step(ids, ids) for ids in batches]
    return eng, torch.stack(losses).cpu()


def phase_train_parity(torch, np, ops):
    """The same 3 Engine steps on the card and on the CPU from the same
    weights (fp32): the card path runs K1-lse, K2 and K3, the CPU path
    their plain versions."""
    from paddle_tpu_torch.distributed import Engine
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(**PARITY_CONFIG)
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=5)
    card = LlamaForCausalLM(cfg, device=DEVICE, seed=5)
    with torch.no_grad():
        for pc, pg in zip(cpu.parameters(), card.parameters()):
            pg.copy_(pc)
    rng = np.random.default_rng(5)
    batches = [torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (PARITY_BATCH, PARITY_SEQ)))
        for _ in range(PARITY_STEPS)]
    counts0 = (ops.flash_attention_forward.launches,
               ops.flash_attention_backward.launches_dq,
               ops.flash_attention_backward.launches_dkv)
    ec, lc = _engine_steps(torch, Engine, cpu, batches, PARITY_LR)
    eg, lg = _engine_steps(torch, Engine, card,
                           [x.to(DEVICE) for x in batches], PARITY_LR)
    sync()
    counts = (ops.flash_attention_forward.launches - counts0[0],
              ops.flash_attention_backward.launches_dq - counts0[1],
              ops.flash_attention_backward.launches_dkv - counts0[2])
    loss_rel = ((lg - lc).abs() / lc.abs()).max().item()
    sc, sg = ec.state_dict(), eg.state_dict()
    worst = {}
    for key in ("model", "m", "v"):
        w = (0.0, "")
        for name, a in sc[key].items():
            err = (sg[key][name].cpu() - a).abs().max().item()
            if key != "model":   # moments: relative to their magnitude
                err /= max(a.abs().max().item(), 1e-30)
            w = max(w, (err, name))
        worst[key] = w
    # Adam normalises each update: an element whose gradient is rounding
    # noise can move by up to lr per step either way, so 2 * lr * steps
    # bounds a parameter's difference; the moments are linear in the
    # gradients and must agree to fp32 reduction order (relative 1e-3)
    p_tol = 2 * PARITY_LR * PARITY_STEPS
    print(f"train parity (card vs CPU, fp32, {PARITY_STEPS} steps, hidden "
          f"{cfg.hidden_size}, seq {PARITY_SEQ}): losses card "
          f"{[round(x, 6) for x in lg.tolist()]} cpu "
          f"{[round(x, 6) for x in lc.tolist()]} max_rel={loss_rel:.3e}; "
          f"params worst abs {worst['model'][0]:.3e} ({worst['model'][1]}, "
          f"tol {p_tol}); m worst rel {worst['m'][0]:.3e} "
          f"({worst['m'][1]}); v worst rel {worst['v'][0]:.3e} "
          f"({worst['v'][1]}); card launches k1_lse/k2/k3={counts}",
          flush=True)
    L = cfg.num_hidden_layers * PARITY_STEPS
    if not (loss_rel <= 1e-4 and worst["model"][0] <= p_tol
            and worst["m"][0] <= 1e-3 and worst["v"][0] <= 1e-3
            and min(counts) >= L):
        raise AssertionError("training parity card vs CPU failed")


def phase_train_full(torch, np, ops, card):
    """The headline config trained at full width and depth; returns the
    main-path launch counts (K1-lse, K2, K3)."""
    from paddle_tpu_torch.distributed import Engine
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(**TRAIN_CONFIG)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=DEVICE, seed=0)
    eng = Engine(model, lr=1e-4, clip_norm=1.0)
    rng = np.random.default_rng(0)
    batches = [torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)).to(
            DEVICE) for _ in range(TRAIN_STEPS)]
    sync()
    print(f"train setup: {cfg.num_params() / 1e6:.1f}M params, "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    losses = [eng.step(batches[0], batches[0]) for _ in range(TRAIN_WARMUP)]
    sync()
    ops.flash_attention.launches = 0
    ops.flash_attention_forward.launches = 0
    ops.flash_attention_backward.launches_dq = 0
    ops.flash_attention_backward.launches_dkv = 0
    t0 = time.perf_counter()
    for ids in batches:
        losses.append(eng.step(ids, ids))
    last = losses[-1].item()    # one host read fences the chain
    wall = time.perf_counter() - t0
    counts = (ops.flash_attention_forward.launches,
              ops.flash_attention_backward.launches_dq,
              ops.flash_attention_backward.launches_dkv)
    serving_k1 = ops.flash_attention.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    vals = torch.stack(losses).float().cpu()
    tok_s = TRAIN_BATCH * TRAIN_SEQ * TRAIN_STEPS / wall
    L, H, Q = cfg.num_hidden_layers, cfg.num_attention_heads, cfg.head_dim
    flops_per_token = 6.0 * cfg.num_params() + 6.0 * L * (H * Q) * TRAIN_SEQ
    mfu = tok_s * flops_per_token / PEAK_FLOPS["bfloat16"]
    print(f"train [{card}]: tokens_per_s={tok_s:.1f} mfu={mfu:.4f} "
          f"ms_per_step={wall / TRAIN_STEPS * 1e3:.2f} peak_mem_gb="
          f"{peak_gb:.2f} ({cfg.num_params() / 1e6:.1f}M params, batch "
          f"{TRAIN_BATCH} x seq {TRAIN_SEQ}, {cfg.dtype}, fused CE, no remat); "
          f"losses {[round(x, 4) for x in vals.tolist()]}; launches "
          f"k1_lse/k2/k3={counts} serving_k1={serving_k1}", flush=True)
    need = TRAIN_STEPS * L
    if not torch.isfinite(vals).all():
        raise AssertionError(f"non-finite training loss: {vals.tolist()}")
    if not 9.0 <= vals[0].item() <= 12.5:
        raise AssertionError(f"first loss {vals[0].item()} outside [9, 12.5]"
                             f" (ln {cfg.vocab_size} = 10.37)")
    if min(counts) < need or serving_k1 != 0:
        raise AssertionError(f"kernels did not carry the train step: "
                             f"{counts} < {need} or serving K1 ran "
                             f"{serving_k1} times")
    # learning: 6 steps at lr 1e-3 on one batch
    eng.lr = 1e-3
    fixed = [eng.step(batches[0], batches[0]) for _ in range(6)]
    first, final = fixed[0].item(), fixed[-1].item()
    print(f"train fixed batch (lr 1e-3, 6 steps): first loss {first:.4f} "
          f"last loss {final:.4f} (last {last:.4f} before)", flush=True)
    if not final < first:
        raise AssertionError(f"loss did not fall on a fixed batch: {first} "
                             f"-> {final}")
    del eng, model, batches
    torch.cuda.empty_cache()
    return counts


def _skewed_routing(torch, np, n_rows, e, k, empty, seed):
    """Top-k expert ids [n_rows] for n_rows / k tokens, k distinct experts
    a token from a seeded skewed draw (Gumbel top-k over probabilities
    falling from 2 to 1 across the experts) that gives expert ``empty`` no
    token. (The layout gives the pad tail to the last expert, so ``empty``
    must be another one for it to own no tile.)"""
    rng = np.random.default_rng(seed)
    p = np.linspace(2.0, 1.0, e)
    p[empty] = 0.0
    with np.errstate(divide="ignore"):
        logp = np.log(p / p.sum())
    g = logp + rng.gumbel(size=(n_rows // k, e))
    top = np.argsort(-g, axis=1)[:, :k].reshape(-1)
    return torch.from_numpy(top.astype(np.int64)).to(DEVICE)


def _grouped_mm_library(torch, x, w, dout, gids, e, tile_m):
    """One PyTorch call computing each of K5, K5 over w^T and K6 on the
    same inputs (the timed yardstick; the port never calls it):
    torch._grouped_mm (bf16 only; its dw comes out in bf16) where this
    torch has it, else a loop of per-expert torch.mm. Returns (name, fwd,
    dx, dw) callables. Each expert's rows run to the end of its tiles, the
    last expert's through the pad tail, as in the layout."""
    p = x.shape[0]
    counts = torch.bincount(gids.long(), minlength=e) * tile_m
    ends = torch.cumsum(counts, 0).to(torch.int32)
    if hasattr(torch, "_grouped_mm") and x.dtype == torch.bfloat16:
        return ("torch._grouped_mm",
                lambda: torch._grouped_mm(x, w, offs=ends),
                lambda: torch._grouped_mm(dout, w.transpose(1, 2),
                                          offs=ends),
                lambda: torch._grouped_mm(x.t(), dout, offs=ends))
    bounds = [0] + ends.tolist()
    spans = [(i, bounds[i], bounds[i + 1]) for i in range(e)]
    assert bounds[-1] == p

    def loop(fn):
        return lambda: [fn(i, a, b) for i, a, b in spans]
    return ("per-expert torch.mm loop",
            loop(lambda i, a, b: torch.mm(x[a:b], w[i])),
            loop(lambda i, a, b: torch.mm(dout[a:b], w[i].t())),
            loop(lambda i, a, b: torch.mm(x[a:b].t(), dout[a:b])))


def phase_pgmm(torch, np, ops):
    """K5 (forward and its trans_w dx mode) and K6 against their plain
    versions on a skewed padded layout with a tileless expert; returns the
    main-path rows (bf16, x [36864, 1024] against w [8, 1024, 2816])."""
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    rows = {}
    for name, n_rows, e, k, n, tile_m, dnames in PGMM_CASES:
        empty = e // 2
        flat_e = _skewed_routing(torch, np, n_rows, e, 2, empty, 7)
        order, pos_sorted, gids, p = ops.padded_group_layout(flat_e, e,
                                                             n_rows, tile_m)
        pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
        if (gids == empty).any().item():
            raise AssertionError(f"pgmm {name}: expert {empty} owns a tile")
        shapes = [(k, n)] if name != "main" else [(k, n), (n, k)]
        for dname in dnames:
            dtype = getattr(torch, dname)
            for kk, nn in shapes:
                def rnd(*shape):
                    return torch.randn(*shape, device=DEVICE,
                                       generator=gen).to(dtype)
                # pad rows are zero, as the MoE layer's x_pad
                x = torch.zeros(p, kk, device=DEVICE, dtype=dtype)
                x[pos] = rnd(n_rows, kk)
                dout = torch.zeros(p, nn, device=DEVICE, dtype=dtype)
                dout[pos] = rnd(n_rows, nn)
                w = (rnd(e, kk, nn) * kk ** -0.5).to(dtype)
                calls = {
                    "k5": (lambda: ops.pgmm_raw(x, w, gids, tile_m),
                           lambda: ops.pgmm_reference(x, w, gids, tile_m)),
                    "k5_dx": (lambda: ops.pgmm_raw(dout, w, gids, tile_m,
                                                   trans_w=True),
                              lambda: ops.pgmm_reference(dout, w, gids,
                                                         tile_m, True)),
                    "k6": (lambda: ops.pgmm_dw(x, dout, gids, e, tile_m),
                           lambda: ops.pgmm_dw_reference(x, dout, gids, e,
                                                         tile_m)),
                }
                lib_name, *lib = _grouped_mm_library(torch, x, w, dout, gids,
                                                     e, tile_m)
                es = x.element_size()
                work = {  # (flops, bytes): each input read once, output once
                    "k5": (2 * p * kk * nn,
                           (p * kk + e * kk * nn + p * nn) * es + gids.numel() * 4),
                    "k5_dx": (2 * p * kk * nn,
                              (p * nn + e * kk * nn + p * kk) * es
                              + gids.numel() * 4),
                    "k6": (2 * p * kk * nn, (p * kk + p * nn) * es
                           + e * kk * nn * 4 + gids.numel() * 4),
                }
                for (cname, (kern, plain)), lib_fn in zip(calls.items(), lib):
                    out = kern()
                    ref = plain()
                    sync()
                    abs_err = (out.float() - ref.float()).abs().max().item()
                    err = abs_err / ref.float().abs().max().item()
                    zero_ok = True
                    if cname == "k6":
                        zero_ok = bool((out[empty] == 0).all().item())
                    del out, ref
                    ms = cuda_ms(kern, 10, 2)
                    plain_ms = cuda_ms(plain, 3, 1)
                    library_ms = cuda_ms(lib_fn, 10, 2)
                    bound_ms, bound_by = bound(*work[cname], dname)
                    print(f"pgmm {cname} case={name} dtype={dname} P={p} "
                          f"k={kk} n={nn} experts={e} tile_m={tile_m} "
                          f"max_abs_err={abs_err:.3e} rel_err={err:.3e} "
                          f"ms={ms:.4f} "
                          f"plain_ms={plain_ms:.4f} library_ms="
                          f"{library_ms:.4f} ({lib_name}) bound_ms="
                          f"{bound_ms:.5f} bound_by={bound_by}"
                          + (f" tileless_expert_zero={zero_ok}"
                             if cname == "k6" else ""), flush=True)
                    if not (err <= TOL[dname] and zero_ok):
                        raise AssertionError(
                            f"pgmm {cname} {name} {dname}: relative error "
                            f"{err} (tol {TOL[dname]}), tileless expert "
                            f"zero: {zero_ok}")
                    if name == "main" and (kk, nn) == (k, n) \
                            and cname in ("k5", "k6"):
                        rows[cname] = dict(max_abs_err=abs_err, ms=ms,
                                           plain_ms=plain_ms,
                                           bound_ms=bound_ms,
                                           bound_by=bound_by,
                                           library_ms=library_ms)
                del x, dout, w, calls, lib
                torch.cuda.empty_cache()
    return rows["k5"], rows["k6"]


def _recording_routes(mod, seen):
    """Patch routed_ffn to append, for every forward, its top-k expert ids
    (on the host) and the smallest gap between rank-1/rank-2 and
    rank-k/rank-k+1 gate probabilities; returns the real function."""
    real = mod.routed_ffn

    def spy(tokens, probs, expert_fn, k, *a, **kw):
        s = probs.detach().float().sort(dim=-1, descending=True)
        gap = min((s.values[:, 0] - s.values[:, 1]).min().item(),
                  (s.values[:, k - 1] - s.values[:, k]).min().item())
        seen.append((s.indices[:, :k].cpu(), gap))
        return real(tokens, probs, expert_fn, k, *a, **kw)
    mod.routed_ffn = spy
    return real


def phase_moe_parity(torch, np, ops):
    """3 Engine steps of a tiny fp32 MoE Llama on the card and on the CPU
    from the same weights: the card path runs K5/K6 (and K1-lse/K2/K3), the
    CPU path their plain versions."""
    from paddle_tpu_torch.distributed import Engine
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    moe_mod = importlib.import_module(
        "paddle_tpu_torch.incubate.distributed.models.moe.moe_layer")
    cfg = LlamaConfig(**MOE_PARITY_CONFIG)
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=8)
    card = LlamaForCausalLM(cfg, device=DEVICE, seed=8)
    with torch.no_grad():
        for pc, pg in zip(cpu.parameters(), card.parameters()):
            pg.copy_(pc)
    rng = np.random.default_rng(8)
    batches = [torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (PARITY_BATCH, PARITY_SEQ)))
        for _ in range(PARITY_STEPS)]
    routes = {"cpu": [], "card": []}
    real = _recording_routes(moe_mod, routes["cpu"])
    ec, lc = _engine_steps(torch, Engine, cpu, batches, PARITY_LR)
    n5, n6 = ops.pgmm.launches, ops.pgmm_dw.launches
    moe_mod.routed_ffn = real
    _recording_routes(moe_mod, routes["card"])
    eg, lg = _engine_steps(torch, Engine, card,
                           [x.to(DEVICE) for x in batches], PARITY_LR)
    sync()
    counts = (ops.pgmm.launches - n5, ops.pgmm_dw.launches - n6)
    moe_mod.routed_ffn = real
    # the gates' fp32 matmuls round differently on the two devices, so a
    # near-tie could route a token elsewhere: count the choices that differ
    flips = sum(int((a != b).sum()) for (a, _), (b, _) in
                zip(routes["cpu"], routes["card"]))
    gap = min(g for _, g in routes["cpu"])
    loss_rel = ((lg - lc).abs() / lc.abs()).max().item()
    sc, sg = ec.state_dict(), eg.state_dict()
    worst = {}
    for key in ("model", "m", "v"):
        w = (0.0, "")
        for name, a in sc[key].items():
            err = (sg[key][name].cpu() - a).abs().max().item()
            if key != "model":
                err /= max(a.abs().max().item(), 1e-30)
            w = max(w, (err, name))
        worst[key] = w
    p_tol = 2 * PARITY_LR * PARITY_STEPS   # as phase_train_parity derives
    L = cfg.num_hidden_layers * PARITY_STEPS
    print(f"moe parity (card vs CPU, fp32, {PARITY_STEPS} steps, "
          f"{cfg.num_experts} experts top-2 pgmm, hidden {cfg.hidden_size}, "
          f"seq {PARITY_SEQ}): losses card {[round(x, 6) for x in lg.tolist()]}"
          f" cpu {[round(x, 6) for x in lc.tolist()]} max_rel={loss_rel:.3e};"
          f" params worst abs {worst['model'][0]:.3e} ({worst['model'][1]}, "
          f"tol {p_tol}); m worst rel {worst['m'][0]:.3e} ({worst['m'][1]}); "
          f"v worst rel {worst['v'][0]:.3e} ({worst['v'][1]}); routing: "
          f"{flips} of {sum(a.numel() for a, _ in routes['cpu'])} expert "
          f"choices differ, smallest top-k gap (CPU) {gap:.3e}; card "
          f"launches k5/k6={counts}", flush=True)
    if not (loss_rel <= 1e-4 and worst["model"][0] <= p_tol
            and worst["m"][0] <= 1e-3 and worst["v"][0] <= 1e-3
            and counts == (6 * L, 3 * L) and flips == 0
            and len(routes["card"]) == len(routes["cpu"]) == L):
        raise AssertionError("MoE training parity card vs CPU failed")


def _sync_count(torch, fn):
    """Run fn under torch.cuda.set_sync_debug_mode("warn"); returns the
    messages of the synchronizing operations PyTorch reported."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return [str(w.message) for w in seen
            if "synchroniz" in str(w.message).lower()
            and "prototype" not in str(w.message)]


def moe_flops_per_token(cfg, model, seq):
    """bench.py:1773-1778: activated parameters (expert weights counted at
    their top-k share) and 6 n_act + 6 L hidden seq FLOPs a token."""
    n_total = sum(p.numel() for p in model.parameters())
    n_exp = sum(p.numel() for name, p in model.named_parameters()
                if ".experts." in name)
    n_act = n_total - n_exp * (1.0 - cfg.moe_topk / cfg.num_experts)
    fpt = 6.0 * n_act + 6.0 * cfg.num_hidden_layers * cfg.hidden_size * seq
    return n_total, n_act, fpt


def phase_moe_train(torch, np, ops, card):
    """The Mixtral-class MoE step trained at full width and depth; returns
    the main-path launch counts (K5, K6) of the timed steps."""
    from paddle_tpu_torch.distributed import Engine
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(**MOE_CONFIG)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=DEVICE, seed=0)
    eng = Engine(model, lr=1e-4, clip_norm=1.0)
    rng = np.random.default_rng(0)
    batches = [torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (MOE_BATCH, MOE_SEQ)).astype(np.int32)).to(
            DEVICE) for _ in range(MOE_STEPS)]
    n_total, n_act, fpt = moe_flops_per_token(cfg, model, MOE_SEQ)
    sync()
    print(f"moe train setup: {n_total / 1e6:.1f}M params, "
          f"{n_act / 1e6:.1f}M activated, "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    losses = [eng.step(batches[0], batches[0]) for _ in range(MOE_WARMUP)]
    sync()
    for fn in (ops.flash_attention, ops.flash_attention_forward, ops.pgmm,
               ops.pgmm_dw):
        fn.launches = 0
    ops.flash_attention_backward.launches_dq = 0
    ops.flash_attention_backward.launches_dkv = 0
    t0 = time.perf_counter()
    for ids in batches:
        losses.append(eng.step(ids, ids))
    last = losses[-1].item()    # one host read fences the chain
    wall = time.perf_counter() - t0
    k5, k6 = ops.pgmm.launches, ops.pgmm_dw.launches
    attn = (ops.flash_attention_forward.launches,
            ops.flash_attention_backward.launches_dq,
            ops.flash_attention_backward.launches_dkv)
    serving_k1 = ops.flash_attention.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    vals = torch.stack(losses).float().cpu()
    tok_s = MOE_BATCH * MOE_SEQ * MOE_STEPS / wall
    mfu = tok_s * fpt / PEAK_FLOPS["bfloat16"]
    per_step = [c / MOE_STEPS for c in (k5, k6, *attn)]
    print(f"moe train [{card}]: tokens_per_s={tok_s:.1f} "
          f"activated_mfu={mfu:.4f} ms_per_step={wall / MOE_STEPS * 1e3:.2f} "
          f"peak_mem_gb={peak_gb:.2f} ({n_total / 1e6:.1f}M params, "
          f"{n_act / 1e6:.1f}M activated, {cfg.num_experts} experts top-"
          f"{cfg.moe_topk} pgmm, batch {MOE_BATCH} x seq {MOE_SEQ}, "
          f"{cfg.dtype}); losses {[round(x, 4) for x in vals.tolist()]}; "
          f"launches per step k5/k6/k1_lse/k2/k3={per_step} "
          f"serving_k1={serving_k1}", flush=True)
    L = cfg.num_hidden_layers
    if per_step != [6 * L, 3 * L, L, L, L] or serving_k1 != 0:
        raise AssertionError(f"kernels did not carry the MoE step: per step "
                             f"{per_step} != {[6 * L, 3 * L, L, L, L]} or "
                             f"serving K1 ran {serving_k1} times")
    if not torch.isfinite(vals).all():
        raise AssertionError(f"non-finite MoE loss: {vals.tolist()}")
    if not 9.0 <= vals[0].item() <= 12.5:
        raise AssertionError(f"first MoE loss {vals[0].item()} outside "
                             f"[9, 12.5]")
    syncs = _sync_count(torch, lambda: eng.step(batches[1], batches[1]))
    print(f"moe step under set_sync_debug_mode: {len(syncs)} synchronizing "
          f"operations", flush=True)
    for msg in syncs[:5]:
        print(f"  {msg[:160]}", flush=True)
    if syncs:
        raise AssertionError(f"the MoE step synchronized {len(syncs)} times")
    eng.lr = 1e-3
    fixed = [eng.step(batches[0], batches[0]) for _ in range(6)]
    first, final = fixed[0].item(), fixed[-1].item()
    print(f"moe fixed batch (lr 1e-3, 6 steps): first loss {first:.4f} "
          f"last loss {final:.4f} (last {last:.4f} before)", flush=True)
    if not final < first:
        raise AssertionError(f"MoE loss did not fall on a fixed batch: "
                             f"{first} -> {final}")
    del eng, model, batches
    torch.cuda.empty_cache()
    return k5, k6


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
    ops.flash_attention_forward.launches = 0
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
    if ops.flash_attention_forward.launches != 0:
        raise AssertionError(
            f"serving built an autograd graph: the training forward (K1 with "
            f"lse) ran {ops.flash_attention_forward.launches} times")
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
        for fn, regs, spill in ptxas_summary(_build.build_log(name)):
            print(f"  {name}: {fn} registers={regs} spill_store_bytes="
                  f"{spill}", flush=True)

    k1 = phase_k1(torch, F, ops)
    k4 = phase_k4(torch, ops)
    k1_lse = phase_k1_lse(torch, F, ops)
    k2, k3 = phase_k2k3(torch, F, ops)
    k1_launches, k4_launches = phase_serving(torch, np, ops, card)
    phase_train_parity(torch, np, ops)
    lse_launches, k2_launches, k3_launches = phase_train_full(torch, np, ops,
                                                              card)
    k5, k6 = phase_pgmm(torch, np, ops)
    phase_moe_parity(torch, np, ops)
    k5_launches, k6_launches = phase_moe_train(torch, np, ops, card)

    kernels = [
        dict(name="flash_fwd", route="cuda",
             source="paddle_tpu_torch/ops/csrc/flash_fwd.cu",
             replaces="paddle_tpu/ops/flash_attention.py:117",
             launches=k1_launches, **k1),
        dict(name="flash_fwd_lse", route="cuda",
             source="paddle_tpu_torch/ops/csrc/flash_fwd.cu",
             replaces="paddle_tpu/ops/flash_attention.py:117",
             launches=lse_launches, **k1_lse),
        dict(name="flash_bwd_dq", route="cuda",
             source="paddle_tpu_torch/ops/csrc/flash_bwd.cu",
             replaces="paddle_tpu/ops/flash_attention.py:337",
             launches=k2_launches, **k2),
        dict(name="flash_bwd_dkv", route="cuda",
             source="paddle_tpu_torch/ops/csrc/flash_bwd.cu",
             replaces="paddle_tpu/ops/flash_attention.py:420",
             launches=k3_launches, **k3),
        dict(name="paged_decode", route="cuda",
             source="paddle_tpu_torch/ops/csrc/paged_decode.cu",
             replaces="paddle_tpu/ops/paged_attention.py:174",
             launches=k4_launches, **k4),
        dict(name="pgmm", route="cuda",
             source="paddle_tpu_torch/ops/csrc/grouped_matmul.cu",
             replaces="paddle_tpu/ops/grouped_matmul.py:38",
             launches=k5_launches, **k5),
        dict(name="pgmm_dw", route="cuda",
             source="paddle_tpu_torch/ops/csrc/grouped_matmul.cu",
             replaces="paddle_tpu/ops/grouped_matmul.py:93",
             launches=k6_launches, **k6),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
