#!/usr/bin/env python3
"""Smoke run of paddle_tpu_torch on one CUDA card.

    python3 chip_smoke.py        # from the root of a checkout

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. the card's name and power limit; build every kernel from ops/csrc.
  2. K1 (flash attention forward, csrc/flash_fwd.cu) against its plain
     PyTorch version at the serving prefill shape and at GQA, ragged,
     end-aligned and strided (q, k, v as views of one [b, s, 3, h, d]
     buffer) shapes, in bf16 (max abs error <= 2e-2) and fp32 (<= 1e-4),
     and at FP16_CASES (phase 41's BERT shape [32, 128, 12/12, 64], not
     causal, and the training shape [2, 4096, 16/4, 128], causal) in fp16
     (<= 5e-3: fp16's rounding of O(1) outputs, P rounded to fp16),
     with kernel, plain and SDPA times, the roofline bound and the
     kernel's own device time (device_ms: the chained calls queued behind
     a spin kernel and timed by CUDA events, so without the host's gaps).
  3. K4 (paged decode, csrc/paged_decode.cu) the same way, in bf16 and
     fp32: 8 rows of lengths 0 to 640 at 16/16 and 16/4 heads of 128 (the
     main-path row is 16/16 bf16), the serving wave's decode shape (8 rows
     of 384 to 640 tokens), a long GQA case (4 rows of up to 4096 tokens,
     32/8 heads), the fused engine's decode shape (128 rows of 49 to 128
     tokens, 8 pages each) and phase 57 (b)'s fleets' (4 rows of 17 to 64
     tokens, 8/8 heads of 64); each with device_ms and its share of the bound,
     also with the pages cold in L2 (cold_ms: calls cycle through input
     sets that need twice the L2 cache), zero rows exactly zero and two
     calls bitwise equal. Then 12 launches at the wave's shape captured in
     a CUDA graph and replayed after the lengths and tables are rewritten
     in place: bitwise equal to eager calls, with the replay's device time
     per launch.
  4. K1 with its lse output (the training forward) against its plain
     version at the K1 cases, the training shape [2, 4096, 16/4, 128],
     the MoE step's [8, 2048, 16/4, 64], the remat step's [4, 4096,
     16/4, 128], phase 30's GPT step [2, 2048, 32/32, 128] (q, k, v strided
     views), phase 32's BERT step [32, 128, 12/12, 64] (not causal) and
     phase 56 (b)'s per-rank shard and pp microbatch [1, 4096, 16/4,
     128], phase 57 (a)'s guarded step [8, 1024, 16/4, 64], 57 (b)'s
     trainer [4, 512, 8/8, 64] and 56 (b)'s ring attention stripe pairs
     over sep=2 [2, 1024, 16/4, 128] (stripes of fp32 tensors, each cast
     to a contiguous bf16 copy as the ring casts them; the diagonal pair
     causal, the other not) (bf16 at those ten), and at FP16_CASES in fp16 (lse max abs error
     <= 5e-3 bf16 and fp16 / 1e-4 fp32, out as in 2), timed beside the
     no-lse path and SDPA's forward, with device_ms.
  5. K2/K3 (flash backward, csrc/flash_bwd.cu) against the plain backward
     on the same (q, k, v, o, lse, dout): the training shape, the MoE
     step's, the remat step's, GPT's, BERT's, phase 56 (b)'s dp shard,
     phase 57's two steps and 56 (b)'s two ring stripe pairs (bf16), MHA,
     ragged 77
     (not causal),
     end-aligned 200/520 at head_dim 64 and q, k, v as strided views of one
     [b, s, 3, h, d] buffer, each also in fp32; FP16_CASES in fp16; max
     abs error <= tol x max(1, max |plain|) (fp16: 5e-3, dS rounded to
     fp16 before the dQ and dK products); at the training shape two runs
     must be bitwise
     equal; K2 and K3 times (chained and device_ms) beside their bounds,
     the plain backward and SDPA's backward.
  6. serving: the llama-750M-class config at full width (12 layers), random
     weights from seed 0, through the legacy ContinuousBatchingEngine: a
     wave of 16 greedy requests with both exact and re-stepped prompts and
     one eos request. Checks token counts, that both kernels carried the
     wave (launch counts), that no training kernel ran (no autograd graph),
     and a teacher-forced check of every emitted token against the dense
     forward: its logit within MARGIN_ULPS bf16 ulps of its position's
     maximum (the worst position printed with its top1-top2 gap).
  7. fused serving: the JAX package's big-batch arm (bench.py
     bench_serving_large_batch) on the same model: ContinuousBatchingEngine
     with 128 slots, max_len 128, page 16, the fused mega-step and the
     radix prefix cache (1153 pages); 256 greedy requests of 64-token
     prompts sharing a 48-token system prompt, 16-64 new tokens each, run
     cold and then warm. The decode step is captured once as a CUDA graph
     at construction; every decode block must replay it (no eager step, no
     recapture, K4 launches >= 12 a replay), every request must finish
     with its token count, and every emitted token must pass the
     teacher-forced check (batched), cold and in each warm stream that
     differs from its cold one. Prints tokens/s, prefill calls and packed
     rows, cached tokens matched, and the decode step's time replayed and
     eager at 128 rows (CUDA events).
  7b. K4 on int8 pools (QuantizedKVPool: int8 pages, an fp32 absmax scale
     per (page, kv head); the same kernel, dequantizing in its loop)
     against the dense-gather version on the same bytes and scales, at the
     main-path row's shape (bf16 and fp32 q) and the fused decode shape:
     max abs error within phase 3's tolerances, zero rows zero, two calls
     bitwise equal; ms, device_ms, cold_ms and the bound from the bytes
     the call must move (int8 rows, the pages' scales, q, out); then 12
     launches replayed from a CUDA graph after lengths, tables and scales
     change in place, bitwise equal to eager calls.
 7c. speculative decode and int8 KV: the JAX package's bench_speculative
     arm (bench.py:1526-1532, :1548-1552) at its TPU widths: the phase-6
     model, 8 slots, max_len 128, page 16, block 4, fused, prefix cache
     (73 pages), 16 requests of a random 8-token motif tiled 8 times,
     max_new (i % 4 + 1) x 16. Four engines on one model (spec off, spec
     k=4, int8, spec + int8) and twins of the two int8 engines serve the
     wave cold, then 2 warm waves each, interleaved (best of 2). Prints
     useful tokens/s, spec steps and replays, acceptance rate, K4 launches
     on fp and int8 pools, the int8 headroom (bf16 pool bytes over int8
     pages + scales, from the live tensors), how many spec streams differ
     from spec-off, and the replayed spec step against the eager one and
     the replayed greedy step (8 rows from context 96, CUDA events).
     Checks: every request's token count in every engine; every spec
     dispatch a replay of the one spec graph; K4-int8 carried every decode
     step of the int8 engines; identical int8 engines give identical
     streams; every emitted token within the teacher-forced margin (cold,
     and each warm stream that differs from its cold one).
 8. training parity: a small fp32 Llama (hidden 512, 4/2 heads of 128, 2
     layers, vocab 1024, seq 200) takes 3 Engine steps on the card and on
     the CPU from the same weights; losses, parameters and AdamW moments
     must agree.
  9. training at full width and depth: the headline config of bench.py
     (bench_llama, llama_pretrain_tokens_per_sec_per_chip: 853M params,
     seq 4096, batch 2, bf16, fused CE, no remat), random weights from
     seed 0, Engine(lr=1e-4, clip 1.0): 2 warm-up and 8 timed steps on
     fresh batches (tokens/s, MFU, ms per step, peak memory), then 6 steps
     at lr 1e-3 on one batch whose loss must fall. The K1-lse, K2 and K3
     counters must show 16 launches a step, the serving K1 counter none.
 10. K5 (padded grouped matmul, csrc/grouped_matmul.cu), forward and its
     trans_w (dx) mode, and K6 (its dw) against their plain versions on a
     seeded skewed routing that leaves one expert without a token: the MoE
     step's shapes (x [36864, 1024] against w [8, 1024, 2816], [36864,
     2816] against [8, 2816, 1024], bf16), the MoE serving decode step's
     (phase 15: 128 tokens x top-2 = 256 rows padded to 4608, the same
     weight shapes, bf16), a small case (fp32 and bf16) and one whose k
     and n a 128 tile does not divide; error <= tol x max
     |plain|, the tileless expert's dw exactly 0; kernel (chained and
     device_ms), plain and library (torch._grouped_mm, or a per-expert
     torch.mm loop) times and the bound.
 11. MoE training parity, for every dispatch: a small fp32 MoE Llama (4
     experts) takes 3 Engine steps on the card and on the CPU from the
     same weights, with pgmm, einsum, scatter, ragged and auto (einsum
     here), a switch gate in eval mode, and flash remat over scatter; the
     capacity modes at capacity factor 0.5, so choices drop. Each: the
     same expert choices and the same dropped choices, losses, parameters
     and moments within phase 8's tolerances, K1-lse once a layer a step,
     and K5/K6 launches for pgmm and ragged only.
 12. MoE training at full width and depth: the Mixtral-class config of
     bench.py bench_moe (640M params, 225M activated: 8 layers, hidden 1024,
     8 swiglu experts of 2816, top-2 GShard, batch 8 x seq 2048, bf16) with
     moe_dispatch="pgmm", Engine(lr=1e-4, clip 1.0): 2 warm-up and 8 timed
     steps on fresh batches (tokens/s, activated MFU, ms per step, peak
     memory, launches per step: K5 48, K6 24, K1-lse/K2/K3 8 each, serving
     K1 0), one step under set_sync_debug_mode (no synchronizing
     operation), then 6 steps at lr 1e-3 on one batch whose loss must fall.
 13. remat at full width and depth: bench.py's llama_853M_seq4096_remat
     line (:1962-1968: phase 9's model with recompute=True and the
     flash_qkv policy, batch 4 x seq 4096): 2 warm-up and 8 timed steps
     (tokens/s, MFU from model FLOPs with no recompute counted, ms per
     step, peak memory; K1-lse/K2/K3 exactly 16 a step: the policy saves
     the flash forward, so the backward does not run it again; serving K1
     0; the projections of q/k/v run outside the checkpointed region, so
     they are kept, not replayed; phases 4 and 5 hold the three kernels
     against their plain versions at this step's shape), then 6 steps at
     lr 1e-3 on one batch whose loss must fall; the same config without
     remat at batch 4 (ms, peak memory, the remat tax as a ms ratio;
     remat's peak must be lower); then each policy at 4
     layers of the same widths: K1-lse 4 a step for flash, flash_qkv and
     flash_mlp, 8 for full, 6 for full with remat_every=2.
 14. the MoE line at its default dispatch: phase 12's config with
     moe_dispatch="auto", which must resolve to scatter (capacity 5120:
     16384 x 8 x 5120 > 2^24): 2 warm-up and 8 timed steps (tokens/s,
     activated MFU, ms per step, peak memory) beside phase 12's pgmm line;
     K1-lse/K2/K3 8 a step, K5/K6 none; one step under
     set_sync_debug_mode (no synchronizing operation); 6 steps at lr 1e-3
     on one batch whose loss must fall.
 15. MoE serving: bench_moe's model (phase 12's config, pgmm, bf16, random
     weights from seed 0) through phase 7's fused 128-slot engine and wave,
     cold then warm: every decode block replays the one captured graph,
     which holds 24 K5 launches (3 a layer) beside 8 K4 launches, and each
     replay moves K5's count by them; K6 never runs; warm streams equal
     cold (pgmm drops nothing). The teacher-forced check takes the
     engine's own expert choices: the wave runs once more with eager
     steps (bitwise the replayed step; its streams must equal the cold
     wave's) while the gates record the experts picked for every emitted
     position, and the dense forward takes them there (a top-k choice
     flips at near-ties between two bf16 paths, which moves a token's
     logits far past the margin); every emitted token within the margin.
     The routing itself is held to the dense forward: wherever, in that
     forward, a layer's own top-k (from its own gate over the hidden state
     the engine's earlier choices led to) differs from the engine's
     choice, the forward's gate logits of the two experts must lie within
     GATE_MARGIN. Prints tokens/s, launches, the busy share of a profiled
     warm wave, the replayed step against the eager one (and the
     synchronizing operations of each: none in the replay), and phase
     10's K5 times at the decode layout with their share of the replayed
     step. Then the legacy
     engine (K1 prefill, eager decode) on 16 of the requests at 8 slots,
     checked the same way, and the wave once more at moe_dispatch="auto"
     (einsum at decode, scatter at prefill; no K5), with the count of
     streams that differ from the pgmm engines' (capacity drops depend on
     a step's rows, so they may).
 16. generate(): bench.py bench_serving's wave (the phase-6 model, 16
     requests of 64-token prompts sharing 48, max_new (i % 4 + 1) x 16)
     through model.generate in batches of 8 to 64 new tokens, greedy, with
     the dense cache (plain attention) and the paged cache (K1 prefill, K4
     decode: exactly 12 and 12 x 63 launches a batch), beside the
     prefix-cache engine on the same wave, best of 2 interleaved waves:
     useful tokens/s of each and the engine's over dense generate's
     (bench_serving's vs_baseline). Paged streams against dense (count),
     every token within the teacher-forced margin.
 17. brownout: phase 7's wave through a fused engine with brownout=True,
     the pool cut by the serving.block_pool fault site (exhaust, at the
     first admission) to the 416 of its 1152 blocks that the wave's first
     64 requests need (half the slots) until it enters brownout: it must
     enter (brownouts >= 1, brownout_steps > 0), leave
     before the wave ends, replay the one graph (no recapture, no eager
     step), finish every request, and keep every stream that differs from
     phase 7's cold wave within the teacher-forced margin.
 18. varlen (flash_attention_varlen: K1, K2 and K3 in their segment-id
     mode): one packed row of 8192 tokens (the dense training line's 2 x
     4096) cut into documents of 3000, 1500, 1200, 900, 700, 400, 300 and
     192 tokens, 16 q / 4 kv heads of 128, causal, bf16; forward and
     backward through the entry point (launch counts), then
     flash_attn_varlen_qkvpacked's forward on the same tokens at 16 heads
     for q, k and v; the kernels against their plain versions (out, lse,
     gradients within phase 5's tolerances); every id 0 must give the dense
     kernels' output, lse and gradients bit for bit. Each kernel's ms,
     device_ms, bound (4, 6 and 8 head_dim operations per visible (q, k)
     pair and q head, the pairs counted on the host from the ids), plain
     ms, and SDPA with the equivalent boolean mask (forward, and forward +
     backward; its backend named) as the yardstick.
 19. flashmask (flashmask_attention's kernel path: the row-bound mode),
     [2, 4096, 16/4, 128], causal, bf16, forward and backward through the
     entry point: (a) the causal document mask, 1 index, hm 1, documents of
     2048, 1024 and 1024 tokens a row; (b) 2 indices, hm = 4: kv head h
     hides rows [c + W_h, min(c + W_h + 512, 4096)) from column c, W_h in
     256, 512, 1024, 2048. Checked and timed as phase 18.
 20. lse cotangent (flash_attention_with_lse) at the training shape and
     at ring attention's two stripe pairs (phase 56 (b)'s sep=2): loss
     (out g).sum() + (lse h).sum() with seeded g and h, gradients through
     autograd against the plain backward with l-bar; K2 with l-bar timed as
     phase 18 (SDPA's forward and backward, which take no lse cotangent,
     as the yardstick).
 21. block_multihead_attention at the Llama serving width (16 q / 4 kv
     heads of 128, block 64): 64 sequences, 8 prefill rows of 512 tokens
     and 56 decode rows at contexts drawn from 256-2048, with bf16 caches
     and with raw int8 caches and static per-head scales: exactly 8 K1
     launches and one K4 (int8: on int8 pages) a call; the output against
     the same call with the kernels' plain versions in their place (TOL),
     the caches equal byte for byte.
 22. fused_moe at bench_moe's expert width: x [4, 1024, 1024], 8 swiglu
     experts (w1 [8, 1024, 5632], w2 [8, 2816, 1024]), top-2, bf16 against
     the same call in fp32 (error <= TOL x max |fp32|). No hand-written
     kernel runs here: its products are plain einsums, as the JAX
     package's are XLA's.
 23. recovery (bench.py bench_serving_recovery, :474) at phase 7's widths:
     (a) a ServingSupervisor over phase 7's fused engine and wave, whose
     first quarter samples (seeded, temperature 0.8): the wave clean (the
     reference), then under a serving.step kill at a step with at least 64
     busy slots after tokens were delivered (PT-SRV-001: rebuild, capture,
     replay), then with the step watchdog armed at 5 x the clean wave's
     slowest step (at least 0.25 s) and a serving.stall of 3 budgets at
     the same step (PT-SRV-002). Every wave starts with an empty radix
     cache. Checks: recoveries equal the faults, in order, and no other
     overrun; no request fails and every stream equals the reference byte
     for byte; each rebuilt engine captured its graph once and replays it;
     K4 launches during the recovery. (c) The supervisor is abandoned
     mid-wave and a new one over the same journal finishes the wave:
     streams equal, each token journaled once, every engine of the old
     supervisor freed, and memory_allocated after this third recovery
     within 64 MiB of its value after the first. (b) The legacy engine
     (phase 6's engine and 16-request wave) with a kill mid-wave: streams
     equal, K1 and K4 launch inside the recovery. Prints recovery_s, the
     rebuild's share, replayed requests and the faulted and clean waves'
     tokens/s.
 24. fleet (bench.py bench_fleet, :713): a FleetRouter of 3 replicas of
     phase 23's fused engine on its model, with affinity, over the same
     wave: a clean pass; a fleet.replica_kill of replica 1 mid-wave (its
     journal's requests finish on the survivors; then restart(1)); a
     drain of replica 0 mid-wave (queued requests migrate, in-flight ones
     finish in place, the replica rebuilds); parallel_step=True with a
     serving.step kill (one supervisor rebuilds, capturing its graph, in
     its stepping thread) and replica 2 killed and restarted mid-wave.
     Every stream equals phase 23's reference byte for byte, no request
     fails. Prints the router's failover time, fleet tokens/s, one
     supervisor-wrapped engine's tokens/s (phase 23) and their ratio.
 25. disagg (bench.py bench_disagg's tiers, :1259, closed-loop): (a) a
     TieredRouter of one prefill and one decode replica, both phase 23's
     fused engine on its model, warmed as phase 24's: phase 23's wave,
     every stream byte-equal to its reference; migrations + requests
     finished in place = 256, none corrupt; each engine captured its graph
     once and the decode engine replays it over spliced chains (K4);
     memory_allocated after the phase, router closed, within 64 MiB of
     its value before. Prints tiered against phase 23's single-supervisor
     tokens/s, migration_s mean and p99, the chain bytes and pages per
     migration (against 12 layers x 2 x 4 pages x 64 KiB = 6.0 MiB at a
     64-token prompt's first token), and a migration's time split into
     export (gather, then crc + digest), import verify, scatter and
     admit_migrated, timed around the codec's calls (host time). (b) int8
     pools with speculative decode (phase 7c's engine geometry and 16
     motif prompts, max_new_tokens (i % 4 + 1) * 15) on one prefill and
     two decode replicas: every stream byte-equal to one such engine, the
     chains' headers carry kv_scales; prints acceptance and spec steps
     beside the single engine's. (c) phase 23's first 64 requests under
     a serving.kv_transfer bitflip (PT-SRV-007, the chain re-prefilled on
     the decode tier) and a fleet.replica_kill of the decode replica after
     its splices (PT-FLT-001 failover to the prefill tier), each on a
     router of its own: streams byte-equal, every rid finished once across
     the journals.
 26. observability (bench.py bench_observability, :1026) on phase 23's
     model: (a) bench's TPU geometry (4 slots, max_len 256, page 16, block
     8, prefix cache, not fused) with 12 requests of 16-token prompts,
     max_new_tokens 48, seeds 700 + i; (b) phase 7's fused 128-slot engine
     and 256-request wave. A bare and a traced engine (TraceRecorder into a
     MetricsRegistry with the engine collector and a live MetricsServer on
     port 0, closed in a finally) each take a warm-up wave; the traced one
     then gets a fresh recorder and the two run best-of-4, interleaved
     with the order alternating (each engine goes first twice).
     Checks: traced streams byte-equal to bare ones, every rid's lifecycle
     holds submit, admit, first_token, finish in order, nothing dropped;
     in (b) one graph capture each, the same eager_decode_steps traced and
     bare, and no more synchronizing operations in a traced wave than in a
     bare one (set_sync_debug_mode). Prints p50/p99 TTFT,
     observability_overhead_pct, the scrape's family count and the trace
     events.
 27. SLO burst (bench.py bench_slo_burst, :1133): (a) bench's TPU burst
     workload (seed 23, 6 s, 6 rps, x4 bursts of 1 s every 3 s, prompts
     16-48, outputs 8-32, tenants chat and batch) replayed wall-clock,
     open-loop, into a 2-replica FleetRouter (brownout_depth 10**9) of
     26 (a)'s engine, after a closed-loop warm wave and with a fresh
     recorder and SLOMonitor (TTFT 1500 ms, 1 s windows): no request
     fails, submitted + refused = arrivals, every stream byte-equal to the
     same request served closed-loop by one engine of the same geometry;
     prints attainment, goodput, p99 TTFT under burst, arrivals, refused,
     fleet steps and wall time. (b) the observatory of
     tools/traffic_replay.py run_replay (observatory_replay: its seeded
     burst on a VirtualClock, 2-slot engines, SLOAutoscaler min 1 max 3)
     on the card (SERVE_CONFIG's width at OBSERVATORY_LAYERS of its 12
     layers), autoscaler off and on: each report equal to the same replay
     of a 1-layer tiny model on the CPU.
 28. disagg under burst (bench.py bench_disagg, :1259): the seed-29 burst
     replayed wall-clock into a unified 2-replica FleetRouter, then a
     TieredRouter of one prefill and one decode replica, both of 26 (a)'s
     engine with extra_blocks 4, each after a warm wave with a fresh
     recorder and a migration-stats snapshot: streams byte-equal to the
     closed-loop engine in both arms, the recorder's migrations (and
     pt_migration_time_ms observations) equal to the router's
     measured-window delta, memory_allocated after the phase within 64 MiB
     of its value before. Prints unified and tiered p99 TTFT, the
     migrations, mean migration_s, pages, bytes, deferred, refused and
     re-prefills, and pt_migration_time_ms's count and mean beside the
     router's.
 29. the process fleet (inference/procfleet), each worker a process of
     its own (CUDA context, the SERVE_CONFIG model from seed 0, journal,
     /metrics) over the PT-PROC wire: (a) bench.py bench_fleet's process
     arm (:826-886) on phase 6's legacy engine and wave: a
     ProcFleetRouter of 1 worker, then 2 (parallel_step), brownout depth
     10**9, a warm pass, a checked pass and one timed pass; every stream
     byte-equal to the same wave through one engine in this process (best
     of 3);
     prints fleet_proc_tokens_per_sec of both arms, their ratio (both
     workers share this card: overhead and time-slicing, not scale-out)
     and 1 worker's over the in-process engine's, each
     worker's spawn-to-HELLO seconds and card memory (mem_get_info).
     (e) procfleet_collector over that fleet: 2 workers alive, each
     worker's worker_up and pt_engine_scheduled_tokens_total under its
     replica label. (b) the fleet_proc_kill drill (tools/fault_drill.py
     :1369): fleet.proc_kill at the second step of worker 0 SIGKILLs it;
     one death, the pid gone, streams byte-equal, failover_s printed, the
     survivor's decode steps grow and this process still launches K4
     (held to its plain version); then worker 0 restarted with failover
     off: its requests are lost with PT-FLT-001, the rest byte-equal.
     After close() the scrape answers with 0 alive and every spawned
     worker reaped. (c) a ProcTieredRouter of 1 prefill + 1 decode worker
     on phase 23's fused prefix engine, every 3rd request of its wave
     (86, 22 of them sampled): chains cross TCP, streams byte-equal to phase 23's,
     migrations >= 1, a migr-kv record in the prefill journal; prints
     migration_s mean and p99, chain MiB and the wire's share (one frame
     of the chain's size encoded, sent over localhost TCP and decoded,
     twice, over the mean). (d)
     bench.py bench_serving_migration_under_loss (:1401-1498): loopback
     workers (threads of this process) with the presets' tiny engine
     geometry on the same model, 1 prefill + 2 decode, chaos, hedging,
     crc checks, 5 s op timeouts; 8 prompts of 6 tokens (seed 47),
     max_new 8, a warm wave then the measured one, clean and under a
     net.send drop (MIGRATE_IN 1) and bitflip (MIGRATE_IN 4, 64 bits):
     lossy streams equal clean, both faults fired; prints p99 of both,
     hedges, typed refusals and re-prefills. Afterwards no worker pid is
     alive or listed by nvidia-smi --query-compute-apps, and no worker
     rebuilt a kernel library.
 30. GPT training: (a) card-vs-CPU parity, a small fp32 GPT (hidden 256,
     4 heads of 64, 2 layers, vocab 1024, seq 200, every 7th label -100)
     through 3 Engine steps, within phase 8's tolerances; (b) GPT-3 6.7B's
     width (hidden 4096, 32 heads of 128, intermediate 16384, vocab
     50304, bf16, random weights from seed 0) cut to 16 of its 32 layers
     (the whole model's bf16 weights and gradients and fp32 AdamW moments
     need ~80 GB), batch 2 x 2048, Engine(lr=1e-4, clip 1.0): 1 warm-up and
     4 timed steps (tokens/s, MFU by bench.py:101-103, ms per step, peak
     memory; K1-lse/K2/K3 exactly 16 a step, serving K1 0), one step under
     set_sync_debug_mode (no synchronizing operation), then 6 steps at lr
     1e-3 on one batch whose loss must fall. Phases 4 and 5 hold the three
     kernels at this step's shape ([2, 2048, 32/32, 128], q, k and v views
     of the fused qkv product).
 31. GPT serving: GPT-3 6.7B at full width and depth (32 layers) through
     phase 6's legacy engine and wave (K1 prefill at [8, 512, 32/32, 128],
     K4 decode) and phase 7's fused 128-slot engine and waves (1153 pages,
     cold then warm, every greedy block a replay of the one captured
     graph), with their checks (token counts, launch counts, no autograd
     graph, every emitted token within the teacher-forced margin) and
     timings, each line prefixed "gpt". Phases 2 and 3 hold K1 and K4 at
     these shapes ("gpt_prefill"; "gpt_wave", the legacy decode, and
     "gpt_fused").
 32. BERT fine-tuning: (a) card-vs-CPU parity of BertForSequenceClassification
     (3 labels) and BertForMaskedLM (15% of positions labelled, the rest
     -100), hidden 256, 4 heads of 64, 2 layers, seq 77 (ragged against
     the kernels' tiles), fp32, 3 Engine steps each; (b) bench.py
     bench_bert's config (BERT-base, bf16, dropout 0, batch 32 x 128,
     Engine(lr=2e-5, clip 1.0, loss_fn=model.loss_fn)): 1 warm-up and 8
     timed steps (tokens/s, MFU with non-causal attention's 12 L h seq
     FLOPs a token, ms per step, peak memory), then one BertForMaskedLM
     step at the same shape; each: K1-lse/K2/K3 exactly 12 a step, serving
     K1 0, and every launch of a further step non-causal, with no
     synchronizing operation (set_sync_debug_mode). Phases 4 and 5
     hold the three kernels at this shape ([32, 128, 12/12, 64], not
     causal).
 33. vision parity, card against CPU on the same weights and batches
     (fp32, TF32 off): (a) resnet18(num_classes=10), 3
     hapi.Model.train_batch steps (Momentum 0.9, lr 1e-3, batch 16 of 3 x
     32 x 32), each started on the card from the CPU's parameters,
     BatchNorm statistics and velocity: the loss within 1e-4 relative,
     every parameter within 1e-4, every _mean / _variance within 2e-3 of
     its largest; (b) the tiny ViT (ViTConfig.tiny, batch 4) and UNet
     (UNetConfig.tiny, batch 2 of 16 x 16 latents): the loss within 1e-4
     relative and every gradient within 1e-4 of its largest; (c) each zoo
     factory (VGG 11/13/16/19 with and without BatchNorm, MobileNetV1/V2,
     AlexNet, SqueezeNet 1.0/1.1) in eval mode at 224 px, batch 2: logits
     within 1e-4 of their largest. K1-K6 must launch zero times: this path
     runs none of them, as the JAX package runs no Pallas kernel there
     (convolutions, pools and norms are torch's ops, attention the dense
     _xla_attention).
 34. bench_resnet (bench.py:112-148, BASELINE config 1): resnet18
     (num_classes=10), batch 256 of 3 x 32 x 32 fp32, Momentum(lr 0.1,
     momentum 0.9), CrossEntropyLoss, through hapi.Model.train_batch (one
     host read of the loss a step, as bench's): 1 warm-up and 8 timed
     steps; images/s, ms a step, the loss, peak memory; the loss finite,
     the BatchNorm statistics moved, no K1-K6 launch.
 35. bench_vit (bench.py:1681-1730, config 5): vit_l_16(dtype="bfloat16")
     (304M parameters, 224 px, 197 tokens), batch 32, bench's step (the
     loss's gradients, then p - 1e-4 g): 1 warm-up and 8 timed steps;
     images/s, MFU with bench's FLOP count over 989 TFLOP/s, peak memory;
     losses finite, no K1-K6 launch.
 36. bench_unet (bench.py:1623-1678, config 5): UNetConfig(block_channels
     (128, 256, 512), 2 layers a block, 8 heads, cross_attention_dim 768,
     bf16), batch 8 of 4 x 32 x 32 latents, context 77, bench's step: 1
     warm-up and 8 timed steps; latents/s, peak memory; losses finite, no
     K1-K6 launch.
 37. engine optimizer: Engine(model, optimizer=X). (a) card against CPU
     at PARITY_CONFIG (2 layers, hidden 512, fp32, batch 2 x seq 200), 3
     steps for each X of tests/test_torch_engine_optimizer.py (AdamW
     under LinearWarmup(CosineAnnealingDecay) with apply_decay_param_fun
     and a global-norm clip, Lamb, RAdam, NAdam, Adagrad, Momentum), the
     schedule stepped on the host: losses within 1e-4 relative, parameters
     within 2 x lr x steps, every accumulator within 1e-3 of its largest,
     K1-lse/K2/K3 launched on the card. (b) the train config of phase 9
     under AdamW(LinearWarmup(CosineAnnealingDecay(3e-4, T_max=1000),
     100 warm-up steps), weight_decay=0.01, ClipGradByGlobalNorm(1.0)): 1
     warm-up step under set_sync_debug_mode (0 synchronizing operations)
     and 8 timed steps; ms a step, tokens/s, MFU, peak memory, launches a
     step (16 each of K1-lse, K2, K3); then the built-in AdamW engine on
     the same weights and batches, built after the first is freed.
 38. hapi fit (BASELINE config 1): first a card-vs-CPU fit of resnet18,
     3 iterations of batch 32 at lr 1e-3 through the augmenting chain,
     each card step started from the CPU's state (loss 1e-4 relative,
     top-1/5 accuracy within one image, parameters 1e-4, statistics 2e-3).
     Then resnet18(num_classes=10) on the card, Cifar10(mode="train",
     size=50000) with RandomCrop(32, padding=4), RandomHorizontalFlip,
     ToTensor and Normalize, Momentum(CosineAnnealingDecay(0.1, 200), 0.9,
     weight decay 5e-4), Accuracy(topk=(1, 5)): fit(eval_data=
     Cifar10(mode="test", size=10000), batch_size=256, epochs=1,
     num_workers=4, callbacks=[ModelCheckpoint, EarlyStopping,
     LRScheduler]) with this process's CUDA context live in the forked
     workers' parent; images/s over the epoch beside phase 34's rate, the
     share of it spent waiting on the loader; evaluate, predict, save and
     load into a fresh model (equal state, equal eval loss); K1-K6 at 0
     launches.
 39. (none: the fp16 flash kernels are held to their plain versions in
     phases 2, 4 and 5.)
 40. dygraph AMP parity: a 2-layer TransformerEncoder of the Paddle layers
     (hidden 256, 4 heads of 64, FFN 512, vocab 1024, batch 8 x seq 64)
     built on the CPU from seed 19 and copied to the card; 3 steps of
     auto_cast(O1, bf16) + GradScaler(1024).minimize + AdamW(1e-4, wd
     0.01, global clip 1.0) on both: losses within 2e-2 relative, and the
     unscaled gradients of the first step (which AdamW's update would
     normalise away) by amp_grad_errors: each parameter's max abs error
     <= AMP_GRAD_TOL of its largest CPU gradient; K1-lse/K2/K3 launched.
 41. dygraph AMP at BERT-base width (BASELINE config 2): Embedding(30522,
     768) + learned positions (512) + LayerNorm, TransformerEncoder(12 x
     TransformerEncoderLayer(768, 12, 3072, dropout 0, gelu)), Linear(768,
     2) on the first token, F.cross_entropy; batch 32 x 128 (bench_bert's
     shape), ids from np.random.default_rng(0); AdamW(2e-5, weight_decay
     0.01, ClipGradByGlobalNorm(1.0)); the step JAX's form: auto_cast,
     scaler.minimize(opt, scaler.scale(loss)), opt.clear_grad(). Three
     arms: (a) O1 bf16, GradScaler(init_loss_scaling=1024); (b) O2 bf16
     after amp.decorate, GradScaler(1024); (c) O1 fp16, GradScaler()'s
     dynamic scaling. Each: 2 warm-up and 5 timed steps; ms a step,
     tokens/s, peak memory, launches a step (12 each of K1-lse, K2, K3,
     asserted), host syncs a step (exactly 1, the scaler's, asserted),
     ops the dispatcher ran a step and host us an op of the forward's
     enqueue (queued behind a spin kernel, so the card runs none of it
     meanwhile). (c) also runs an eval forward under no_grad (12 primal fp16
     K1 launches) and a step forced to overflow (scale 2^40): the scaler
     must skip it (parameters unchanged bitwise, OVERFLOW in the health
     word, scale halved). Phase 32's Engine BERT step is printed beside
     them as a reading of another code path.
 42. the nn surface sweep (nn_sweep_cases): every activation, loss,
     norm, pool, conv, resize and common functional and layer of the nn
     slice and the recurrent layers, forward and backward, fp32 and bf16,
     at NN_ACT / NN_LOGITS / NN_MAP / NN_MAP1 / NN_MAP3 / NN_SEQ sizes,
     each against the same call on the CPU on the same values (fp32 for
     the heavy bf16 cases): every output and gradient (inputs and layer
     parameters) within NN_SWEEP_TOL of max(1, max |cpu|) and on the card;
     then dropout2d/3d, alpha_dropout, rrelu and gumbel_softmax in training
     on the card held to their rates. K1-K6 at 0 launches.
 43. the "large" PTB LSTM language model (LSTM_LM: Zaremba et al.,
     arXiv:1409.2329 section 4.1; Embedding, Dropout, two one-layer LSTMs,
     Linear, ParamAttr(Uniform(-0.04, 0.04)), SGD lr 1 with
     ClipGradByGlobalNorm(10) through hapi.Model.train_batch, tokens from
     seed 0): first at hidden 64 with dropout off, the first step's loss
     and gradients card vs CPU (LSTM_LM_PARITY); then at full width 3
     warm-up and 20 timed steps on one fixed batch: ms a step, tokens/s,
     the phase's own peak memory (over what earlier phases hold), kernels
     a step (torch.profiler, printed only), finite
     losses and the eval loss on that batch falling. K1-K6 at 0 launches.
 44. the nn extras and linalg sweep (extras_sweep_cases): every function
     and layer of nn/functional/extras.py and nn/layer/extras.py, the five
     arguments the nn slice refused (conv_transpose "SAME", interpolate
     align_mode=1, instance_norm's running statistics, soft-label cross
     entropy with a weight, sequence_length on the packed recurrent layers,
     RNN and BiRNN) and every paddle.linalg function, forward and
     backward, fp32 (bf16 where the case takes it), each against the same
     call on the CPU: CTC at EXTRAS_CTC, RNN-T at EXTRAS_RNNT, grid_sample
     at EXTRAS_GRID, linalg batches at EXTRAS_LINALG, the packed GRU at
     EXTRAS_GRU; the worst error per dtype within NN_SWEEP_TOL; then
     feature_alpha_dropout, class_center_sample and a fractional pool's
     draws on the card. K1-K6 at 0 launches.
 45. the DeepSpeech2-class CTC model (DS2: PaddleSpeech's Aishell-1 recipe,
     two Conv2D + BatchNorm2D + Hardtanh(0, 20) blocks masked by frame,
     three bidirectional GRUs of 1024 with sequence_length, Linear(2048,
     4301), F.ctc_loss over the post-conv lengths; 61.2M fp32 parameters):
     first at DS2_PARITY's small width the first step's loss and every
     gradient card vs CPU; then at full width, batch 32 of 300-1200
     frames from seed 0, Adam(1e-3) with ClipGradByGlobalNorm(5), eager
     loss.backward / step / clear_grad, TF32 off: 2 warm-up and 8 timed
     steps on one fixed batch: ms a step, utterances/s, frames/s, the
     phase's own peak memory, kernels a step, finite losses and the eval
     loss falling. K1-K6 at 0 launches.
 46. the tensor extras sweep (tensor_sweep_cases): every function of
     tensor/extras.py and tensor/toplevel_extras.py, fft, signal and audio
     (the functions and the four feature layers), and each of the 68
     in-place variants and where_, forward and backward, fp32 (bf16 where
     the case takes it) at TX_* sizes, card against CPU within
     NN_SWEEP_TOL; the CPU references of phases 42, 44 and 46 come from a
     process started at phase 1 (RefClient, ROADMAP Queue 1 p). Then
     log_normal, standard_gamma and the fills log_normal_, cauchy_ and
     geometric_ (continuous) by their moments on the card, and
     top_p_sampling on TOP_P logits: every draw in its row's nucleus,
     TOP_P_DRAWS draws of one row against the nucleus's renormalised
     probabilities (chi-square p > 1e-3), the same seed the same draws.
     K1-K6 at 0 launches.
 47. amp.debugging on phase 41's BERT-base encoder (DYGRAPH_BERT, seed-0
     weights and batch): an fp32 step (forward, cross entropy, backward)
     dumped twice by dump_tensor_stats (compare_accuracy flags 0 rows), an
     O1 bf16 step dumped (aligned with the fp32 dump op for op, no MISSING
     row; flagged count and worst op printed), collect_operator_stats
     equal to the white ops the O1 dump holds, the tensor checker on an
     inf planted in layer 3's linear1 weight (raises naming linear; warn
     mode warns, the health word carries NAN/INF bits), and the step's ms
     and host syncs with the dump off and on (at most 1 more). 12 each of
     K1-lse, K2, K3 a dumped step.
 48. the profiler: 4 steps of phase 9's Llama train step under
     Profiler(make_scheduler(closed=1, ready=1, record=2),
     profile_memory=True, on_trace_ready=export_chrome_tracing(
     build/chip_smoke/profiler)) with RecordEvent scopes around the batch
     and the step: OverView's steps and OperatorView's calls 4,
     MemoryView's peak within 5% of max_memory_allocated, the device
     trace's flash_fwd_tc_kernel, dq_tc_kernel and dkv_tc_kernel counts
     equal to the wrappers' counters over the 2 recorded steps (2 x 16
     each), ms a step recorded against not. Then phase 6's legacy engine
     (16 requests of PROFILE_SERVE_NEW tokens) under a Profiler with
     TraceRecorder(mirror_host_events=True): the recorder's span names and
     counts in OperatorView, K1 and K4 in the device trace equal to the
     wrappers' counters. Where Kineto records no CUDA kernel on the
     machine the profiler must refuse, and the trace counts print as not
     measured.
 49. DS2's front end: audio.features.Spectrogram(DS2_FRONT) and a log on
     phase 45's batch shape (32 waveforms of 3-12 s at 16 kHz from seed 0,
     161 bins, 302-1174 frames), card against CPU, ms a batch; one DS2
     step at phase 45's width on the card's features (finite loss), and
     phase 45's card-vs-CPU parity on the first rows' features. K1-K6 at
     0 launches.
 50. jit.to_static on phase 41's arm (a) (O1 bf16, GradScaler(1024),
     AdamW, seed-0 weights and batch) at 4 of the encoder's 12 layers
     (JIT_BERT): the compiled step's first loss and
     gradients against the eager step's (SMALL_AMP["tol"],
     AMP_GRAD_TOL), the first step's seconds (Dynamo capture and the
     Inductor compile), JIT_STATIC warm-up and timed steps: ms a step
     beside phase 41 (a)'s in this run, one Dynamo graph, no graph break
     or recompile, 12 each of K1-lse, K2, K3 a step, losses that fall.
 51. deployment of the encoder in eval with bf16 weights: jit.save with
     InputSpec([32, 128], "int64") under build/chip_smoke/deploy,
     jit.load and inference.create_predictor: logits identical to the
     eager model's or within DEPLOY_ULPS bf16 ulps of each row's
     largest, also from a fresh process that imports only
     paddle_tpu_torch.inference; 12 primal K1 launches (the op
     paddle_tpu_torch::flash_fwd) a forward; ms a batch for eager, loaded
     and Predictor; Config.enable_bf16 on an fp32 save within
     BF16_WEIGHT_TOL of the fp32 logits.
 52. the encoder in fp32 as a static program (enable_static,
     program_guard, static.data, cross entropy, AdamW.minimize,
     Executor.run) at JIT_BERT's 4 layers: the first loss against the
     eager fp32 step's (STATIC_LOSS_TOL), JIT_STATIC warm-up and timed
     steps with the loss falling, one cached signature, the recorded ops
     and apply_default_passes' counts, one each of K1-lse, K2, K3 a layer
     a step.
 53. model compression of phase 41's encoder (BERT-base, batch 32 x 128):
     (a) QAT (73 QuantedLinear; O1 bf16 steps with 12 each of K1-lse, K2,
     K3 and a falling loss, ms beside phase 41 (a)); (b) PTQ calibrated on
     4 batches (12 primal K1 a forward), converted: 73 int8 products
     (torch._int_mm; the head's N = 2 padded to 8) and 12 primal K1 a
     forward, logits against the fake-quant model's within the head's
     one-step bound, ms beside the bf16 eval forward, the int8 GEMM
     against the dense int8 peak; (c) ASP 2:4 (mask_1d) with decorate:
     every pruned weight 2:4 at density 0.5 after the steps.
 54. the incubate.nn.functional fused family against CPU runs:
     fused_multi_transformer at GPT-3 6.7B width over 2 layers (prefill 8
     x 512, 16 decode steps; 2 + 2 x 16 K1), masked_multihead_attention
     on a dense [2, 8, 32, 2048, 128] cache, the other thirteen at
     BERT-base width in bf16 and fp32 (FAMILY_TOL).
 55. the packages against CPU runs (PACKAGE_TOL): sparse matmul and
     masked_matmul at 4096^2, 1% density; every distribution's log_prob,
     entropy and KL on 10^6 elements; send_u_recv sum, mean, max at
     ogbn-arxiv's size; viterbi_decode at 64 x 128 x 50; a custom_op and
     a cpp_extension op on card tensors; flops of the encoder.
 56. distributed training (paddle_tpu_torch.distributed): (a) one NCCL
     rank, TRAIN_CONFIG at full width and depth, Engine over
     make_mesh(MESH_1) against Engine(mesh=None) from the same seed-0
     weights on DIST_STEPS seeded batches: losses within DIST_LOSS_RTOL,
     K1-lse, K2 and K3 launched 16 times a step on both paths, each
     step's ms, the median's difference and each path's host enqueue of
     one step; (b) two processes sharing the card over gloo,
     DIST_DP_LAYERS of the 16 layers at full width, on each mesh of
     DIST_GLOO_MESHES: dp=2 (one sequence a rank), sep=2 (ring attention,
     zigzag), pp=2 (GPipe over 2 microbatches, VPP with 2 chunks a stage,
     zero-bubble), against one process's mesh=None steps over the same
     global batch (losses within DIST_LOSS_RTOL; gathered parameters
     within 2 * lr * steps + |w| / 256, sep=2 within 2 * lr * steps plus
     DIST_SEP_ULPS bf16 ulps; each parameter's update from the seed-0
     weights within DIST_UPDATE_RTOL of mesh=None's, and a planted fault,
     pp stage 1's blocks left at their initial values, caught by that
     check), K1-lse, K2 (dense or GLSE) and K3 launched on each rank as
     its schedule implies (_dist_need),
     each mesh's step ms, the collectives (CommDebugMode) and
     point-to-point transfers of one step. The ranks are killed after
     DIST_SPAWN_S. (tp and fsdp need DTensor's functional all-gather,
     which gloo ends with SIGSEGV on CUDA tensors: DIST_GLOO_MESHES.)
 57. the numeric guard and the resilience trainer: (a) bench.py
     bench_guard's config (GUARD_CONFIG), a plain and a GuardPolicy()
     Engine from the same seed-0 weights, GUARD_ITERS steps a wave,
     interleaved best of GUARD_WAVES: guard_overhead_pct, every timed
     guarded step's word 0, its losses, parameters and moments bitwise
     the plain engine's, one each of K1-lse, K2, K3 a layer a step;
     then a nan_grad and a loss_spike step under a FaultPlan: NAN_GRAD
     and SPIKE, every parameter and moment bit-identical, the counter
     advancing. (b) bench_checkpoint_publish's config (PUBLISH_CONFIG,
     PUBLISH_ENGINE): a guarded ResilientTrainer (rollback policy) with
     async saves whose loss_spike rolls it back once, its replayed losses
     equal to an uninterrupted run's byte for byte where the steps before
     the rollback are (else within PUBLISH_REPLAY_RTOL); then
     CheckpointPublisher.publish swaps a warm 2-replica FleetRouter
     (checkpoint_publish_time_s, shards, parameters, generation), whose
     greedy streams equal a cold fleet's from the same checkpoint token
     for token; a flipped byte in the shard is refused with the serving
     weights intact.
K4's "launches" in the kernels line counts the serving phases' waves on
fp pools (phases 6, 7, 7c, 15-17, 23-28, 29's launches in this
process: (a)'s reference wave and (d)'s loopback workers; a spawned
worker's launches move its own counters and are not counted; and 31)
and phase 21's calls;
"paged_decode_int8" counts phases 7c's and 25's launches on int8 pools;
K1's adds
the legacy engine of phase 15, the paged generate of phase 16, phase 21's
prefill rows, phase 23's legacy arm and phase 29 (a)'s reference wave to
phase 6's wave, and phase 31's legacy wave; K5's adds phase 15's served
waves to phase 12's steps; K1-lse, K2 and K3 count the timed steps of
phases 9, 13, 14, 30, 32, 37 (b), 41 (a, b), 47's dumped steps, 48's
recorded steps, 50, 52, 53's (a) and (c), 56 (a)'s mesh path, 56 (b)'s
two ranks' compared steps (each read by its own process, on every mesh;
its GLSE K2 in the l-bar row), 57 (a)'s timed waves and 57 (b)'s trainer
(K1-lse also phase 20's forwards); K1 and K4 also count phase 48's profiled serving wave; K1 also
phase 51's checked forwards (eager, loaded, Predictor), phase 53 (b)'s
calibration and int8 forwards and phase 54's checked calls; K1 and K4
also phase 57 (b)'s fleets' waves; the fp16 rows count phase 41 (c)'s timed steps (and its eval
forward for the primal K1); the
masked and l-bar rows count the main-path runs of phases 18-20; each
read with the counts set to 0 just before it.
The second-to-last line is a JSON object listing each kernel; the last is
{"ok": true, "device": {...}}. Without a CUDA device, or outside a checkout
of the repository, it exits non-zero before printing any result.
"""

import collections
import contextlib
import csv
import gc
import importlib
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import warnings
import weakref

DEVICE = "cuda"
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12,  # H100 SXM, dense
              "float32": 67e12}
PEAK_BYTES = 3.35e12                                  # H100 SXM HBM3
L2_BYTES = 50 * 2 ** 20                               # H100 SXM L2 cache
TOL = {"bfloat16": 2e-2, "float32": 1e-4, "float16": 5e-3}
# Teacher-forced check: every emitted token's logit must lie within this
# margin of the maximum logit at its position, counted in bf16 units in the
# last place (ulps) of that maximum: ulp(x) = 2 ** (floor(log2 |x|) - 7).
# Greedy decode picks the maximum of its own bf16 logits; the dense forward
# recomputes them through other kernels with other bf16 rounding, which
# scales with the logits' magnitude, so an emitted token may trail the
# recomputed maximum by a few ulps. The margin was first 0.1 in logits,
# set on the 12-layer Llama serving model (logit std ~0.9, row maxima in
# [2, 4), where an ulp is 0.0156 and 0.1 admits 6 ulps); GPT-3 6.7B's
# logits (std ~1.29) put the row maxima in [4, 8), where 0.1 admits 3
# ulps and the first H100 runs read 3. The H100 readings in ulps are in
# PERF.md. A wrong token trails by about a standard deviation of the
# logits (tens of ulps) or more.
MARGIN_ULPS = 6
# MoE routing check: where the engine picked another expert than the dense
# forward's own top-k at a layer, the forward's gate logits of the two
# experts must lie within this margin. The gate's logits are fp32 dots of
# the normed bf16 hidden state with a Xavier-uniform gate, std ~1.4 at
# hidden 1024 (0.044 x sqrt(1024)), 1.6 times the output logits' scale; the
# output logits' worst bf16 trail (0.047 on the first H100 run) so scales
# to ~0.08 for a difference of two gate logits (the first H100 run with
# this check measured 0.1159). 0.25 is three times the estimate and a
# sixth of the std: a token routed to another expert than a near-tie's
# trails by about a std or more.
GATE_MARGIN = 0.25
# K1 cases: name, batch, s_q, s_kv, q heads, kv heads, head_dim, causal
K1_CASES = [
    ("prefill", 8, 512, 512, 16, 16, 128, True),   # the serving prefill
    ("gqa", 2, 1024, 1024, 16, 4, 128, True),
    ("ragged", 2, 77, 77, 16, 16, 128, False),
    ("end_aligned", 2, 200, 520, 16, 4, 64, True),
    ("strided", 2, 1024, 1024, 16, 16, 128, True),
    # phase 15's legacy MoE engine prefills 8 prompts of 64 tokens at 16/4
    # heads of 64; phase 16's paged generate 8 at 16/16 heads of 128
    ("moe_prefill", 8, 64, 64, 16, 4, 64, True),
    ("generate_prefill", 8, 64, 64, 16, 16, 128, True),
    # phase 31's GPT-3 6.7B legacy prefill (8 prompts of the 512 bucket,
    # 32/32 heads of 128), q, k and v views of its fused [b, s, 3h] product
    ("gpt_prefill", 8, 512, 512, 32, 32, 128, True),
    # phase 57 (b)'s fleets: each replica prefills its 4 slots' 16-token
    # prompts in one group (PUBLISH_CONFIG: 8/8 heads of 64)
    ("publish_prefill", 4, 16, 16, 8, 8, 64, True),
]
# the train step's attention shape (bench.py:2013-2019 at batch 2)
TRAIN_SHAPE = ("train", 2, 4096, 4096, 16, 4, 128, True)
LSE_TOL = {"bfloat16": 5e-3, "float32": 1e-4, "float16": 5e-3}
# the MoE step's attention shape (MOE_CONFIG below: batch 8 x seq 2048, 16 q
# / 4 kv heads of 64)
MOE_ATTN_SHAPE = ("moe", 8, 2048, 2048, 16, 4, 64, True)
# the remat step's attention shape (REMAT_CONFIG below at batch 4)
REMAT_ATTN_SHAPE = ("remat", 4, 4096, 4096, 16, 4, 128, True)
# phase 30's GPT step ([2, 2048], 32/32 heads of 128, causal; q, k and v
# views of the fused qkv product) and phase 32's BERT step (bench_bert:
# [32, 128], 12/12 heads of 64, not causal)
GPT_ATTN_SHAPE = ("gpt_train", 2, 2048, 2048, 32, 32, 128, True)
BERT_ATTN_SHAPE = ("bert", 32, 128, 128, 12, 12, 64, False)
# phase 56 (b)'s per-rank shard of the training shape (dp=2: one sequence)
DP_SHARD_SHAPE = ("dp_shard", 1, 4096, 4096, 16, 4, 128, True)
# phase 57's steps: (a) bench_guard's (GUARD_CONFIG at batch 8 x seq 1024:
# 16 q / 4 kv heads of 64) and (b) the trainer's (PUBLISH_CONFIG at
# PUBLISH_BATCH: 8/8 heads of 64)
GUARD_ATTN_SHAPE = ("guard", 8, 1024, 1024, 16, 4, 64, True)
PUBLISH_ATTN_SHAPE = ("publish", 4, 512, 512, 8, 8, 64, True)
# phase 56 (b)'s ring attention over {"sep": 2}: a rank's stripe pairs of
# the training shape (its 2 x 2048 rows cut into two stripes of 1024), the
# diagonal pairs causal and the others full; q, k and v are stripes of the
# rank's fp32 [2, 2048, h, 128] tensors, each cast to a contiguous bf16
# copy, as the ring holds its shards in fp32 and casts each stripe for its
# kernel (K2 runs in GLSE mode there: phase 20). Its pp microbatch [1, 4096] is DP_SHARD_SHAPE.
RING_DIAG_SHAPE = ("ring_diag", 2, 1024, 1024, 16, 4, 128, True)
RING_FULL_SHAPE = ("ring_full", 2, 1024, 1024, 16, 4, 128, False)
# the main paths' attention shapes, which K1-lse and K2/K3 run in bf16 only
TRAIN_PATH_SHAPES = (TRAIN_SHAPE, MOE_ATTN_SHAPE, REMAT_ATTN_SHAPE,
                     GPT_ATTN_SHAPE, BERT_ATTN_SHAPE, DP_SHARD_SHAPE,
                     GUARD_ATTN_SHAPE, PUBLISH_ATTN_SHAPE, RING_DIAG_SHAPE,
                     RING_FULL_SHAPE)
# the cases whose q, k and v are views of one [b, s, 3, h, d] buffer
STRIDED_CASES = ("strided", "gpt_prefill", "gpt_train")
# the cases whose q, k and v are ring attention's stripes
RING_CASES = ("ring_diag", "ring_full")
# phases 18-20: the masked and lse-cotangent modes at the dense training
# line's attention width (bench.py:2013-2019: 16 q / 4 kv heads of 128,
# batch 2 x seq 4096, bf16). varlen packs the batch into one row of 8192
# tokens, cut into these documents:
VARLEN_SHAPE = (1, 8192, 16, 4, 128)        # b, s, hq, hkv, d
VARLEN_DOCS = (3000, 1500, 1200, 900, 700, 400, 300, 192)
FLASHMASK_SHAPE = (2, 4096, 16, 4, 128)
FLASHMASK_DOCS = (2048, 1024, 1024)        # the causal document mask
# the band case (a test shape, not a user's mask): kv head h hides rows
# [c + W_h, min(c + W_h + FLASHMASK_BAND, s)) from column c
FLASHMASK_WINDOWS = (256, 512, 1024, 2048)
FLASHMASK_BAND = 512
# phase 21: block_multihead_attention at the Llama serving width
BMHA = dict(heads=16, kv_heads=4, head_dim=128, block_size=64,
            prefill_rows=8, prefill_len=512, decode_rows=56, ctx_lo=256,
            ctx_hi=2048)
# phase 22: fused_moe at bench_moe's expert width (bench.py:1750-1754)
FUSED_MOE = dict(x=(4, 1024, 1024), experts=8, ffn=2816, topk=2)
# K2/K3 cases; the training, MoE and remat shapes run in bf16 only.
# "strided" (here and in K1_CASES) takes q, k and v as strided views of one
# [b, s, 3, h, d] buffer.
BWD_CASES = [
    TRAIN_SHAPE,
    MOE_ATTN_SHAPE,
    REMAT_ATTN_SHAPE,
    GPT_ATTN_SHAPE,
    BERT_ATTN_SHAPE,
    DP_SHARD_SHAPE,
    GUARD_ATTN_SHAPE,
    PUBLISH_ATTN_SHAPE,
    RING_DIAG_SHAPE,
    RING_FULL_SHAPE,
    ("mha", 2, 1024, 1024, 16, 16, 128, True),
    ("ragged", 2, 77, 77, 16, 16, 128, False),
    ("end_aligned", 2, 200, 520, 16, 4, 64, True),
    ("strided", 2, 1024, 1024, 16, 16, 128, True),
]
# K4 cases: name, q heads, kv heads, head_dim, page, pages per row, lengths.
# "main" is the main-path row's; "wave" the serving wave's decode (prompts
# of 384-512 tokens and up to 128 new ones, ENGINE's max_len 640).
K4_CASES = [
    ("main", 16, 16, 128, 16, 40, [0, 1, 16, 64, 100, 333, 512, 640]),
    ("main_gqa", 16, 4, 128, 16, 40, [0, 1, 16, 64, 100, 333, 512, 640]),
    ("wave", 16, 16, 128, 16, 40, [384, 421, 457, 494, 530, 567, 603, 640]),
    ("long_gqa", 32, 8, 128, 16, 256, [1, 1000, 2500, 4096]),
    # the fused engine's decode (FUSED_ENGINE): 128 rows at the wave's
    # contexts, 49 (first decode step) to 128 (max_len)
    ("fused", 16, 16, 128, 16, 8, [49 + i * 79 // 127 for i in range(128)]),
    # phase 15's MoE model (16/4 heads of 64) at the fused engine's decode
    # and at the legacy engine's (8 rows, contexts 64 to 128); phase 16's
    # paged generate (8 rows of 16/16 heads of 128, contexts 64 to 128)
    ("moe_fused", 16, 4, 64, 16, 8, [49 + i * 79 // 127 for i in range(128)]),
    ("moe_legacy", 16, 4, 64, 16, 8, [64 + i * 64 // 7 for i in range(8)]),
    ("generate", 16, 16, 128, 16, 8, [64 + i * 64 // 7 for i in range(8)]),
    # phase 31's GPT-3 6.7B (32/32 heads) at the legacy engine's decode
    # (the "wave" rows and contexts) and at the fused engine's
    ("gpt_wave", 32, 32, 128, 16, 40, [384 + i * 256 // 7 for i in range(8)]),
    ("gpt_fused", 32, 32, 128, 16, 8,
     [49 + i * 79 // 127 for i in range(128)]),
    # phase 57 (b)'s fleets (PUBLISH_ENGINE): a replica's 4 rows of 8/8
    # heads of 64, 16 pages of 16 a row, contexts from the first decode
    # step (16-token prompts) to the last (48 new tokens)
    ("publish", 8, 8, 64, 16, 16, [17, 33, 48, 64]),
]
K4_GRAPH_LAYERS = 12   # one decode step of the serving config's 12 layers
# K4 on int8 pools (QuantizedKVPool): the main-path row's shape and the
# fused engine's decode shape, q in bf16 (and fp32 at "main")
K4_INT8_CASES = [c for c in K4_CASES if c[0] in ("main", "fused")]
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
LEGACY_EOS = 7          # request 5's eos token
# the JAX package's big-batch serving arm (bench.py
# bench_serving_large_batch, :371-379 and :396-401) at its TPU widths: the
# SERVE_CONFIG model, 128 slots, fused mega-step, prefix cache with 128
# extra blocks (1153 pages); 256 requests of 64-token prompts whose first 48
# tokens are one shared system prompt, max_new_tokens (i % 4 + 1) * 16
FUSED_ENGINE = dict(max_batch=128, max_len=128, page_size=16, block_size=16,
                    fused=True)
FUSED_EXTRA_BLOCKS = 128
FUSED_REQUESTS, FUSED_PROMPT, FUSED_SHARED, FUSED_MAX_NEW = 256, 64, 48, 64
# phases 23-24: bench.py bench_serving_recovery (:474) and bench_fleet
# (:713) over phase 7's engine and wave, whose first quarter samples
# (seeded, temperature 0.8) as in the JAX package's crash-replay test; the
# watchdog budget is 5 x the clean wave's slowest step and at least
# RECOVERY_BUDGET_MIN s; memory may not grow across recoveries by more than
# RECOVERY_MEM_SLACK bytes; the fleet has FLEET_REPLICAS replicas
RECOVERY_SAMPLED, RECOVERY_TEMP = FUSED_REQUESTS // 4, 0.8
RECOVERY_BUDGET_MIN = 0.25
RECOVERY_MEM_SLACK = 64 << 20
FLEET_REPLICAS = 3
# phase 25: bench.py bench_disagg's 1 prefill + 1 decode tier over phase
# 23's engine and wave (closed-loop; phase 28 replays bench's open-loop
# burst); arm (b) runs phase 7c's int8 + spec geometry on two
# decode replicas with max_new_tokens (i % 4 + 1) * DISAGG_SPEC_MAX_NEW,
# which keeps every row's K+1 window inside max_len, so every decode
# dispatch is a spec dispatch whatever rows share it; arm (c)
# faults the first DISAGG_FAULT_REQUESTS requests: the bitflip at the
# DISAGG_BITFLIP_AT-th artifact in transit, the decode replica killed at
# its DISAGG_KILL_AT-th router step, after at least DISAGG_KILL_AFTER
# migrations
DISAGG_SPEC_DECODE, DISAGG_SPEC_MAX_NEW = 2, 15
DISAGG_FAULT_REQUESTS = 64
DISAGG_BITFLIP_AT = 5
DISAGG_KILL_AT, DISAGG_KILL_AFTER = 2, 8
# phase 29: the process fleet on the SERVE_CONFIG model, each worker a
# process of its own that builds the model from seed 0 (bit for bit the
# in-process model) through the presets' llama_engine. (a)-(b) phase 6's
# legacy engine and wave (bench.py bench_fleet's process arm, :826-886,
# best of PROC_TIMED passes after a warm one; the fleet_proc_kill drill);
# (c) 1 + 1 tiers over TCP on phase 23's fused engine, every
# PROC_TIER_STRIDE-th request of its wave; (d) bench.py
# bench_serving_migration_under_loss (:1401-1498) on loopback workers with
# the presets' tiny engine geometry and its 8 x 6-token wave (seed 47).
# PROC_SPAWN_S bounds spawn -> HELLO (torch import, CUDA context, 750M
# init, engine: 7.0-8.4 s measured for the legacy engine on the H100),
# PROC_OP_S every wire op
PROC_PRESETS = "paddle_tpu_torch.inference.procfleet.presets"
PROC_SPAWN_S, PROC_OP_S = 180.0, 120.0
PROC_TIMED = 1          # cut from 3, then 2, to keep the whole run's time
PROC_TIER_STRIDE = 3
LOSS_ENGINE = dict(max_batch=2, max_len=32, page_size=8, block_size=2,
                   prefix_cache=True)
LOSS_REQUESTS, LOSS_PROMPT, LOSS_MAX_NEW, LOSS_OP_S = 8, 6, 8, 5.0
# phases 26-28: bench.py bench_observability (:1026), bench_slo_burst
# (:1133) and bench_disagg (:1259) on the SERVE_CONFIG model (bench's TPU
# arms use a 4-layer, hidden-512 model: a cut that does not carry over),
# with bench's TPU engine geometry and traffic verbatim: 4 slots, max_len
# 256, page 16, block 8, prefix cache; 12 requests of 16-token prompts
# (seed 0), max_new_tokens 48, seeds 700 + i; best-of-2 interleaved waves
# (cut from 4 to keep the whole run's time), each engine first in one of
# them (bench's best-of-3 runs bare first in every round, which mixes the
# order into the comparison)
OBS_ENGINE = dict(max_batch=4, max_len=256, page_size=16, block_size=8)
OBS_REQUESTS, OBS_PROMPT, OBS_MAX_NEW, OBS_SEED0 = 12, 16, 48, 700
OBS_TIMED = 2
#: the span chain every served request must hold, in order
OBS_CHAIN = ("submit", "admit", "first_token", "finish")
# the open-loop burst of bench_slo_burst (seed 23) and bench_disagg (seed
# 29): 6 s at 6 rps, bursts of 1 s every 3 s at x4, prompts 16-48 and
# outputs 8-32 tokens, tenants chat (weight 2, a 16-token shared prefix)
# and batch (weight 1, priority 2); TTFT target 1500 ms over 1 s windows;
# the disagg engines keep extra_blocks = slots
BURST_SLO_SEED, BURST_DISAGG_SEED = 23, 29
BURST_TTFT_MS = 1500.0
# the observatory of tools/traffic_replay.py run_replay (:78-120): its
# selftest burst workload (seed 17), 2-slot engines, a VirtualClock at
# 0.05 s a fleet step, the SLO and the autoscaler's knobs; on the card
# over OBSERVATORY_LAYERS of SERVE_CONFIG's 12 layers at its width (the
# report is the virtual clock's and the scheduler's, the same for any
# model: the CPU run's is a 1-layer tiny model's)
OBSERVATORY_LAYERS = 2
OBSERVATORY_ENGINE = dict(max_batch=2, max_len=32, page_size=8, block_size=2,
                          prefix_cache=True)
OBSERVATORY_SLO = dict(ttft_ms=500.0, inter_token_ms=None,
                       queue_wait_ms=None, target_attainment=0.7,
                       window_s=1.0)
OBSERVATORY_SCALER = dict(min_replicas=1, max_replicas=3, up_after=2,
                          down_after=4, cooldown_windows=1)
OBSERVATORY_DT_S = 0.05
# the JAX package's speculative / int8-KV arm (bench.py bench_speculative,
# :1526-1532 and :1548-1552) at its TPU widths: the SERVE_CONFIG model, 8
# slots, max_len 128 (prompt 64 + max_new 64), page 16, block 4, fused,
# prefix cache with 8 extra blocks (73 pages), SpecConfig(k=4); 16 requests,
# each a random 8-token motif tiled 8 times, max_new_tokens (i % 4 + 1) * 16
SPEC_ENGINE = dict(max_batch=8, max_len=128, page_size=16, block_size=4,
                   fused=True)
SPEC_EXTRA_BLOCKS, SPEC_K = 8, 4
SPEC_MOTIF, SPEC_REPS, SPEC_MAX_NEW = 8, 8, 64
SPEC_TIMED = 2          # best-of-2 waves a engine, interleaved (cut
#                         from 3 to keep the whole run's time)
# context of the spec-step timing: the wave's mean (64 + 64 / 2)
SPEC_STEP_CTX = 96
# context of the decode-step timing: the wave's mean (64 + 40 / 2 ~ 84-96)
FUSED_STEP_CTX = 88
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
# phase 13: bench.py's llama_853M_seq4096_remat line (:1962-1968): the
# headline model with recompute=True and the flash_qkv policy at batch 4;
# then the same at batch 4 without remat, and the policy check at 4 layers
REMAT_CONFIG = dict(TRAIN_CONFIG, recompute=True, remat_policy="flash_qkv")
REMAT_BATCH, REMAT_WARMUP, REMAT_STEPS = 4, 2, 8
REMAT_POLICY_LAYERS = 4
# policy, remat_every, K1-lse launches a step at 4 layers
REMAT_POLICY_CASES = [("flash", 1, 4), ("flash_qkv", 1, 4),
                      ("flash_mlp", 1, 4), ("full", 1, 8), ("full", 2, 6)]
# phase 14: bench.py bench_moe (:1749-1754) at its default dispatch; "auto"
# resolves to scatter at this shape (capacity 5120: 16384 x 8 x 5120 >
# 2^24)
MOE_AUTO_CONFIG = dict(MOE_CONFIG, moe_dispatch="auto")
MOE_AUTO_CAPACITY = 5120
# phase 15: bench_moe's model (MOE_CONFIG: pgmm) served at
# bench_serving_large_batch's wave (FUSED_ENGINE, FUSED_EXTRA_BLOCKS) cold
# then warm; the legacy engine (no prefix cache) on MOE_LEGACY_REQUESTS of
# the requests at 8 slots; the wave once more at moe_dispatch="auto"
MOE_LEGACY_ENGINE = dict(max_batch=8, max_len=128, page_size=16,
                         block_size=16)
MOE_LEGACY_REQUESTS = 16
# phase 16: bench.py bench_serving (:208-246): the SERVE_CONFIG model, 16
# requests of 64-token prompts sharing 48, generate() in batches of 8 with
# max_new_tokens 64 (every row decoded to the batch's max), beside the
# prefix-cache engine (8 slots, max_len 128, page 16, block 16, 8 extra
# blocks) on the same wave; best of GEN_TIMED interleaved waves each (cut
# from 3 to keep the whole run's time)
GEN_REQUESTS, GEN_BATCH, GEN_TIMED = 16, 8, 2
GEN_ENGINE = dict(max_batch=8, max_len=128, page_size=16, block_size=16)
GEN_EXTRA_BLOCKS = 8
# phase 17: phase 7's wave with brownout=True under a pool pressure
# episode: blocks held out of the allocator until the engine enters
# brownout. The engine sizes its pool so that every admission fits
# (max_batch x pages a slot + extra_blocks), so extra_blocks alone cannot
# make it defer; the hold cuts the pool as the JAX package's fault plan
# ("serving.block_pool") does: to the pages the wave's first max_batch / 2
# requests need, so the other half of the slots stand idle and the queue
# head defers from the first step until the first requests finish, far
# past enter_after (2 steps). (The least hold that defers the first
# admission is not enough: one step later the head matches the shared
# prompt's blocks and fits.)
# K5/K6 cases: name, routed rows, experts, k, n, tile_m, dtypes; "main" is
# the train step's: 8 x 2048 tokens x top-2 = 32768 rows, padded to 36864
PGMM_CASES = [
    ("main", MOE_BATCH * MOE_SEQ * 2, 8, 1024, 2816, 512, ("bfloat16",)),
    # phase 15's decode step: 128 rows x top-2 = 256 rows, padded to 4608
    ("decode", FUSED_ENGINE["max_batch"] * 2, 8, 1024, 2816, 512,
     ("bfloat16",)),
    ("small", 3000, 4, 256, 384, 512, ("float32", "bfloat16")),
    ("edge", 1000, 4, 136, 200, 256, ("float32", "bfloat16")),
]
# the MoE card-vs-CPU parity config (fp32, 4 experts, seq 200)
MOE_PARITY_CONFIG = dict(vocab_size=1024, hidden_size=256,
                         intermediate_size=512, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2,
                         max_position_embeddings=256, num_experts=4)
# phase 11's cases: name, config overrides, eval mode. The capacity modes
# run at capacity factor 0.5 (capacity 100 for 400 tokens x top-2 over 4
# experts), so every step drops choices; "auto" resolves to einsum here.
MOE_PARITY_CASES = [
    ("pgmm", dict(moe_dispatch="pgmm"), False),
    ("einsum", dict(moe_dispatch="einsum", moe_capacity_factor=0.5), False),
    ("scatter", dict(moe_dispatch="scatter", moe_capacity_factor=0.5),
     False),
    ("ragged", dict(moe_dispatch="ragged"), False),
    ("auto", dict(moe_dispatch="auto", moe_capacity_factor=0.5), False),
    ("switch_eval", dict(moe_gate="switch", moe_dispatch="scatter",
                         moe_capacity_factor=0.5), True),
    ("remat_flash_scatter", dict(moe_dispatch="scatter",
                                 moe_capacity_factor=0.5, recompute=True,
                                 remat_policy="flash"), False),
]


# phases 30-31: GPT-3 6.7B (the GPT-3 paper's Table 2.1; BASELINE.md
# config 4) at full width: 32 layers, hidden 4096, 32 heads of 128 (MHA),
# intermediate 16384 (GPTConfig's 4 x hidden), 2048 positions, vocab 50304
# (GPTConfig's default), bf16, random weights from seed 0. Phase 31 serves
# it whole (phase 6's legacy wave, phase 7's fused wave); phase 30 trains
# it cut to GPT_TRAIN_LAYERS of its 32 layers (bf16 weights and gradients
# with fp32 AdamW moments of all 32 need ~80 GB) at batch 2 x 2048
GPT_CONFIG = dict(vocab_size=50304, hidden_size=4096, num_hidden_layers=32,
                  num_attention_heads=32, max_position_embeddings=2048,
                  dtype="bfloat16")
GPT_TRAIN_LAYERS = 16
GPT_BATCH, GPT_SEQ, GPT_WARMUP, GPT_STEPS = 2, 2048, 1, 4
# the GPT card-vs-CPU parity config (fp32, head_dim 64; seq 200 is ragged
# against the kernels' tiles)
GPT_PARITY_CONFIG = dict(vocab_size=1024, hidden_size=256,
                         num_hidden_layers=2, num_attention_heads=4,
                         max_position_embeddings=256)
# phase 32: bench.py bench_bert (:152-185): BERT-base (BertConfig(): 12
# layers, hidden 768, 12 heads of 64, vocab 30522) in bf16 with dropout 0,
# BertForSequenceClassification (2 labels), batch 32 x 128, Engine(lr
# 2e-5, clip 1.0, the model's loss_fn): 1 warm-up and 8 timed steps; then
# one BertForMaskedLM step at the same shape (15% of positions labelled)
BERT_CONFIG = dict(dtype="bfloat16", hidden_dropout_prob=0.0,
                   attention_probs_dropout_prob=0.0)
BERT_BATCH, BERT_SEQ, BERT_WARMUP, BERT_STEPS, BERT_LR = 32, 128, 1, 8, 2e-5
BERT_MLM_LABELLED = 0.15
# the BERT card-vs-CPU parity config (fp32, head_dim 64, seq 77: ragged)
BERT_PARITY_CONFIG = dict(vocab_size=1024, hidden_size=256,
                          num_hidden_layers=2, num_attention_heads=4,
                          intermediate_size=512, max_position_embeddings=256,
                          hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0, num_labels=3)
BERT_PARITY_SEQ = 77
# the key biases' gradients are 0 in exact arithmetic (softmax does not see
# a shift of every key's logit): their moments are rounding noise, held to
# this share of the largest moment instead of their own magnitude
BERT_MOMENT_FLOOR = 1e-6
# phase 33: card against CPU, fp32, TF32 off. resnet18(num_classes=10)
# through 3 hapi train_batch steps (Momentum 0.9 at lr 1e-3, batch 16 of
# 3 x 32 x 32), each step started on the card from the CPU's parameters,
# BatchNorm statistics and velocity (a pre-activation that rounding moves
# across ReLU's kink moves a BatchNorm channel's whole gradient, and free
# steps compound it: tests/test_torch_vision.py); the tiny ViT and UNet
# (ViTConfig.tiny, batch 4; UNetConfig.tiny, batch 2 of 16 x 16) loss and
# gradients; each zoo factory in eval mode at 224 px, batch 2
VISION_PARITY_BATCH, VISION_PARITY_LR = 16, 1e-3
ZOO_FACTORIES = [("vgg11", {}), ("vgg13", {}), ("vgg16", {}), ("vgg19", {}),
                 ("vgg11", dict(batch_norm=True)),
                 ("vgg13", dict(batch_norm=True)),
                 ("vgg16", dict(batch_norm=True)),
                 ("vgg19", dict(batch_norm=True)), ("mobilenet_v1", {}),
                 ("mobilenet_v2", {}), ("alexnet", {}), ("squeezenet1_0", {}),
                 ("squeezenet1_1", {})]
ZOO_PX, ZOO_BATCH = 224, 2
# card-vs-CPU bounds (fp32): a loss relative, a parameter after a step
# absolute (lr 1e-3), a BatchNorm statistic, logit or gradient relative to
# its tensor's largest magnitude (at least 1)
VISION_TOL = dict(loss=1e-4, param=1e-4, stat=2e-3, logits=1e-4, grad=1e-4)
# phases 34-36: bench.py's vision arms at their TPU shapes, 1 warm-up and 8
# timed steps each, random weights from seed 0 and inputs from
# default_rng(0), made on the card before the timing. 34: bench_resnet
# (:112-148): resnet18(num_classes=10), batch 256 of 3 x 32 x 32 fp32,
# Momentum(lr 0.1, momentum 0.9), CrossEntropyLoss, hapi.Model.train_batch
# (one host read of the loss a step, as bench's). 35: bench_vit
# (:1681-1730): vit_l_16(dtype="bfloat16"), batch 32 of bf16 224 x 224
# images; 36: bench_unet (:1623-1678): UNET_BENCH_CONFIG, batch 8 of 4 x 32
# x 32 fp32 latents, 77 x 768 context. 35 and 36 run bench's step: the
# loss's gradients, then p - 1e-4 g for every parameter
RESNET_BENCH = dict(batch=256, lr=0.1, momentum=0.9)
VIT_BENCH_BATCH = 32
UNET_BENCH_CONFIG = dict(block_channels=(128, 256, 512), layers_per_block=2,
                         num_heads=8, cross_attention_dim=768,
                         dtype="bfloat16")
UNET_BENCH_BATCH, UNET_BENCH_HW, UNET_BENCH_CTX = 8, 32, 77
BENCH_SGD_LR = 1e-4
VISION_WARMUP, VISION_STEPS = 1, 8
# phase 37: Engine(optimizer=). (a) card against CPU at PARITY_CONFIG's
# depth (2 layers, fp32; LlamaConfig.tiny's head_dim 16 is below the
# kernels' 64), 3 steps of each optimizer of
# tests/test_torch_engine_optimizer.py, the schedule stepped on the host
# after each step; (b) TRAIN_CONFIG at full width under AdamW with the
# warm-up + cosine schedule below, 1 warm-up and OPT_TRAIN_STEPS timed
# steps, then the built-in AdamW engine on the same weights and batches
OPT_TRAIN_STEPS = 8
OPT_TRAIN_SCHEDULE = dict(peak=3e-4, T_max=1000, warmup_steps=100)
OPT_TRAIN_DECAY = 0.01
# phase 38: BASELINE config 1 through hapi.Model.fit: resnet18 on the
# synthetic CIFAR-10 at its split sizes (50000 train / 10000 test images),
# RandomCrop(32, padding=4) + RandomHorizontalFlip + ToTensor + Normalize
# (test: ToTensor + Normalize), batch 256, 4 loader workers, Momentum(0.9,
# weight decay 5e-4) under CosineAnnealingDecay(0.1, T_max 200) stepped by
# the LRScheduler callback; the card-vs-CPU fit first: 3 iterations of
# batch 32 at lr 1e-3 (VISION_TOL's lr), each step started on the card
# from the CPU's state
HAPI_FIT = dict(train=50000, test=10000, batch=256, workers=4, lr=0.1,
                T_max=200, momentum=0.9, weight_decay=5e-4)
HAPI_PARITY = dict(batch=32, iters=3, lr=1e-3)
# The eager Paddle API: the fp16 kernel cases of phases 2, 4 and 5 (the
# shapes phase 41's fp16 arm and the training line give the kernels); the
# small encoder of phase 40's card-vs-CPU AMP parity; BERT-base width built from the
# Paddle layers (BASELINE config 2: vocab 30522, hidden 768, 12 layers of
# 12 heads, FFN 3072, 512 positions, 2 labels) at bench_bert's batch.
FP16_CASES = (BERT_ATTN_SHAPE, TRAIN_SHAPE)
SMALL_ENCODER = dict(vocab=1024, hidden=256, heads=4, ffn=512, layers=2,
                     max_pos=128, labels=2)
SMALL_AMP = dict(batch=8, seq=64, steps=3, lr=1e-4, seed=19, tol=2e-2)
# The dygraph AMP parity's gradient check (phase 40, and tests/
# test_torch_transformer.py against the JAX package): the first step's
# unscaled gradients, each parameter's max abs error over its largest
# reference gradient. 5e-2 is 6.4 bf16 epsilons (2^-7): the white ops
# round inputs and outputs to bf16 at different points in the two runs,
# and the backward compounds it over the layers. A parameter whose
# largest reference gradient is below AMP_NOISE_SHARE (one bf16 rounding,
# 2^-8) of the largest over all parameters is zero to rounding (the
# attention's k biases: softmax ignores a shift of a row's logits) and is
# measured against that largest instead.
AMP_GRAD_TOL = 5e-2
AMP_NOISE_SHARE = 2.0 ** -8
DYGRAPH_BERT = dict(vocab=30522, hidden=768, heads=12, ffn=3072, layers=12,
                    max_pos=512, labels=2)
DYGRAPH = dict(batch=32, seq=128, warmup=2, steps=5, lr=2e-5)
DYGRAPH_ARMS = (("a O1 bf16", "O1", "bfloat16", 1024.0),
                ("b O2 bf16", "O2", "bfloat16", 1024.0),
                ("c O1 fp16", "O1", "float16", None))
OVERFLOW_SCALE = 2.0 ** 40
READINGS = {}   # phase 32's Engine BERT step, read by phase 41
DYGRAPH_MS = {}  # phase 41's ms a step by arm, read by phase 50
# jit and static (phases 50-52) on phase 41's encoder, batch and weights:
# warm-up and timed steps of the to_static arm and of the static program,
# iterations of each deployment timing. The compiled step's first loss
# and gradients against the eager step's: SMALL_AMP["tol"] and
# AMP_GRAD_TOL, as phase 40 reads them. The deployed bf16 logits against
# the eager ones: identical, else within DEPLOY_ULPS bf16 ulps of each
# row's largest logit (the exported graph may round at other points).
# enable_bf16 on an fp32 save against the fp32 logits: BF16_WEIGHT_TOL of
# the largest (the weights rounded to 8 bits, through 12 layers). The
# static program's first fp32 loss (TF32 off) against the eager fp32
# step's: STATIC_LOSS_TOL relative (the compiled graph fuses the
# elementwise ops, so fp32 sums round at other points).
JIT_STATIC = dict(warmup=2, steps=5, deploy_iters=10, static_warmup=1,
                  static_steps=3)
# phases 50 and 52 compile the encoder at 4 of its 12 layers (the Inductor
# compiles dominate their time); phase 51 exports all 12
JIT_BERT = dict(DYGRAPH_BERT, layers=4)
DEPLOY_ULPS = 2
BF16_WEIGHT_TOL = 5e-2
STATIC_LOSS_TOL = 1e-4
# Model compression (phase 53) on phase 41's encoder: QAT warm-up and
# timed steps, PTQ calibration batches, ASP steps, forwards a timing, the
# int8 GEMM's [M, K] x [K, N] (a BERT-base FFN product at 32 x 128
# tokens) against the H100 SXM's dense int8 peak.
COMPRESS = dict(warmup=2, steps=5, calib=4, asp_steps=5, forward_iters=10,
                int8_gemm=(4096, 768, 3072))
INT8_PEAK = 1979e12
# The fused family (phase 54): fused_multi_transformer at GPT-3 6.7B width
# (BASELINE config 4's hidden, heads and ffn) over 2 of its 32 layers,
# prefill 8 x 512 then 16 decode steps; masked_multihead_attention on a
# dense cache [2, batch, heads, max_seq, head_dim]. Card against the CPU
# run in fp32 on the same bf16-rounded values: max |card - cpu| over
# max(1, max |cpu|) within FAMILY_TOL of the card's dtype (bf16's 3e-2 is
# about 8 bf16 ulps, as NN_SWEEP_TOL reads it).
FMT = dict(hidden=4096, heads=32, ffn=16384, layers=2, batch=8, prefill=512,
           decode=16)
MMHA = dict(batch=8, heads=32, max_seq=2048, head_dim=128)
FAMILY_TOL = {"bfloat16": 3e-2, "float32": 1e-4}
# The packages (phase 55): a 4096 x 4096 sparse matrix at 1% density
# (times [4096, 1024] for matmul; [4096, 512] x [512, 4096] sampled for
# masked_matmul), distributions over 10^6 elements, ogbn-arxiv's published
# size (OGB: 169,343 papers, 1,166,243 citation edges, 128-dim features),
# a CRF batch of 64 x 128 steps x 50 tags. Card against CPU in fp32 within
# PACKAGE_TOL (transcendentals and summation order differ by ulps).
SPARSE = dict(n=4096, density=0.01, cols=1024, k=512)
DIST_N = 10 ** 6
OGBN_ARXIV = dict(nodes=169343, edges=1166243, features=128)
VITERBI = dict(batch=64, seq=128, tags=50)
PACKAGE_TOL = 1e-4
# Distributed training (phase 56). (a) one NCCL rank at TRAIN_CONFIG's full
# width and depth: Engine over make_mesh(MESH_1) against Engine(mesh=None)
# on the same seed-0 weights and DIST_STEPS seeded batches of TRAIN_BATCH x
# TRAIN_SEQ; bf16, so the losses agree within DIST_LOSS_RTOL (the same ops
# on the same tensors; the clip's global norm sums its squares in another
# order). (b) two ranks sharing the card over gloo, dp=2, at full width
# with DIST_DP_LAYERS of the 16 layers, one sequence each, against one
# process's mesh=None steps over the same global batch: losses within
# DIST_LOSS_RTOL, each gathered parameter within 2 * lr * steps (Adam
# normalises each update; an element whose bf16 gradient rounds otherwise
# moves by up to lr a step) + |w| / 256 (one bf16 rounding). The same two
# ranks then train the same model and batch on (b)'s other meshes, held to
# the same tolerances: sep=2 (ring attention, zigzag) and pp=2 (GPipe with
# n_micro=2, VPP with pp_interleave=2, zero-bubble). sep=2 alone is held
# to 2 * lr * steps plus DIST_SEP_ULPS bf16 ulps (the ulp at |w| + 2 * lr *
# steps): its ring sums attention in another order, so more elements
# whose gradient is near 0 take the other sign of Adam's lr-sized update,
# and each run rounds each step's update to bf16, up to half an ulp (where
# |w| is in [2**-7, 2**-5), lr = 1e-4 rounds to 2**-13 = 1.22e-4, so an
# element whose sign differs at all three steps is 6 * 2**-13 = 7.3e-4
# apart, over 2 * lr * steps = 6e-4).
# That the drift is rounding and not a fault is held on the card by
# tests/test_torch_cuda.py::test_sep2_fp32_parameters_within_the_lr_bound
# (the same sep=2 run in fp32, within 2 * lr * steps plus fp32 rounding).
# The bound of 2 * lr * steps exceeds what three steps move most weights,
# so each parameter's update (w after the steps minus the seed-0 w) is also
# held to mesh=None's: |du - du_ref| <= DIST_UPDATE_RTOL * |du_ref| in the
# 2-norm over the tensor (a parameter never updated reads 1, an update of
# the wrong sign 2); a planted fault, the blocks of pp stage 1 left at
# their seed-0 values, must fail it on every mesh.
MESH_1 = {"dp": 1, "fsdp": 1, "tp": 1}
DIST_STEPS, DIST_LR, DIST_LOSS_RTOL = 3, 1e-4, 2e-3
DIST_DP_LAYERS = 4
DIST_SEP_ULPS = {"sep2": DIST_STEPS}
DIST_UPDATE_RTOL = 0.5
# (b)'s meshes over the two ranks. gloo runs torch.distributed's
# all_reduce, broadcast, all_gather_into_tensor and reduce_scatter_tensor
# on CUDA tensors (tests/test_torch_cuda.py::
# test_gloo_collectives_on_cuda_tensors), but the functional all-gather
# that DTensor's Shard -> Replicate calls (_functional_collectives.
# all_gather_tensor, in wait_tensor) ends the process with SIGSEGV there
# (torch 2.11+cu128; PERF.md section 7), and tp and fsdp gather: so no tp
# or fsdp. dp's collectives are all-reduces; sep's exchanges are c10d's
# all_gather_into_tensor (the zigzag permutation) and point-to-point
# sends through host copies (the ring); pp's are point-to-point sends,
# broadcasts and all-reduces. tp and fsdp are held against the JAX package
# on the CPU (tests/test_torch_dist_engine.py). Each entry: (label, mesh,
# Engine keywords).
DIST_GLOO_MESHES = (
    ("dp2", {"dp": 2}, {}),
    ("sep2", {"sep": 2}, {}),
    ("pp2", {"pp": 2}, {"n_micro": 2}),
    ("pp2_vpp", {"pp": 2}, {"pp_interleave": 2}),
    ("pp2_zb", {"pp": 2}, {"pp_schedule": "zb"}),
)
DIST_SPAWN_S = 600        # the two ranks' whole run, then they are killed
DIST_BACKEND = "nccl"     # (a)'s one-rank world
# The numeric guard and the resilience trainer (phase 57). (a) bench.py
# bench_guard's config (:1802-1808), not cut: a plain and a GuardPolicy()
# engine from the same seed-0 weights, GUARD_ITERS seeded batches a wave,
# interleaved best of GUARD_WAVES, guard_overhead_pct as bench.py:1834;
# then a nan_grad and (after the warm-up) a loss_spike step under a
# FaultPlan, each leaving every parameter and moment bit-identical.
# (b) bench_checkpoint_publish's config (:672-678), not cut, and its
# 2-replica fleet of legacy engines: a guarded ResilientTrainer (rollback
# policy, no re-warm) takes PUBLISH_STEPS steps of PUBLISH_BATCH with
# async saves every PUBLISH_SAVE_EVERY, a loss_spike at PUBLISH_SPIKE_AT
# rolls it back; the replayed losses equal an uninterrupted run's byte
# for byte where two runs of one step are bitwise equal on the card, else
# within PUBLISH_REPLAY_RTOL. Then CheckpointPublisher.publish swaps the
# warm fleet; its greedy streams equal a cold fleet's built from the same
# checkpoint, token for token; a flipped byte in one shard is refused
# with the serving weights intact.
GUARD_CONFIG = dict(vocab_size=32000, hidden_size=1024,
                    intermediate_size=2816, num_hidden_layers=8,
                    num_attention_heads=16, num_key_value_heads=4,
                    max_position_embeddings=2048, dtype="bfloat16")
GUARD_BATCH, GUARD_SEQ, GUARD_ITERS, GUARD_WAVES = 8, 1024, 8, 3
PUBLISH_CONFIG = dict(vocab_size=32000, hidden_size=512,
                      intermediate_size=1408, num_hidden_layers=4,
                      num_attention_heads=8, num_key_value_heads=8,
                      max_position_embeddings=512, dtype="bfloat16")
PUBLISH_ENGINE = dict(max_batch=4, max_len=256, page_size=16, block_size=8)
PUBLISH_REQUESTS, PUBLISH_NEW = 8, 48
PUBLISH_BATCH = (4, 512)
PUBLISH_STEPS, PUBLISH_SAVE_EVERY, PUBLISH_SPIKE_AT = 8, 2, 5
PUBLISH_REPLAY_RTOL = 1e-3
CIFAR_MEAN = [0.4914, 0.4822, 0.4465]
CIFAR_STD = [0.2470, 0.2435, 0.2616]
# The nn surface (phases 42-43). The sweep's shapes: activations and
# elementwise losses at [4, 512, 1024], class losses over [2048, 1024]
# logits, norms, pools, resizes and 2-D convs at a ResNet stage's map (a
# batch of 16 x [256, 28, 28]), 1-D ops at [16, 256, 784], 3-D ops at [2,
# 64, 16, 28, 28], the recurrent layers at batch 16 x 64 steps x 512
# features (hidden 512). The CPU references take most of the phase's time,
# so the batches are half of a training batch's.
# Each case's reference is the same call on the CPU on the same values:
# in the case's dtype, except the "heavy" bf16 cases (convolutions, the
# resize matmuls, bilinear, the recurrent layers) and the ops without a
# CPU bf16 kernel, whose CPU reference runs in fp32 on the same
# bf16-rounded values and parameters (CPU bf16 kernels there are slow or
# absent; the card accumulates them in fp32). Error: max |card - cpu| over
# max(1, max |cpu|), every output and every gradient (inputs and layer
# parameters) of sum(out * cotangent); bf16's 3e-2 is about 8 bf16 ulps.
NN_ACT = (4, 512, 1024)
NN_LOGITS = (2048, 1024)
NN_MAP = (16, 256, 28, 28)
NN_MAP1 = (16, 256, 784)
NN_MAP3 = (2, 64, 16, 28, 28)
NN_SEQ = (16, 64, 512)
NN_SWEEP_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# Zaremba, Sutskever & Vinyals, "Recurrent Neural Network Regularization"
# (arXiv:1409.2329), section 4.1, the "large" Penn Treebank LSTM: vocab
# 10000, 2 layers of 1500 units, 35 steps unrolled, batch 20, dropout 0.65
# on the non-recurrent connections, Uniform(-0.04, 0.04) init, SGD at lr 1
# with the global gradient norm clipped at 10, the loss summed over the
# steps and averaged over the batch. Tokens from seed 0 (PTB itself is not
# on the machine). LSTM_LM_PARITY: the same model at hidden 64, dropout
# off, card vs CPU on the first step's loss (relative) and gradients (max
# abs error over each parameter's largest CPU gradient).
LSTM_LM = dict(vocab=10000, hidden=1500, layers=2, steps=35, batch=20,
               dropout=0.65, init=0.04, lr=1.0, clip=10.0)
LSTM_LM_TIMED = dict(warmup=3, steps=20)
LSTM_LM_PARITY = dict(hidden=64, dropout=0.0, tol=1e-4)
# The DeepSpeech2 recipe PaddleSpeech ships for Aishell-1 (examples/aishell/
# asr0/conf/deepspeech2.yaml; Amodei et al., arXiv:1512.02595): a 161-bin
# linear spectrogram (20 ms window, 10 ms hop at 16 kHz), two Conv2D +
# BatchNorm2D + Hardtanh(0, 20) blocks of 32 channels, three bidirectional
# GRUs of 1024, a character softmax (4300 characters + blank; the recipe's
# vocabulary file is not in the repository, so the size is of the order of
# Aishell-1's character set) and CTC; Adam at 1e-3 with the global gradient
# norm clipped at 5. Batch 32 of 300-1200 frames (3-12 s), labels of 8-30
# characters, all from seed 0. Cut: the sequence-wise batch norm
# PaddleSpeech keeps inside its GRU stack.
# Phase 44's sizes: CTC [T, batch, classes] with labels 8-30 long; RNN-T
# [batch, T, U + 1, classes]; grid_sample's input [n, c, h, w]; linalg
# batches [b, n, n]; the packed GRU at phase 45's first-layer width.
EXTRAS_CTC = dict(T=400, batch=32, classes=4301, labels=(8, 30))
EXTRAS_RNNT = dict(batch=4, T=200, U=50, classes=1024)
EXTRAS_GRID = (32, 64, 56, 56)
EXTRAS_LINALG = (64, 128)
EXTRAS_GRU = dict(batch=8, frames=400, input=1312, hidden=1024)
# CTC's and RNN-T's fp32 tolerance: their log-domain recursions carry an
# absolute error of about eps x |log-likelihood| (~3500 nats at T 400 over
# 4301 classes: 4e-4), which the posteriors in the gradient inherit as a
# relative error; 2e-3 is ~16 eps x |loss|.
EXTRAS_LATTICE_TOL = 2e-3
# The spectral cases' fp32 tolerance (eigvalsh, svdvals, eigh, svd,
# pca_lowrank on values 1..n): a vector's error is ~eps x |A| / gap = eps x
# n, and a gradient sums n of them (1.35e-4 seen at n 128); 1e-3.
EXTRAS_SPECTRAL_TOL = 1e-3
DS2 = dict(freq=161, channels=32, hidden=1024, layers=3, vocab=4301,
           batch=32, frames=(300, 1200), labels=(8, 30), lr=1e-3, clip=5.0)
DS2_TIMED = dict(warmup=2, steps=8)
DS2_PARITY = dict(DS2, channels=4, hidden=32, vocab=30, batch=4,
                  frames=(60, 120), labels=(3, 10), tol=1e-4)
# Phase 46's sizes: elementwise [64, 1024], batched matrices [16, 64, 64],
# cdist's two point sets, histogramdd's samples, 8 one-second 16 kHz
# waveforms for signal and audio; top_p_sampling on [128, 32000] logits
# and TOP_P_DRAWS draws of one row for the chi-square test.
TX_ELEM = (64, 1024)
TX_MAT = (16, 64, 64)
TX_CDIST = ((8, 256, 64), (8, 128, 64))
TX_HIST = (4096, 3)
TX_SIGNAL = (8, 16000)
TOP_P = (128, 32000)
TOP_P_DRAWS = 4096
# DS2's front end (PaddleSpeech examples/aishell/asr0/conf/deepspeech2.yaml:
# a 161-bin linear spectrogram, 20 ms window, 10 ms hop at 16 kHz); phase
# 49 cuts the parity batch's features to this many frames
DS2_FRONT = dict(n_fft=320, hop_length=160, win_length=320, window="hann",
                 power=2.0)
DS2_FRONT_PARITY_FRAMES = 120
# Phase 48: steps under the profiler (closed 1, ready 1, record 2) and the
# serving arm's new tokens a request
PROFILE_STEPS = 4
PROFILE_SERVE_NEW = 8


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
        (["fp16"] if rest.startswith("I6__half") else []) + \
        (["int8"] if re.match(r"I(f|13__nv_bfloat16)a", rest) else []) + \
        re.findall(r"L[ib](\d+)E", rest.split("EEv")[0])
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


def host_enqueue_s(torch, fn):
    """The host's time to queue ``fn``'s work, in s, with the card held
    by a spin kernel (about 0.2 s) so that no kernel of ``fn`` runs while
    the host queues: a pure host cost unless the launch queue fills.
    Returns (seconds, whether the card was still spinning when the host
    was done)."""
    sync()
    torch.cuda._sleep(400_000_000)
    mark = torch.cuda.Event()
    mark.record()
    t0 = time.perf_counter()
    fn()
    wall = time.perf_counter() - t0
    idle = not mark.query()
    sync()
    return wall, idle


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
    """K1 against its plain version; returns the main-path rows: prefill in
    bf16 and phase 41's BERT shape in fp16."""
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    row = fp16_row = None
    cases = [(c, dn) for dn in ("bfloat16", "float32") for c in K1_CASES]
    cases += [(c, "float16") for c in FP16_CASES]
    for (name, b, s_q, s_kv, hq, hkv, d, causal), dname in cases:
        dtype = getattr(torch, dname)
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
        got = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=library_ms, device_ms=dev_ms)
        if name == "prefill" and dname == "bfloat16":
            row = got
        if name == "bert" and dname == "float16":
            fp16_row = got
        del q, k, v, out, ref
    torch.cuda.empty_cache()
    return row, fp16_row


def _k4_inputs(torch, gen, dtype, hq, hkv, d, page, maxp, lens_list):
    b = len(lens_list)
    npages = b * maxp
    q = torch.randn(b, hq, d, device=DEVICE, generator=gen).to(dtype)
    kc = torch.randn(npages, hkv, page, d, device=DEVICE,
                     generator=gen).to(dtype)
    vc = torch.randn(npages, hkv, page, d, device=DEVICE,
                     generator=gen).to(dtype)
    tables = torch.randperm(npages, device=DEVICE, generator=gen)
    tables = tables.reshape(b, maxp).to(torch.int32)
    lens = torch.tensor(lens_list, dtype=torch.int32, device=DEVICE)
    return q, kc, vc, tables, lens


def phase_k4(torch, ops):
    """K4 against its plain version at K4_CASES, then replayed from a CUDA
    graph; returns the main-path row (bf16, "main")."""
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    row = None
    for dname in ("bfloat16", "float32"):
        dtype = getattr(torch, dname)
        for name, hq, hkv, d, page, maxp, lens_list in K4_CASES:
            args = _k4_inputs(torch, gen, dtype, hq, hkv, d, page, maxp,
                              lens_list)
            q, kc = args[0], args[1]
            out = ops.paged_decode_attention(*args)
            again = ops.paged_decode_attention(*args)
            ref = ops.paged_decode_reference(*args)
            sync()
            err = (out.float() - ref.float()).abs().max().item()
            same = torch.equal(out, again)
            zero_ok = all(out[i].abs().max().item() == 0.0
                          for i, n in enumerate(lens_list) if n == 0)
            ms = cuda_ms(lambda: ops.paged_decode_attention(*args), 50, 5)
            dev_ms = device_ms(torch, lambda: ops.paged_decode_attention(*args),
                               50, 5)
            plain_ms = cuda_ms(lambda: ops.paged_decode_reference(*args), 5, 1)
            ntok = sum(lens_list)
            flops = 4 * d * hq * ntok
            nbytes = (2 * ntok * hkv * d * kc.element_size()
                      + 2 * q.numel() * q.element_size()
                      + args[3].numel() * 4 + args[4].numel() * 4)
            bound_ms, bound_by = bound(flops, nbytes, dname)
            # device_ms re-reads the same pages, which stay in the 50 MB L2
            # cache; a decode step reads each layer's pages once, after
            # other work: cold_ms cycles through input sets that together
            # need more than twice the L2 cache
            sets = [args] + [
                _k4_inputs(torch, gen, dtype, hq, hkv, d, page, maxp,
                           lens_list) for _ in range(-(-L2_BYTES * 2 // nbytes))]
            turn = itertools.cycle(sets)
            cold_ms = device_ms(torch, lambda: ops.paged_decode_attention(
                *next(turn)), 50, 5)
            del sets
            print(f"k4 case={name} dtype={dname} rows={len(lens_list)} "
                  f"heads={hq}/{hkv} d={d} page={page} pages_per_row={maxp} "
                  f"lens={lens_list} max_abs_err={err:.3e} ms={ms:.4f} "
                  f"device_ms={dev_ms:.4f} cold_ms={cold_ms:.4f} "
                  f"plain_ms={plain_ms:.4f} "
                  f"library_ms=null bound_ms={bound_ms:.5f} "
                  f"bound_by={bound_by} share_of_bound="
                  f"{bound_ms / dev_ms:.3f} cold_share_of_bound="
                  f"{bound_ms / cold_ms:.3f} zero_rows_zero={zero_ok} "
                  f"bitwise_repeat={same}", flush=True)
            if not (err <= TOL[dname] and zero_ok and same):
                raise AssertionError(f"K4 {name} {dname}: max abs error "
                                     f"{err} (tol {TOL[dname]}), zero rows "
                                     f"zero {zero_ok}, bitwise repeat {same}")
            if dname == "bfloat16" and name == "main":
                row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by,
                           library_ms=None, device_ms=dev_ms)
            del args, q, kc, out, again, ref
    phase_k4_graph(torch, ops, gen)
    return row


def phase_k4_graph(torch, ops, gen):
    """K4_GRAPH_LAYERS launches at the wave's decode shape captured in a CUDA
    graph, replayed after the lengths and tables are rewritten in place;
    each replayed output must equal an eager call's bit for bit."""
    name, hq, hkv, d, page, maxp, lens_list = next(c for c in K4_CASES
                                                   if c[0] == "wave")
    q, kc, vc, tables, lens = _k4_inputs(torch, gen, torch.bfloat16, hq, hkv,
                                         d, page, maxp, lens_list)
    qs = [torch.randn(q.shape, device=DEVICE, generator=gen).to(q.dtype)
          for _ in range(K4_GRAPH_LAYERS)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for x in qs:
            ops.paged_decode_attention(x, kc, vc, tables, lens)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [ops.paged_decode_attention(x, kc, vc, tables, lens)
                for x in qs]
    lens.copy_(lens.flip(0) - 1)   # new lengths and tables, in place
    tables.copy_(tables.flip(0))
    graph.replay()
    eager = [ops.paged_decode_attention(x, kc, vc, tables, lens) for x in qs]
    sync()
    same = all(torch.equal(o, e) for o, e in zip(outs, eager))
    replay_ms = device_ms(torch, graph.replay, 20, 3) / K4_GRAPH_LAYERS
    eager_ms = device_ms(torch, lambda: [
        ops.paged_decode_attention(x, kc, vc, tables, lens) for x in qs],
        20, 3) / K4_GRAPH_LAYERS
    print(f"k4_graph case={name} launches={K4_GRAPH_LAYERS} "
          f"lens_after_rewrite={lens.tolist()} replay_bitwise_equal={same} "
          f"replay_device_ms_per_launch={replay_ms:.4f} "
          f"eager_device_ms_per_launch={eager_ms:.4f}", flush=True)
    if not same:
        raise AssertionError("K4: the CUDA graph's replay differs from eager "
                             "calls")


def _k4_int8_inputs(torch, ops, gen, dtype, hq, hkv, d, page, maxp,
                    lens_list):
    """_k4_inputs with int8 pools: random bytes in [-127, 127] and random
    per-(page, kv head) scales in [0.5, 3)."""
    q, _, _, tables, lens = _k4_inputs(torch, gen, dtype, hq, hkv, d, page,
                                       maxp, lens_list)
    npages = tables.numel()

    def pool():
        data = torch.randint(-127, 128, (npages, hkv, page, d), device=DEVICE,
                             generator=gen, dtype=torch.int32).to(torch.int8)
        scale = 0.5 + 2.5 * torch.rand(npages, hkv, device=DEVICE,
                                       generator=gen)
        return ops.QuantizedKVPool(data, scale)

    return q, pool(), pool(), tables, lens


def k4_int8_bytes(q, hkv, d, page, lens_list, tables):
    """Bytes K4 must move on int8 pools: the int8 K and V rows the lengths
    need, the two fp32 scales of each page read, q in and out, the tables
    and the lengths."""
    ntok = sum(lens_list)
    pages = sum(-(-n // page) for n in lens_list)
    return (2 * ntok * hkv * d + 2 * pages * hkv * 4
            + 2 * q.numel() * q.element_size() + tables.numel() * 4
            + len(lens_list) * 4)


def phase_k4_int8(torch, ops):
    """K4 on int8 pools against its plain version (the dense gather that
    dequantizes) at K4_INT8_CASES, then replayed from a CUDA graph; returns
    the main-path row (bf16 q, "main")."""
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    row = None
    for dname in ("bfloat16", "float32"):
        dtype = getattr(torch, dname)
        for name, hq, hkv, d, page, maxp, lens_list in K4_INT8_CASES:
            if dname == "float32" and name != "main":
                continue
            args = _k4_int8_inputs(torch, ops, gen, dtype, hq, hkv, d, page,
                                   maxp, lens_list)
            q = args[0]
            out = ops.paged_decode_attention(*args)
            again = ops.paged_decode_attention(*args)
            ref = ops.paged_decode_reference(*args)
            sync()
            err = (out.float() - ref.float()).abs().max().item()
            same = torch.equal(out, again)
            zero_ok = all(out[i].abs().max().item() == 0.0
                          for i, n in enumerate(lens_list) if n == 0)
            ms = cuda_ms(lambda: ops.paged_decode_attention(*args), 50, 5)
            dev_ms = device_ms(torch, lambda: ops.paged_decode_attention(*args),
                               50, 5)
            plain_ms = cuda_ms(lambda: ops.paged_decode_reference(*args), 5, 1)
            flops = 4 * d * hq * sum(lens_list)
            nbytes = k4_int8_bytes(q, hkv, d, page, lens_list, args[3])
            bound_ms, bound_by = bound(flops, nbytes, dname)
            # pages cold in L2, as phase_k4 measures them
            sets = [args] + [
                _k4_int8_inputs(torch, ops, gen, dtype, hq, hkv, d, page,
                                maxp, lens_list)
                for _ in range(-(-L2_BYTES * 2 // nbytes))]
            turn = itertools.cycle(sets)
            cold_ms = device_ms(torch, lambda: ops.paged_decode_attention(
                *next(turn)), 50, 5)
            del sets
            print(f"k4_int8 case={name} dtype={dname} rows={len(lens_list)} "
                  f"heads={hq}/{hkv} d={d} page={page} pages_per_row={maxp} "
                  f"max_abs_err={err:.3e} ms={ms:.4f} "
                  f"device_ms={dev_ms:.4f} cold_ms={cold_ms:.4f} "
                  f"plain_ms={plain_ms:.4f} library_ms=null "
                  f"bound_ms={bound_ms:.5f} bound_by={bound_by} "
                  f"bytes={nbytes} share_of_bound={bound_ms / dev_ms:.3f} "
                  f"cold_share_of_bound={bound_ms / cold_ms:.3f} "
                  f"zero_rows_zero={zero_ok} bitwise_repeat={same}",
                  flush=True)
            if not (err <= TOL[dname] and zero_ok and same):
                raise AssertionError(f"K4 int8 {name} {dname}: max abs "
                                     f"error {err} (tol {TOL[dname]}), zero "
                                     f"rows zero {zero_ok}, bitwise repeat "
                                     f"{same}")
            if dname == "bfloat16" and name == "main":
                row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by,
                           library_ms=None, device_ms=dev_ms,
                           cold_ms=cold_ms)
            del args, q, out, again, ref
    phase_k4_int8_graph(torch, ops, gen)
    return row


def phase_k4_int8_graph(torch, ops, gen):
    """As phase_k4_graph on int8 pools: K4_GRAPH_LAYERS launches captured,
    replayed after the lengths, tables and scales are rewritten in place,
    bitwise equal to eager calls."""
    name, hq, hkv, d, page, maxp, lens_list = next(c for c in K4_CASES
                                                   if c[0] == "wave")
    q, kc, vc, tables, lens = _k4_int8_inputs(torch, ops, gen,
                                              torch.bfloat16, hq, hkv, d,
                                              page, maxp, lens_list)
    qs = [torch.randn(q.shape, device=DEVICE, generator=gen).to(q.dtype)
          for _ in range(K4_GRAPH_LAYERS)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for x in qs:
            ops.paged_decode_attention(x, kc, vc, tables, lens)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [ops.paged_decode_attention(x, kc, vc, tables, lens)
                for x in qs]
    lens.copy_(lens.flip(0) - 1)   # new lengths, tables and scales
    tables.copy_(tables.flip(0))
    kc.scale.mul_(1.5)
    graph.replay()
    eager = [ops.paged_decode_attention(x, kc, vc, tables, lens) for x in qs]
    sync()
    same = all(torch.equal(o, e) for o, e in zip(outs, eager))
    replay_ms = device_ms(torch, graph.replay, 20, 3) / K4_GRAPH_LAYERS
    print(f"k4_int8_graph case={name} launches={K4_GRAPH_LAYERS} "
          f"replay_bitwise_equal={same} "
          f"replay_device_ms_per_launch={replay_ms:.4f}", flush=True)
    if not same:
        raise AssertionError("K4 int8: the CUDA graph's replay differs from "
                             "eager calls")


def _inputs(torch, gen, dtype, b, s_q, s_kv, hq, hkv, d):
    def rnd(*shape):
        return torch.randn(*shape, device=DEVICE, generator=gen).to(dtype)
    return (rnd(b, s_q, hq, d), rnd(b, s_kv, hkv, d), rnd(b, s_kv, hkv, d))


def _case_inputs(torch, gen, dtype, name, b, s_q, s_kv, hq, hkv, d):
    """q, k, v of a kernel case; STRIDED_CASES take them as strided views
    of one [b, s, 3, h, d] buffer (s_q = s_kv, hq = hkv), RING_CASES as
    the ring's stripes of fp32 [b, 2 s, h, d] tensors, each cast to
    ``dtype`` (a contiguous copy, as the ring's _block_attn_lse casts
    them): the diagonal pair the first stripes of q and k/v, the full pair
    q's second stripe against k/v's first."""
    if name in RING_CASES:
        q, k, v = _inputs(torch, gen, torch.float32, b, 2 * s_q, 2 * s_kv,
                          hq, hkv, d)
        lo = s_q if name == "ring_full" else 0
        return (q[:, lo:lo + s_q].to(dtype), k[:, :s_kv].to(dtype),
                v[:, :s_kv].to(dtype))
    if name in STRIDED_CASES:
        qkv = torch.randn(b, s_q, 3, hq, d, device=DEVICE,
                          generator=gen).to(dtype)
        return qkv.unbind(2)
    return _inputs(torch, gen, dtype, b, s_q, s_kv, hq, hkv, d)


def phase_k1_lse(torch, F, ops):
    """K1 with its lse output against the plain forward-with-lse; returns
    the main-path rows: the training shape in bf16 and phase 41's BERT
    shape in fp16."""
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    row = fp16_row = None
    cases = [(c, dn) for dn in ("bfloat16", "float32") for c in K1_CASES]
    cases += [(c, "bfloat16") for c in TRAIN_PATH_SHAPES]
    cases += [(c, "float16") for c in FP16_CASES]
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
        got = dict(max_abs_err=max(err, lse_err), ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=library_ms, device_ms=dev_ms)
        if name == "train" and dname == "bfloat16":
            row = got
        if name == "bert" and dname == "float16":
            fp16_row = got
        del q, k, v, out, lse
    torch.cuda.empty_cache()
    return row, fp16_row


def phase_k2k3(torch, F, ops):
    """K2 and K3 against the plain backward on the same (q, k, v, o, lse,
    dout); returns the main-path rows (K2, K3): the training shape in bf16,
    then phase 41's BERT shape in fp16."""
    # the module (the package attribute of that name is the function)
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    rows, fp16_rows = None, None
    cases = [(c, dn) for c in BWD_CASES for dn in ("bfloat16", "float32")
             if not (c in TRAIN_PATH_SHAPES and dn == "float32")]
    cases += [(c, "float16") for c in FP16_CASES]
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
        dq_dev = device_ms(torch, lambda: fa._launch_dq(q, k, v, o, lse, do,
                                                        causal, scale))
        dkv_dev = device_ms(torch, lambda: fa._launch_dkv(q, k, v, do, lse,
                                                          delta, causal,
                                                          scale))
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
              f"dq_ms={dq_ms:.4f} dkv_ms={dkv_ms:.4f} dq_device_ms="
              f"{dq_dev:.4f} dkv_device_ms={dkv_dev:.4f} plain_ms={plain_ms:.4f}"
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
        got = (dict(max_abs_err=errs["dq"][0], ms=dq_ms, plain_ms=plain_ms,
                    bound_ms=dq_bound[0], bound_by=dq_bound[1],
                    library_ms=library_ms, device_ms=dq_dev),
               dict(max_abs_err=max(errs["dk"][0], errs["dv"][0]),
                    ms=dkv_ms, plain_ms=plain_ms, bound_ms=dkv_bound[0],
                    bound_by=dkv_bound[1], library_ms=library_ms,
                    device_ms=dkv_dev))
        if name == "train" and dname == "bfloat16":
            rows = got
        if name == "bert" and dname == "float16":
            fp16_rows = got
        del q, k, v, do, o, lse, delta
        torch.cuda.empty_cache()
    return rows + fp16_rows


def _engine_steps(torch, Engine, model, batches, lr):
    eng = Engine(model, lr=lr, loss_fn=model.loss_fn)
    losses = [eng.step(ids, labels) for ids, labels in batches]
    return eng, torch.stack(losses).cpu()


def _card_cpu_parity(torch, ops, what, make, batches, lr, floor=0.0):
    """The same Engine steps on the card and on the CPU from the same
    weights (fp32): ``make(device)`` builds the model, ``batches`` holds
    (ids, labels) CPU tensors. The card path runs K1-lse, K2 and K3, the
    CPU path their plain versions; returns their card launches. A
    moment's error is relative to its largest magnitude, or to ``floor``
    times the largest of all moments when that is larger (a parameter
    whose gradient is rounding noise)."""
    from paddle_tpu_torch.distributed import Engine

    cpu, card = make("cpu"), make(DEVICE)
    with torch.no_grad():
        for pc, pg in zip(cpu.parameters(), card.parameters()):
            pg.copy_(pc)
    counts0 = (ops.flash_attention_forward.launches,
               ops.flash_attention_backward.launches_dq,
               ops.flash_attention_backward.launches_dkv)
    ec, lc = _engine_steps(torch, Engine, cpu, batches, lr)
    eg, lg = _engine_steps(torch, Engine, card,
                           [(x.to(DEVICE), y.to(DEVICE)) for x, y in batches],
                           lr)
    sync()
    counts = (ops.flash_attention_forward.launches - counts0[0],
              ops.flash_attention_backward.launches_dq - counts0[1],
              ops.flash_attention_backward.launches_dkv - counts0[2])
    loss_rel = ((lg - lc).abs() / lc.abs()).max().item()
    sc, sg = ec.state_dict(), eg.state_dict()
    worst = {}
    for key in ("model", "m", "v"):
        w = (0.0, "")
        top = max(a.abs().max().item() for a in sc[key].values())
        for name, a in sc[key].items():
            err = (sg[key][name].cpu() - a).abs().max().item()
            if key != "model":   # moments: relative to their magnitude
                err /= max(a.abs().max().item(), floor * top, 1e-30)
            w = max(w, (err, name))
        worst[key] = w
    # Adam normalises each update: an element whose gradient is rounding
    # noise can move by up to lr per step either way, so 2 * lr * steps
    # bounds a parameter's difference; the moments are linear in the
    # gradients and must agree to fp32 reduction order (relative 1e-3)
    steps = len(batches)
    p_tol = 2 * lr * steps
    cfg = cpu.config
    print(f"{what} parity (card vs CPU, fp32, {steps} steps, hidden "
          f"{cfg.hidden_size}, seq {batches[0][0].shape[1]}): losses card "
          f"{[round(x, 6) for x in lg.tolist()]} cpu "
          f"{[round(x, 6) for x in lc.tolist()]} max_rel={loss_rel:.3e}; "
          f"params worst abs {worst['model'][0]:.3e} ({worst['model'][1]}, "
          f"tol {p_tol}); m worst rel {worst['m'][0]:.3e} "
          f"({worst['m'][1]}); v worst rel {worst['v'][0]:.3e} "
          f"({worst['v'][1]}); card launches k1_lse/k2/k3={counts}",
          flush=True)
    L = cfg.num_hidden_layers * steps
    if not (loss_rel <= 1e-4 and worst["model"][0] <= p_tol
            and worst["m"][0] <= 1e-3 and worst["v"][0] <= 1e-3
            and min(counts) >= L):
        raise AssertionError(f"{what} parity card vs CPU failed")
    return counts


def phase_train_parity(torch, np, ops):
    """The same 3 Engine steps on the card and on the CPU from the same
    weights (fp32): the card path runs K1-lse, K2 and K3, the CPU path
    their plain versions."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(**PARITY_CONFIG)
    rng = np.random.default_rng(5)
    batches = [torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (PARITY_BATCH, PARITY_SEQ)))
        for _ in range(PARITY_STEPS)]
    _card_cpu_parity(torch, ops, "train",
                     lambda dev: LlamaForCausalLM(cfg, device=dev, seed=5),
                     [(x, x) for x in batches], PARITY_LR)


def phase_train_full(torch, np, ops, card):
    """The headline config trained at full width and depth; returns the
    main-path launch counts (K1-lse, K2, K3)."""
    from paddle_tpu_torch.models import LlamaConfig

    cfg = LlamaConfig(**TRAIN_CONFIG)
    eng, batches, r = _timed_train(torch, np, ops, cfg, TRAIN_BATCH,
                                   TRAIN_SEQ, TRAIN_WARMUP, TRAIN_STEPS)
    L, H, Q = cfg.num_hidden_layers, cfg.num_attention_heads, cfg.head_dim
    flops_per_token = 6.0 * cfg.num_params() + 6.0 * L * (H * Q) * TRAIN_SEQ
    mfu = r["tok_s"] * flops_per_token / PEAK_FLOPS["bfloat16"]
    counts = (r["launches"]["k1_lse"], r["launches"]["k2"],
              r["launches"]["k3"])
    serving_k1 = r["launches"]["k1"]
    print(f"train [{card}]: tokens_per_s={r['tok_s']:.1f} mfu={mfu:.4f} "
          f"ms_per_step={r['ms']:.2f} peak_mem_gb={r['peak_gb']:.2f} "
          f"({cfg.num_params() / 1e6:.1f}M params, batch {TRAIN_BATCH} x "
          f"seq {TRAIN_SEQ}, {cfg.dtype}, fused CE, no remat); losses "
          f"{[round(x, 4) for x in r['losses'].tolist()]}; launches "
          f"k1_lse/k2/k3={counts} serving_k1={serving_k1}", flush=True)
    _check_losses(r["losses"], "training")
    need = TRAIN_STEPS * L
    if min(counts) < need or serving_k1 != 0:
        raise AssertionError(f"kernels did not carry the train step: "
                             f"{counts} < {need} or serving K1 ran "
                             f"{serving_k1} times")
    _loss_falls(eng, batches[0], "train")
    del eng, batches
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
    main-path rows (bf16, x [36864, 1024] against w [8, 1024, 2816]) and
    K5's rows at the decode layout ({(k, n): row} for the gate/up product
    and the down product)."""
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    rows, decode = {}, {}
    for name, n_rows, e, k, n, tile_m, dnames in PGMM_CASES:
        empty = e // 2
        flat_e = _skewed_routing(torch, np, n_rows, e, 2, empty, 7)
        order, pos_sorted, gids, p = ops.padded_group_layout(flat_e, e,
                                                             n_rows, tile_m)
        pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
        if (gids == empty).any().item():
            raise AssertionError(f"pgmm {name}: expert {empty} owns a tile")
        shapes = [(k, n), (n, k)] if name in ("main", "decode") else [(k, n)]
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
                    dev_ms = device_ms(torch, kern, 10, 2)
                    plain_ms = cuda_ms(plain, 3, 1)
                    library_ms = cuda_ms(lib_fn, 10, 2)
                    bound_ms, bound_by = bound(*work[cname], dname)
                    print(f"pgmm {cname} case={name} dtype={dname} P={p} "
                          f"k={kk} n={nn} experts={e} tile_m={tile_m} "
                          f"max_abs_err={abs_err:.3e} rel_err={err:.3e} "
                          f"ms={ms:.4f} device_ms={dev_ms:.4f} "
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
                    row = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                               bound_ms=bound_ms, bound_by=bound_by,
                               library_ms=library_ms, device_ms=dev_ms)
                    if name == "main" and (kk, nn) == (k, n) \
                            and cname in ("k5", "k6"):
                        rows[cname] = row
                    if name == "decode" and cname == "k5":
                        decode[(kk, nn)] = dict(row, P=p, lib=lib_name)
                del x, dout, w, calls, lib
                torch.cuda.empty_cache()
    return rows["k5"], rows["k6"], decode


def _recording_routes(mod, seen):
    """Patch routed_ffn to append, for every call, its choices on the host:
    the top-k expert ids of the dropless modes, or ``topk_routing``'s
    expert ids and keep mask (the dropped choices) of the capacity modes,
    and the smallest gap between rank-1/rank-2 and rank-k/rank-k+1 gate
    probabilities; returns the real function."""
    real = mod.routed_ffn

    def spy(tokens, probs, expert_fn, k, capacity, *a, **kw):
        p = probs.detach().float()
        s = p.sort(dim=-1, descending=True)
        gap = min((s.values[:, 0] - s.values[:, 1]).min().item(),
                  (s.values[:, k - 1] - s.values[:, k]).min().item())
        mode = mod.resolve_dispatch(kw.get("dispatch_mode", "auto"),
                                    p.shape[0], p.shape[1], capacity,
                                    expert_fn)
        if mode in ("einsum", "scatter"):
            eidx, _, _, keep, _ = mod.topk_routing(p, k, capacity)
            seen.append((mode, eidx.cpu(), keep.cpu(), gap))
        else:
            seen.append((mode, s.indices[:, :k].cpu(), None, gap))
        return real(tokens, probs, expert_fn, k, capacity, *a, **kw)
    mod.routed_ffn = spy
    return real


def _moe_parity_case(torch, np, ops, moe_mod, name, over, evaluate):
    """One phase-11 case: 3 Engine steps on the CPU and on the card from
    the same weights; returns the card's K5/K6/K1-lse launches."""
    from paddle_tpu_torch.distributed import Engine
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(**MOE_PARITY_CONFIG, **over)
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=8)
    card = LlamaForCausalLM(cfg, device=DEVICE, seed=8)
    with torch.no_grad():
        for pc, pg in zip(cpu.parameters(), card.parameters()):
            pg.copy_(pc)
    if evaluate:
        cpu.eval()
        card.eval()
    rng = np.random.default_rng(8)
    batches = [torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (PARITY_BATCH, PARITY_SEQ)))
        for _ in range(PARITY_STEPS)]
    routes = {"cpu": [], "card": []}
    real = _recording_routes(moe_mod, routes["cpu"])
    ec, lc = _engine_steps(torch, Engine, cpu, [(x, x) for x in batches],
                           PARITY_LR)
    moe_mod.routed_ffn = real
    _recording_routes(moe_mod, routes["card"])
    n0 = (ops.pgmm.launches, ops.pgmm_dw.launches,
          ops.flash_attention_forward.launches)
    eg, lg = _engine_steps(torch, Engine, card,
                           [(x.to(DEVICE), x.to(DEVICE)) for x in batches],
                           PARITY_LR)
    sync()
    counts = (ops.pgmm.launches - n0[0], ops.pgmm_dw.launches - n0[1],
              ops.flash_attention_forward.launches - n0[2])
    moe_mod.routed_ffn = real
    # the gates' fp32 matmuls round differently on the two devices, so a
    # near-tie could route a token elsewhere: count the choices (and the
    # dropped choices) that differ
    pairs = list(zip(routes["cpu"], routes["card"]))
    flips = sum(int((a[1] != b[1]).sum()) for a, b in pairs)
    drop_flips = sum(int((a[2] != b[2]).sum()) for a, b in pairs
                     if a[2] is not None)
    dropped = sum(int((~a[2]).sum()) for a, _ in pairs if a[2] is not None)
    modes = sorted({r[0] for r in routes["card"]})
    gap = min(r[3] for r in routes["cpu"])
    loss_rel = ((lg - lc).abs() / lc.abs()).max().item()
    sc, sg = ec.state_dict(), eg.state_dict()
    worst = {}
    for key in ("model", "m", "v"):
        w = (0.0, "")
        for pname, a in sc[key].items():
            err = (sg[key][pname].cpu() - a).abs().max().item()
            if key != "model":
                err /= max(a.abs().max().item(), 1e-30)
            w = max(w, (err, pname))
        worst[key] = w
    p_tol = 2 * PARITY_LR * PARITY_STEPS   # as phase_train_parity derives
    L = cfg.num_hidden_layers * PARITY_STEPS
    grouped = name in ("pgmm", "ragged")
    want = (6 * L, 3 * L) if grouped else (0, 0)
    topk = 1 if cfg.moe_gate == "switch" else cfg.moe_topk
    print(f"moe parity {name} (card vs CPU, fp32, {PARITY_STEPS} steps, "
          f"{cfg.num_experts} experts top-{topk} {cfg.moe_gate}, dispatch "
          f"{modes}, capacity "
          f"factor {cfg.moe_capacity_factor}{', eval' if evaluate else ''}"
          f"{', remat ' + cfg.remat_policy if cfg.recompute else ''}): "
          f"losses card {[round(x, 6) for x in lg.tolist()]} cpu "
          f"{[round(x, 6) for x in lc.tolist()]} max_rel={loss_rel:.3e}; "
          f"params worst abs {worst['model'][0]:.3e} ({worst['model'][1]}, "
          f"tol {p_tol}); m worst rel {worst['m'][0]:.3e}; v worst rel "
          f"{worst['v'][0]:.3e}; routing: {flips} of "
          f"{sum(a[1].numel() for a, _ in pairs)} expert choices and "
          f"{drop_flips} drop decisions differ ({dropped} choices dropped "
          f"on the CPU), smallest top-k gap (CPU) {gap:.3e}; card launches "
          f"k5/k6/k1_lse={counts}", flush=True)
    calls = L * (2 if cfg.recompute else 1)   # a recompute routes again
    if not (loss_rel <= 1e-4 and worst["model"][0] <= p_tol
            and worst["m"][0] <= 1e-3 and worst["v"][0] <= 1e-3
            and counts[:2] == want and counts[2] == L
            and flips == 0 and drop_flips == 0
            and len(routes["card"]) == len(routes["cpu"]) == calls
            and (grouped or name == "auto" or dropped > 0)):
        raise AssertionError(f"MoE training parity card vs CPU failed "
                             f"({name})")
    return counts


def phase_moe_parity(torch, np, ops):
    """3 Engine steps of a tiny fp32 MoE Llama on the card and on the CPU
    from the same weights, for each dispatch (MOE_PARITY_CASES): the card
    path runs K5/K6 (pgmm, ragged) and K1-lse/K2/K3, the CPU path their
    plain versions."""
    moe_mod = importlib.import_module(
        "paddle_tpu_torch.incubate.distributed.models.moe.moe_layer")
    for name, over, evaluate in MOE_PARITY_CASES:
        _moe_parity_case(torch, np, ops, moe_mod, name, over, evaluate)


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
    the main-path launch counts (K5, K6) of the timed steps and the line's
    numbers (ms, tokens/s, peak memory, activated MFU)."""
    from paddle_tpu_torch.models import LlamaConfig

    cfg = LlamaConfig(**MOE_CONFIG)
    eng, batches, r = _timed_train(torch, np, ops, cfg, MOE_BATCH, MOE_SEQ,
                                   MOE_WARMUP, MOE_STEPS)
    n_total, n_act, fpt = moe_flops_per_token(cfg, eng.model, MOE_SEQ)
    mfu = r["tok_s"] * fpt / PEAK_FLOPS["bfloat16"]
    per_step = [r["per_step"][k] for k in ("k5", "k6", "k1_lse", "k2", "k3")]
    serving_k1 = r["launches"]["k1"]
    print(f"moe train [{card}]: tokens_per_s={r['tok_s']:.1f} "
          f"activated_mfu={mfu:.4f} ms_per_step={r['ms']:.2f} "
          f"peak_mem_gb={r['peak_gb']:.2f} ({n_total / 1e6:.1f}M params, "
          f"{n_act / 1e6:.1f}M activated, {cfg.num_experts} experts top-"
          f"{cfg.moe_topk} pgmm, batch {MOE_BATCH} x seq {MOE_SEQ}, "
          f"{cfg.dtype}); losses "
          f"{[round(x, 4) for x in r['losses'].tolist()]}; launches per "
          f"step k5/k6/k1_lse/k2/k3={per_step} serving_k1={serving_k1}",
          flush=True)
    L = cfg.num_hidden_layers
    if per_step != [6 * L, 3 * L, L, L, L] or serving_k1 != 0:
        raise AssertionError(f"kernels did not carry the MoE step: per step "
                             f"{per_step} != {[6 * L, 3 * L, L, L, L]} or "
                             f"serving K1 ran {serving_k1} times")
    _check_losses(r["losses"], "MoE")
    syncs = _sync_count(torch, lambda: eng.step(batches[1], batches[1]))
    print(f"moe step under set_sync_debug_mode: {len(syncs)} synchronizing "
          f"operations", flush=True)
    for msg in syncs[:5]:
        print(f"  {msg[:160]}", flush=True)
    if syncs:
        raise AssertionError(f"the MoE step synchronized {len(syncs)} times")
    _loss_falls(eng, batches[0], "moe")
    del eng, batches
    torch.cuda.empty_cache()
    return r["launches"]["k5"], r["launches"]["k6"], dict(
        ms=r["ms"], tok_s=r["tok_s"], peak_gb=r["peak_gb"], mfu=mfu)


def _reset_counts(ops):
    for fn in (ops.flash_attention, ops.flash_attention_forward, ops.pgmm,
               ops.pgmm_dw):
        fn.launches = 0
    ops.flash_attention_backward.launches_dq = 0
    ops.flash_attention_backward.launches_dkv = 0
    ops.flash_attention_backward.launches_glse = 0


def _read_counts(ops):
    return dict(k1=ops.flash_attention.launches,
                k1_lse=ops.flash_attention_forward.launches,
                k2=ops.flash_attention_backward.launches_dq,
                k2_glse=ops.flash_attention_backward.launches_glse,
                k3=ops.flash_attention_backward.launches_dkv,
                k5=ops.pgmm.launches, k6=ops.pgmm_dw.launches)


def _timed_train(torch, np, ops, cfg, batch, seq, warmup, steps,
                 build=None):
    """Build ``cfg`` on the card (random weights, seed 0; ``build``, the
    model class, is LlamaForCausalLM unless given) under
    Engine(lr=1e-4, clip 1.0); ``warmup`` steps on one batch, then
    ``steps`` timed steps on fresh batches with every launch count set to 0
    just before and read just after. Returns (engine, batches, stats):
    ms a step, tokens/s, peak memory (GB, from the model's construction
    on), launches a step, the losses."""
    from paddle_tpu_torch.distributed import Engine
    from paddle_tpu_torch.models import LlamaForCausalLM

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = (build or LlamaForCausalLM)(cfg, device=DEVICE, seed=0)
    eng = Engine(model, lr=1e-4, clip_norm=1.0)
    rng = np.random.default_rng(0)
    batches = [torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, seq)).astype(np.int32)).to(DEVICE)
        for _ in range(steps)]
    losses = [eng.step(batches[0], batches[0]) for _ in range(warmup)]
    sync()
    _reset_counts(ops)
    t0 = time.perf_counter()
    for ids in batches:
        losses.append(eng.step(ids, ids))
    losses[-1].item()           # one host read fences the chain
    wall = time.perf_counter() - t0
    counts = _read_counts(ops)
    return eng, batches, dict(
        ms=wall / steps * 1e3, tok_s=batch * seq * steps / wall,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        per_step={k: v / steps for k, v in counts.items()},
        launches=counts, losses=torch.stack(losses).float().cpu())


def _loss_falls(eng, ids, what):
    """6 steps at lr 1e-3 on one batch: the loss must fall."""
    eng.lr = 1e-3
    fixed = [eng.step(ids, ids) for _ in range(6)]
    first, final = fixed[0].item(), fixed[-1].item()
    print(f"{what} fixed batch (lr 1e-3, 6 steps): first loss {first:.4f} "
          f"last loss {final:.4f}", flush=True)
    if not final < first:
        raise AssertionError(f"{what}: loss did not fall on a fixed batch: "
                             f"{first} -> {final}")


def _check_losses(vals, what):
    if not bool(vals.isfinite().all()):
        raise AssertionError(f"non-finite {what} loss: {vals.tolist()}")
    if not 9.0 <= vals[0].item() <= 12.5:
        raise AssertionError(f"first {what} loss {vals[0].item()} outside "
                             f"[9, 12.5] (ln 32000 = 10.37, ln 50304 = "
                             f"10.83)")


def phase_remat_train(torch, np, ops, card):
    """bench.py's remat line (853M, seq 4096, batch 4, flash_qkv) trained
    at full width and depth, the same at batch 4 without remat, and the
    K1-lse launches of each policy at 4 layers; returns the main-path
    launch counts (K1-lse, K2, K3) of the remat run's timed steps."""
    from paddle_tpu_torch.models import LlamaConfig

    cfg = LlamaConfig(**REMAT_CONFIG)
    L, H, Q = cfg.num_hidden_layers, cfg.num_attention_heads, cfg.head_dim
    # bench.py:101-103's model FLOPs: no recompute counted
    fpt = 6.0 * cfg.num_params() + 6.0 * L * (H * Q) * TRAIN_SEQ
    eng, batches, r = _timed_train(torch, np, ops, cfg, REMAT_BATCH,
                                   TRAIN_SEQ, REMAT_WARMUP, REMAT_STEPS)
    per = r["per_step"]
    print(f"remat train [{card}]: tokens_per_s={r['tok_s']:.1f} mfu="
          f"{r['tok_s'] * fpt / PEAK_FLOPS['bfloat16']:.4f} ms_per_step="
          f"{r['ms']:.2f} peak_mem_gb={r['peak_gb']:.2f} "
          f"({cfg.num_params() / 1e6:.1f}M params, batch {REMAT_BATCH} x "
          f"seq {TRAIN_SEQ}, {cfg.dtype}, remat {cfg.remat_policy} every "
          f"{cfg.remat_every}); losses "
          f"{[round(x, 4) for x in r['losses'].tolist()]}; launches per "
          f"step k1_lse/k2/k3={per['k1_lse']}/{per['k2']}/{per['k3']} "
          f"serving_k1={r['launches']['k1']}", flush=True)
    _check_losses(r["losses"], "remat")
    if (per["k1_lse"], per["k2"], per["k3"]) != (L, L, L) \
            or r["launches"]["k1"] != 0:
        raise AssertionError(f"remat step launches: K1-lse/K2/K3 per step "
                             f"{per['k1_lse']}/{per['k2']}/{per['k3']} != "
                             f"{L} each (a saved forward runs once), or "
                             f"serving K1 ran {r['launches']['k1']} times")
    _loss_falls(eng, batches[0], "remat")
    launches = (r["launches"]["k1_lse"], r["launches"]["k2"],
                r["launches"]["k3"])
    del eng, batches
    cfg0 = LlamaConfig(**dict(REMAT_CONFIG, recompute=False))
    eng, batches, r0 = _timed_train(torch, np, ops, cfg0, REMAT_BATCH,
                                    TRAIN_SEQ, REMAT_WARMUP, REMAT_STEPS)
    _check_losses(r0["losses"], "no-remat batch-4")
    print(f"no-remat batch-4 train [{card}]: tokens_per_s={r0['tok_s']:.1f} "
          f"ms_per_step={r0['ms']:.2f} peak_mem_gb={r0['peak_gb']:.2f}; "
          f"remat tax (ms ratio) {r['ms'] / r0['ms']:.4f}, peak memory "
          f"ratio {r['peak_gb'] / r0['peak_gb']:.4f}", flush=True)
    del eng, batches
    if not r["peak_gb"] < r0["peak_gb"]:
        raise AssertionError(f"remat peak memory {r['peak_gb']} GB is not "
                             f"below no-remat's {r0['peak_gb']} GB")
    for policy, every, want in REMAT_POLICY_CASES:
        cfgp = LlamaConfig(**dict(REMAT_CONFIG,
                                  num_hidden_layers=REMAT_POLICY_LAYERS,
                                  remat_policy=policy, remat_every=every))
        eng, _, rp = _timed_train(torch, np, ops, cfgp, REMAT_BATCH,
                                  TRAIN_SEQ, 1, 2)
        per = rp["per_step"]
        print(f"remat policy {policy} every {every} ({REMAT_POLICY_LAYERS} "
              f"layers, batch {REMAT_BATCH} x seq {TRAIN_SEQ}) [{card}]: "
              f"k1_lse per step {per['k1_lse']} (want {want}), k2/k3 "
              f"{per['k2']}/{per['k3']}, ms_per_step={rp['ms']:.2f} "
              f"peak_mem_gb={rp['peak_gb']:.2f}", flush=True)
        del eng
        if (per["k1_lse"], per["k2"], per["k3"]) != (
                want, REMAT_POLICY_LAYERS, REMAT_POLICY_LAYERS):
            raise AssertionError(f"remat policy {policy} every {every}: "
                                 f"K1-lse {per['k1_lse']} a step, want "
                                 f"{want}")
    torch.cuda.empty_cache()
    return launches


def phase_moe_auto_train(torch, np, ops, card, pgmm):
    """bench.py bench_moe at its default dispatch ("auto", which resolves
    to scatter here), trained at full width and depth beside phase 12's
    pgmm line; returns the main-path launch counts (K1-lse, K2, K3)."""
    from paddle_tpu_torch.incubate.distributed.models.moe import \
        resolve_dispatch
    from paddle_tpu_torch.models import LlamaConfig

    cfg = LlamaConfig(**MOE_AUTO_CONFIG)
    eng, batches, r = _timed_train(torch, np, ops, cfg, MOE_BATCH, MOE_SEQ,
                                   MOE_WARMUP, MOE_STEPS)
    mlp = eng.model.model.layers[0].mlp
    n = MOE_BATCH * MOE_SEQ
    cap = mlp.capacity(n)
    mode = resolve_dispatch(mlp.dispatch_mode, n, cfg.num_experts, cap,
                            mlp.experts)
    n_total, n_act, fpt = moe_flops_per_token(cfg, eng.model, MOE_SEQ)
    mfu = r["tok_s"] * fpt / PEAK_FLOPS["bfloat16"]
    per = r["per_step"]
    print(f"moe auto train [{card}]: dispatch auto -> {mode} (capacity "
          f"{cap}) tokens_per_s={r['tok_s']:.1f} activated_mfu={mfu:.4f} "
          f"ms_per_step={r['ms']:.2f} peak_mem_gb={r['peak_gb']:.2f}; "
          f"pgmm (phase 12, same run): tokens_per_s={pgmm['tok_s']:.1f} "
          f"activated_mfu={pgmm['mfu']:.4f} ms_per_step={pgmm['ms']:.2f} "
          f"peak_mem_gb={pgmm['peak_gb']:.2f}; scatter/pgmm ms ratio "
          f"{r['ms'] / pgmm['ms']:.4f}; losses "
          f"{[round(x, 4) for x in r['losses'].tolist()]}; launches per step "
          f"k5/k6/k1_lse/k2/k3={per['k5']}/{per['k6']}/{per['k1_lse']}/"
          f"{per['k2']}/{per['k3']} serving_k1={r['launches']['k1']}",
          flush=True)
    L = cfg.num_hidden_layers
    if mode != "scatter" or cap != MOE_AUTO_CAPACITY:
        raise AssertionError(f"auto resolved to {mode} at capacity {cap}, "
                             f"want scatter at {MOE_AUTO_CAPACITY}")
    if [per[k] for k in ("k5", "k6", "k1_lse", "k2", "k3")] != \
            [0, 0, L, L, L] or r["launches"]["k1"] != 0:
        raise AssertionError(f"MoE auto step launches per step {per}, want "
                             f"K5/K6 0 and K1-lse/K2/K3 {L}")
    _check_losses(r["losses"], "MoE auto")
    syncs = _sync_count(torch, lambda: eng.step(batches[1], batches[1]))
    print(f"moe auto step under set_sync_debug_mode: {len(syncs)} "
          f"synchronizing operations", flush=True)
    for msg in syncs[:5]:
        print(f"  {msg[:160]}", flush=True)
    if syncs:
        raise AssertionError(f"the MoE auto step synchronized {len(syncs)} "
                             f"times")
    _loss_falls(eng, batches[0], "moe auto")
    launches = (r["launches"]["k1_lse"], r["launches"]["k2"],
                r["launches"]["k3"])
    del eng, batches
    torch.cuda.empty_cache()
    return launches


def _n_params(model):
    return sum(p.numel() for p in model.parameters())


def phase_serving(torch, np, ops, card):
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    t0 = time.perf_counter()
    model = LlamaForCausalLM(LlamaConfig(**SERVE_CONFIG), device=DEVICE,
                             seed=0)
    return _serve_legacy(torch, np, ops, card, model, "", t0)


def _serve_legacy(torch, np, ops, card, model, tag, t0):
    """Phase 6's engine and wave on ``model`` (built since ``t0``), its
    checks and timings; ``tag`` prefixes the printed lines. Returns the
    wave's K1 and K4 launches."""
    from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                    Request)

    cfg = model.config
    eng = ContinuousBatchingEngine(model, device=DEVICE, **ENGINE)
    sync()
    print(f"{tag}serving setup: {_n_params(model) / 1e6:.1f}M params, "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    warm, prompts, kws, rng = _legacy_wave(np, cfg.vocab_size)

    def prompt(n):
        return rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)

    bucket = ENGINE["prompt_buckets"][0]
    # warm-up (cuBLAS handles, first launches), not counted
    for p in warm:
        eng.add_request(Request(p, max_new_tokens=4))
    eng.run_until_done()

    eos_id = LEGACY_EOS
    reqs = [Request(p, **kw) for p, kw in zip(prompts, kws)]
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
    print(f"{tag}serving wave: {len(done)} requests, prefill_groups={groups} "
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
    tf = _teacher_forced(torch, np, model, [r.prompt for r in reqs],
                         [r.output for r in reqs])
    print(f"{tag}teacher-forced: {tf}", flush=True)
    if not tf.ok():
        raise AssertionError(f"teacher-forced check: {tf}")

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
    print(f"{tag}serving [{card}]: useful_tokens_per_s={useful / wall:.1f} "
          f"({useful} tokens in {wall:.3f}s, {len(reqs)} requests, {slots} "
          f"slots) prefill_ms={prefill_ms:.3f} (4 x {bucket} tokens, {L} "
          f"layers) decode_ms_per_step={step_ms:.3f} ({slots} rows at "
          f"context {ctx})", flush=True)
    return k1_launches, k4_launches


def _fused_wave(np, vocab, n=FUSED_REQUESTS):
    """``n`` prompts (a shared system prompt and a random tail, from seed
    0) and their max_new_tokens, as bench.py's serving arms make them."""
    rng = np.random.default_rng(0)
    system = rng.integers(0, vocab, (FUSED_SHARED,)).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(
        0, vocab, (FUSED_PROMPT - FUSED_SHARED,)).astype(np.int32)])
        for _ in range(n)]
    news = [(i % 4 + 1) * FUSED_MAX_NEW // 4 for i in range(n)]
    return prompts, news


class Trail:
    """The teacher-forced check's readings over the emitted tokens it
    was given (``add``): the worst trail of an emitted token's logit
    behind its position's maximum, in bf16 ulps of that maximum
    (MARGIN_ULPS) and in logits, with where it lies and how near a tie
    that position is; how many emitted tokens are the argmax; the median
    top1-top2 gap and the mean logit std over the positions."""

    def __init__(self, torch):
        self.torch = torch
        self.ulps, self.abs, self.top1, self.n = 0.0, 0.0, 0, 0
        self.at = None
        self.gaps, self.stds = [], []

    def add(self, logits, emitted, where):
        """``logits`` [g, k, vocab] (fp32), ``emitted`` [g, k] ids;
        ``where(r, t)`` names row r's t-th emitted position."""
        torch = self.torch
        top2 = logits.topk(2, dim=-1).values
        best = top2[..., 0]
        got = logits.gather(-1, emitted[..., None])[..., 0]
        # frexp: best = m 2**e with |m| in [0.5, 1), so a bf16 ulp of it
        # (8 significant bits) is 2**(e - 8)
        ulp = torch.ldexp(torch.ones_like(best), torch.frexp(best)[1] - 8)
        trail = best - got
        ulps = trail / ulp
        self.top1 += int((got >= best).sum().item())
        self.n += got.numel()
        self.abs = max(self.abs, trail.max().item())
        self.gaps.append((top2[..., 0] - top2[..., 1]).flatten())
        self.stds.append(logits.std(dim=-1).flatten())
        i = int(ulps.argmax().item())
        r, t = divmod(i, ulps.shape[-1])
        if self.at is None or ulps[r, t].item() > self.ulps:
            self.ulps = ulps[r, t].item()
            rank = int((logits[r, t] > got[r, t]).sum().item())
            self.at = (f"{where(r, t)}: max logit {best[r, t].item():.4f} "
                       f"(ulp {ulp[r, t].item():g}), trail "
                       f"{trail[r, t].item():.4f}, top1-top2 gap "
                       f"{(top2[r, t, 0] - top2[r, t, 1]).item():.4f}, "
                       f"emitted token's rank {rank + 1}")

    def ok(self):
        return self.ulps <= MARGIN_ULPS

    def __str__(self):
        if not self.n:
            return "no emitted tokens"
        cat = self.torch.cat
        return (f"worst trail {self.ulps:g} ulps of the max logit, "
                f"{self.abs:.4f} in logits (margin {MARGIN_ULPS} ulps); "
                f"the emitted token is the dense argmax for {self.top1} of "
                f"{self.n}; worst at {self.at}; median top1-top2 gap "
                f"{cat(self.gaps).median().item():.4f}, mean logit std "
                f"{cat(self.stds).mean().item():.4f}")


def _teacher_forced(torch, np, model, prompts, outputs):
    """The teacher-forced readings (a :class:`Trail`) of every emitted
    token of ``outputs``: the dense forward run over prompt + output,
    batched by prompt and output length."""
    trail = Trail(torch)
    by_len = {}
    for i, (p, out) in enumerate(zip(prompts, outputs)):
        by_len.setdefault((len(p), len(out)), []).append((i, p, out))
    with torch.no_grad():
        for (plen, _), rows in sorted(by_len.items()):
            seqs = np.stack([np.concatenate([p, np.asarray(o, np.int32)])
                             for _, p, o in rows])
            ids = torch.from_numpy(seqs[:, :-1]).to(DEVICE)
            start = plen - 1
            logits = model(ids)[:, start:].float()       # [g, k, vocab]
            emitted = torch.from_numpy(seqs[:, start + 1:].astype(
                np.int64)).to(DEVICE)
            trail.add(logits, emitted,
                      lambda r, t, rows=rows: f"stream {rows[r][0]} token {t}")
    return trail


class _RouteRecorder:
    """Records the experts an engine's MoE layers choose for the tokens of
    a wave's streams: ``routes[(stream, position)]`` = the top-k expert ids
    of each layer [L, k]. ``ctx`` is set, around each model call that
    carries stream tokens, to each of its flat rows' (stream, position) or
    None; a call whose row count differs from it is not recorded."""

    def __init__(self, torch, model):
        self.torch, self.model = torch, model
        self.k = model.config.moe_topk
        self.L = model.config.num_hidden_layers
        self.ctx = None
        self.routes = {}

    def __enter__(self):
        for i, layer in enumerate(self.model.model.layers):
            layer.mlp.gate.probs = self._recording(i, layer.mlp.gate)
        return self

    def __exit__(self, *exc):
        for layer in self.model.model.layers:
            del layer.mlp.gate.probs

    def _recording(self, i, gate):
        cls_probs = type(gate).probs

        def probs(inp):
            p = cls_probs(gate, inp)
            if self.ctx is not None and len(self.ctx) == p.shape[0]:
                top = p.topk(self.k, dim=-1).indices.tolist()
                for key, experts in zip(self.ctx, top):
                    if key is not None:
                        self.routes.setdefault(key, [None] * self.L)[i] = \
                            experts
            return p
        return probs

    def around(self, obj, name, ctx_of):
        """Wrap ``obj.name`` so that each call records under the context
        ``ctx_of(*args)`` gives."""
        orig = getattr(obj, name)

        def call(*args, **kw):
            self.ctx = ctx_of(*args)
            try:
                return orig(*args, **kw)
            finally:
                self.ctx = None
        setattr(obj, name, call)


def _recorded_wave(torch, np, eng, Request, prompts, news):
    """The wave through ``eng`` (radix cache emptied first) with its decode
    steps run eagerly and the experts its MoE layers choose recorded for
    every token whose logits give an emitted token: the decode steps
    (fused: ``_fused_step``; legacy: ``model.paged_token_step``), the
    first-token steps (``_first_token``) or prefill chunks
    (``_prefill_group``). The eager step computes what the captured graph
    replays (the card tests hold them bitwise equal). Returns (streams,
    routes)."""
    reqs = [Request(p, max_new_tokens=k) for p, k in zip(prompts, news)]
    index = {id(r): i for i, r in enumerate(reqs)}
    rec = _RouteRecorder(torch, eng.model)

    def slot_key(i, pos):
        r = eng._slots[i]
        return None if r is None else (index[id(r)], int(pos))

    if eng._fused:
        def fused_ctx(*_):
            act = eng._dev_act.tolist()
            pos = eng._dev_pos.tolist()
            return [slot_key(i, pos[i] - 1) if act[i] else None
                    for i in range(eng.max_batch)]
        rec.around(eng, "_fused_step", fused_ctx)
        rec.around(eng, "_first_token", lambda ready: [
            (index[id(r)], len(r.prompt) - 1) for _, r in ready]
            + [None] * (eng._first_token_group(len(ready)) - len(ready)))
        graph, eng._graph = eng._graph, None
    else:
        rec.around(eng.model, "paged_token_step", lambda toks, caches, pos: [
            slot_key(i, p) for i, p in enumerate(pos.tolist())])
        rec.around(eng, "_prefill_group", lambda padded, grp: [
            (index[id(r)], t) if t < len(r.prompt) else None
            for _, r in grp for t in range(padded)])
    if eng.prefix_cache is not None:
        eng._radix.evict_lru(eng._alloc.num_blocks)
    try:
        with rec:
            for r in reqs:
                eng.add_request(r)
            eng.run_until_done(max_steps=40000)
    finally:
        for obj, name in ((eng, "_fused_step"), (eng, "_first_token"),
                          (eng, "_prefill_group"),
                          (eng.model, "paged_token_step")):
            obj.__dict__.pop(name, None)
        if eng._fused:
            eng._graph = graph
    return [list(r.output) for r in reqs], rec.routes


def _moe_margin_check(torch, np, model, prompts, outputs, routes, what,
                      card):
    """The teacher-forced check of an MoE model's streams, with the
    routing the engine chose. An MoE layer routes each token to its top-k
    experts, a discontinuous choice: where a position's k-th and (k+1)-th
    gate probabilities lie within rounding of each other, the serving path
    (other kernels, other bf16 rounding) may pick another expert than a
    dense forward would, and the logits then differ by far more than
    MARGIN_ULPS. So the dense forward takes, at every position ``routes`` holds
    (the engine's choices for the tokens whose logits gave the emitted
    ones), the engine's experts (the gate's other probabilities zeroed
    before its top-k; the kept weights are the gate's own), and every
    emitted token must lie within MARGIN_ULPS of its position's maximum logit
    there. The routing is held to the forward's own gate: at every forced
    layer-position where the forward's top-k (over the hidden state the
    engine's earlier choices led to) differs from the engine's, the
    forward's gate logits of the experts that swap must lie within
    GATE_MARGIN. Prints how many positions the engine routed unlike the
    dense forward."""
    k = model.config.moe_topk
    L = model.config.num_hidden_layers
    by_len = {}
    for i, (p, out) in enumerate(zip(prompts, outputs)):
        by_len.setdefault(len(out), []).append((i, p, out))
    tf, flipped, forced_n = Trail(torch), 0, 0
    gates = [layer.mlp.gate for layer in model.model.layers]
    forced = [None] * L
    # forced layer-positions, those routed unlike the forward, its gap there
    forced_all, moved, gate_gap = 0, 0, 0.0

    def forcing(i, gate):
        cls_probs = type(gate).probs

        def probs(inp):
            nonlocal moved, gate_gap
            p = cls_probs(gate, inp)
            f = forced[i]
            if f is None:
                return p
            f = f.reshape(-1, k)
            on = f[:, 0] >= 0
            keep = torch.zeros_like(p, dtype=torch.bool).scatter_(
                1, f.clamp_min(0), True)
            own = torch.zeros_like(keep).scatter_(
                1, p.topk(k, dim=-1).indices, True)
            # the forward's own gate-logit gap (softmax keeps differences)
            # between its least top-k expert the engine dropped and the
            # engine's best pick outside the forward's top-k
            lp = p.log()
            gap = (torch.where(own & ~keep, lp, float("inf")).amin(-1)
                   - torch.where(keep & ~own, lp, float("-inf")).amax(-1))
            flip = on & (keep != own).any(-1)
            if flip.any().item():
                moved += int(flip.sum().item())
                gate_gap = max(gate_gap, gap[flip].max().item())
            return torch.where(on[:, None] & ~keep, 0.0, p)
        return probs

    for i, g in enumerate(gates):
        g.probs = forcing(i, g)
    try:
        with torch.no_grad():
            for rows in by_len.values():
                seqs = np.stack([np.concatenate([p, np.asarray(o, np.int32)])
                                 for _, p, o in rows])
                ids = torch.from_numpy(seqs[:, :-1]).to(DEVICE)
                g_, T = ids.shape
                start = len(rows[0][1]) - 1
                table = np.full((L, g_, T, k), -1, np.int64)
                for r, (si, _, _) in enumerate(rows):
                    for t in range(T):
                        route = routes.get((si, t))
                        if route is not None and None not in route:
                            table[:, r, t] = route
                forced_n += int((table[0, :, start:, 0] >= 0).sum())
                forced_all += L * int((table[0, ..., 0] >= 0).sum())
                for i in range(L):
                    forced[i] = None
                own = model(ids).float()
                for i in range(L):
                    forced[i] = torch.from_numpy(table[i]).to(DEVICE)
                logits = model(ids)[:, start:].float()
                for i in range(L):
                    forced[i] = None
                # positions the engine routed unlike the dense forward:
                # the forward's logits move where a choice moved
                flipped += int(((own[:, start:] - logits).abs().amax(-1)
                                > 0).sum())
                emitted = torch.from_numpy(seqs[:, start + 1:].astype(
                    np.int64)).to(DEVICE)
                tf.add(logits, emitted, lambda r, t, rows=rows:
                       f"stream {rows[r][0]} token {t}")
    finally:
        for g in gates:
            del g.probs
    n = tf.n
    print(f"moe teacher-forced {what} [{card}]: {tf}; with the engine's "
          f"routing at {forced_n} of {n} emitted positions; {flipped} "
          f"positions' logits move "
          f"when the dense forward takes the engine's routing; the engine "
          f"picked other experts than the forward's own gate at {moved} of "
          f"{forced_all} layer-positions, the forward's gate-logit gap "
          f"there at most {gate_gap:.4f} (margin {GATE_MARGIN})", flush=True)
    fails = []
    if forced_n != n:
        fails.append(f"routing recorded at {forced_n} of {n} emitted "
                     f"positions")
    if not tf.ok():
        fails.append(f"under the engine's own routing: {tf}")
    if not gate_gap <= GATE_MARGIN:
        fails.append(f"the engine's routing departs from the dense "
                     f"forward's own where its gate logits are {gate_gap} "
                     f"> {GATE_MARGIN} apart")
    if fails:
        raise AssertionError(f"moe {what}: " + "; ".join(fails))


def _reset_stats(eng):
    """Zero an engine's counters (not its capture and program counts)."""
    for k in eng.stats:
        if k not in ("graph_captures", "spec_graph_captures",
                     "compile_cache_entries"):
            eng.stats[k] = 0.0 if k.endswith("_s") else 0


def _warm_up_engine(eng, Request, np, vocab):
    """Two requests that share nothing with the waves (first launches at
    the prefill shapes), then an empty radix cache: the next wave runs
    cold."""
    rng = np.random.default_rng(1)
    for _ in range(2):
        eng.add_request(Request(rng.integers(0, vocab, (
            FUSED_PROMPT,)).astype(np.int32), max_new_tokens=4))
    eng.run_until_done()
    if eng.prefix_cache is not None:
        eng._radix.evict_lru(eng._alloc.num_blocks)


def _differ(a, b):
    """How many of the streams ``a`` differ from ``b``'s."""
    return sum(x != y for x, y in zip(a, b))


def _activate_all(np, eng, ctx):
    """Every slot of a fused engine active at context ``ctx`` over its own
    pages (the engine's cache contents are no longer needed)."""
    maxp = eng._maxp
    for i in range(eng.max_batch):
        eng._queue_update(i, np.arange(i * maxp, (i + 1) * maxp), ctx, True)
    eng._flush_updates()


def _step_ms(torch, eng, ctx, step, measure=None):
    """``measure(torch, step)`` (default: CUDA-event ms over 20 calls after
    3) from every row at context ``ctx``, without autograd."""
    eng._dev_pos.fill_(ctx)
    eng._step_i.zero_()
    with torch.no_grad():
        if measure is None:
            return cuda_ms(step, 20, 3)
        return measure(torch, step)


def phase_serving_fused(torch, np, ops, card):
    """The fused 128-slot engine at FUSED_ENGINE: a cold wave, then the same
    wave warm (the radix cache primed). Returns K4's launches in the two
    waves."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    t0 = time.perf_counter()
    model = LlamaForCausalLM(LlamaConfig(**SERVE_CONFIG), device=DEVICE,
                             seed=0)
    return _serve_fused(torch, np, ops, card, model, "", t0)


def _serve_fused(torch, np, ops, card, model, tag, t0):
    """Phase 7's engine and waves on ``model`` (built since ``t0``), its
    checks and timings; ``tag`` prefixes the printed lines. Returns the two
    waves' K4 launches and the cold wave's streams."""
    from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                    PrefixCacheConfig,
                                                    Request)

    cfg = model.config
    eng = ContinuousBatchingEngine(
        model, device=DEVICE,
        prefix_cache=PrefixCacheConfig(extra_blocks=FUSED_EXTRA_BLOCKS),
        **FUSED_ENGINE)
    sync()
    pool_gb = sum(k.numel() * k.element_size() * 2
                  for k, _ in eng.caches["kv"]) / 1e9
    print(f"{tag}fused serving setup: {eng._park + 1} pages ({pool_gb:.2f} "
          f"GB of "
          f"K/V), graph_captures={eng.stats['graph_captures']}, "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    if eng.stats["graph_captures"] != 1 or eng._graph_counts[0] != \
            cfg.num_hidden_layers:
        raise AssertionError(f"the decode step was not captured once with "
                             f"{cfg.num_hidden_layers} K4 launches")
    prompts, news = _fused_wave(np, cfg.vocab_size)
    _warm_up_engine(eng, Request, np, cfg.vocab_size)

    L = cfg.num_hidden_layers
    waves = {}
    for name in ("cold", "warm"):
        _reset_stats(eng)
        reqs = [Request(p, max_new_tokens=k) for p, k in zip(prompts, news)]
        ops.paged_decode_attention.launches = 0
        ops.flash_attention.launches = 0
        sync()
        t0 = time.perf_counter()
        for r in reqs:
            eng.add_request(r)
        done = eng.run_until_done()
        sync()
        wall = time.perf_counter() - t0
        k4 = ops.paged_decode_attention.launches
        st = dict(eng.stats)
        useful = sum(len(r.output) for r in reqs)
        print(f"{tag}fused serving {name} [{card}]: useful_tokens_per_s="
              f"{useful / wall:.1f} ({useful} tokens in {wall:.3f}s, "
              f"{len(reqs)} requests, {FUSED_ENGINE['max_batch']} slots) "
              f"prefill_groups={st['prefill_groups']} packed_rows="
              f"{st['packed_rows']} cached_tokens_matched={st['hit_tokens']} "
              f"miss_tokens={st['miss_tokens']} cow_copies={st['cow_copies']} "
              f"decode_steps={st['decode_steps']} graph_captures="
              f"{st['graph_captures']} graph_replays={st['graph_replays']} "
              f"eager_decode_steps={st['eager_decode_steps']} "
              f"k4_launches={k4} k1_launches={ops.flash_attention.launches} "
              f"host_s admit={st['admit_host_s']:.3f} decode="
              f"{st['decode_host_s']:.3f} prefill={st['prefill_host_s']:.3f}",
              flush=True)
        if len(done) != len(reqs) or any(
                r.failed or len(r.output) != r.max_new_tokens for r in reqs):
            raise AssertionError(f"fused {name}: {len(done)} of {len(reqs)} "
                                 "requests finished with their token counts")
        if (st["eager_decode_steps"] != 0 or st["graph_captures"] != 1
                or st["graph_replays"] != st["decode_steps"]
                or k4 < st["graph_replays"] * L):
            raise AssertionError(
                f"fused {name}: greedy blocks must replay the one captured "
                f"graph with {L} K4 launches each: {st}, k4 {k4}")
        if name == "warm" and st["hit_tokens"] < len(reqs) * FUSED_SHARED:
            raise AssertionError(f"warm wave matched {st['hit_tokens']} "
                                 "cached tokens")
        waves[name] = ([list(r.output) for r in reqs], k4)

    cold, warm = waves["cold"][0], waves["warm"][0]
    differ = [i for i, (c, w) in enumerate(zip(cold, warm)) if c != w]
    tf = _teacher_forced(torch, np, model, prompts, cold)
    tf_w = _teacher_forced(torch, np, model, [prompts[i] for i in differ],
                           [warm[i] for i in differ])
    print(f"{tag}fused teacher-forced cold: {tf}", flush=True)
    print(f"{tag}fused teacher-forced over the {len(differ)} warm streams "
          f"that differ from cold: {tf_w}", flush=True)
    if not (tf.ok() and tf_w.ok()):
        raise AssertionError(f"fused teacher-forced check: {tf}; warm "
                             f"{tf_w}")

    # the decode step at the wave's shape, replayed and eager
    _activate_all(np, eng, FUSED_STEP_CTX)
    replay_ms = _step_ms(torch, eng, FUSED_STEP_CTX, eng._graph.replay)
    eager_ms = _step_ms(torch, eng, FUSED_STEP_CTX, eng._fused_step)
    print(f"{tag}fused decode step [{card}]: replayed_ms={replay_ms:.4f} "
          f"eager_ms={eager_ms:.4f} ({eng.max_batch} rows from context "
          f"{FUSED_STEP_CTX}, {L} layers)", flush=True)
    return waves["cold"][1] + waves["warm"][1], cold


def _pool_bytes(eng):
    """Bytes of an engine's live K/V pools (int8 pages and their scales,
    or the fp pages)."""
    total = 0
    for pair in eng.caches["kv"]:
        for side in pair:
            for t in (side.data, side.scale) if hasattr(side, "scale") \
                    else (side,):
                total += t.numel() * t.element_size()
    return total


def phase_serving_spec(torch, np, ops, card):
    """bench_speculative's arm at SPEC_ENGINE: four engines on one model
    (spec off, spec on, int8, spec + int8) and two twins (int8, spec +
    int8) serve the same 16-request wave, cold, then SPEC_TIMED warm waves
    each, interleaved. Returns (K4 launches on fp pools, K4 launches on
    int8 pools) in those waves."""
    from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                    PrefixCacheConfig,
                                                    Request, SpecConfig)
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(**SERVE_CONFIG)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=DEVICE, seed=0)
    rng = np.random.default_rng(0)
    prompts = [np.tile(rng.integers(0, cfg.vocab_size, (SPEC_MOTIF,)).astype(
        np.int32), SPEC_REPS) for _ in range(2 * SPEC_ENGINE["max_batch"])]
    news = [(i % 4 + 1) * SPEC_MAX_NEW // 4 for i in range(len(prompts))]
    useful = sum(news)
    kinds = {"spec_off": {}, "spec": dict(speculative=SpecConfig(k=SPEC_K)),
             "int8": dict(kv_cache="int8"),
             "spec_int8": dict(speculative=SpecConfig(k=SPEC_K),
                               kv_cache="int8")}
    twins = {"int8_twin": "int8", "spec_int8_twin": "spec_int8"}

    def build(name):
        return ContinuousBatchingEngine(
            model, device=DEVICE,
            prefix_cache=PrefixCacheConfig(extra_blocks=SPEC_EXTRA_BLOCKS),
            **SPEC_ENGINE, **kinds[twins.get(name, name)])

    engines = {n: build(n) for n in list(kinds) + list(twins)}
    sync()
    print(f"spec serving setup: {len(engines)} engines of "
          f"{engines['spec']._park + 1} pages, "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    L = cfg.num_hidden_layers
    fails = []
    for name, eng in engines.items():
        st = eng.stats
        want = 2 if eng._spec is not None else 1
        if st["graph_captures"] + st["spec_graph_captures"] != want:
            fails.append(f"{name}: {st['graph_captures']} greedy and "
                         f"{st['spec_graph_captures']} spec captures")

    def wave(eng):
        """One wave through ``eng``: (streams, seconds, K4 launches fp and
        int8 during it)."""
        reqs = [Request(p, max_new_tokens=k) for p, k in zip(prompts, news)]
        k0 = (ops.paged_decode_attention.launches,
              ops.paged_decode_attention.int8_launches)
        sync()
        t = time.perf_counter()
        for r in reqs:
            eng.add_request(r)
        eng.run_until_done(max_steps=40000)
        sync()
        dt = time.perf_counter() - t
        n_all = ops.paged_decode_attention.launches - k0[0]
        n8 = ops.paged_decode_attention.int8_launches - k0[1]
        bad = [r.rid for r, k in zip(reqs, news)
               if r.failed or len(r.output) != k]
        if bad:
            fails.append(f"requests {bad} did not get their token counts")
        return [list(r.output) for r in reqs], dt, (n_all - n8, n8)

    ops.paged_decode_attention.launches = 0
    ops.paged_decode_attention.int8_launches = 0
    cold, best, k4 = {}, {}, {}
    for name, eng in engines.items():     # cold: radix empty
        _reset_stats(eng)
        cold[name], _, k4[name] = wave(eng)
    warm = {}
    for _ in range(SPEC_TIMED):           # warm, interleaved, best-of
        for name in kinds:
            warm[name], dt, n = wave(engines[name])
            best[name] = min(best.get(name, float("inf")), dt)
            k4[name] = tuple(a + b for a, b in zip(k4[name], n))
    k4_fp = ops.paged_decode_attention.launches \
        - ops.paged_decode_attention.int8_launches
    k4_int8 = ops.paged_decode_attention.int8_launches

    headroom = _pool_bytes(engines["spec_off"]) / _pool_bytes(
        engines["int8"])
    for name in kinds:
        st = engines[name].stats
        rate = st["spec_accepted"] / max(1, st["spec_proposed"])
        print(f"spec serving {name} [{card}]: useful_tokens_per_s="
              f"{useful / best[name]:.1f} ({useful} tokens, best of "
              f"{SPEC_TIMED} warm waves {best[name]:.3f}s) spec_steps="
              f"{st['spec_steps']} spec_graph_replays="
              f"{st['spec_graph_replays']} eager_spec_steps="
              f"{st['eager_spec_steps']} acceptance_rate={rate:.4f} "
              f"({st['spec_accepted']}/{st['spec_proposed']}) decode_steps="
              f"{st['decode_steps']} graph_replays={st['graph_replays']} "
              f"eager_decode_steps={st['eager_decode_steps']} "
              f"k4_launches_fp={k4[name][0]} k4_launches_int8={k4[name][1]} "
              f"pool_bytes={_pool_bytes(engines[name])} "
              f"int8_kv_headroom={headroom:.4f}", flush=True)
        if engines[name]._spec is not None and (
                st["eager_spec_steps"] != 0 or st["spec_steps"] == 0
                or st["spec_graph_replays"] != st["spec_steps"]):
            fails.append(f"{name}: spec dispatches must all replay the spec "
                         f"graph: {st}")
        if st["eager_decode_steps"] != 0:
            fails.append(f"{name}: {st['eager_decode_steps']} eager decode "
                         "steps")
        quant = engines[name]._kv_dtype == "int8"
        if quant and (k4[name][0] != 0 or k4[name][1]
                      < st["graph_replays"] * L or k4[name][1] == 0):
            fails.append(f"{name}: K4-int8 did not carry the decode steps "
                         f"(k4 {k4[name]}, replays {st['graph_replays']})")

    # streams: spec against spec off, twins against each other, warm
    # against cold; every emitted token teacher-forced against the dense
    # forward
    spec_vs_off = _differ(cold["spec"], cold["spec_off"])
    spec8_vs_int8 = _differ(cold["spec_int8"], cold["int8"])
    twin_diff = {t: _differ(cold[t], cold[src]) for t, src in twins.items()}
    warm_diff = {n: _differ(warm[n], cold[n]) for n in kinds}
    print(f"spec streams [{card}]: {spec_vs_off} of {len(prompts)} spec "
          f"streams differ from spec-off; {spec8_vs_int8} spec+int8 from "
          f"int8; identical int8 engines differ in "
          f"{twin_diff['int8_twin']} (int8) and "
          f"{twin_diff['spec_int8_twin']} (spec+int8) streams; warm differs "
          f"from cold in {warm_diff}", flush=True)
    if any(twin_diff.values()):
        fails.append(f"identical int8 engines differ: {twin_diff}")
    for name in kinds:
        outs = cold[name] + [w for w, c in zip(warm[name], cold[name])
                             if w != c]
        ps = prompts + [p for p, w, c in zip(prompts, warm[name], cold[name])
                        if w != c]
        tf = _teacher_forced(torch, np, model, ps, outs)
        print(f"spec teacher-forced {name}: {tf}", flush=True)
        if not tf.ok():
            fails.append(f"{name}: {tf}")

    # the spec step at the wave's shape: every row active at context
    # SPEC_STEP_CTX over its own pages, one token emitted a replay (the
    # verify window is computed whole whatever the caps)
    eng = engines["spec"]
    maxp = eng._maxp
    for i in range(eng.max_batch):
        eng._queue_update(i, np.arange(i * maxp, (i + 1) * maxp),
                          SPEC_STEP_CTX, True,
                          hist=eng._spec_seed(prompts[i]))
    eng._flush_updates()
    eng._dev_caps.fill_(1)

    def timed(fn):
        eng._dev_pos.fill_(SPEC_STEP_CTX)
        eng._step_i.zero_()
        with torch.no_grad():
            return cuda_ms(fn, 20, 3)

    spec_replay = timed(eng._spec_graph.replay)
    spec_eager = timed(eng._spec_step)
    greedy_replay = timed(eng._graph.replay)
    print(f"spec step [{card}]: replayed_ms={spec_replay:.4f} "
          f"eager_ms={spec_eager:.4f} greedy_replayed_ms={greedy_replay:.4f} "
          f"({eng.max_batch} rows from context {SPEC_STEP_CTX}, window "
          f"{SPEC_K + 1}, {L} layers)", flush=True)
    if fails:
        raise AssertionError("spec serving: " + "; ".join(fails))
    return k4_fp, k4_int8


def _zero_serving_counts(ops):
    for fn in (ops.flash_attention, ops.paged_decode_attention, ops.pgmm,
               ops.pgmm_dw):
        fn.launches = 0
    ops.paged_decode_attention.int8_launches = 0


def _serving_counts(ops):
    return dict(k1=ops.flash_attention.launches,
                k4=ops.paged_decode_attention.launches,
                k5=ops.pgmm.launches, k6=ops.pgmm_dw.launches)


def _serve_wave(eng, Request, prompts, news):
    """One wave through ``eng``, synchronized at both ends: (requests,
    seconds). Raises unless every request finished with its count."""
    reqs = [Request(p, max_new_tokens=k) for p, k in zip(prompts, news)]
    sync()
    t0 = time.perf_counter()
    for r in reqs:
        eng.add_request(r)
    done = eng.run_until_done(max_steps=40000)
    sync()
    wall = time.perf_counter() - t0
    if len(done) != len(reqs) or any(
            r.failed or len(r.output) != r.max_new_tokens for r in reqs):
        raise AssertionError(f"{len(done)} of {len(reqs)} requests finished "
                             "with their token counts")
    return reqs, wall


def _busy_share(torch, fn):
    """(device busy ms, wall ms) of ``fn`` under torch.profiler: the
    kernels' device time summed (one stream, so they do not overlap) over
    the host clock around ``fn`` and a synchronize. None for the busy time
    where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return (busy_ms if busy_ms > 0 else None), wall_ms


def phase_moe_serving(torch, np, ops, card, k5_decode):
    """bench_moe's model (MOE_CONFIG, pgmm, bf16) served: the fused
    128-slot engine at phase 7's wave, cold then warm; the replayed step
    against the eager one, beside K5's device time at the decode layout
    (``k5_decode``: phase 10's "decode" rows); the legacy engine on
    MOE_LEGACY_REQUESTS requests; the wave once more at
    moe_dispatch="auto". Returns the launches of K1, K4 and K5 in those
    waves."""
    from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                    PrefixCacheConfig,
                                                    Request)
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(**MOE_CONFIG)
    L = cfg.num_hidden_layers
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=DEVICE, seed=0)

    def fused():
        return ContinuousBatchingEngine(
            model, device=DEVICE,
            prefix_cache=PrefixCacheConfig(extra_blocks=FUSED_EXTRA_BLOCKS),
            **FUSED_ENGINE)

    eng = fused()
    sync()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"moe serving setup [{card}]: {n_params / 1e6:.1f}M params, "
          f"{cfg.num_experts} experts top-{cfg.moe_topk} "
          f"{cfg.moe_dispatch}, {eng._park + 1} pages, graph_captures="
          f"{eng.stats['graph_captures']}, launches a replay (k4, k4_int8, "
          f"k5, k6)={eng._graph_counts}, {time.perf_counter() - t0:.2f}s",
          flush=True)
    if eng.stats["graph_captures"] != 1 or eng._graph_counts != (
            L, 0, 3 * L, 0):
        raise AssertionError(f"the MoE decode step was not captured once "
                             f"with {L} K4 and {3 * L} K5 launches")
    prompts, news = _fused_wave(np, cfg.vocab_size)
    _warm_up_engine(eng, Request, np, cfg.vocab_size)
    launches = dict(k1=0, k4=0, k5=0)
    waves = {}
    for name in ("cold", "warm"):
        _reset_stats(eng)
        _zero_serving_counts(ops)
        reqs, wall = _serve_wave(eng, Request, prompts, news)
        c = _serving_counts(ops)
        st = dict(eng.stats)
        useful = sum(len(r.output) for r in reqs)
        print(f"moe serving {name} [{card}]: useful_tokens_per_s="
              f"{useful / wall:.1f} ({useful} tokens in {wall:.3f}s, "
              f"{len(reqs)} requests, {FUSED_ENGINE['max_batch']} slots) "
              f"prefill_groups={st['prefill_groups']} packed_rows="
              f"{st['packed_rows']} cached_tokens_matched={st['hit_tokens']} "
              f"decode_steps={st['decode_steps']} graph_replays="
              f"{st['graph_replays']} eager_decode_steps="
              f"{st['eager_decode_steps']} k5_launches={c['k5']} "
              f"(k5 a replay {eng._graph_counts[2]}) k6_launches={c['k6']} "
              f"k4_launches={c['k4']} k1_launches={c['k1']}", flush=True)
        if (st["eager_decode_steps"] != 0 or st["graph_captures"] != 1
                or st["graph_replays"] != st["decode_steps"]
                or c["k5"] < st["graph_replays"] * 3 * L or c["k6"] != 0
                or c["k4"] < st["graph_replays"] * L):
            raise AssertionError(
                f"moe {name}: greedy blocks must replay the one captured "
                f"graph ({3 * L} K5 and {L} K4 launches each), K6 never: "
                f"{st}, {c}")
        waves[name] = [list(r.output) for r in reqs]
        for k in launches:
            launches[k] += c[k]
    cold, warm = waves["cold"], waves["warm"]
    warm_diff = _differ(warm, cold)
    print(f"moe serving [{card}]: {warm_diff} of {len(prompts)} warm "
          f"streams differ from cold", flush=True)
    if warm_diff:
        raise AssertionError(f"moe serving: {warm_diff} warm streams differ "
                             "from cold (pgmm drops nothing)")
    # the same wave once more with eager steps, recording the experts the
    # engine picks: the dense forward takes them for the margin check
    streams, routes = _recorded_wave(torch, np, eng, Request, prompts, news)
    if streams != cold:
        raise AssertionError(f"moe serving: {_differ(streams, cold)} streams "
                             "of the eager wave differ from the replayed "
                             "cold wave")
    _moe_margin_check(torch, np, model, prompts, cold, routes, "fused cold",
                      card)
    busy_ms, wall_ms = _busy_share(
        torch, lambda: _serve_wave(eng, Request, prompts, news))
    print(f"moe serving warm wave under the profiler [{card}]: "
          + (f"device_busy_ms={busy_ms:.1f} wall_ms={wall_ms:.1f} "
             f"busy_share={busy_ms / wall_ms:.3f}" if busy_ms is not None
             else f"busy_share=not measured (the profiler saw no device "
             f"time; wall_ms={wall_ms:.1f})"), flush=True)

    # the decode step at the wave's shape, replayed and eager; the syncs
    # of each
    _activate_all(np, eng, FUSED_STEP_CTX)
    replay_ms = _step_ms(torch, eng, FUSED_STEP_CTX, eng._graph.replay)
    eager_ms = _step_ms(torch, eng, FUSED_STEP_CTX, eng._fused_step)
    syncs_replay = _step_ms(torch, eng, FUSED_STEP_CTX, eng._graph.replay,
                            _sync_count)
    syncs_eager = _step_ms(torch, eng, FUSED_STEP_CTX, eng._fused_step,
                           _sync_count)
    print(f"moe decode step [{card}]: replayed_ms={replay_ms:.4f} "
          f"eager_ms={eager_ms:.4f} ({eng.max_batch} rows from context "
          f"{FUSED_STEP_CTX}, {L} layers, {3 * L} K5 launches a step); "
          f"synchronizing operations: {len(syncs_replay)} replayed, "
          f"{len(syncs_eager)} eager", flush=True)
    for msg in (syncs_replay + syncs_eager)[:5]:
        print(f"  {msg[:160]}", flush=True)
    if syncs_replay:
        raise AssertionError(f"the replayed MoE step synchronized "
                             f"{len(syncs_replay)} times")
    # a layer's experts: gate and up [hidden -> intermediate], down back
    h, inter = cfg.hidden_size, cfg.intermediate_size
    k5_step = L * (2 * k5_decode[(h, inter)]["device_ms"]
                   + k5_decode[(inter, h)]["device_ms"])
    for (kk, nn), r in sorted(k5_decode.items()):
        print(f"moe decode K5 [{card}] (phase 10, case decode): "
              f"{eng.max_batch} tokens x top-{cfg.moe_topk} in P={r['P']} "
              f"padded rows, k={kk} n={nn}: device_ms={r['device_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.5f} bound_by={r['bound_by']} "
              f"library_ms={r['library_ms']:.4f} ({r['lib']}) "
              f"plain_ms={r['plain_ms']:.4f}", flush=True)
    print(f"moe decode K5 share [{card}]: {3 * L} launches a step, "
          f"{k5_step:.4f} device ms at phase 10's times, "
          f"{k5_step / replay_ms:.3f} of the replayed step's "
          f"{replay_ms:.4f} ms", flush=True)
    del eng
    torch.cuda.empty_cache()

    # the legacy engine (K1 prefill, eager decode) on the first requests
    leg = ContinuousBatchingEngine(model, device=DEVICE, **MOE_LEGACY_ENGINE)
    _warm_up_engine(leg, Request, np, cfg.vocab_size)
    _reset_stats(leg)
    _zero_serving_counts(ops)
    lp, ln = prompts[:MOE_LEGACY_REQUESTS], news[:MOE_LEGACY_REQUESTS]
    reqs, wall = _serve_wave(leg, Request, lp, ln)
    c = _serving_counts(ops)
    legacy = [list(r.output) for r in reqs]
    leg_diff = _differ(legacy, cold)
    st = leg.stats
    print(f"moe serving legacy [{card}]: useful_tokens_per_s="
          f"{sum(ln) / wall:.1f} ({sum(ln)} tokens in {wall:.3f}s, "
          f"{len(lp)} requests, {MOE_LEGACY_ENGINE['max_batch']} slots) "
          f"prefill_groups={st['prefill_groups']} decode_steps="
          f"{st['decode_steps']} k1_launches={c['k1']} k4_launches={c['k4']} "
          f"k5_launches={c['k5']} k6_launches={c['k6']}; {leg_diff} of "
          f"{len(lp)} streams differ from the fused engine's", flush=True)
    if (c["k1"] < st["prefill_groups"] * L or c["k6"] != 0
            or c["k4"] < st["decode_steps"] * L
            or c["k5"] < (st["decode_steps"] + st["prefill_groups"]) * 3 * L):
        raise AssertionError(f"moe legacy engine: {st}, {c}")
    streams, routes = _recorded_wave(torch, np, leg, Request, lp, ln)
    if streams != legacy:
        raise AssertionError("moe legacy engine: a second wave differs")
    _moe_margin_check(torch, np, model, lp, legacy, routes, "legacy", card)
    for k in launches:
        launches[k] += c[k]
    del leg

    # the same wave at the default dispatch: capacity routing, no K5
    for layer in model.model.layers:
        layer.mlp.dispatch_mode = "auto"
    eng = fused()
    _warm_up_engine(eng, Request, np, cfg.vocab_size)
    _reset_stats(eng)
    _zero_serving_counts(ops)
    reqs, wall = _serve_wave(eng, Request, prompts, news)
    c = _serving_counts(ops)
    auto = [list(r.output) for r in reqs]
    print(f"moe serving auto [{card}]: useful_tokens_per_s="
          f"{sum(news) / wall:.1f} ({sum(news)} tokens in {wall:.3f}s) "
          f"graph_replays={eng.stats['graph_replays']} k5_launches="
          f"{c['k5']} k4_launches={c['k4']}; {_differ(auto, cold)} of "
          f"{len(auto)} streams differ from the pgmm fused wave, "
          f"{_differ(auto, legacy)} of {len(legacy)} from the pgmm legacy "
          f"engine's (capacity drops depend on a step's rows)", flush=True)
    if (c["k5"] != 0 or c["k6"] != 0 or eng.stats["eager_decode_steps"]
            or eng.stats["graph_replays"] != eng.stats["decode_steps"]):
        raise AssertionError(f"moe auto: {eng.stats}, {c}")
    launches["k4"] += c["k4"]
    del eng, model
    torch.cuda.empty_cache()
    return launches


def phase_generate(torch, np, ops, card):
    """bench_serving's wave through generate() with the dense and the
    paged cache and through the prefix-cache engine, best of GEN_TIMED
    interleaved waves each. Returns the launches of K1 and K4 in the timed
    waves."""
    from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                    PrefixCacheConfig,
                                                    Request)
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(**SERVE_CONFIG)
    L = cfg.num_hidden_layers
    model = LlamaForCausalLM(cfg, device=DEVICE, seed=0)
    prompts, news = _fused_wave(np, cfg.vocab_size, GEN_REQUESTS)
    useful = sum(news)
    batches = [np.stack(prompts[lo:lo + GEN_BATCH])
               for lo in range(0, GEN_REQUESTS, GEN_BATCH)]
    eng = ContinuousBatchingEngine(
        model, device=DEVICE,
        prefix_cache=PrefixCacheConfig(extra_blocks=GEN_EXTRA_BLOCKS),
        **GEN_ENGINE)

    def gen(cache_impl):
        return np.concatenate([model.generate(
            b, max_new_tokens=FUSED_MAX_NEW, temperature=0.0,
            cache_impl=cache_impl, page_size=GEN_ENGINE["page_size"]).cpu()
            .numpy() for b in batches])

    arms = {"dense": lambda: gen("dense"), "paged": lambda: gen("paged"),
            "engine": lambda: [r.output for r in _serve_wave(
                eng, Request, prompts, news)[0]]}
    for fn in arms.values():          # warm-up; the engine's primes its cache
        fn()
    _zero_serving_counts(ops)
    best, outs, per = {}, {}, {}
    for _ in range(GEN_TIMED):
        for name, fn in arms.items():
            c0 = _serving_counts(ops)
            sync()
            t0 = time.perf_counter()
            outs[name] = fn()
            sync()
            best[name] = min(best.get(name, float("inf")),
                             time.perf_counter() - t0)
            per[name] = {k: v - c0[k] for k, v in _serving_counts(ops).items()}
    c = _serving_counts(ops)
    tps = {k: useful / v for k, v in best.items()}
    dense, paged = outs["dense"], outs["paged"]
    differ = [i for i in range(GEN_REQUESTS)
              if not np.array_equal(dense[i], paged[i])]
    eng_differ = sum(list(dense[i][:news[i]]) != outs["engine"][i]
                     for i in range(GEN_REQUESTS))
    tf = _teacher_forced(torch, np, model, prompts, [list(r) for r in paged])
    tf_d = _teacher_forced(torch, np, model, [prompts[i] for i in differ],
                           [list(dense[i]) for i in differ])
    print(f"generate [{card}]: useful_tokens_per_s dense={tps['dense']:.1f} "
          f"paged={tps['paged']:.1f} engine={tps['engine']:.1f} "
          f"vs_baseline (engine / dense generate)="
          f"{tps['engine'] / tps['dense']:.4f} paged/dense="
          f"{tps['paged'] / tps['dense']:.4f} ({useful} useful tokens of "
          f"{GEN_REQUESTS} requests, generate in batches of {GEN_BATCH} to "
          f"{FUSED_MAX_NEW} new tokens; best of {GEN_TIMED}: "
          f"{best['dense']:.3f} / {best['paged']:.3f} / "
          f"{best['engine']:.3f}s); launches a wave: dense {per['dense']}, "
          f"paged {per['paged']}, engine {per['engine']}", flush=True)
    print(f"generate streams [{card}]: {len(differ)} of {GEN_REQUESTS} "
          f"paged streams differ from dense; {eng_differ} engine streams "
          f"differ from dense generate's; teacher-forced paged: {tf}; "
          f"over the differing dense streams: {tf_d}", flush=True)
    want_paged = dict(k1=len(batches) * L,
                      k4=len(batches) * (FUSED_MAX_NEW - 1) * L)
    if (per["paged"]["k1"] != want_paged["k1"]
            or per["paged"]["k4"] != want_paged["k4"]
            or per["dense"]["k1"] or per["dense"]["k4"]):
        raise AssertionError(f"generate: paged launches {per['paged']} != "
                             f"{want_paged}, dense {per['dense']} (none)")
    if not (tf.ok() and tf_d.ok()):
        raise AssertionError(f"generate teacher-forced: paged {tf}; dense "
                             f"{tf_d}")
    del eng, model
    torch.cuda.empty_cache()
    return c["k1"], c["k4"]


def phase_brownout(torch, np, ops, card, base):
    """Phase 7's wave through a fused engine with brownout=True, the pool
    cut (the serving.block_pool fault site's exhaust) to the pages of the
    wave's first max_batch / 2 requests until the engine enters brownout;
    ``base``
    is phase 7's cold streams (the same model from seed 0, no brownout).
    Returns K4's launches in the wave."""
    from paddle_tpu_torch.distributed.resilience import FaultPlan, FaultSpec
    from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                    PrefixCacheConfig,
                                                    Request)
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(**SERVE_CONFIG)
    model = LlamaForCausalLM(cfg, device=DEVICE, seed=0)
    eng = ContinuousBatchingEngine(
        model, device=DEVICE, brownout=True,
        prefix_cache=PrefixCacheConfig(extra_blocks=FUSED_EXTRA_BLOCKS),
        **FUSED_ENGINE)
    _warm_up_engine(eng, Request, np, cfg.vocab_size)
    _reset_stats(eng)
    prompts, news = _fused_wave(np, cfg.vocab_size)
    reqs = [Request(p, max_new_tokens=k) for p, k in zip(prompts, news)]
    # each of the first admission's requests takes its own blocks (the
    # cache registers nothing before their first tokens)
    half = eng.max_batch // 2
    room = sum(eng._pages_needed(len(p), k) for p, k in
               zip(prompts[:half], news[:half]))
    held = eng._alloc.free_blocks - room
    # the JAX package's pool-pressure fault site: the first admission's
    # allocation finds all but `room` blocks held
    plan = FaultPlan(seed=9, specs=[FaultSpec(
        "serving.block_pool", "exhaust", at=0, count=1, arg=held)])
    _zero_serving_counts(ops)
    sync()
    t0 = time.perf_counter()
    steps, entered, exited = 0, None, None
    with plan:
        for r in reqs:
            eng.add_request(r)
        while eng.has_work():
            eng.step()
            steps += 1
            if steps == 1 and len(eng._alloc._held) != held:
                raise AssertionError(f"brownout: {len(eng._alloc._held)} "
                                     f"blocks held, not {held}")
            if entered is None and eng._brownout_active:
                entered = steps
                eng._alloc.release_held()     # the pressure episode ends
            if entered is not None and exited is None \
                    and not eng._brownout_active:
                exited = steps
    eng.finished()
    sync()
    wall = time.perf_counter() - t0
    c = _serving_counts(ops)
    st = eng.stats
    outs = [list(r.output) for r in reqs]
    differ = [i for i in range(len(reqs)) if outs[i] != base[i]]
    tf = _teacher_forced(torch, np, model, [prompts[i] for i in differ],
                         [outs[i] for i in differ])
    print(f"brownout [{card}]: useful_tokens_per_s="
          f"{sum(news) / wall:.1f} ({sum(news)} tokens in {wall:.3f}s) "
          f"{held} of {eng._alloc.num_blocks} blocks held until brownout "
          f"(the {room} left hold the first {half} requests); "
          f"entered at step {entered}, exited at step {exited} of {steps}; "
          f"brownouts={st['brownouts']} brownout_steps="
          f"{st['brownout_steps']} cached_tokens_matched={st['hit_tokens']} "
          f"graph_captures={st['graph_captures']} graph_replays="
          f"{st['graph_replays']} eager_decode_steps="
          f"{st['eager_decode_steps']} k4_launches={c['k4']}; "
          f"{len(differ)} of {len(reqs)} streams differ from the wave "
          f"without brownout (phase 7, cold); teacher-forced over them: "
          f"{tf}", flush=True)
    if (plan.fired() != {"serving.block_pool": 1}
            or st["brownouts"] < 1 or st["brownout_steps"] == 0
            or exited is None
            or exited >= steps or st["graph_captures"] != 1
            or st["eager_decode_steps"] != 0
            or st["graph_replays"] != st["decode_steps"]
            or any(r.failed or len(r.output) != r.max_new_tokens
                   for r in reqs) or not tf.ok()):
        raise AssertionError(f"brownout: entered {entered}, exited {exited} "
                             f"of {steps} steps, {st}, teacher-forced {tf}")
    del eng, model
    torch.cuda.empty_cache()
    return c["k4"]


# ---- phases 18-22: the attention and MoE functional surface ---------------

_MASK_COUNTERS = (
    ("flash_attention", "launches_seg"), ("flash_attention", "launches_rowmask"),
    ("flash_attention_forward", "launches_seg"),
    ("flash_attention_forward", "launches_rowmask"),
    ("flash_attention_backward", "launches_dq_seg"),
    ("flash_attention_backward", "launches_dkv_seg"),
    ("flash_attention_backward", "launches_dq_rowmask"),
    ("flash_attention_backward", "launches_dkv_rowmask"),
    ("flash_attention_backward", "launches_glse"),
    ("flash_attention_backward", "launches_dq"),
    ("flash_attention_backward", "launches_dkv"),
    ("flash_attention", "launches"), ("flash_attention_forward", "launches"),
    ("paged_decode_attention", "launches"),
    ("paged_decode_attention", "int8_launches"))


def _zero_mask_counts(ops):
    for fn, attr in _MASK_COUNTERS:
        setattr(getattr(ops, fn), attr, 0)


def _mask_counts(ops):
    return {f"{fn}.{attr}": getattr(getattr(ops, fn), attr)
            for fn, attr in _MASK_COUNTERS}


def masked_pairs(np, b, s_q, s_kv, hq, causal, q_seg=None, kv_seg=None,
                 start=None, end=None):
    """Visible (q, k) pairs summed over the batch and the q heads, counted
    on the host from the mask's operands (numpy): the end-aligned causal
    mask and segment ids (q row i sees column j iff their ids are equal) or
    per-column row bounds [b, hm, s_kv] (column c hides rows [start[c],
    end[c]); bounds row h serves the hq / hm q heads of its kv heads). With
    neither, ``causal_pairs`` times b hq."""
    offset = s_kv - s_q
    if q_seg is not None:
        total = 0.0
        for r in range(b):
            # segments are runs of equal ids, q and kv packed alike
            _, counts = np.unique(q_seg[r], return_counts=True)
            for n in counts.tolist():
                total += n * (n + 1) / 2 if causal else n * n
        return total * hq
    if start is None:
        return causal_pairs(s_q, s_kv, causal) * b * hq
    c = np.arange(s_kv)
    lo = np.maximum(c - offset, 0) if causal else np.zeros_like(c)
    seen = s_q - lo                                   # rows at or after lo
    hidden = np.clip(np.minimum(end, s_q) - np.maximum(start, lo), 0, None)
    per_row = (seen[None, None, :] - hidden).sum(-1)  # [b, hm]
    return float(per_row.sum()) * hq / start.shape[1]


def _sdpa_backend(torch, q, k, v, mask, causal=False):
    """The SDPA backend torch picks for these [b, h, s, d] inputs (its own
    dispatcher's choice), or "unknown"."""
    try:
        from torch.nn.attention import SDPBackend
        return SDPBackend(torch._fused_sdp_choice(
            q, k, v, attn_mask=mask, dropout_p=0.0, is_causal=causal,
            enable_gqa=q.shape[1] != k.shape[1])).name
    except (AttributeError, TypeError, ValueError, RuntimeError):
        return "unknown"  # a private dispatcher: its signature moves


def _sdpa_masked(torch, F, q, k, v, keep):
    """SDPA with the boolean mask ``keep`` [b, 1 or hq, s_q, s_kv] (True =
    visible), kv heads repeated to q's beforehand (GQA with a mask runs
    SDPA's math backend): (forward ms, forward + backward ms, backend). A
    yardstick only: the port never calls it."""
    rep = q.shape[2] // k.shape[2]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k.repeat_interleave(rep, 2),
                            v.repeat_interleave(rep, 2)))
    backend = _sdpa_backend(torch, qt, kt, vt, keep)

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep)

    out = fwd()
    go = torch.ones_like(out)
    fwd_ms = cuda_ms(fwd, 5, 1)

    def both():
        o = fwd()
        torch.autograd.grad(o, (qt, kt, vt), go)

    both_ms = cuda_ms(both, 5, 1)
    del out, qt, kt, vt
    return fwd_ms, both_ms, backend


def _grad_errs(grads, refs):
    errs = {}
    for gname, a, r in zip(("dq", "dk", "dv"), grads, refs):
        raw = (a.float() - r.float()).abs().max().item()
        errs[gname] = (raw, raw / max(1.0, r.float().abs().max().item()))
    return errs


def _mode_rows(torch, F, fa, name, q, k, v, do, causal, mask, keep, pairs,
               g_lse=None, library=None):
    """A masked mode (``mask``: the checked ``fa._Mask``, or None for the
    lse cotangent's dense mode) against its plain versions on one input:
    K1 with lse (out and lse), K2 and K3 (gradients, on the kernel's out and
    lse) within TOL; then each kernel's ms, device_ms, bound (4 d, 6 d and 8
    d operations per visible pair and q head at the bf16 peak, or the bytes
    it moves), plain ms and SDPA-with-mask ms. Returns (fwd, dq, dkv) rows
    for the kernels line (fwd None for the lse cotangent)."""
    b, s_q, hq, d = q.shape
    scale = d ** -0.5
    kw = {} if mask is None else (
        dict(q_seg=mask.a, kv_seg=mask.b) if mask.kind == "seg"
        else dict(row_start=mask.a, row_end=mask.b))
    out, lse = fa._launch_forward(q, k, v, causal, scale, True, mask)
    if mask is None:
        ref, ref_lse = fa.flash_attention_reference_lse(q, k, v, causal)
    else:
        ref, ref_lse = fa._masked_reference_lse(q, k, v, keep, causal, scale)
    sync()
    err = (out.float() - ref.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    del ref, ref_lse
    dq, delta = fa._launch_dq(q, k, v, out, lse, do, causal, scale, mask,
                              g_lse)
    dk, dv = fa._launch_dkv(q, k, v, do, lse, delta, causal, scale, mask)
    refs = fa.flash_attention_backward_reference(q, k, v, out, lse, do,
                                                 causal, scale, g_lse=g_lse,
                                                 **kw)
    sync()
    errs = _grad_errs((dq, dk, dv), refs)
    del refs, dq, dk, dv
    torch.cuda.empty_cache()
    worst = max(rel for _, rel in errs.values())
    print(f"{name}: max_abs_err={err:.3e} lse_max_abs_err={lse_err:.3e} "
          + " ".join(f"{g}_err={r:.3e} {g}_rel={rel:.3e}"
                     for g, (r, rel) in errs.items()), flush=True)
    if not (err <= TOL["bfloat16"] and lse_err <= LSE_TOL["bfloat16"]
            and worst <= TOL["bfloat16"]):
        raise AssertionError(f"{name}: out error {err}, lse error {lse_err}, "
                             f"gradient error {worst} (tol "
                             f"{TOL['bfloat16']} / {LSE_TOL['bfloat16']})")

    def fwd():
        return fa._launch_forward(q, k, v, causal, scale, True, mask)

    def k2():
        return fa._launch_dq(q, k, v, out, lse, do, causal, scale, mask,
                             g_lse)

    def k3():
        return fa._launch_dkv(q, k, v, do, lse, delta, causal, scale, mask)

    es = q.element_size()
    row_bytes = b * hq * s_q * 4
    mask_bytes = 0 if mask is None else (mask.a.numel() + mask.b.numel()) * 4
    glse_bytes = 0 if g_lse is None else row_bytes
    fwd_bytes = ((2 * q.numel() + k.numel() + v.numel()) * es + row_bytes
                 + mask_bytes)
    dq_bytes = ((4 * q.numel() + k.numel() + v.numel()) * es + 2 * row_bytes
                + mask_bytes + glse_bytes)
    dkv_bytes = ((2 * q.numel() + 4 * k.numel()) * es + 2 * row_bytes
                 + mask_bytes)
    bounds = (bound(4 * d * pairs, fwd_bytes, "bfloat16"),
              bound(6 * d * pairs, dq_bytes, "bfloat16"),
              bound(8 * d * pairs, dkv_bytes, "bfloat16"))
    if mask is None:
        plain_fwd = lambda: fa.flash_attention_reference_lse(q, k, v, causal)
    else:
        plain_fwd = lambda: fa._masked_reference_lse(q, k, v, keep, causal,
                                                     scale)
    plain = (cuda_ms(plain_fwd, 3, 1),
             cuda_ms(lambda: fa.flash_attention_backward_reference(
                 q, k, v, out, lse, do, causal, scale, g_lse=g_lse, **kw),
                 3, 1))
    torch.cuda.empty_cache()
    lib_fwd, lib_both, backend = library
    rows = []
    for kname, fn, (bms, bby), pms, lms in (
            ("k1", fwd, bounds[0], plain[0], lib_fwd),
            ("k2", k2, bounds[1], plain[1], lib_both - lib_fwd),
            ("k3", k3, bounds[2], plain[1], lib_both - lib_fwd)):
        ms = cuda_ms(fn)
        dev = device_ms(torch, fn)
        print(f"{name} {kname}: ms={ms:.4f} device_ms={dev:.4f} "
              f"bound_ms={bms:.5f} ({bby}) share_of_bound={bms / dev:.3f} "
              f"plain_ms={pms:.4f} library_ms={lms:.4f} (SDPA {backend} "
              f"with the boolean mask: forward {lib_fwd:.4f}, forward + "
              f"backward {lib_both:.4f}) visible_pairs={pairs:.0f}",
              flush=True)
        rows.append(dict(max_abs_err=(max(err, lse_err) if kname == "k1"
                                      else errs["dq"][0] if kname == "k2"
                                      else max(errs["dk"][0], errs["dv"][0])),
                         ms=ms, plain_ms=pms, bound_ms=bms, bound_by=bby,
                         library_ms=lms, device_ms=dev))
    del out, lse, delta
    torch.cuda.empty_cache()
    return rows


def _seg_ids(torch, docs, s):
    ids = torch.repeat_interleave(
        torch.arange(len(docs), dtype=torch.int32),
        torch.tensor(docs))
    if ids.numel() != s:
        raise AssertionError(f"documents {docs} do not fill {s} tokens")
    return ids


def phase_varlen(torch, F, ops):
    """flash_attention_varlen (K1-K3 in segment mode) forward and backward
    on one packed row of VARLEN_DOCS, flash_attn_varlen_qkvpacked's forward
    on the same tokens at 16 heads for q, k and v, and the all-zeros-segment
    case bitwise against the dense kernels. Returns (flash_fwd_seg,
    flash_bwd_dq_seg, flash_bwd_dkv_seg) rows."""
    import numpy as np

    from paddle_tpu_torch.nn.functional import flash_attn_varlen_qkvpacked

    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    b, s, hq, hkv, d = VARLEN_SHAPE
    gen = torch.Generator(device=DEVICE).manual_seed(18)
    q, k, v = _inputs(torch, gen, torch.bfloat16, b, s, s, hq, hkv, d)
    do = torch.randn(b, s, hq, d, device=DEVICE, generator=gen).to(
        torch.bfloat16)
    ids = _seg_ids(torch, VARLEN_DOCS, s)[None].to(DEVICE)
    cu = torch.tensor(np.concatenate([[0], np.cumsum(VARLEN_DOCS)]),
                      dtype=torch.int32)
    qkv = torch.randn(s, 3, hq, d, device=DEVICE, generator=gen).to(
        torch.bfloat16)
    # the main path: the entry points, forward and backward
    _zero_mask_counts(ops)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    out = ops.flash_attention_varlen(qg, kg, vg, ids, ids, True)
    torch.autograd.grad(out, (qg, kg, vg), do)
    packed, _ = flash_attn_varlen_qkvpacked(qkv, cu, cu, max(VARLEN_DOCS),
                                            max(VARLEN_DOCS), causal=True)
    sync()
    counts = _mask_counts(ops)
    want = {"flash_attention_forward.launches_seg": 1,
            "flash_attention_backward.launches_dq_seg": 1,
            "flash_attention_backward.launches_dkv_seg": 1,
            "flash_attention.launches_seg": 1}
    print(f"varlen main path launches: "
          f"{ {n: c for n, c in counts.items() if c} }", flush=True)
    if {n: c for n, c in counts.items() if c} != want:
        raise AssertionError(f"varlen: launches {counts}, expected {want}")
    pk = ops.flash_attention_varlen_reference(
        qkv[None, :, 0], qkv[None, :, 1], qkv[None, :, 2], ids, ids, True)[0]
    perr = (packed.float() - pk.float()).abs().max().item()
    print(f"flash_attn_varlen_qkvpacked [{s}, 3, {hq}, {d}] "
          f"{len(VARLEN_DOCS)} documents: max_abs_err={perr:.3e}", flush=True)
    if not perr <= TOL["bfloat16"]:
        raise AssertionError(f"flash_attn_varlen_qkvpacked: error {perr}")
    del qkv, packed, pk, out, qg, kg, vg
    torch.cuda.empty_cache()

    # every id 0: the segment mode masks nothing and gives the dense bits
    zeros = torch.zeros_like(ids)
    zm = fa._check_mask(q, k, fa._Mask("seg", zeros, zeros))
    zo, zl = fa._launch_forward(q, k, v, True, d ** -0.5, True, zm)
    do_, dl = fa._launch_forward(q, k, v, True, d ** -0.5, True)
    same = torch.equal(zo, do_) and torch.equal(zl, dl)
    zdq, zdelta = fa._launch_dq(q, k, v, zo, zl, do, True, d ** -0.5, zm)
    zdk, zdv = fa._launch_dkv(q, k, v, do, zl, zdelta, True, d ** -0.5, zm)
    ddq, ddelta = fa._launch_dq(q, k, v, do_, dl, do, True, d ** -0.5)
    ddk, ddv = fa._launch_dkv(q, k, v, do, dl, ddelta, True, d ** -0.5)
    same_grads = all(torch.equal(a, b_) for a, b_ in
                     zip((zdq, zdk, zdv), (ddq, ddk, ddv)))
    print(f"varlen all-zeros segments vs dense: forward bitwise {same}, "
          f"gradients bitwise {same_grads}", flush=True)
    if not (same and same_grads):
        raise AssertionError("varlen: all-zeros segment ids differ from the "
                             "dense kernels")
    del zo, zl, do_, dl, zdq, zdelta, zdk, zdv, ddq, ddelta, ddk, ddv
    torch.cuda.empty_cache()

    mask = fa._check_mask(q, k, fa._Mask("seg", ids, ids))
    keep = fa._seg_keep(ids, ids) & torch.ones(
        s, s, dtype=torch.bool, device=DEVICE).tril()
    pairs = masked_pairs(np, b, s, s, hq, True,
                         q_seg=ids.cpu().numpy(), kv_seg=ids.cpu().numpy())
    library = _sdpa_masked(torch, F, q, k, v, keep)
    rows = _mode_rows(torch, F, fa, "varlen", q, k, v, do, True, mask, keep,
                      pairs, library=library)
    n = counts
    rows[0]["launches"] = (n["flash_attention.launches_seg"]
                           + n["flash_attention_forward.launches_seg"])
    rows[1]["launches"] = n["flash_attention_backward.launches_dq_seg"]
    rows[2]["launches"] = n["flash_attention_backward.launches_dkv_seg"]
    return rows


def _flashmask_indices(torch, case, b, s, hkv):
    """startend_row_indices of the two flashmask cases: "doc" the causal
    document mask (1 index, hm 1: column c hides the rows from its
    document's end on); "band" (2 indices, hm = kv heads): kv head h hides
    rows [c + W_h, min(c + W_h + FLASHMASK_BAND, s))."""
    c = torch.arange(s, dtype=torch.int32)
    if case == "doc":
        bounds = torch.cumsum(torch.tensor(FLASHMASK_DOCS), 0)
        doc_end = bounds[torch.bucketize(c, bounds, right=True)]
        return doc_end.to(torch.int32).view(1, 1, s, 1).expand(
            b, 1, s, 1).contiguous()
    w = torch.tensor(FLASHMASK_WINDOWS, dtype=torch.int32)[:, None]
    lts = c[None] + w
    lte = torch.clamp(lts + FLASHMASK_BAND, max=s)
    return torch.stack([lts, lte], -1)[None].expand(b, hkv, s, 2).contiguous()


def phase_flashmask(torch, F, ops):
    """flashmask_attention's kernel path (K1-K3 in row-bound mode),
    forward and backward, on FLASHMASK_SHAPE in two cases. Returns the
    (flash_fwd_rowmask, flash_bwd_dq_rowmask, flash_bwd_dkv_rowmask) rows
    of the band case (both bounds, per-head bounds), launches summed."""
    import numpy as np

    from paddle_tpu_torch.nn.functional import flashmask_attention

    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    b, s, hq, hkv, d = FLASHMASK_SHAPE
    gen = torch.Generator(device=DEVICE).manual_seed(19)
    q, k, v = _inputs(torch, gen, torch.bfloat16, b, s, s, hq, hkv, d)
    do = torch.randn(b, s, hq, d, device=DEVICE, generator=gen).to(
        torch.bfloat16)
    rows, totals = None, None
    for case in ("doc", "band"):
        idx = _flashmask_indices(torch, case, b, s, hkv).to(DEVICE)
        _zero_mask_counts(ops)
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        out = flashmask_attention(qg, kg, vg, idx, causal=True)
        torch.autograd.grad(out, (qg, kg, vg), do)
        sync()
        counts = _mask_counts(ops)
        got = {n_: c for n_, c in counts.items() if c}
        want = {"flash_attention_forward.launches_rowmask": 1,
                "flash_attention_backward.launches_dq_rowmask": 1,
                "flash_attention_backward.launches_dkv_rowmask": 1}
        print(f"flashmask {case} main path launches: {got}", flush=True)
        if got != want:
            raise AssertionError(f"flashmask {case}: launches {got}, "
                                 f"expected {want}")
        totals = got if totals is None else {
            n_: totals[n_] + got[n_] for n_ in want}
        del out, qg, kg, vg
        start = idx[..., 0]
        end = (idx[..., 1] if idx.shape[-1] > 1
               else torch.full_like(start, 2 * s))
        mask = fa._check_mask(q, k, fa._Mask("rowmask", start, end))
        keep = fa._row_keep(mask.a, mask.b, hq, s) & torch.ones(
            s, s, dtype=torch.bool, device=DEVICE).tril()
        pairs = masked_pairs(np, b, s, s, hq, True,
                             start=mask.a.cpu().numpy(),
                             end=mask.b.cpu().numpy())
        library = _sdpa_masked(torch, F, q, k, v, keep)
        r = _mode_rows(torch, F, fa, f"flashmask {case}", q, k, v, do, True,
                       mask, keep, pairs, library=library)
        del keep
        torch.cuda.empty_cache()
        if case == "band":
            rows = r
    rows[0]["launches"] = totals["flash_attention_forward.launches_rowmask"]
    rows[1]["launches"] = totals[
        "flash_attention_backward.launches_dq_rowmask"]
    rows[2]["launches"] = totals[
        "flash_attention_backward.launches_dkv_rowmask"]
    return rows


def phase_lse_cotangent(torch, F, ops):
    """flash_attention_with_lse, loss (out g).sum() + (lse h).sum(): K2
    takes l-bar, at the training shape and at ring attention's two stripe
    pairs (RING_DIAG_SHAPE, RING_FULL_SHAPE: phase 56 (b)'s sep=2 runs K2
    in this mode). Returns (the training shape's flash_bwd_dq_glse row, K1
    with lse launches of the main path)."""
    row, lse_launches = None, 0
    for shape in (TRAIN_SHAPE, RING_DIAG_SHAPE, RING_FULL_SHAPE):
        got, n = _lse_cotangent_case(torch, F, ops, shape)
        lse_launches += n
        if shape is TRAIN_SHAPE:
            row = got
    return row, lse_launches


def _lse_cotangent_case(torch, F, ops, shape):
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    name, b, s, _, hq, hkv, d, causal = shape
    gen = torch.Generator(device=DEVICE).manual_seed(20)
    q, k, v = _case_inputs(torch, gen, torch.bfloat16, name, b, s, s, hq,
                           hkv, d)
    g = torch.randn(b, s, hq, d, device=DEVICE, generator=gen).to(
        torch.bfloat16)
    h = torch.randn(b, hq, s, device=DEVICE, generator=gen)
    _zero_mask_counts(ops)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    out, lse = ops.flash_attention_with_lse(qg, kg, vg, causal)
    loss = (out.float() * g.float()).sum() + (lse * h).sum()
    grads = torch.autograd.grad(loss, (qg, kg, vg))
    sync()
    counts = {n_: c for n_, c in _mask_counts(ops).items() if c}
    want = {"flash_attention_forward.launches": 1,
            "flash_attention_backward.launches_glse": 1,
            "flash_attention_backward.launches_dkv": 1}
    print(f"lse cotangent {name} main path launches: {counts}", flush=True)
    if counts != want:
        raise AssertionError(f"lse cotangent {name}: launches {counts}, "
                             f"expected {want}")
    refs = ops.flash_attention_backward_reference(
        q, k, v, out.detach(), lse.detach(), g, causal, g_lse=h)
    errs = _grad_errs(grads, refs)
    worst = max(rel for _, rel in errs.values())
    print(f"lse cotangent {name} through autograd vs plain: " + " ".join(
        f"{n_}_rel={rel:.3e}" for n_, (_, rel) in errs.items()), flush=True)
    if not worst <= TOL["bfloat16"]:
        raise AssertionError(f"lse cotangent {name}: gradient error {worst}")
    del grads, refs, out, lse, qg, kg, vg, loss
    torch.cuda.empty_cache()
    # the yardstick: SDPA forward and backward (no lse cotangent)
    fwd_ms = cuda_ms(lambda: sdpa(F, q, k, v, causal), 5, 1)
    qs, ks, vs = (x.detach().clone().requires_grad_() for x in (q, k, v))
    lo = sdpa(F, qs, ks, vs, causal)
    gt = g.transpose(1, 2)
    bwd_ms = cuda_ms(lambda: lo.backward(gt, retain_graph=True), 5, 1)
    library = (fwd_ms, fwd_ms + bwd_ms, _sdpa_backend(
        torch, *(x.transpose(1, 2) for x in (q, k, v)), None, causal))
    del qs, ks, vs, lo
    pairs = causal_pairs(s, s, causal) * b * hq
    rows = _mode_rows(torch, F, fa, f"lse cotangent {name}", q, k, v, g,
                      causal, None, None, pairs, g_lse=h, library=library)
    row = rows[1]
    row["launches"] = counts["flash_attention_backward.launches_glse"]
    return row, counts["flash_attention_forward.launches"]


def _bmha_case(torch, np, quant, gen):
    """block_multihead_attention's inputs at BMHA: the rows' qkv, caches
    holding random history, tables, lengths (8 prefill rows, 56 decode)."""
    nh, kv, hd, page = BMHA["heads"], BMHA["kv_heads"], BMHA["head_dim"], \
        BMHA["block_size"]
    rng = np.random.default_rng(21)
    n_pre, n_dec = BMHA["prefill_rows"], BMHA["decode_rows"]
    ctx = rng.integers(BMHA["ctx_lo"], BMHA["ctx_hi"] + 1, n_dec)
    enc = np.concatenate([np.full(n_pre, BMHA["prefill_len"]),
                          np.zeros(n_dec, np.int64)])
    dec = np.concatenate([np.zeros(n_pre, np.int64), ctx - 1])
    this = np.concatenate([np.full(n_pre, BMHA["prefill_len"]),
                           np.ones(n_dec, np.int64)])
    b = n_pre + n_dec
    maxp = -(-max(BMHA["prefill_len"], BMHA["ctx_hi"]) // page)
    npages = b * maxp
    tables = torch.randperm(npages, device=DEVICE, generator=gen).reshape(
        b, maxp).to(torch.int32)
    tok = int(this.sum())
    qkv = torch.randn(tok, (nh + 2 * kv) * hd, device=DEVICE,
                      generator=gen).to(torch.bfloat16)
    if quant:
        caches = [torch.randint(-127, 128, (npages, kv, page, hd),
                                device=DEVICE, generator=gen,
                                dtype=torch.int8) for _ in range(2)]
        qs = torch.linspace(30, 60, kv, device=DEVICE)
        scales = dict(cache_k_quant_scales=qs, cache_v_quant_scales=qs * 1.5,
                      cache_k_dequant_scales=1 / qs,
                      cache_v_dequant_scales=1 / (qs * 1.5))
    else:
        caches = [torch.randn(npages, kv, page, hd, device=DEVICE,
                              generator=gen).to(torch.bfloat16)
                  for _ in range(2)]
        scales = {}

    def lens(a):
        return torch.tensor(a, dtype=torch.int32)[:, None]

    cu = lens(np.concatenate([[0], np.cumsum(this)]))
    args = dict(qkv=qkv, key_cache=caches[0], value_cache=caches[1],
                seq_lens_encoder=lens(enc), seq_lens_decoder=lens(dec),
                seq_lens_this_time=lens(this),
                padding_offsets=torch.zeros(tok, dtype=torch.int32),
                cum_offsets=torch.zeros(b, dtype=torch.int32),
                cu_seqlens_q=cu, cu_seqlens_k=cu, block_tables=tables,
                block_size=page, **scales)
    return args, int((ctx).sum())


def phase_block_mha(torch, np, ops):
    """block_multihead_attention at the Llama serving width (BMHA): bf16
    caches, then raw int8 caches with static scales. Each call on the card
    (K1 a prefill row, one K4 call for the decode rows) against the same
    call with the kernels' plain versions in their place, on copies of the
    caches: out within TOL, the caches byte for byte. Returns (K1 launches,
    K4 launches) of the two calls."""
    imod = importlib.import_module("paddle_tpu_torch.incubate.nn.functional")
    gen = torch.Generator(device=DEVICE).manual_seed(21)
    k1 = k4 = 0
    for quant in (False, True):
        args, ctx_tokens = _bmha_case(torch, np, quant, gen)
        plain_args = dict(args, key_cache=args["key_cache"].clone(),
                          value_cache=args["value_cache"].clone())
        _zero_mask_counts(ops)
        t0 = time.perf_counter()
        out = imod.block_multihead_attention(**args)[0]
        sync()
        wall = time.perf_counter() - t0
        counts = _mask_counts(ops)
        c1 = counts["flash_attention.launches"]
        c4 = counts["paged_decode_attention.launches"]
        c4q = counts["paged_decode_attention.int8_launches"]
        saved = (imod.flash_attention, imod.paged_decode_attention)
        imod.flash_attention = lambda q, k, v, causal: \
            ops.flash_attention_reference(q, k, v, causal)
        imod.paged_decode_attention = ops.paged_decode_reference
        try:
            ref = imod.block_multihead_attention(**plain_args)[0]
        finally:
            imod.flash_attention, imod.paged_decode_attention = saved
        sync()
        err = (out.float() - ref.float()).abs().max().item()
        same = (torch.equal(args["key_cache"], plain_args["key_cache"])
                and torch.equal(args["value_cache"],
                                plain_args["value_cache"]))
        kind = "int8" if quant else "bf16"
        print(f"block_mha {kind}: {BMHA['prefill_rows']} prefill rows of "
              f"{BMHA['prefill_len']}, {BMHA['decode_rows']} decode rows "
              f"({ctx_tokens} context tokens), heads {BMHA['heads']}/"
              f"{BMHA['kv_heads']} x {BMHA['head_dim']}, block "
              f"{BMHA['block_size']}: max_abs_err={err:.3e} caches equal "
              f"{same}; launches K1 {c1} K4 {c4} (int8 {c4q}); call "
              f"{wall * 1e3:.1f} ms (host clock, first call)", flush=True)
        if not (err <= TOL["bfloat16"] and same):
            raise AssertionError(f"block_mha {kind}: error {err}, caches "
                                 f"equal {same}")
        if c1 != BMHA["prefill_rows"] or c4 != 1 or c4q != int(quant):
            raise AssertionError(f"block_mha {kind}: launches K1 {c1}, K4 "
                                 f"{c4} (int8 {c4q})")
        k1 += c1
        k4 += c4
        del args, plain_args, out, ref
        torch.cuda.empty_cache()
    return k1, k4


def phase_fused_moe(torch, np):
    """fused_moe at bench_moe's expert width (FUSED_MOE), bf16, against the
    same call in fp32 on the card (one routing: the gate logits are fp32
    inputs of both)."""
    from paddle_tpu_torch.incubate.nn.functional import fused_moe

    gen = torch.Generator(device=DEVICE).manual_seed(22)
    bsz, seq, dm = FUSED_MOE["x"]
    e, ff, k = FUSED_MOE["experts"], FUSED_MOE["ffn"], FUSED_MOE["topk"]
    x = torch.randn(bsz, seq, dm, device=DEVICE, generator=gen)
    gate = torch.randn(bsz, seq, e, device=DEVICE, generator=gen)
    w1 = torch.randn(e, dm, 2 * ff, device=DEVICE, generator=gen) / dm ** 0.5
    w2 = torch.randn(e, ff, dm, device=DEVICE, generator=gen) / ff ** 0.5
    ref = fused_moe(x, gate, w1, w2, moe_topk=k)
    bf = [t.to(torch.bfloat16) for t in (x, w1, w2)]
    out = fused_moe(bf[0], gate, bf[1], bf[2], moe_topk=k)
    sync()
    err = (out.float() - ref).abs().max().item()
    scale = ref.abs().max().item()
    ms = cuda_ms(lambda: fused_moe(bf[0], gate, bf[1], bf[2], moe_topk=k),
                 5, 1)
    print(f"fused_moe x [{bsz}, {seq}, {dm}], {e} swiglu experts of {ff}, "
          f"top-{k}: bf16 vs fp32 max_abs_err={err:.3e} (max |fp32| "
          f"{scale:.3f}) finite {bool(torch.isfinite(out).all())} "
          f"ms={ms:.3f}", flush=True)
    if not (torch.isfinite(out).all() and err <= TOL["bfloat16"] * scale):
        raise AssertionError(f"fused_moe: error {err} > "
                             f"{TOL['bfloat16']} x {scale}")


# ---- phases 23-24: serving recovery and the fleet router -----------------

def _scratch_dir(name):
    """An empty directory for journals under the checkout's build/ (listed
    in .gitignore)."""
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "chip_smoke", name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    return d


def _recovery_wave(np, vocab):
    """Phase 7's 256 prompts and max_new_tokens; the first
    RECOVERY_SAMPLED requests sample at RECOVERY_TEMP with their own seeds
    (the rest greedy), as kwargs for Request."""
    prompts, news = _fused_wave(np, vocab)
    kws = [dict(max_new_tokens=k) for k in news]
    for i in range(RECOVERY_SAMPLED):
        kws[i].update(temperature=RECOVERY_TEMP, seed=1000 + i)
    return prompts, kws


def _cold(*engines):
    """Empty the engines' radix caches: the next wave starts cold, so its
    step schedule is the first cold wave's."""
    for eng in engines:
        eng._radix.evict_lru(eng._alloc.num_blocks)


def _run_sup(sup, reqs, schedule=None, times=None):
    """Submit ``reqs`` and step the supervisor to the end; ``schedule``
    collects (active slots, delivered tokens) before each step and
    ``times`` each step's host seconds."""
    for r in reqs:
        sup.submit(r)
    while sup.has_work():
        if schedule is not None:
            schedule.append((sup.engine.active_slots(),
                             sum(len(r.output) for r in reqs)))
        t0 = time.perf_counter()
        sup.step()
        if times is not None:
            times.append(time.perf_counter() - t0)
    sup.finished()
    sync()


def _mid_wave(schedule, min_active):
    """The step index in the middle of the steps that start with at least
    ``min_active`` busy slots after some tokens were delivered."""
    steps = [i for i, (act, dlv) in enumerate(schedule)
             if act >= min_active and dlv > 0]
    if not steps:
        raise AssertionError(f"no step with >= {min_active} busy slots "
                             f"after a delivery: {schedule}")
    return steps[len(steps) // 2]


def _check_streams(what, reqs, ref):
    outs = [list(r.output) for r in reqs]
    bad = [i for i, (a, b) in enumerate(zip(outs, ref)) if a != b]
    failed = [r.rid for r in reqs if r.failed or not r.done]
    if bad or failed:
        raise AssertionError(
            f"{what}: {len(bad)} of {len(reqs)} streams differ from the "
            f"uninterrupted run (first {bad[:8]}), {len(failed)} failed or "
            f"unfinished: {[r.error for r in reqs if r.failed][:2]}")


class _RecoveryProbe:
    """Wraps a supervisor's ``_recover`` and its factory: K1/K4 launches
    from the start of each recovery to its end, the rebuild's seconds
    (engine construction with its graph capture) and the new engines."""

    def __init__(self, ops, sup):
        self.k1 = self.k4 = 0
        self.build_s = []
        self.engines = []
        recover, build = sup._recover, sup._build

        def timed_build():
            t0 = time.perf_counter()
            eng = build()
            sync()
            self.build_s.append(time.perf_counter() - t0)
            self.engines.append(weakref.ref(eng))
            return eng

        def counted(*args, **kwargs):
            k1 = ops.flash_attention.launches
            k4 = ops.paged_decode_attention.launches
            recover(*args, **kwargs)
            self.k1 += ops.flash_attention.launches - k1
            self.k4 += ops.paged_decode_attention.launches - k4

        sup._build = timed_build
        sup._recover = counted

    @staticmethod
    def detach(sup):
        """Drop the wrappers (they and ``sup`` refer to each other)."""
        del sup._build, sup._recover


def phase_recovery(torch, np, ops, card):
    """bench.py bench_serving_recovery at the SERVE_CONFIG widths: (a) a
    ServingSupervisor over the fused 128-slot engine, the 256-request wave
    clean, under a serving.step kill and under a serving.stall overrun;
    (b) the legacy engine with phase 6's wave and a kill; (c) a journal
    restart. Returns (K1 launches, K4 launches, model, the clean streams,
    the supervisor's clean tokens/s)."""
    from paddle_tpu_torch.distributed.resilience import FaultPlan, FaultSpec
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            PrefixCacheConfig, Request,
                                            RequestJournal,
                                            ServingSupervisor)
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(**SERVE_CONFIG)
    L = cfg.num_hidden_layers
    model = LlamaForCausalLM(cfg, device=DEVICE, seed=0)

    def build():
        return ContinuousBatchingEngine(
            model, device=DEVICE,
            prefix_cache=PrefixCacheConfig(extra_blocks=FUSED_EXTRA_BLOCKS),
            **FUSED_ENGINE)

    prompts, kws = _recovery_wave(np, cfg.vocab_size)

    def wave():
        return [Request(p, **kw) for p, kw in zip(prompts, kws)]

    _zero_serving_counts(ops)
    path = os.path.join(_scratch_dir("recovery"), "fused.jrnl")
    sup = ServingSupervisor(build, path, max_recoveries=3)
    probe = _RecoveryProbe(ops, sup)
    warm = [Request(p, max_new_tokens=4) for p in prompts[-2:]]
    _run_sup(sup, warm)
    _cold(sup.engine)

    # (a) the clean wave: the reference streams and the step schedule
    schedule, times = [], []
    reqs = wave()
    t0 = time.perf_counter()
    _run_sup(sup, reqs, schedule, times)
    clean_s = time.perf_counter() - t0
    ref = [list(r.output) for r in reqs]
    _check_streams("recovery clean", reqs, ref)
    useful = sum(len(o) for o in ref)
    k = _mid_wave(schedule, FUSED_ENGINE["max_batch"] // 2)
    budget = max(RECOVERY_BUDGET_MIN, 5 * max(times))

    # the kill: PT-SRV-001, rebuild, replay
    _cold(sup.engine)
    reqs = wave()
    plan = FaultPlan(seed=7, specs=[FaultSpec("serving.step", "kill", at=k)])
    rec0, replayed0 = sup.stats["recovery_s"], sup.stats["replayed_requests"]
    k4_0 = probe.k4
    t0 = time.perf_counter()
    with plan:
        _run_sup(sup, reqs)
    kill_s = time.perf_counter() - t0
    eng = sup.engine
    mem_first = torch.cuda.memory_allocated()
    kill_rec = sup.stats["recovery_s"] - rec0
    kill_replayed = sup.stats["replayed_requests"] - replayed0
    print(f"recovery kill [{card}]: serving.step kill at step {k} of "
          f"{len(schedule)} ({schedule[k][0]} busy slots, {schedule[k][1]} "
          f"tokens delivered); recovery_s={kill_rec:.4f} (rebuild "
          f"{probe.build_s[-1]:.4f} s with the graph capture) "
          f"replayed_requests={kill_replayed}; faulted wave "
          f"{useful / kill_s:.1f} tokens/s against clean "
          f"{useful / clean_s:.1f} ({useful} tokens); rebuilt engine: "
          f"graph_captures={eng.stats['graph_captures']} graph_replays="
          f"{eng.stats['graph_replays']} eager_decode_steps="
          f"{eng.stats['eager_decode_steps']}, K4 launches during the "
          f"recovery {probe.k4 - k4_0}", flush=True)
    _check_streams("recovery kill", reqs, ref)
    if (plan.fired() != {"serving.step": 1} or sup.recoveries != 1
            or [c for c, _ in sup.events] != ["PT-SRV-001"]
            or eng.stats["graph_captures"] != 1
            or eng.stats["graph_replays"] == 0 or kill_replayed == 0
            or probe.k4 == k4_0
            or ops.paged_decode_attention.launches
            < eng.stats["graph_replays"] * L):
        raise AssertionError(f"recovery kill: fired {plan.fired()}, events "
                             f"{sup.events}, rebuilt engine {eng.stats}")
    del eng

    # the stall: the watchdog flags PT-SRV-002 mid-hang, then rebuild
    sup.set_step_budget(budget)
    _cold(sup.engine)
    reqs = wave()
    plan = FaultPlan(seed=7, specs=[FaultSpec("serving.stall", "stall",
                                              at=k, arg=3 * budget)])
    rec0, replayed0 = sup.stats["recovery_s"], sup.stats["replayed_requests"]
    t0 = time.perf_counter()
    with plan, warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        _run_sup(sup, reqs)
    stall_s = time.perf_counter() - t0
    overruns = list(sup.watchdog.overruns)
    print(f"recovery stall [{card}]: budget {budget:.3f} s (5 x the "
          f"slowest clean step {max(times):.4f} s, at least "
          f"{RECOVERY_BUDGET_MIN}), a {3 * budget:.3f} s stall at step {k}; "
          f"overruns={[(t, round(e, 4)) for t, e in overruns]} "
          f"recovery_s={sup.stats['recovery_s'] - rec0:.4f} (rebuild "
          f"{probe.build_s[-1]:.4f} s) replayed_requests="
          f"{sup.stats['replayed_requests'] - replayed0}; faulted wave "
          f"{useful / stall_s:.1f} tokens/s", flush=True)
    _check_streams("recovery stall", reqs, ref)
    if (plan.fired() != {"serving.stall": 1} or sup.recoveries != 2
            or [c for c, _ in sup.events] != ["PT-SRV-001", "PT-SRV-002"]
            or len(overruns) != 1
            or sup.engine.stats["graph_captures"] != 1):
        raise AssertionError(f"recovery stall: fired {plan.fired()}, events "
                             f"{sup.events}, overruns {overruns}")
    sup.set_step_budget(None)

    # (c) restart: the supervisor dies mid-wave; a new one over the journal
    _cold(sup.engine)
    reqs = wave()
    for r in reqs:
        sup.submit(r)
    for _ in range(k):
        sup.step()
    delivered = {r.rid: list(r.output) for r in reqs}
    old = [weakref.ref(sup.engine)] + probe.engines
    sup.abandon()
    _RecoveryProbe.detach(sup)
    del sup, probe
    leaked = sum(w() is not None for w in old)
    sup2 = ServingSupervisor(build, path)
    sup2.run_until_done()
    sync()
    mem_third = torch.cuda.memory_allocated()
    restarted = {rid: r for rid, r in sup2.requests.items()}
    outs = [restarted.get(r.rid, r) for r in reqs]
    recs = RequestJournal.load(path)
    dup = [r.rid for r, want in zip(reqs, ref)
           if [t for x in recs if x["k"] == "prog" and x["rid"] == r.rid
               for t in x["toks"]] != want]
    print(f"recovery restart [{card}]: abandoned at step {k} with "
          f"{sum(len(v) for v in delivered.values())} tokens delivered, "
          f"{len(restarted)} requests replayed by the new supervisor in "
          f"{sup2.stats['recovery_s']:.4f} s; engines of the old supervisor "
          f"still alive: {leaked}; memory_allocated after the first "
          f"recovery {mem_first / 2**20:.1f} MiB, after the third "
          f"{mem_third / 2**20:.1f} MiB", flush=True)
    _check_streams("recovery restart", outs, ref)
    if (dup or leaked or [c for c, _ in sup2.events] != ["PT-SRV-001"]
            or abs(mem_third - mem_first) > RECOVERY_MEM_SLACK
            or any(restarted[rid].output[:len(delivered[rid])]
                   != delivered[rid] for rid in restarted)):
        raise AssertionError(
            f"recovery restart: re-delivered or lost tokens {dup[:8]}, "
            f"{leaked} old engines alive, memory {mem_first} -> "
            f"{mem_third}, events {sup2.events}")
    sup2.close()
    single_tok_s = useful / clean_s
    del sup2

    # (b) the legacy engine: phase 6's wave, a kill mid-wave; K1 (prefill)
    # and K4 (decode) carry the replay
    warm_l, prompts_l, kws_l, _ = _legacy_wave(np, cfg.vocab_size)

    def build_legacy():
        return ContinuousBatchingEngine(model, device=DEVICE, **ENGINE)

    def wave_l():
        return [Request(p, **kw) for p, kw in zip(prompts_l, kws_l)]

    sup = ServingSupervisor(build_legacy,
                            os.path.join(_scratch_dir("legacy"), "j.jrnl"))
    probe = _RecoveryProbe(ops, sup)
    _run_sup(sup, [Request(p, max_new_tokens=4) for p in warm_l])
    schedule = []
    reqs = wave_l()
    _run_sup(sup, reqs, schedule)
    ref_l = [list(r.output) for r in reqs]
    k_l = _mid_wave(schedule, ENGINE["max_batch"] // 2)
    reqs = wave_l()
    plan = FaultPlan(seed=7, specs=[FaultSpec("serving.step", "kill",
                                              at=k_l)])
    with plan:
        _run_sup(sup, reqs)
    print(f"recovery legacy [{card}]: kill at step {k_l} of "
          f"{len(schedule)}; recovery_s={sup.stats['recovery_s']:.4f} "
          f"(rebuild {probe.build_s[-1]:.4f} s) replayed_requests="
          f"{sup.stats['replayed_requests']}; during the recovery K1 "
          f"launches {probe.k1}, K4 launches {probe.k4}", flush=True)
    _check_streams("recovery legacy", reqs, ref_l)
    if (plan.fired() != {"serving.step": 1} or sup.recoveries != 1
            or probe.k1 == 0 or probe.k4 == 0):
        raise AssertionError(f"recovery legacy: fired {plan.fired()}, "
                             f"events {sup.events}, K1 {probe.k1} K4 "
                             f"{probe.k4}")
    sup.close()
    _RecoveryProbe.detach(sup)
    c = _serving_counts(ops)
    return c["k1"], c["k4"], model, ref, single_tok_s


def _legacy_wave(np, vocab):
    """Phase 6's wave, from seed 0: two warm-up prompts (the bucket and one
    token less), then 16 requests, 4 of exactly the bucket length and 12
    of 3/4 bucket to bucket - 1 (re-stepped), max_new_tokens cycling
    through WAVE_NEW, request 5 with an eos. Returns (warm-up prompts,
    prompts, Request kwargs, the generator for later draws)."""
    rng = np.random.default_rng(0)

    def prompt(n):
        return rng.integers(0, vocab, (n,)).astype(np.int32)

    bucket = ENGINE["prompt_buckets"][0]
    warm = [prompt(n) for n in (bucket, bucket - 1)]
    lens = [bucket] * 4 + [int(x) for x in
                           rng.integers(bucket * 3 // 4, bucket, 12)]
    news = [WAVE_NEW[i % 4] for i in range(16)]
    prompts = [prompt(n) for n in lens]
    kws = [dict(max_new_tokens=k,
                eos_token_id=LEGACY_EOS if i == 5 else None)
           for i, k in enumerate(news)]
    return warm, prompts, kws, rng


def phase_fleet(torch, np, ops, card, model, ref, single_tok_s):
    """bench.py bench_fleet at the SERVE_CONFIG widths: a FleetRouter of
    FLEET_REPLICAS replicas of phase 23's fused engine sharing ``model``,
    with affinity, over phase 23's wave: clean, a replica kill, a drain,
    and parallel_step with a rebuild inside a stepping thread and a
    restart. ``ref`` is phase 23's clean streams, ``single_tok_s`` one
    supervisor-wrapped engine's tokens/s on the wave. Returns (K1, K4
    launches)."""
    from paddle_tpu_torch.distributed.resilience import FaultPlan, FaultSpec
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            FleetConfig, FleetRouter,
                                            PrefixCacheConfig, Request,
                                            RequestJournal)

    cfg = model.config
    L = cfg.num_hidden_layers

    def build():
        return ContinuousBatchingEngine(
            model, device=DEVICE,
            prefix_cache=PrefixCacheConfig(extra_blocks=FUSED_EXTRA_BLOCKS),
            **FUSED_ENGINE)

    prompts, kws = _recovery_wave(np, cfg.vocab_size)

    def wave():
        return [Request(p, **kw) for p, kw in zip(prompts, kws)]

    _zero_serving_counts(ops)
    fleet = FleetRouter(build, _scratch_dir("fleet"),
                        num_replicas=FLEET_REPLICAS,
                        config=FleetConfig(affinity=True))
    for rep in fleet.replicas:
        _warm_up_engine(rep.sup.engine, Request, np, cfg.vocab_size)

    def engines():
        return [rep.sup.engine for rep in fleet.replicas
                if rep.state == "alive"]

    def run(reqs, on_step=None):
        steps = 0
        for r in reqs:
            fleet.submit(r)
        while fleet.has_work():
            if on_step is not None:
                on_step(steps)
            fleet.step()
            steps += 1
        fleet.finished()
        sync()
        return steps

    # the clean pass
    reqs = wave()
    t0 = time.perf_counter()
    n_steps = run(reqs)
    fleet_s = time.perf_counter() - t0
    _check_streams("fleet clean", reqs, ref)
    useful = sum(len(o) for o in ref)
    spread = dict(collections.Counter(fleet._assigned[r.rid] for r in reqs))
    k = n_steps // 2

    # a replica killed mid-wave: its journal fails over to the survivors
    _cold(*engines())
    reqs = wave()
    plan = FaultPlan(seed=7, specs=[FaultSpec(
        "fleet.replica_kill", "kill", at=k, match="replica:1:")])
    with plan:
        run(reqs)
    dead = fleet.replicas[1]
    moved = [x["rid"] for x in RequestJournal.load(dead.journal_path)
             if x["k"] == "migr"]
    on_dead = [r for r in reqs if r.rid in moved]
    print(f"fleet kill [{card}]: replica 1 killed at its fleet step {k} of "
          f"{n_steps}; failover_s={fleet.stats['failover_s']:.4f} "
          f"failover_requests={fleet.stats['failover_requests']} "
          f"({len(on_dead)} moved to survivors "
          f"{sorted(set(fleet._assigned[r.rid] for r in on_dead))})",
          flush=True)
    _check_streams("fleet kill", reqs, ref)
    if (plan.fired() != {"fleet.replica_kill": 1}
            or fleet.stats["replica_deaths"] != 1 or not on_dead
            or any(fleet._assigned[r.rid] == 1 for r in on_dead)):
        raise AssertionError(f"fleet kill: fired {plan.fired()}, "
                             f"{fleet.stats}")
    failover_s = fleet.stats["failover_s"]
    fleet.restart(1)

    # a drain mid-wave: queued requests migrate, in-flight ones finish in
    # place, the replica rebuilds once idle
    _cold(*engines())
    reqs = wave()
    half = len(reqs) // 2
    for r in reqs[:half]:
        fleet.submit(r)
    for _ in range(k // 2):
        fleet.step()
    gen0 = fleet.replicas[0].gen
    for r in reqs[half:]:
        fleet.submit(r)
    inflight = [r.rid for r in reqs if fleet._assigned.get(r.rid) == 0
                and not r.done]
    fleet.drain(0)
    stayed = [rid for rid in inflight if fleet._assigned[rid] == 0]
    run([])
    print(f"fleet drain [{card}]: replica 0 drained with {len(inflight)} "
          f"requests on it: {fleet.stats['migrated']} queued ones migrated, "
          f"{len(stayed)} in flight finished in place; generation "
          f"{gen0} -> {fleet.replicas[0].gen}", flush=True)
    _check_streams("fleet drain", reqs, ref)
    if (fleet.stats["migrated"] == 0 or not stayed
            or fleet.replicas[0].gen != gen0 + 1
            or fleet.replicas[0].state != "alive"):
        raise AssertionError(f"fleet drain: {fleet.stats}")

    # parallel_step: a serving.step kill rebuilds one replica (its graph
    # captured) inside its stepping thread; replica 2 is killed and
    # restarted mid-wave
    fleet.config.parallel_step = True
    _cold(*engines())
    reqs = wave()
    # every supervisor of the pass (a restart replaces replica 2's)
    sups = {id(rep.sup): rep.sup for rep in fleet.replicas}
    recoveries0 = sum(sup.recoveries for sup in sups.values())
    deaths0 = fleet.stats["replica_deaths"]
    plan = FaultPlan(seed=7, specs=[
        FaultSpec("serving.step", "kill", at=k),
        FaultSpec("fleet.replica_kill", "kill", at=k // 2,
                  match="replica:2:")])

    def restart_dead(step):
        sups.update((id(rep.sup), rep.sup) for rep in fleet.replicas)
        if fleet.replicas[2].state == "dead":
            fleet.restart(2)

    t0 = time.perf_counter()
    with plan:
        run(reqs, restart_dead)
    par_s = time.perf_counter() - t0
    sups.update((id(rep.sup), rep.sup) for rep in fleet.replicas)
    rebuilt = sum(sup.recoveries for sup in sups.values()) - recoveries0
    print(f"fleet parallel_step [{card}]: fired {plan.fired()}, "
          f"{rebuilt} supervisor rebuild in a stepping thread, replica 2 "
          f"restarted (generation {fleet.replicas[2].gen}); "
          f"{useful / par_s:.1f} tokens/s with the faults", flush=True)
    _check_streams("fleet parallel_step", reqs, ref)
    if (plan.fired() != {"serving.step": 1, "fleet.replica_kill": 1}
            or rebuilt != 1 or fleet.stats["replica_deaths"] != deaths0 + 1
            or fleet.replicas[2].state != "alive"
            or any(e.stats["graph_captures"] != 1 for e in engines())):
        raise AssertionError(f"fleet parallel_step: fired {plan.fired()}, "
                             f"rebuilds {rebuilt}, {fleet.stats}")
    fleet.close()
    fleet_tok_s = useful / fleet_s
    print(f"fleet [{card}]: fleet_tokens_per_s={fleet_tok_s:.1f} "
          f"({FLEET_REPLICAS} replicas on one card, clean pass, {useful} "
          f"tokens in {fleet_s:.3f}s, requests per replica {spread}) "
          f"single_supervisor_tokens_per_s={single_tok_s:.1f} vs_baseline="
          f"{fleet_tok_s / single_tok_s:.3f} failover_s={failover_s:.4f}",
          flush=True)
    c = _serving_counts(ops)
    if c["k4"] < L:
        raise AssertionError(f"fleet: K4 launches {c['k4']}")
    return c["k1"], c["k4"]


class _MigrationSplit:
    """Host seconds of each codec call a migration makes, timed around the
    calls (the package is not touched): ``gather`` (the chain's device
    gather and host copy, after the work queued on the stream), ``export``
    (the rest of ``export_chain``: crc32 per page, digest, join),
    ``verify`` (import crc32 + digest), ``scatter`` (the page upload and
    in-place writes, queued) and ``admit`` (``admit_migrated``). Also
    notes whether each exported header carries int8 scales."""

    def __init__(self, codec, disagg, engine_cls):
        self.t = collections.defaultdict(list)
        self.scales = []
        self._undo = []

        def timed(name, fn):
            def run(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    self.t[name].append(time.perf_counter() - t0)
            return run

        export = codec.export_chain

        def export_timed(engine, rid):
            g0 = sum(self.t["gather"])
            t0 = time.perf_counter()
            art = export(engine, rid)
            self.t["export"].append(time.perf_counter() - t0
                                    - (sum(self.t["gather"]) - g0))
            self.scales.append("kv_scales" in codec.peek(art))
            return art

        for owner, name, key in (
                (disagg, "gather_chain_pages", "gather"),
                (disagg, "scatter_chain_pages", "scatter"),
                (codec, "_verify", "verify"),
                (engine_cls, "admit_migrated", "admit")):
            self._patch(owner, name, timed(key, getattr(owner, name)))
        self._patch(codec, "export_chain", export_timed)

    def _patch(self, owner, name, fn):
        self._undo.append((owner, name, getattr(owner, name),
                           name in vars(owner)))
        setattr(owner, name, fn)

    def restore(self):
        for owner, name, old, own in reversed(self._undo):
            if own:
                setattr(owner, name, old)
            else:
                delattr(owner, name)

    def line(self):
        return " ".join(f"{k}={1e3 * sum(v) / max(1, len(v)):.3f}"
                        for k, v in self.t.items())


def _terminal_counts(RequestJournal, fleet_dir):
    """rid -> number of fin records that did not fail, over every journal
    of a fleet directory."""
    fins = collections.Counter()
    for name in os.listdir(fleet_dir):
        for rec in RequestJournal.load(os.path.join(fleet_dir, name)):
            if rec["k"] == "fin" and not rec["failed"]:
                fins[rec["rid"]] += 1
    return fins


def phase_disagg(torch, np, ops, card, model, ref, single_tok_s):
    """bench.py bench_disagg's tiers at the SERVE_CONFIG widths (the
    module docstring's phase 25): (a) the clean tiered wave, (b) int8
    chains with spec decode on the decode tier, (c) a corrupt transfer
    and a decode-replica kill. ``ref`` and ``single_tok_s`` are phase 23's
    clean streams and tokens/s. Returns K4's launches (fp pools, int8
    pools)."""
    from paddle_tpu_torch.distributed.resilience import FaultPlan, FaultSpec
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            KVChainCodec, PrefixCacheConfig,
                                            Request, RequestJournal,
                                            TieredRouter, disagg)
    from paddle_tpu_torch.inference.serving import SpecConfig

    cfg = model.config
    L = cfg.num_hidden_layers
    vocab = cfg.vocab_size

    def build():
        return ContinuousBatchingEngine(
            model, device=DEVICE,
            prefix_cache=PrefixCacheConfig(extra_blocks=FUSED_EXTRA_BLOCKS),
            **FUSED_ENGINE)

    def build_spec():
        return ContinuousBatchingEngine(
            model, device=DEVICE,
            prefix_cache=PrefixCacheConfig(extra_blocks=SPEC_EXTRA_BLOCKS),
            speculative=SpecConfig(k=SPEC_K), kv_cache="int8",
            **SPEC_ENGINE)

    def router(name, build_fn, num_decode=1, codec=None):
        d = _scratch_dir(f"disagg_{name}")
        tiered = TieredRouter(build_fn, build_fn, d, num_prefill=1,
                              num_decode=num_decode, codec=codec)
        for rep in tiered.replicas:
            _warm_up_engine(rep.sup.engine, Request, np, vocab)
        return tiered, d

    def run(tiered, reqs):
        for r in reqs:
            tiered.submit(r)
        while tiered.has_work():
            tiered.step()
        tiered.finished()
        sync()

    prompts, kws = _recovery_wave(np, vocab)
    useful = sum(len(o) for o in ref)
    page_bytes = (cfg.num_key_value_heads * FUSED_ENGINE["page_size"]
                  * cfg.head_dim * next(model.parameters()).element_size())
    fails = []
    gc.collect()
    sync()
    mem0 = torch.cuda.memory_allocated()
    _zero_serving_counts(ops)

    # (a) the clean tiered wave
    codec = KVChainCodec()
    tiered, d = router("clean", build, codec=codec)
    pre, dec = (rep.sup.engine for rep in tiered.replicas)
    _reset_stats(pre)
    _reset_stats(dec)
    split = _MigrationSplit(codec, disagg, ContinuousBatchingEngine)
    k4_0 = ops.paged_decode_attention.launches
    reqs = [Request(p, **kw) for p, kw in zip(prompts, kws)]
    try:
        t0 = time.perf_counter()
        run(tiered, reqs)
        tier_s = time.perf_counter() - t0
    finally:
        split.restore()
    k4_wave = ops.paged_decode_attention.launches - k4_0
    st = dict(tiered.stats)
    samples = sorted(tiered.migration_samples)
    recs = RequestJournal.load(tiered.replicas[0].journal_path)
    in_place = sum(r["k"] == "fin" for r in recs)
    migr_kv = sum(r["k"] == "migr-kv" for r in recs)
    n = max(1, st["migrations"])
    payload = st["migration_pages"] * L * 2 * page_bytes
    first_chain = L * 2 * (FUSED_PROMPT // FUSED_ENGINE["page_size"]) \
        * page_bytes
    replays = (pre.stats["graph_replays"], dec.stats["graph_replays"])
    tier_tok_s = useful / tier_s
    p99 = samples[min(len(samples) - 1, int(0.99 * len(samples)))] \
        if samples else 0.0
    print(f"disagg clean [{card}]: tiered_tokens_per_s={tier_tok_s:.1f} "
          f"({useful} tokens in {tier_s:.3f}s, 1 prefill + 1 decode "
          f"replica) single_supervisor_tokens_per_s={single_tok_s:.1f} "
          f"vs_baseline={tier_tok_s / single_tok_s:.3f}; migrations="
          f"{st['migrations']} finished_in_place={in_place} "
          f"deferred={st['migration_deferred']} refused="
          f"{st['migration_refused']} corrupt={st['migration_corrupt']}; "
          f"migration_s mean={1e3 * st['migration_s'] / n:.3f} ms "
          f"p99={1e3 * p99:.3f} ms; chain bytes per migration "
          f"{st['migration_bytes'] / n / 2**20:.3f} MiB, pages "
          f"{st['migration_pages'] / n:.3f} (a 64-token prompt's "
          f"first-token chain: {first_chain / 2**20:.3f} MiB); host ms per "
          f"migration: {split.line()}; graph_replays prefill/decode "
          f"{replays}, K4 launches {k4_wave}", flush=True)
    _check_streams("disagg clean", reqs, ref)
    header = st["migration_bytes"] - payload
    if (st["migrations"] + in_place != len(reqs)
            or migr_kv != st["migrations"] or st["migration_corrupt"]
            or st["migration_reprefill"] or st["migrations"] == 0
            or not 0 < header < 16384 * n
            or pre.stats["graph_captures"] != 1
            or dec.stats["graph_captures"] != 1 or replays[1] == 0
            or k4_wave < sum(replays) * L
            or any(split.scales)):
        fails.append(f"clean: {st}, in place {in_place}, migr-kv "
                     f"{migr_kv}, header bytes {header}, replays {replays}, "
                     f"K4 {k4_wave}")
    tiered.close()
    del tiered, pre, dec, reqs
    gc.collect()
    sync()
    mem1 = torch.cuda.memory_allocated()
    print(f"disagg memory [{card}]: memory_allocated {mem0 / 2**20:.1f} MiB "
          f"before the phase, {mem1 / 2**20:.1f} MiB after the clean wave "
          f"with the router closed", flush=True)
    if mem1 > mem0 + RECOVERY_MEM_SLACK:
        fails.append(f"memory {mem0} -> {mem1}")

    # (b) int8 chains, spec decode on the decode tier
    rng = np.random.default_rng(0)
    prompts_b = [np.tile(rng.integers(0, vocab, (SPEC_MOTIF,)).astype(
        np.int32), SPEC_REPS) for _ in range(2 * SPEC_ENGINE["max_batch"])]
    news_b = [(i % 4 + 1) * DISAGG_SPEC_MAX_NEW
              for i in range(len(prompts_b))]
    single = build_spec()
    _warm_up_engine(single, Request, np, vocab)
    _reset_stats(single)
    k8_0 = ops.paged_decode_attention.int8_launches
    ref_b = [list(r.output) for r in
             _serve_wave(single, Request, prompts_b, news_b)[0]]
    codec = KVChainCodec()
    tiered, d = router("spec_int8", build_spec, DISAGG_SPEC_DECODE, codec)
    for rep in tiered.replicas:
        _reset_stats(rep.sup.engine)
    split = _MigrationSplit(codec, disagg, ContinuousBatchingEngine)
    reqs = [Request(p, max_new_tokens=k) for p, k in zip(prompts_b, news_b)]
    try:
        run(tiered, reqs)
    finally:
        split.restore()
    k8 = ops.paged_decode_attention.int8_launches - k8_0
    keys = ("spec_steps", "spec_proposed", "spec_accepted", "decode_steps")
    tier_spec = {k: sum(rep.sup.engine.stats[k] for rep in tiered.replicas)
                 for k in keys}
    st = tiered.stats
    one = {k: single.stats[k] for k in keys}
    rates = [d["spec_accepted"] / max(1, d["spec_proposed"])
             for d in (tier_spec, one)]
    print(f"disagg spec int8 [{card}]: {len(reqs)} requests, "
          f"{st['migrations']} migrations (1 prefill + {DISAGG_SPEC_DECODE} "
          f"decode replicas), every header with kv_scales: "
          f"{bool(split.scales) and all(split.scales)}; tiered {tier_spec} "
          f"against one engine {one}; acceptance tiered {rates[0]:.4f} "
          f"single {rates[1]:.4f}; K4 int8 launches {k8}", flush=True)
    _check_streams("disagg spec int8", reqs, ref_b)
    if (st["migrations"] == 0 or not split.scales or not all(split.scales)
            or st["migration_corrupt"] or tier_spec["spec_steps"] == 0
            or k8 == 0):
        fails.append(f"spec int8: {st}, scales {split.scales}")
    tiered.close()
    del tiered, single, reqs

    # (c) faults on the wave's first requests
    nf = DISAGG_FAULT_REQUESTS
    ref_c = ref[:nf]
    tiered, d = router("bitflip", build)
    plan = FaultPlan(seed=7, specs=[FaultSpec(
        "serving.kv_transfer", "bitflip", at=DISAGG_BITFLIP_AT)])
    reqs = [Request(p, **kw) for p, kw in zip(prompts[:nf], kws[:nf])]
    with plan:
        run(tiered, reqs)
    st = tiered.stats
    codes = [c for c, _ in tiered.events]
    print(f"disagg bitflip [{card}]: fired {plan.fired()}, events "
          f"PT-SRV-007 x{codes.count('PT-SRV-007')}, migrations="
          f"{st['migrations']} corrupt={st['migration_corrupt']} "
          f"reprefill={st['migration_reprefill']}", flush=True)
    _check_streams("disagg bitflip", reqs, ref_c)
    fins = _terminal_counts(RequestJournal, d)
    if (plan.fired() != {"serving.kv_transfer": 1}
            or "PT-SRV-007" not in codes or st["migration_reprefill"] < 1
            or fins != {r.rid: 1 for r in reqs}):
        fails.append(f"bitflip: fired {plan.fired()}, {st}, events "
                     f"{tiered.events[-3:]}")
    tiered.close()
    del tiered

    tiered, d = router("kill", build)
    plan = FaultPlan(seed=7, specs=[FaultSpec(
        "fleet.replica_kill", "kill", at=DISAGG_KILL_AT,
        match="replica:1:")])
    reqs = [Request(p, **kw) for p, kw in zip(prompts[:nf], kws[:nf])]
    with plan:
        run(tiered, reqs)
    st = tiered.stats
    spliced = sum(r["k"] == "admit" for r in
                  RequestJournal.load(tiered.replicas[1].journal_path))
    fins = _terminal_counts(RequestJournal, d)
    print(f"disagg kill [{card}]: fired {plan.fired()}, decode replica "
          f"killed after {spliced} splices; replica_deaths="
          f"{st['replica_deaths']} failover_requests="
          f"{st['failover_requests']} failover_s={st['failover_s']:.4f}; "
          f"rids finished once across the journals: "
          f"{sum(v == 1 for v in fins.values())} of {len(reqs)}", flush=True)
    _check_streams("disagg kill", reqs, ref_c)
    if (plan.fired() != {"fleet.replica_kill": 1}
            or st["replica_deaths"] != 1 or spliced < DISAGG_KILL_AFTER
            or "PT-FLT-001" not in [c for c, _ in tiered.events]
            or fins != {r.rid: 1 for r in reqs}):
        fails.append(f"kill: fired {plan.fired()}, {st}, spliced {spliced}")
    tiered.close()
    del tiered
    if fails:
        raise AssertionError("disagg: " + "; ".join(fails))
    c = _serving_counts(ops)
    k8 = ops.paged_decode_attention.int8_launches
    return c["k4"] - k8, k8


def burst_workload(O, seed, vocab):
    """bench.py's TPU burst WorkloadConfig (bench_slo_burst, bench_disagg)
    with ``seed``."""
    return O.WorkloadConfig(
        seed=seed, duration_s=6.0, rate_rps=6.0, arrival="burst",
        burst_every_s=3.0, burst_len_s=1.0, burst_multiplier=4.0,
        vocab_size=vocab, prompt_min=16, prompt_max=48, output_min=8,
        output_max=32,
        tenants=(O.TenantSpec("chat", 2.0, prefix_len=16),
                 O.TenantSpec("batch", 1.0, priority=2)))


def observatory_workload(O):
    """tools/traffic_replay.py's selftest workload (_selftest_workload)."""
    return O.WorkloadConfig(
        seed=17, duration_s=10.0, rate_rps=5.0, arrival="burst",
        burst_every_s=4.0, burst_len_s=2.0, burst_multiplier=8.0,
        vocab_size=64, prompt_mu=2.2, prompt_sigma=0.4, prompt_min=4,
        prompt_max=16, output_mu=1.8, output_sigma=0.4, output_min=4,
        output_max=12,
        tenants=(O.TenantSpec("chat", weight=2.0, prefix_len=8),
                 O.TenantSpec("batch", weight=1.0, prefix_len=0,
                              priority=2)))


class _EngineClock:
    """Stands in for the serving module's ``time`` with ``monotonic`` read
    from ``clock`` (the engine's enqueue and admission stamps, hence the
    queue waits, in the replay's virtual seconds)."""

    def __init__(self, clock):
        self._clock = clock

    def monotonic(self):
        return self._clock()

    def __getattr__(self, name):
        return getattr(time, name)


def observatory_replay(model, fleet_dir, autoscale_on, device=None):
    """tools/traffic_replay.py ``run_replay`` on the port: the seeded
    burst schedule replayed open-loop on a VirtualClock into a 1-replica
    FleetRouter of 2-slot prefix-cache engines over ``model``, the SLO
    monitor's windows rolled and the autoscaler ticked at each boundary
    (off: the control arm). The engines' queue-wait clock is the virtual
    one too, and request ids start at 1 (the router breaks load ties by
    rid), as in the fresh process tools/traffic_replay.py runs in, so the
    report is a function of the scheduling alone. Returns the report
    dict."""
    from paddle_tpu_torch import observability as O
    from paddle_tpu_torch.inference import serving
    from paddle_tpu_torch.inference.autoscale import (AutoscaleConfig,
                                                      SLOAutoscaler)
    from paddle_tpu_torch.inference.fleet import FleetConfig, FleetRouter

    device = DEVICE if device is None else device

    def build():
        return serving.ContinuousBatchingEngine(model, device=device,
                                                **OBSERVATORY_ENGINE)

    clock = O.VirtualClock()
    tracer = O.TraceRecorder(clock=clock)
    monitor = O.SLOMonitor(O.SLOConfig(**OBSERVATORY_SLO), tracer=tracer)
    saved, saved_rid = serving._time, serving.Request._counter[0]
    serving._time = _EngineClock(clock)
    serving.Request._counter[0] = 0
    try:
        fleet = FleetRouter(build, fleet_dir, num_replicas=1, tracer=tracer,
                            config=FleetConfig(brownout_depth=10 ** 9))
        try:
            scaler = SLOAutoscaler(fleet, monitor,
                                   AutoscaleConfig(**OBSERVATORY_SCALER),
                                   tracer=tracer, enabled=autoscale_on)
            driver = O.ReplayDriver(
                fleet, O.generate_schedule(observatory_workload(O)),
                clock=clock, dt_s=OBSERVATORY_DT_S, monitor=monitor,
                autoscaler=scaler, max_steps=5000)
            return driver.run()
        finally:
            fleet.close()
    finally:
        serving._time = saved
        serving.Request._counter[0] = max(saved_rid,
                                          serving.Request._counter[0])


def _chain_breaks(tracer, rids):
    """rids whose lifecycle lacks OBS_CHAIN in order."""
    bad = []
    for rid in rids:
        names = iter(tracer.lifecycle(rid))
        if not all(step in names for step in OBS_CHAIN):
            bad.append(rid)
    return bad


def _obs_arm(torch, ops, name, card, make, wave):
    """bench_observability's comparison for one engine kind: a bare and a
    traced engine (TraceRecorder into a MetricsRegistry with the engine
    collector and a live MetricsServer), a warm-up wave each, a fresh
    recorder on the traced engine, then OBS_TIMED interleaved waves each,
    the order alternating (best-of). ``wave(eng)`` serves one wave and
    returns its requests.
    Returns (K4 launches in the timed waves, the arm's readings)."""
    from paddle_tpu_torch.observability import (MetricsRegistry,
                                                MetricsServer, TraceRecorder,
                                                engine_collector,
                                                parse_prometheus_text)
    import urllib.request

    registry = MetricsRegistry()
    plain = make(None)
    traced = make(TraceRecorder(registry=registry))
    registry.register_collector(engine_collector(traced))
    server = MetricsServer(registry, port=0)
    try:
        wave(plain)
        wave(traced)
        tracer = TraceRecorder()        # warm waves only
        traced.tracer = tracer
        best = {"bare": float("inf"), "traced": float("inf")}
        diff = rids = 0
        served = []
        ops.paged_decode_attention.launches = 0
        for i in range(OBS_TIMED):
            outs = {}
            # alternate which engine goes first, so the order of the runs
            # does not enter the best-of comparison
            arms = (("bare", plain), ("traced", traced))
            for arm, eng in arms[::-1] if i % 2 else arms:
                sync()
                t0 = time.perf_counter()
                reqs = wave(eng)
                sync()
                best[arm] = min(best[arm], time.perf_counter() - t0)
                outs[arm] = [list(r.output) for r in reqs]
                if arm == "traced":
                    served += [r.rid for r in reqs]
            diff += _differ(outs["bare"], outs["traced"])
            rids += len(outs["bare"])
        k4 = ops.paged_decode_attention.launches
        with urllib.request.urlopen(server.url, timeout=10) as resp:
            scrape = resp.read().decode("utf-8")
        families = len(parse_prometheus_text(scrape))
    finally:
        server.close()
    slo = tracer.slo_summary()
    pct = (best["traced"] - best["bare"]) / best["bare"] * 100.0
    breaks = _chain_breaks(tracer, served)
    read = dict(p50=slo["p50_time_to_first_token_ms"],
                p99=slo["p99_time_to_first_token_ms"], pct=pct,
                families=families, events=len(tracer.events),
                dropped=tracer.dropped, plain=plain, traced=traced)
    print(f"observability {name} [{card}]: p50_ttft_ms={read['p50']} "
          f"p99_ttft_ms={read['p99']} observability_overhead_pct={pct:.2f} "
          f"(best-of-{OBS_TIMED} wave bare {best['bare']:.4f}s traced "
          f"{best['traced']:.4f}s); scrape {families} families, "
          f"{len(tracer.events)} trace events over {slo['submitted']} warm "
          f"requests, dropped {tracer.dropped}; streams differing traced vs "
          f"bare {diff} of {rids}; K4 launches {k4}", flush=True)
    fails = []
    if diff:
        fails.append(f"{diff} traced streams differ from the bare ones")
    if breaks:
        fails.append(f"rids {breaks[:8]} lack {OBS_CHAIN} in order")
    if tracer.dropped or tracer.incomplete():
        fails.append(f"dropped {tracer.dropped}, incomplete "
                     f"{tracer.incomplete()[:8]}")
    if not families:
        fails.append("the /metrics scrape carried no family")
    if fails:
        raise AssertionError(f"observability {name}: " + "; ".join(fails))
    return k4, read


def phase_observability(torch, np, ops, card, model):
    """bench.py bench_observability on the SERVE_CONFIG model: (a) bench's
    4-slot prefix-cache engine and 12-request wave, (b) phase 7's fused
    128-slot engine and 256-request wave (every decode block a graph
    replay). Returns K4's launches in the timed waves."""
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            PrefixCacheConfig, Request)

    vocab = model.config.vocab_size
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, (OBS_PROMPT,)).astype(np.int32)
               for _ in range(OBS_REQUESTS)]

    def small(tracer):
        return ContinuousBatchingEngine(model, device=DEVICE,
                                        prefix_cache=True, tracer=tracer,
                                        **OBS_ENGINE)

    def small_wave(eng):
        reqs = [Request(p, max_new_tokens=OBS_MAX_NEW, seed=OBS_SEED0 + i)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.add_request(r)
        eng.run_until_done(max_steps=20000)
        return reqs

    k4_a, read = _obs_arm(torch, ops, "(a) 4 slots", card, small,
                          small_wave)
    if read["plain"]._fused:
        raise AssertionError("bench's 4-slot engine must not be fused")
    del read

    fused_prompts, news = _fused_wave(np, vocab)

    def fused(tracer):
        return ContinuousBatchingEngine(
            model, device=DEVICE, tracer=tracer,
            prefix_cache=PrefixCacheConfig(extra_blocks=FUSED_EXTRA_BLOCKS),
            **FUSED_ENGINE)

    def fused_wave(eng):
        reqs = [Request(p, max_new_tokens=k)
                for p, k in zip(fused_prompts, news)]
        for r in reqs:
            eng.add_request(r)
        eng.run_until_done(max_steps=40000)
        return reqs

    k4_b, read = _obs_arm(torch, ops,
                          f"(b) fused {FUSED_ENGINE['max_batch']} slots",
                          card, fused, fused_wave)
    plain, traced = read["plain"], read["traced"]
    syncs = {arm: len(_sync_count(torch, lambda e=eng: fused_wave(e)))
             for arm, eng in (("bare", plain), ("traced", traced))}
    st = {arm: (eng.stats["graph_captures"], eng.stats["eager_decode_steps"],
                eng.stats["graph_replays"])
          for arm, eng in (("bare", plain), ("traced", traced))}
    print(f"observability (b) graph and syncs [{card}]: (graph_captures, "
          f"eager_decode_steps, graph_replays) {st}; synchronizing "
          f"operations in one wave: bare {syncs['bare']}, traced "
          f"{syncs['traced']}", flush=True)
    if (st["bare"][0] != 1 or st["traced"][0] != 1
            or st["bare"][1] != st["traced"][1]
            or syncs["traced"] > syncs["bare"]):
        raise AssertionError(f"observability (b): tracing changed the "
                             f"captured path: {st}, syncs {syncs}")
    del plain, traced, read
    gc.collect()
    return k4_a + k4_b


def _fresh_recorder(target, O):
    """bench's warm-only discipline: a fresh recorder on the router and
    every replica's supervisor and engine (no recapture needed)."""
    tracer = O.TraceRecorder()
    target.tracer = tracer
    for rep in target.replicas:
        rep.sup.tracer = tracer
        rep.sup._attach_tracer()
    return tracer


def _warm_router(target, Request, np, vocab, wl, seed0):
    """bench's closed-loop warm wave: 2 x slots prompts of prompt_min
    tokens (seed 0), max_new_tokens output_max."""
    rng = np.random.default_rng(0)
    for i in range(2 * OBS_ENGINE["max_batch"]):
        target.submit(Request(rng.integers(0, vocab, (wl.prompt_min,))
                              .astype(np.int32),
                              max_new_tokens=wl.output_max, seed=seed0 + i))
    target.run_until_done(max_steps=20000)


def _closed_loop_ref(build, Request, schedule):
    """Every arrival of ``schedule`` served closed-loop by one engine:
    {seed: stream}."""
    eng = build()
    reqs = [Request(a.prompt, max_new_tokens=a.max_new, seed=a.seed,
                    priority=a.priority, tenant=a.tenant) for a in schedule]
    for r in reqs:
        eng.add_request(r)
    eng.run_until_done(max_steps=200000)
    return {r.seed: list(r.output) for r in reqs}


def _check_replay(what, driver, ref, arrivals):
    st = driver.stats
    bad = [r.seed for r in driver.requests if list(r.output) != ref[r.seed]]
    failed = [r.rid for r in driver.requests if r.failed or not r.done]
    if (bad or failed or st["submitted"] + st["refused"] != arrivals):
        raise AssertionError(
            f"{what}: {len(bad)} of {len(driver.requests)} streams differ "
            f"from the closed-loop engine (seeds {bad[:6]}), failed or "
            f"unfinished {failed[:6]}, submitted {st['submitted']} + "
            f"refused {st['refused']} != {arrivals} arrivals")


def phase_slo_burst(torch, np, ops, card, model):
    """(a) bench.py bench_slo_burst on the SERVE_CONFIG model: the seeded
    burst replayed wall-clock, open-loop, into a 2-replica FleetRouter of
    bench's 4-slot engine; (b) the observatory (tools/traffic_replay.py
    run_replay) on the card (OBSERVATORY_LAYERS of the model's depth),
    autoscaler off and on, against the same replay of a 1-layer tiny
    model on the CPU. Returns K4's launches in the measured replays."""
    from paddle_tpu_torch import observability as O
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            Request)
    from paddle_tpu_torch.inference.fleet import FleetConfig, FleetRouter
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    vocab = model.config.vocab_size
    wl = burst_workload(O, BURST_SLO_SEED, vocab)
    schedule = O.generate_schedule(wl)

    def build():
        return ContinuousBatchingEngine(model, device=DEVICE,
                                        prefix_cache=True, **OBS_ENGINE)

    fleet = FleetRouter(build, _scratch_dir("slo_burst"), num_replicas=2,
                        config=FleetConfig(brownout_depth=10 ** 9))
    try:
        _warm_router(fleet, Request, np, vocab, wl, 900)
        tracer = _fresh_recorder(fleet, O)
        monitor = O.SLOMonitor(O.SLOConfig(ttft_ms=BURST_TTFT_MS,
                                           window_s=1.0), tracer=tracer)
        driver = O.ReplayDriver(fleet, schedule, monitor=monitor,
                                wall_clock=True, max_steps=200000)
        ops.paged_decode_attention.launches = 0
        sync()
        t0 = time.perf_counter()
        report = driver.run()
        sync()
        wall = time.perf_counter() - t0
        k4 = ops.paged_decode_attention.launches
    finally:
        fleet.close()
    tot = report["slo"]["totals"]
    attain = 100.0 * tot["met"] / tot["finished"] if tot["finished"] else 0.0
    p99 = tracer._h_ttft.quantile(0.99)
    print(f"slo burst (a) [{card}]: serving_slo_attainment_pct={attain:.2f} "
          f"serving_goodput_tokens_per_sec={tot['good_tokens'] / wall:.1f} "
          f"serving_ttft_p99_under_burst_ms={p99} ({len(schedule)} "
          f"arrivals over {wl.duration_s}s, refused "
          f"{report['driver']['refused']}, {report['driver']['steps']} fleet "
          f"steps in {wall:.2f}s wall, {tot['finished']} finished, "
          f"{tot['tokens']} tokens, 2x{OBS_ENGINE['max_batch']} slots); K4 "
          f"launches {k4}", flush=True)
    _check_replay("slo burst (a)", driver,
                  _closed_loop_ref(build, Request, schedule), len(schedule))

    cpu_model = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1),
                                 device="cpu", seed=0)
    obs_model = LlamaForCausalLM(LlamaConfig(**dict(
        SERVE_CONFIG, num_hidden_layers=OBSERVATORY_LAYERS)), device=DEVICE,
        seed=0)
    for on in (False, True):
        arm = "on" if on else "off"
        ops.paged_decode_attention.launches = 0
        t0 = time.perf_counter()
        card_rep = observatory_replay(obs_model, _scratch_dir(f"obs_{arm}"),
                                      on)
        card_s = time.perf_counter() - t0
        k4 += ops.paged_decode_attention.launches
        cpu_rep = observatory_replay(cpu_model, _scratch_dir(f"obs_cpu_{arm}"),
                                     on, device="cpu")
        asc = card_rep["autoscaler"]["stats"]
        print(f"slo burst (b) observatory autoscaler {arm} [{card}]: "
              f"driver {card_rep['driver']}, attainment "
              f"{card_rep['slo']['attainment']}, scale_ups "
              f"{asc['scale_ups']} brownouts {asc['brownouts']}, digest "
              f"{card_rep['schedule']['digest']}, {card_s:.2f}s; equal to "
              f"the CPU run: {card_rep == cpu_rep}", flush=True)
        if card_rep != cpu_rep:
            raise AssertionError(f"observatory {arm}: the card's report "
                                 "differs from the CPU run's")
    return k4


def phase_disagg_burst(torch, np, ops, card, model):
    """bench.py bench_disagg's A/B on the SERVE_CONFIG model: the seed-29
    burst replayed wall-clock into a unified 2-replica FleetRouter, then a
    TieredRouter of 1 prefill + 1 decode replica, both of bench's 4-slot
    engine with extra_blocks = slots. Returns K4's launches in the
    measured replays."""
    from paddle_tpu_torch import observability as O
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            PrefixCacheConfig, Request,
                                            TieredRouter)
    from paddle_tpu_torch.inference.fleet import FleetConfig, FleetRouter

    vocab = model.config.vocab_size
    wl = burst_workload(O, BURST_DISAGG_SEED, vocab)
    schedule = O.generate_schedule(wl)
    slots = OBS_ENGINE["max_batch"]

    def build():
        return ContinuousBatchingEngine(
            model, device=DEVICE,
            prefix_cache=PrefixCacheConfig(extra_blocks=slots),
            **OBS_ENGINE)

    keys = ("migrations", "migration_s", "migration_pages",
            "migration_bytes", "migration_deferred", "migration_refused",
            "migration_reprefill")
    gc.collect()
    sync()
    mem0 = torch.cuda.memory_allocated() if DEVICE == "cuda" else 0
    ref = _closed_loop_ref(build, Request, schedule)
    k4 = 0
    out = {}
    for arm in ("unified", "tiered"):
        d = _scratch_dir(f"disagg_burst_{arm}")
        cfg = FleetConfig(brownout_depth=10 ** 9)
        target = (FleetRouter(build, d, num_replicas=2, config=cfg)
                  if arm == "unified" else
                  TieredRouter(build, build, d, num_prefill=1, num_decode=1,
                               config=cfg))
        try:
            _warm_router(target, Request, np, vocab, wl, 950)
            tracer = _fresh_recorder(target, O)
            snap = {k: target.stats.get(k, 0) for k in keys}
            driver = O.ReplayDriver(target, schedule, wall_clock=True,
                                    max_steps=200000)
            ops.paged_decode_attention.launches = 0
            t0 = time.perf_counter()
            driver.run()
            sync()
            wall = time.perf_counter() - t0
            k4 += ops.paged_decode_attention.launches
            delta = {k: target.stats.get(k, 0) - snap[k] for k in keys}
        finally:
            target.close()
        _check_replay(f"disagg burst {arm}", driver, ref, len(schedule))
        out[arm] = (tracer, delta, wall, driver.stats)
        del target, driver
    gc.collect()
    sync()
    mem1 = torch.cuda.memory_allocated() if DEVICE == "cuda" else 0
    tr_uni, tr_tier = out["unified"][0], out["tiered"][0]
    delta = out["tiered"][1]
    mig = delta["migrations"]
    h = tr_tier._h_migration
    row = h.snapshot()
    n_h = h.row_count(row)
    print(f"disagg burst [{card}]: {len(schedule)} arrivals; p99 TTFT "
          f"unified {tr_uni._h_ttft.quantile(0.99)} ms vs tiered "
          f"{tr_tier._h_ttft.quantile(0.99)} ms (wall {out['unified'][2]:.2f}"
          f"s / {out['tiered'][2]:.2f}s); {mig} migrations in the measured "
          f"window, mean migration_s "
          f"{delta['migration_s'] / max(1, mig):.6f}, pages "
          f"{delta['migration_pages']}, bytes {delta['migration_bytes']}, "
          f"deferred {delta['migration_deferred']}, refused "
          f"{delta['migration_refused']}, re-prefills "
          f"{delta['migration_reprefill']}; pt_migration_time_ms count "
          f"{n_h} mean {row[-1] / max(1, n_h):.4f} ms beside the router's "
          f"{1e3 * delta['migration_s'] / max(1, mig):.4f} ms; "
          f"memory_allocated {mem0 / 2**20:.1f} -> {mem1 / 2**20:.1f} MiB; "
          f"K4 launches {k4}", flush=True)
    if tr_tier._c_migrations.value() != mig or n_h != mig or not mig:
        raise AssertionError(
            f"disagg burst: the recorder counted "
            f"{tr_tier._c_migrations.value()} migrations ({n_h} timed), "
            f"the router {mig}")
    if mem1 - mem0 > RECOVERY_MEM_SLACK:
        raise AssertionError(f"disagg burst: memory grew {mem0} -> {mem1}")
    return k4


# ---- phase 29: the process fleet ------------------------------------------

def _proc_config(factory_kwargs, op_timeout_s=PROC_OP_S, **extra):
    """A process fleet whose CUDA workers build ``llama_engine`` on the
    SERVE_CONFIG model from seed 0 with ``factory_kwargs``' geometry."""
    from paddle_tpu_torch.inference.procfleet import ProcFleetConfig

    return ProcFleetConfig(
        factory=f"{PROC_PRESETS}:llama_engine",
        factory_kwargs=dict(config=dict(SERVE_CONFIG), seed=0,
                            device=DEVICE, **factory_kwargs),
        spawn_timeout_s=PROC_SPAWN_S, op_timeout_s=op_timeout_s, **extra)


def _pid_gone(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


def _samples(fams, name):
    """``{replica label: value}`` of a family's samples."""
    return {s[1].get("replica"): s[2] for s in fams[name].samples}


def _wire_ms(nbytes):
    """Host ms of one frame of ``nbytes`` blob over a localhost TCP
    connection: encode (crc32), send, receive and decode (crc32 again),
    best of 3."""
    import socket
    import threading

    from paddle_tpu_torch.inference.procfleet import Message, wire

    lst = socket.create_server(("127.0.0.1", 0))
    a = socket.create_connection(lst.getsockname())
    b, _ = lst.accept()
    lst.close()
    msg = Message("CHAIN", {"rid": 0, "digest": "0", "pages": 0,
                            "updates": []}, blob=bytes(nbytes))
    best = float("inf")
    try:
        for _ in range(3):
            t0 = time.perf_counter()
            th = threading.Thread(target=wire.send_msg, args=(a, msg))
            th.start()
            wire.recv_msg(b, timeout=30.0)
            th.join()
            best = min(best, time.perf_counter() - t0)
    finally:
        a.close()
        b.close()
    return best * 1e3


def phase_procfleet(torch, np, ops, card, model, ref):
    """The process fleet at the SERVE_CONFIG widths (the module
    docstring's phase 29): (a) bench_fleet's process arm, 1 then 2 worker
    processes; (e) the remote scrape; (b) the fleet_proc_kill drill and
    its no-failover arm; (c) 1 + 1 tiers over TCP; (d) migration under
    seeded wire loss over loopback workers. ``ref`` is phase 23's clean
    streams. Returns (K1, K4) launches made in this process: (a)'s
    in-process reference wave and (d)'s loopback workers."""
    from paddle_tpu_torch.distributed.resilience import FaultPlan, FaultSpec
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            FleetConfig, Request,
                                            RequestJournal)
    from paddle_tpu_torch.inference.procfleet import (ProcFleetRouter,
                                                      ProcTieredRouter)
    from paddle_tpu_torch.observability import (MetricsRegistry,
                                                parse_prometheus_text,
                                                procfleet_collector)
    from paddle_tpu_torch.ops import _build

    cfg = model.config
    L = cfg.num_hidden_layers
    vocab = cfg.vocab_size
    built = {p.name: p.stat().st_mtime_ns
             for p in _build.BUILD_DIR.glob("*.so")}
    pids = []

    def run(router, reqs):
        for r in reqs:
            router.submit(r)
        router.run_until_done(max_steps=200000)
        router.finished()
        return reqs

    # the in-process reference: phase 6's wave through one legacy engine
    warm_l, prompts_l, kws_l, _ = _legacy_wave(np, vocab)

    def wave():
        return [Request(p, **kw) for p, kw in zip(prompts_l, kws_l)]

    _zero_serving_counts(ops)
    eng = ContinuousBatchingEngine(model, device=DEVICE, **ENGINE)
    for p in warm_l:
        eng.add_request(Request(p, max_new_tokens=4))
    eng.run_until_done()
    best = float("inf")
    for _ in range(PROC_TIMED):
        reqs = wave()
        t0 = time.perf_counter()
        for r in reqs:
            eng.add_request(r)
        eng.run_until_done()
        sync()
        best = min(best, time.perf_counter() - t0)
    ref_l = [list(r.output) for r in reqs]
    useful = sum(len(o) for o in ref_l)
    engine_tok_s = useful / best
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # (a) 1 then 2 worker processes, bench_fleet's process arm
    fleet_dir = _scratch_dir("procfleet")
    fleet = None
    try:
        sync()
        free0 = torch.cuda.mem_get_info()[0]
        t0 = time.perf_counter()
        fleet = ProcFleetRouter(_proc_config(ENGINE), fleet_dir,
                                num_replicas=1,
                                config=FleetConfig(brownout_depth=10 ** 9))
        spawn_s = [time.perf_counter() - t0]
        pids.append(fleet.replicas[0].sup.worker_pid)
        free = [free0, torch.cuda.mem_get_info()[0]]
        tok_s = {}
        for n in (1, 2):
            if n == 2:
                t0 = time.perf_counter()
                fleet.add_replica()
                spawn_s.append(time.perf_counter() - t0)
                pids.append(fleet.replicas[1].sup.worker_pid)
                free.append(torch.cuda.mem_get_info()[0])
                fleet.config.parallel_step = True
            run(fleet, [Request(p, max_new_tokens=4) for p in warm_l])
            _check_streams(f"procfleet {n} warm", run(fleet, wave()), ref_l)
            best = float("inf")
            for _ in range(PROC_TIMED):
                reqs = wave()
                t0 = time.perf_counter()
                run(fleet, reqs)
                best = min(best, time.perf_counter() - t0)
                _check_streams(f"procfleet {n}", reqs, ref_l)
            tok_s[n] = useful / best
        spread = dict(collections.Counter(fleet._assigned[r.rid]
                                          for r in reqs))
        mem = [(free[i] - free[i + 1]) / 2 ** 20 for i in range(2)]
        print(f"procfleet (a) [{card}]: fleet_proc_tokens_per_sec 1 worker "
              f"{tok_s[1]:.1f}, 2 workers {tok_s[2]:.1f} (ratio "
              f"{tok_s[2] / tok_s[1]:.3f}; both worker processes share this "
              f"one card, so the ratio reads wire overhead and "
              f"time-slicing, not scale-out); the same engine in this "
              f"process {engine_tok_s:.1f} (1 worker over it "
              f"{tok_s[1] / engine_tok_s:.3f}); {useful} tokens a pass, "
              f"requests per worker {spread}; spawn-to-HELLO "
              f"{[round(x, 3) for x in spawn_s]} s; card memory per worker "
              f"process {[round(m, 1) for m in mem]} MiB (mem_get_info)",
              flush=True)

        # (e) the remote scrape over the live workers
        reg = MetricsRegistry()
        reg.register_collector(procfleet_collector(fleet))
        fams = parse_prometheus_text(reg.dump())
        sched = _samples(fams, "pt_engine_scheduled_tokens_total")
        up = _samples(fams, "pt_procfleet_worker_up")
        dec0 = _samples(fams, "pt_engine_decode_steps")
        alive = fams["pt_procfleet_workers_alive"].samples[0][2]
        print(f"procfleet (e) [{card}]: workers_alive={alive} worker_up="
              f"{up} scheduled_tokens={sched} decode_steps={dec0} (worker "
              f"K4 launches >= decode_steps x {L}: "
              f"{sum(dec0.values()) * L:.0f}) scrape_errors="
              f"{fams['pt_procfleet_scrape_errors'].samples[0][2]}",
              flush=True)
        if (alive != 2 or up != {"0": 1.0, "1": 1.0}
                or set(sched) != {"0", "1"}
                or min(sched.values()) <= 0):
            raise AssertionError(f"procfleet scrape: alive {alive}, up "
                                 f"{up}, scheduled {sched}")

        # (b) the fleet_proc_kill drill on the 2-worker fleet
        fleet.config.parallel_step = False
        pid0 = fleet.replicas[0].sup.worker_pid
        plan = FaultPlan(seed=5, specs=[FaultSpec(
            "fleet.proc_kill", "kill", at=2, count=1, match="replica:0:")])
        reqs = wave()
        with plan:
            run(fleet, reqs)
        fams = parse_prometheus_text(reg.dump())
        dec1 = _samples(fams, "pt_engine_decode_steps")
        print(f"procfleet (b) [{card}]: fired {plan.fired()}, worker pid "
              f"{pid0} gone {_pid_gone(pid0)}; replica_deaths="
              f"{fleet.stats['replica_deaths']} failover_s="
              f"{fleet.stats['failover_s']:.4f} failover_requests="
              f"{fleet.stats['failover_requests']}; the survivor's decode "
              f"steps {dec0.get('1')} -> {dec1.get('1')}", flush=True)
        _check_streams("procfleet kill", reqs, ref_l)
        if (plan.fired() != {"fleet.proc_kill": 1}
                or fleet.stats["replica_deaths"] != 1
                or not _pid_gone(pid0)
                or not dec1.get("1", 0) > dec0.get("1", 0)):
            raise AssertionError(f"procfleet kill: fired {plan.fired()}, "
                                 f"{fleet.stats}")
        _k4_alive(torch, ops)

        # the control arm: failover off, the killed worker's requests lost
        fleet.restart(0)
        pids.append(fleet.replicas[0].sup.worker_pid)
        fleet.failover = False
        plan = FaultPlan(seed=5, specs=[FaultSpec(
            "fleet.proc_kill", "kill", at=2, count=1, match="replica:0:")])
        reqs = wave()
        with plan:
            run(fleet, reqs)
        lost = [r for r in reqs if r.failed]
        kept = [(list(r.output), want) for r, want in zip(reqs, ref_l)
                if not r.failed]
        print(f"procfleet (b) control [{card}]: failover off, {len(lost)} "
              f"of {len(reqs)} requests lost "
              f"({sorted({(r.error or '')[:10] for r in lost})})",
              flush=True)
        if (not lost or any("PT-FLT-001" not in (r.error or "")
                            for r in lost)
                or any(a != b for a, b in kept)):
            raise AssertionError(f"procfleet control: lost {len(lost)}, "
                                 f"{[r.error for r in lost][:2]}")
    finally:
        if fleet is not None:
            fleet.close()
    fams = parse_prometheus_text(reg.dump())
    if (fams["pt_procfleet_workers_alive"].samples[0][2] != 0
            or fams["pt_procfleet_reaped_total"].samples[0][2]
            != fleet.stats["proc_spawned"]):
        raise AssertionError("procfleet scrape after close: "
                             f"{reg.dump()[:400]}")

    # (c) 1 + 1 tiers over TCP on phase 23's fused engine
    prompts, kws = _recovery_wave(np, vocab)
    idx = list(range(0, len(prompts), PROC_TIER_STRIDE))
    tiered = None
    try:
        t0 = time.perf_counter()
        tiered = ProcTieredRouter(
            *[_proc_config(dict(FUSED_ENGINE, prefix_cache=dict(
                extra_blocks=FUSED_EXTRA_BLOCKS)))] * 2,
            _scratch_dir("proctiers"), num_prefill=1, num_decode=1)
        tier_spawn_s = time.perf_counter() - t0
        pids += [rep.sup.worker_pid for rep in tiered.replicas]
        rng = np.random.default_rng(1)
        run(tiered, [Request(rng.integers(0, vocab, (FUSED_PROMPT,)).astype(
            np.int32), max_new_tokens=4) for _ in range(2)])
        m0 = dict(tiered.stats)
        n0 = len(tiered.migration_samples)
        reqs = [Request(prompts[i], **kws[i]) for i in idx]
        t0 = time.perf_counter()
        run(tiered, reqs)
        tier_s = time.perf_counter() - t0
        samples = tiered.migration_samples[n0:]
        migs = tiered.stats["migrations"] - m0["migrations"]
        nbytes = (tiered.stats["migration_bytes"]
                  - m0["migration_bytes"]) / max(1, migs)
        recs = RequestJournal.load(tiered.replicas[0].journal_path)
    finally:
        if tiered is not None:
            tiered.close()
    _check_streams("procfleet tiers", reqs, [ref[i] for i in idx])
    wire_ms = _wire_ms(int(nbytes))
    mean_ms = 1e3 * float(np.mean(samples)) if samples else 0.0
    p99_ms = 1e3 * float(np.percentile(samples, 99)) if samples else 0.0
    print(f"procfleet (c) [{card}]: 2 fused-engine workers (each with its "
          f"graph capture) spawned in {tier_spawn_s:.3f} s; "
          f"{len(reqs)} requests in {tier_s:.3f} s "
          f"({sum(len(r.output) for r in reqs) / tier_s:.1f} tokens/s), "
          f"{migs} migrations over TCP: migration_s mean {mean_ms:.3f} ms "
          f"p99 {p99_ms:.3f} ms (phase "
          f"25 in-process: 44.146 ms mean, PR 13), chain "
          f"{nbytes / 2 ** 20:.3f} MiB; one frame of that size encoded, "
          f"sent over localhost TCP and decoded {wire_ms:.3f} ms, the "
          f"chain crosses twice: wire "
          f"share {2 * wire_ms / max(mean_ms, 1e-9):.3f}; deferred "
          f"{tiered.stats['migration_deferred']} reprefill "
          f"{tiered.stats['migration_reprefill']}", flush=True)
    if (migs < 1 or not any(r["k"] == "migr-kv" for r in recs)
            or tiered.stats["migration_corrupt"]):
        raise AssertionError(f"procfleet tiers: {tiered.stats}")

    # (d) migration under seeded wire loss, loopback workers
    def loss_cfg():
        return _proc_config(LOSS_ENGINE, op_timeout_s=LOSS_OP_S,
                            transport="loopback", chaos=True, hedge=True,
                            verify_crc=True)

    def loss_wave(seed0):
        rng = np.random.default_rng(47)
        return [Request(rng.integers(0, vocab, (LOSS_PROMPT,)).astype(
            np.int32), max_new_tokens=LOSS_MAX_NEW, seed=seed0 + i)
            for i in range(LOSS_REQUESTS)]

    def loss_arm(plan=None):
        router = None
        try:
            router = ProcTieredRouter(loss_cfg(), loss_cfg(),
                                      _scratch_dir("procloss"),
                                      num_prefill=1, num_decode=2)
            run(router, loss_wave(970))
            n0 = len(router.migration_samples)
            reqs = loss_wave(990)
            if plan is not None:
                plan.install()
            try:
                run(router, reqs)
            finally:
                if plan is not None:
                    plan.uninstall()
            if any(r.failed or not r.done for r in reqs):
                raise AssertionError("migration under loss lost requests")
            return ([list(r.output) for r in reqs],
                    list(router.migration_samples[n0:]), dict(router.stats))
        finally:
            if router is not None:
                router.close()

    k4_0 = ops.paged_decode_attention.launches
    clean, clean_s, _ = loss_arm()
    plan = FaultPlan(seed=7, specs=[
        FaultSpec("net.send", "drop", at=1, count=1, match="MIGRATE_IN"),
        FaultSpec("net.send", "bitflip", at=4, count=1, arg=64,
                  match="MIGRATE_IN")])
    lossy, lossy_s, st = loss_arm(plan)
    k4_loss = ops.paged_decode_attention.launches - k4_0
    print(f"procfleet (d) [{card}]: serving_migration_under_loss_p99_s "
          f"clean {float(np.percentile(clean_s, 99)):.4f} "
          f"({len(clean_s)} migrations), lossy "
          f"{float(np.percentile(lossy_s, 99)):.4f} ({len(lossy_s)}); "
          f"fired {sorted(a for _, _, a in plan.log)}, hedges "
          f"{st['migration_hedges']}, typed refusals "
          f"{st['migration_corrupt']}, re-prefills "
          f"{st['migration_reprefill']}; K4 launches in the loopback "
          f"workers {k4_loss}", flush=True)
    if lossy != clean or plan.fired() != {"net.send": 2} or not lossy_s:
        raise AssertionError(f"migration under loss: {_differ(lossy, clean)}"
                             f" streams differ, fired {plan.fired()}")

    # no worker left, no kernel rebuilt by a worker
    apps = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.split()
    left = [p for p in pids if str(p) in apps or not _pid_gone(p)]
    after = {p.name: p.stat().st_mtime_ns
             for p in _build.BUILD_DIR.glob("*.so")}
    print(f"procfleet [{card}]: {len(pids)} worker processes, none left "
          f"({left}); compute apps on the card now {apps}; kernel "
          f"libraries unchanged by the workers: {after == built}",
          flush=True)
    if left or after != built:
        raise AssertionError(f"procfleet: workers left {left}, libraries "
                             f"{built} -> {after}")
    c = _serving_counts(ops)
    return c["k1"], c["k4"]


def _release(torch):
    gc.collect()
    torch.cuda.empty_cache()


def phase_gpt_train(torch, np, ops, card):
    """GPT training: card-vs-CPU parity at GPT_PARITY_CONFIG, then GPT-3
    6.7B's width cut to GPT_TRAIN_LAYERS layers through Engine(model,
    mesh=None); returns the timed steps' K1-lse, K2 and K3 launches."""
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    pcfg = GPTConfig(**GPT_PARITY_CONFIG)
    rng = np.random.default_rng(30)
    batches = []
    for _ in range(PARITY_STEPS):
        ids = torch.from_numpy(rng.integers(
            0, pcfg.vocab_size, (PARITY_BATCH, PARITY_SEQ)))
        labels = ids.clone()
        labels[:, ::7] = -100
        batches.append((ids, labels))
    _card_cpu_parity(torch, ops, "gpt train",
                     lambda dev: GPTForCausalLM(pcfg, device=dev, seed=30),
                     batches, PARITY_LR)
    _release(torch)

    cfg = GPTConfig(**dict(GPT_CONFIG, num_hidden_layers=GPT_TRAIN_LAYERS))
    eng, batches, r = _timed_train(torch, np, ops, cfg, GPT_BATCH, GPT_SEQ,
                                   GPT_WARMUP, GPT_STEPS,
                                   build=GPTForCausalLM)
    n = _n_params(eng.model)
    L, H, Q = cfg.num_hidden_layers, cfg.num_attention_heads, cfg.head_dim
    # bench.py:101-103: 6N + causal attention 6 L H Q seq FLOPs a token
    fpt = 6.0 * n + 6.0 * L * (H * Q) * GPT_SEQ
    mfu = r["tok_s"] * fpt / PEAK_FLOPS["bfloat16"]
    per_step = [r["per_step"][k] for k in ("k1_lse", "k2", "k3")]
    serving_k1 = r["launches"]["k1"]
    print(f"gpt train [{card}]: tokens_per_s={r['tok_s']:.1f} mfu={mfu:.4f} "
          f"ms_per_step={r['ms']:.2f} peak_mem_gb={r['peak_gb']:.2f} "
          f"({n / 1e6:.1f}M params: GPT-3 6.7B's width at {L} of 32 layers, "
          f"batch {GPT_BATCH} x seq {GPT_SEQ}, {cfg.dtype}, unfused CE, no "
          f"remat); losses {[round(x, 4) for x in r['losses'].tolist()]}; "
          f"launches per step k1_lse/k2/k3={per_step} "
          f"serving_k1={serving_k1}", flush=True)
    if per_step != [L, L, L] or serving_k1 != 0:
        raise AssertionError(f"kernels did not carry the GPT step: per step "
                             f"{per_step} != {[L] * 3} or serving K1 ran "
                             f"{serving_k1} times")
    _check_losses(r["losses"], "GPT")
    syncs = _sync_count(torch, lambda: eng.step(batches[1], batches[1]))
    print(f"gpt step under set_sync_debug_mode: {len(syncs)} synchronizing "
          f"operations", flush=True)
    for msg in syncs[:5]:
        print(f"  {msg[:160]}", flush=True)
    if syncs:
        raise AssertionError(f"the GPT step synchronized {len(syncs)} times")
    _loss_falls(eng, batches[0], "gpt")
    counts = (r["launches"]["k1_lse"], r["launches"]["k2"],
              r["launches"]["k3"])
    del eng, batches
    _release(torch)
    return counts


def phase_gpt_serving(torch, np, ops, card):
    """GPT-3 6.7B at full width and depth through phase 6's legacy engine
    and wave (K1 prefill, K4 decode) and phase 7's fused engine and waves
    (K4 in the captured step); returns K1's and K4's launches."""
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    t0 = time.perf_counter()
    model = GPTForCausalLM(GPTConfig(**GPT_CONFIG), device=DEVICE, seed=0)
    k1, k4 = _serve_legacy(torch, np, ops, card, model, "gpt ", t0)
    _release(torch)
    k4_fused, _ = _serve_fused(torch, np, ops, card, model, "gpt ",
                               time.perf_counter())
    del model
    _release(torch)
    return k1, k4 + k4_fused


def _bert_batches(np, rng, cfg, n, batch, seq, mlm):
    """``n`` (ids, labels) pairs: seqcls labels in [0, num_labels), or MLM
    labels at BERT_MLM_LABELLED of the positions and -100 elsewhere."""
    out = []
    for _ in range(n):
        ids = rng.integers(0, cfg.vocab_size, (batch, seq))
        if mlm:
            labels = np.where(rng.random((batch, seq)) < BERT_MLM_LABELLED,
                              rng.integers(0, cfg.vocab_size, (batch, seq)),
                              -100)
        else:
            labels = rng.integers(0, cfg.num_labels, (batch,))
        out.append((ids.astype(np.int64), labels.astype(np.int64)))
    return out


def _causal_flags(fa):
    """Record the ``causal`` argument of every K1, K2 and K3 launch until
    the returned function restores the launchers."""
    seen, real = [], {}
    for name in ("_launch_forward", "_launch_dq", "_launch_dkv"):
        fn = real[name] = getattr(fa, name)
        at = 3 if name == "_launch_forward" else 6

        def rec(*args, _fn=fn, _at=at, _name=name, **kw):
            seen.append((_name, bool(args[_at])))
            return _fn(*args, **kw)
        setattr(fa, name, rec)

    def restore():
        for name, fn in real.items():
            setattr(fa, name, fn)
        return seen
    return restore


def phase_bert(torch, np, ops, card):
    """BERT fine-tuning: card-vs-CPU parity of both heads, then bench.py
    bench_bert's config and one MLM step at its shape; returns the timed
    steps' K1-lse, K2 and K3 launches (non-causal)."""
    from paddle_tpu_torch.distributed import Engine
    from paddle_tpu_torch.models import (BertConfig, BertForMaskedLM,
                                         BertForSequenceClassification)

    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    pcfg = BertConfig(**BERT_PARITY_CONFIG)
    for name, cls, mlm in (("bert seqcls", BertForSequenceClassification,
                            False), ("bert mlm", BertForMaskedLM, True)):
        batches = [(torch.from_numpy(i), torch.from_numpy(lb))
                   for i, lb in _bert_batches(
                       np, np.random.default_rng(32), pcfg, PARITY_STEPS,
                       PARITY_BATCH, BERT_PARITY_SEQ, mlm)]
        _card_cpu_parity(torch, ops, name,
                         lambda dev, c=cls: c(pcfg, device=dev, seed=32),
                         batches, PARITY_LR, floor=BERT_MOMENT_FLOOR)
    _release(torch)

    cfg = BertConfig(**BERT_CONFIG)
    L = cfg.num_hidden_layers
    rows = {}
    for name, cls, mlm, steps in (
            ("seqcls", BertForSequenceClassification, False, BERT_STEPS),
            ("mlm", BertForMaskedLM, True, 1)):
        torch.cuda.reset_peak_memory_stats()
        model = cls(cfg, device=DEVICE, seed=0)
        eng = Engine(model, mesh=None, lr=BERT_LR, clip_norm=1.0,
                     loss_fn=model.loss_fn)
        batches = [(torch.from_numpy(i).to(DEVICE),
                    torch.from_numpy(lb).to(DEVICE))
                   for i, lb in _bert_batches(
                       np, np.random.default_rng(0), cfg,
                       BERT_WARMUP + steps, BERT_BATCH, BERT_SEQ, mlm)]
        losses = [eng.step(*b) for b in batches[:BERT_WARMUP]]
        sync()
        _reset_counts(ops)
        t0 = time.perf_counter()
        for b in batches[BERT_WARMUP:]:
            losses.append(eng.step(*b))
        losses[-1].item()
        wall = time.perf_counter() - t0
        counts = _read_counts(ops)
        # one more step: its launches' causal flags, and the operations
        # that synchronize with the host (none may)
        restore = _causal_flags(fa)
        try:
            syncs = _sync_count(torch, lambda: eng.step(*batches[-1]))
        finally:
            flags = restore()
        n = _n_params(model)
        tok_s = BERT_BATCH * BERT_SEQ * steps / wall
        # 6N + non-causal attention 12 L h seq FLOPs a token
        fpt = 6.0 * n + 12.0 * L * cfg.hidden_size * BERT_SEQ
        mfu = tok_s * fpt / PEAK_FLOPS["bfloat16"]
        per_step = [counts[k] / steps for k in ("k1_lse", "k2", "k3")]
        vals = torch.stack(losses).float().cpu()
        print(f"bert {name} [{card}]: tokens_per_s={tok_s:.1f} mfu={mfu:.4f} "
              f"ms_per_step={wall / steps * 1e3:.2f} peak_mem_gb="
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} ({n / 1e6:.1f}M "
              f"params, batch {BERT_BATCH} x seq {BERT_SEQ}, {cfg.dtype}, "
              f"lr {BERT_LR}, {steps} timed steps); losses "
              f"{[round(x, 4) for x in vals.tolist()]}; launches per step "
              f"k1_lse/k2/k3={per_step} serving_k1={counts['k1']}; causal "
              f"flags of a step's launches: "
              f"{sorted(collections.Counter(flags).items())}; "
              f"synchronizing operations in a step: {len(syncs)}",
              flush=True)
        for msg in syncs[:5]:
            print(f"  {msg[:160]}", flush=True)
        if (per_step != [L, L, L] or counts["k1"] != 0
                or len(flags) != 3 * L or any(c for _, c in flags)):
            raise AssertionError(f"bert {name}: the non-causal kernels did "
                                 f"not carry the step: {per_step}, "
                                 f"{counts}, {flags}")
        if not bool(vals.isfinite().all()):
            raise AssertionError(f"bert {name}: non-finite loss {vals}")
        if syncs:
            raise AssertionError(f"the BERT {name} step synchronized "
                                 f"{len(syncs)} times")
        rows[name] = (counts["k1_lse"], counts["k2"], counts["k3"])
        READINGS[f"bert {name}"] = (wall / steps * 1e3, tok_s)
        del eng, model, batches
        _release(torch)
    return tuple(a + b for a, b in zip(rows["seqcls"], rows["mlm"]))


def _no_kernel_ran(ops, what):
    """The vision path runs none of K1-K6, as the JAX package runs no
    Pallas kernel there."""
    counts = _read_counts(ops)
    if any(counts.values()):
        raise AssertionError(f"{what}: kernels launched {counts}")
    return counts


def _rel_err(a, b):
    """max |a - b| over max(1, max |b|), b the CPU reference."""
    b = b.detach().float().cpu()
    return ((a.detach().float().cpu() - b).abs().max()
            / b.abs().max().clamp_min(1.0)).item()


def _copy_state(torch, dst, src):
    """``src``'s parameters and buffers into ``dst`` (any devices)."""
    with torch.no_grad():
        ref = src.state_dict()
        for k, v in dst.state_dict().items():
            v.copy_(ref[k])


def sgd_bench_step(torch, model, loss_of, lr=BENCH_SGD_LR):
    """bench.py's ViT and UNet step (:1711-1716, :1661-1664): the loss's
    gradients with respect to every parameter, then ``p - lr * g`` (in the
    parameter's dtype); returns the loss tensor (not read)."""
    params = list(model.parameters())
    loss = loss_of()
    grads = torch.autograd.grad(loss, params)
    with torch.no_grad():
        for p, g in zip(params, grads):
            p.sub_(lr * g.to(p.dtype))
    return loss.detach()


def vit_bench_inputs(torch, np, cfg, batch, device):
    """bench_vit's images (in the model's dtype) and labels on
    ``device``."""
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.standard_normal(
        (batch, cfg.in_channels, cfg.image_size, cfg.image_size)))
    labels = torch.from_numpy(rng.integers(0, cfg.num_classes, batch))
    from paddle_tpu_torch import resolve_dtype
    return (imgs.to(device, resolve_dtype(cfg.dtype)), labels.to(device))


def unet_bench_batch(torch, np, cfg, batch, hw, ctx, device):
    """bench_unet's batch (:1645-1654) on ``device``: fp32 latents, noise
    and context, int32 timesteps in [0, 1000)."""
    rng = np.random.default_rng(0)
    arrays = {
        "sample": rng.standard_normal((batch, 4, hw, hw)),
        "timesteps": rng.integers(0, 1000, batch).astype(np.int32),
        "context": rng.standard_normal((batch, ctx,
                                        cfg.cross_attention_dim)),
        "noise": rng.standard_normal((batch, 4, hw, hw))}
    return {k: torch.from_numpy(v).to(device, torch.int32 if k ==
                                      "timesteps" else torch.float32)
            for k, v in arrays.items()}


def resnet_bench(torch, np, device=None):
    """bench_resnet's model, hapi.Model and batches on ``device``:
    (model, hapi model, [(x, y)] for the warm-up and the timed steps)."""
    from paddle_tpu_torch import hapi, nn, optimizer
    from paddle_tpu_torch.vision.models import resnet18

    device = device or DEVICE
    model = resnet18(num_classes=10, device=device, seed=0)
    opt = optimizer.Momentum(learning_rate=RESNET_BENCH["lr"],
                             momentum=RESNET_BENCH["momentum"],
                             parameters=model.parameters())
    m = hapi.Model(model)
    m.prepare(optimizer=opt, loss=nn.CrossEntropyLoss())
    rng = np.random.default_rng(0)
    b = RESNET_BENCH["batch"]
    batches = [(torch.from_numpy(rng.standard_normal(
                    (b, 3, 32, 32)).astype(np.float32)).to(device),
                torch.from_numpy(rng.integers(0, 10, b)).to(device))
               for _ in range(VISION_WARMUP + VISION_STEPS)]
    return model, m, batches


def _resnet_parity(torch, np, card):
    """3 train_batch steps of resnet18 on the card and the CPU, each
    started on the card from the CPU's state; returns the worst errors."""
    from paddle_tpu_torch import hapi, nn, optimizer
    from paddle_tpu_torch.vision.models import resnet18

    cpu = resnet18(num_classes=10, device="cpu", seed=33)
    gpu = resnet18(num_classes=10, device=DEVICE, seed=33)
    opts, models = [], []
    for net in (cpu, gpu):
        opt = optimizer.Momentum(learning_rate=VISION_PARITY_LR,
                                 momentum=0.9, parameters=net.parameters())
        m = hapi.Model(net)
        m.prepare(optimizer=opt, loss=nn.CrossEntropyLoss())
        opts.append(opt)
        models.append(m)
    rng = np.random.default_rng(33)
    worst = dict(loss=0.0, param=(0.0, ""), stat=(0.0, ""))
    moved = False
    for step in range(3):
        _copy_state(torch, gpu, cpu)
        vel = opts[0]._accumulators.get("velocity", {})
        for pc, pg in zip(cpu.parameters(), gpu.parameters()):
            if pc in vel:
                opts[1]._accumulators["velocity"][pg] = vel[pc].to(
                    DEVICE, copy=True)
        x = torch.from_numpy(rng.standard_normal(
            (VISION_PARITY_BATCH, 3, 32, 32)).astype(np.float32))
        y = torch.from_numpy(rng.integers(0, 10, VISION_PARITY_BATCH))
        before = {k: v.clone() for k, v in cpu.state_dict().items()}
        (lc,), _ = models[0].train_batch(x, y)
        (lg,), _ = models[1].train_batch(x.to(DEVICE), y.to(DEVICE))
        worst["loss"] = max(worst["loss"], abs(lg - lc) / abs(lc))
        sg = gpu.state_dict()
        for k, v in cpu.state_dict().items():
            if k.endswith(("_mean", "_variance")):
                worst["stat"] = max(worst["stat"], (_rel_err(sg[k], v), k))
            else:
                err = (sg[k].cpu() - v).abs().max().item()
                worst["param"] = max(worst["param"], (err, k))
                moved |= (v - before[k]).abs().max().item() > \
                    VISION_TOL["param"]
    print(f"vision parity resnet18 [{card}]: 3 train_batch steps card vs "
          f"CPU (fp32, batch {VISION_PARITY_BATCH}, lr {VISION_PARITY_LR}): "
          f"loss max_rel={worst['loss']:.3e}; params worst abs "
          f"{worst['param'][0]:.3e} ({worst['param'][1]}); statistics worst "
          f"rel {worst['stat'][0]:.3e} ({worst['stat'][1]})", flush=True)
    if not (worst["loss"] <= VISION_TOL["loss"]
            and worst["param"][0] <= VISION_TOL["param"]
            and worst["stat"][0] <= VISION_TOL["stat"] and moved):
        raise AssertionError(f"resnet18 card vs CPU failed: {worst}, "
                             f"moved {moved}")
    del cpu, gpu, models, opts


def _grad_parity(torch, what, make, loss_of, card):
    """Loss and every gradient of ``make(device)`` on the card and the CPU
    from the same weights."""
    cpu, gpu = make("cpu"), make(DEVICE)
    _copy_state(torch, gpu, cpu)
    out = []
    for model, dev in ((cpu, "cpu"), (gpu, DEVICE)):
        loss = loss_of(model, dev)
        out.append((loss.item(), torch.autograd.grad(
            loss, list(model.parameters()))))
    (lc, gc), (lg, gg) = out
    loss_rel = abs(lg - lc) / abs(lc)
    names = [n for n, _ in cpu.named_parameters()]
    grad = max((_rel_err(b, a), n) for n, a, b in zip(names, gc, gg))
    print(f"vision parity {what} [{card}]: loss cpu {lc:.6f} card {lg:.6f} "
          f"max_rel={loss_rel:.3e}; gradients worst rel {grad[0]:.3e} "
          f"({grad[1]}, {len(names)} parameters)", flush=True)
    if not (loss_rel <= VISION_TOL["loss"] and grad[0] <= VISION_TOL["grad"]):
        raise AssertionError(f"{what} card vs CPU failed")


def phase_vision_parity(torch, np, ops, card):
    """Card against CPU on the same weights and batches (fp32, TF32 off):
    resnet18's hapi steps with its BatchNorm statistics, the tiny ViT's and
    UNet's loss and gradients, each zoo factory's eval logits; K1-K6 must
    not launch."""
    from paddle_tpu_torch.models import UNet2DConditionModel, UNetConfig
    from paddle_tpu_torch.vision import models as V

    _reset_counts(ops)
    _resnet_parity(torch, np, card)
    vcfg = V.ViTConfig.tiny()
    imgs, labels = vit_bench_inputs(torch, np, vcfg, 4, "cpu")
    _grad_parity(
        torch, "vit tiny", lambda dev: V.VisionTransformer(vcfg, device=dev,
                                                           seed=33),
        lambda m, dev: m.loss_fn(imgs.to(dev), labels.to(dev)), card)
    ucfg = UNetConfig.tiny()
    batch = unet_bench_batch(torch, np, ucfg, 2, 16, 6, "cpu")
    _grad_parity(
        torch, "unet tiny", lambda dev: UNet2DConditionModel(ucfg, device=dev,
                                                             seed=33),
        lambda m, dev: m.loss_fn({k: v.to(dev) for k, v in batch.items()}),
        card)
    x = torch.from_numpy(np.random.default_rng(33).standard_normal(
        (ZOO_BATCH, 3, ZOO_PX, ZOO_PX)).astype(np.float32))
    rows = []
    for name, kw in ZOO_FACTORIES:
        make = getattr(V, name)
        cpu = make(device="cpu", seed=33, **kw).eval()
        gpu = make(device=DEVICE, seed=33, **kw).eval()
        _copy_state(torch, gpu, cpu)
        with torch.no_grad():
            ref, out = cpu(x), gpu(x.to(DEVICE))
        err = _rel_err(out, ref)
        tag = name + ("_bn" if kw else "")
        rows.append(f"{tag} {err:.2e}")
        if tuple(out.shape) != (ZOO_BATCH, 1000) or not err <= \
                VISION_TOL["logits"]:
            raise AssertionError(f"zoo {tag}: card vs CPU error {err}, "
                                 f"shape {tuple(out.shape)}")
        del cpu, gpu
    print(f"vision parity zoo [{card}]: eval logits card vs CPU at "
          f"{ZOO_PX} px, batch {ZOO_BATCH}, worst rel: {', '.join(rows)}",
          flush=True)
    counts = _no_kernel_ran(ops, "vision parity")
    print(f"vision parity: K1-K6 launches {counts}", flush=True)
    _release(torch)


def _timed(torch, step, sync_each):
    """VISION_WARMUP calls of ``step(i)``, then VISION_STEPS timed calls;
    ``step`` returns the loss (a float when ``sync_each``, else a tensor
    read after the last call). Returns (seconds, losses)."""
    losses = [step(i) for i in range(VISION_WARMUP)]
    sync()
    t0 = time.perf_counter()
    for i in range(VISION_WARMUP, VISION_WARMUP + VISION_STEPS):
        losses.append(step(i))
    if not sync_each:
        losses[-1].item()
    dt = time.perf_counter() - t0
    vals = [float(v) for v in losses]
    if not all(math.isfinite(v) for v in vals):
        raise AssertionError(f"non-finite loss: {vals}")
    return dt, vals


def phase_bench_resnet(torch, np, ops, card):
    """bench_resnet: resnet18 on CIFAR shapes through hapi.Model.train_batch
    with Momentum; images/s, ms a step, the loss; BatchNorm statistics must
    move and no kernel of K1-K6 run."""
    model, m, batches = resnet_bench(torch, np)
    stats0 = model.bn1._mean.clone()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(ops)
    dt, losses = _timed(
        torch, lambda i: m.train_batch(*batches[i])[0][0], True)
    b = RESNET_BENCH["batch"]
    moved = (model.bn1._mean - stats0).abs().max().item()
    print(f"bench_resnet [{card}]: images_per_s="
          f"{b * VISION_STEPS / dt:.1f} ms_per_step="
          f"{dt / VISION_STEPS * 1e3:.2f} loss={losses[-1]:.4f} "
          f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f} "
          f"(resnet18, batch {b} x 3 x 32 x 32 fp32, Momentum lr "
          f"{RESNET_BENCH['lr']}, hapi train_batch, {VISION_STEPS} timed "
          f"steps); bn1._mean moved {moved:.3e}; losses "
          f"{[round(v, 4) for v in losses]}", flush=True)
    if not moved > 0:
        raise AssertionError("bench_resnet: BatchNorm statistics did not "
                             "move")
    _no_kernel_ran(ops, "bench_resnet")
    del model, m, batches
    _release(torch)
    return b * VISION_STEPS / dt


def vit_flops_per_image(cfg, n_params):
    """bench.py:1725-1727: 6 N tokens + 12 L h tokens^2."""
    n_tok = cfg.num_patches + 1
    return 6.0 * n_params * n_tok + 12.0 * cfg.num_layers * \
        cfg.hidden_size * n_tok * n_tok


def phase_bench_vit(torch, np, ops, card):
    """bench_vit: ViT-L/16 in bf16 through bench's SGD step; images/s, MFU
    (bench's FLOP count over 989 TFLOP/s), peak memory."""
    from paddle_tpu_torch.vision.models import vit_l_16

    torch.cuda.reset_peak_memory_stats()
    model = vit_l_16(dtype="bfloat16", device=DEVICE, seed=0)
    cfg, b = model.config, VIT_BENCH_BATCH
    imgs, labels = vit_bench_inputs(torch, np, cfg, b, DEVICE)
    _reset_counts(ops)
    dt, losses = _timed(torch, lambda i: sgd_bench_step(
        torch, model, lambda: model.loss_fn(imgs, labels)), False)
    n = _n_params(model)
    ips = b * VISION_STEPS / dt
    mfu = ips * vit_flops_per_image(cfg, n) / PEAK_FLOPS["bfloat16"]
    print(f"bench_vit [{card}]: images_per_s={ips:.1f} mfu={mfu:.4f} "
          f"ms_per_step={dt / VISION_STEPS * 1e3:.2f} peak_mem_gb="
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} ({n / 1e6:.1f}M "
          f"params, {cfg.image_size} px, {cfg.num_patches + 1} tokens, "
          f"batch {b}, bf16, SGD lr {BENCH_SGD_LR}); losses "
          f"{[round(v, 4) for v in losses]}", flush=True)
    _no_kernel_ran(ops, "bench_vit")
    del model, imgs, labels
    _release(torch)


def phase_bench_unet(torch, np, ops, card):
    """bench_unet: the SD-class UNet in bf16 through bench's SGD step;
    latents/s, peak memory."""
    from paddle_tpu_torch.models import UNet2DConditionModel, UNetConfig

    torch.cuda.reset_peak_memory_stats()
    cfg = UNetConfig(**UNET_BENCH_CONFIG)
    model = UNet2DConditionModel(cfg, device=DEVICE, seed=0)
    b = UNET_BENCH_BATCH
    batch = unet_bench_batch(torch, np, cfg, b, UNET_BENCH_HW,
                             UNET_BENCH_CTX, DEVICE)
    _reset_counts(ops)
    dt, losses = _timed(torch, lambda i: sgd_bench_step(
        torch, model, lambda: model.loss_fn(batch)), False)
    print(f"bench_unet [{card}]: latents_per_s={b * VISION_STEPS / dt:.1f} "
          f"ms_per_step={dt / VISION_STEPS * 1e3:.2f} peak_mem_gb="
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} "
          f"({_n_params(model) / 1e6:.1f}M params, channels "
          f"{cfg.block_channels}, batch {b} x 4 x {UNET_BENCH_HW} x "
          f"{UNET_BENCH_HW}, context {UNET_BENCH_CTX} x "
          f"{cfg.cross_attention_dim}, bf16, SGD lr {BENCH_SGD_LR}); losses "
          f"{[round(v, 4) for v in losses]}", flush=True)
    _no_kernel_ran(ops, "bench_unet")
    del model, batch
    _release(torch)


def _opt_cases(pt):
    """The optimizers of tests/test_torch_engine_optimizer.py."""
    L, O = pt.optimizer.lr, pt.optimizer
    return {
        "adamw_warmup_cosine": lambda: O.AdamW(
            learning_rate=L.LinearWarmup(L.CosineAnnealingDecay(
                1e-3, T_max=10), warmup_steps=2, start_lr=0.0, end_lr=1e-3),
            weight_decay=0.01,
            apply_decay_param_fun=lambda n: "norm" not in n,
            grad_clip=pt.nn.ClipGradByGlobalNorm(1.0)),
        "lamb": lambda: O.Lamb(learning_rate=1e-3),
        "radam": lambda: O.RAdam(learning_rate=1e-3),
        "nadam": lambda: O.NAdam(learning_rate=1e-3),
        "adagrad": lambda: O.Adagrad(learning_rate=1e-2,
                                     initial_accumulator_value=0.1),
        "momentum": lambda: O.Momentum(learning_rate=1e-2, momentum=0.9,
                                       weight_decay=1e-2),
    }


def _opt_parity(torch, ops, name, make_opt, cfg, batches):
    """3 Engine(optimizer=) steps on the card and on the CPU from the same
    weights (fp32); returns the card's K1-lse/K2/K3 launches. Parameters
    within 2 x lr x steps (an adaptive update normalises rounding noise to
    up to lr a step), each accumulator within 1e-3 of its largest (or of
    1e-3 of the largest of its kind, for a parameter whose gradient is
    rounding noise), losses within 1e-4 relative."""
    from paddle_tpu_torch.distributed import Engine
    from paddle_tpu_torch.models import LlamaForCausalLM

    cpu = LlamaForCausalLM(cfg, device="cpu", seed=5)
    card = LlamaForCausalLM(cfg, device=DEVICE, seed=5)
    _copy_state(torch, card, cpu)
    runs, lr_max = [], 0.0
    counts0 = _read_counts(ops)
    for model, dev in ((cpu, "cpu"), (card, DEVICE)):
        opt = make_opt()
        eng = Engine(model, optimizer=opt, loss_fn=model.loss_fn)
        losses = []
        for x, y in batches:
            lr_max = max(lr_max, opt.get_lr())
            losses.append(eng.step(x.to(dev), y.to(dev)))
            opt._lr_step()
        runs.append((eng, torch.stack(losses).cpu()))
    sync()
    c1 = _read_counts(ops)
    counts = tuple(c1[k] - counts0[k] for k in ("k1_lse", "k2", "k3"))
    (ec, lc), (eg, lg) = runs
    loss_rel = ((lg - lc).abs() / lc.abs()).max().item()
    sc, sg = ec.state_dict(), eg.state_dict()
    p_err = max(((sg["model"][n].cpu() - a).abs().max().item(), n)
                for n, a in sc["model"].items())
    acc_err = (0.0, "")
    for acc, d in sc["opt"].items():
        top = max(a.abs().max().item() for a in d.values())
        for n, a in d.items():
            err = (sg["opt"][acc][n].cpu() - a).abs().max().item()
            err /= max(a.abs().max().item(), 1e-3 * top, 1e-30)
            acc_err = max(acc_err, (err, f"{acc}:{n}"))
    steps = len(batches)
    p_tol = 2 * lr_max * steps
    print(f"engine optimizer parity {name} (card vs CPU, fp32, {steps} "
          f"steps): losses card {[round(x, 6) for x in lg.tolist()]} cpu "
          f"{[round(x, 6) for x in lc.tolist()]} max_rel={loss_rel:.3e}; "
          f"params worst abs {p_err[0]:.3e} ({p_err[1]}, tol {p_tol:.3g}); "
          f"accumulators {sorted(sc['opt'])} worst rel {acc_err[0]:.3e} "
          f"({acc_err[1]}); card launches k1_lse/k2/k3={counts}",
          flush=True)
    if sorted(sg["opt"]) != sorted(sc["opt"]):
        raise AssertionError(f"{name}: accumulators differ")
    if not (loss_rel <= 1e-4 and p_err[0] <= p_tol
            and acc_err[0] <= 1e-3
            and min(counts) >= cfg.num_hidden_layers * steps):
        raise AssertionError(f"engine optimizer {name} card vs CPU failed")
    del ec, eg, cpu, card
    return counts


def _opt_train(torch, np, ops, cfg, batches, make_engine, what):
    """One warm-up step (under sync-debug mode) and OPT_TRAIN_STEPS timed
    steps of ``make_engine(model)`` (which returns the engine and what to
    call after each step) on TRAIN_CONFIG from seed 0; the counts set to 0
    just before the timed steps and read just after. Returns ms a step,
    tokens/s, launches, losses, the warm-up step's host syncs and the
    peak memory (GB)."""
    from paddle_tpu_torch.models import LlamaForCausalLM

    _release(torch)
    torch.cuda.reset_peak_memory_stats()
    model = LlamaForCausalLM(cfg, device=DEVICE, seed=0)
    eng, after_step = make_engine(model)
    losses = []

    def warm():
        losses.append(eng.step(batches[0], batches[0]))
        after_step()

    syncs = _sync_count(torch, warm)
    sync()
    _reset_counts(ops)
    t0 = time.perf_counter()
    for ids in batches:
        losses.append(eng.step(ids, ids))
        after_step()
    losses[-1].item()           # one host read fences the chain
    wall = time.perf_counter() - t0
    counts = _read_counts(ops)
    out = dict(ms=wall / len(batches) * 1e3, launches=counts,
               losses=torch.stack(losses).float().cpu(), syncs=syncs,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               tok_s=TRAIN_BATCH * TRAIN_SEQ * len(batches) / wall)
    del eng, model
    _release(torch)
    print(f"{what}: {out['ms']:.2f} ms a step", flush=True)
    return out


def phase_engine_optimizer(torch, np, ops, card):
    """(a) Engine(optimizer=X) card against CPU for each X; (b) the full-
    width train step under the pluggable AdamW with its schedule, beside
    the built-in AdamW engine; returns (b)'s K1-lse/K2/K3 launches."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.nn  # noqa: F401  (pt.nn)
    import paddle_tpu_torch.optimizer  # noqa: F401  (pt.optimizer)
    from paddle_tpu_torch.distributed import Engine
    from paddle_tpu_torch.models import LlamaConfig

    pcfg = LlamaConfig(**PARITY_CONFIG)
    rng = np.random.default_rng(5)
    pb = [torch.from_numpy(rng.integers(0, pcfg.vocab_size,
                                        (PARITY_BATCH, PARITY_SEQ)))
          for _ in range(PARITY_STEPS)]
    for name, make in _opt_cases(pt).items():
        _opt_parity(torch, ops, name, make, pcfg, [(x, x) for x in pb])
        _release(torch)

    cfg = LlamaConfig(**TRAIN_CONFIG)
    rng = np.random.default_rng(0)
    batches = [torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)).to(
        DEVICE) for _ in range(OPT_TRAIN_STEPS)]
    sch, L = OPT_TRAIN_SCHEDULE, pt.optimizer.lr
    opts = []

    def pluggable(model):
        opt = pt.optimizer.AdamW(
            learning_rate=L.LinearWarmup(
                L.CosineAnnealingDecay(sch["peak"], T_max=sch["T_max"]),
                warmup_steps=sch["warmup_steps"], start_lr=0.0,
                end_lr=sch["peak"]),
            weight_decay=OPT_TRAIN_DECAY,
            grad_clip=pt.nn.ClipGradByGlobalNorm(1.0))
        opts.append(opt)
        return Engine(model, optimizer=opt), opt._lr_step

    def builtin(model):
        return Engine(model, lr=sch["peak"], weight_decay=OPT_TRAIN_DECAY,
                      clip_norm=1.0), lambda: None

    r = _opt_train(torch, np, ops, cfg, batches, pluggable,
                   "engine optimizer AdamW (pluggable)")
    b = _opt_train(torch, np, ops, cfg, batches, builtin,
                   "engine built-in AdamW")
    L_, H, Q = cfg.num_hidden_layers, cfg.num_attention_heads, cfg.head_dim
    flops_per_token = 6.0 * cfg.num_params() + 6.0 * L_ * (H * Q) * TRAIN_SEQ
    per_step = {k: v / OPT_TRAIN_STEPS for k, v in r["launches"].items()}
    for tag, x in (("pluggable AdamW", r), ("built-in AdamW", b)):
        mfu = x["tok_s"] * flops_per_token / PEAK_FLOPS["bfloat16"]
        print(f"engine optimizer [{card}] {tag}: ms_per_step={x['ms']:.2f} "
              f"tokens_per_s={x['tok_s']:.1f} mfu={mfu:.4f} peak_mem_gb="
              f"{x['peak_gb']:.2f} host_syncs_in_a_step={len(x['syncs'])} "
              f"({cfg.num_params() / 1e6:.1f}M params, batch {TRAIN_BATCH} "
              f"x seq {TRAIN_SEQ}, bf16, no remat, {OPT_TRAIN_STEPS} timed "
              f"steps); losses {[round(v, 4) for v in x['losses'].tolist()]}",
              flush=True)
    print(f"engine optimizer [{card}]: pluggable/built-in step = "
          f"{r['ms'] / b['ms']:.3f}; learning rate after the run "
          f"{opts[0].get_lr():.6e} (LinearWarmup over "
          f"{sch['warmup_steps']} steps to {sch['peak']}); launches a step "
          f"k1_lse/k2/k3={[per_step[k] for k in ('k1_lse', 'k2', 'k3')]} "
          f"serving_k1={r['launches']['k1']}", flush=True)
    for x, what in ((r, "pluggable"), (b, "built-in")):
        _check_losses(x["losses"], f"engine optimizer {what}")
    if r["syncs"]:
        raise AssertionError(f"the pluggable step synchronized: "
                             f"{r['syncs']}")
    need = cfg.num_hidden_layers
    if any(per_step[k] != need for k in ("k1_lse", "k2", "k3")) or \
            r["launches"]["k1"]:
        raise AssertionError(f"engine optimizer launches a step "
                             f"{per_step}, expected {need} each")
    return tuple(r["launches"][k] for k in ("k1_lse", "k2", "k3"))


class _TimedLoader:
    """A DataLoader whose batches are timed as ``fit`` waits for them
    (the workers' start included)."""

    def __init__(self, loader):
        self.loader, self.wait = loader, 0.0

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        t = time.perf_counter()
        it = iter(self.loader)
        self.wait += time.perf_counter() - t
        while True:
            t = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            finally:
                self.wait += time.perf_counter() - t
            yield batch


def _cifar_fit(pt, device, seed, lr):
    """resnet18 under HAPI_FIT's optimizer and metrics, at ``lr``."""
    from paddle_tpu_torch import hapi, metric, nn
    from paddle_tpu_torch.vision.models import resnet18

    net = resnet18(num_classes=10, device=device, seed=seed)
    opt = pt.optimizer.Momentum(
        learning_rate=pt.optimizer.lr.CosineAnnealingDecay(
            lr, T_max=HAPI_FIT["T_max"]),
        momentum=HAPI_FIT["momentum"],
        weight_decay=HAPI_FIT["weight_decay"], parameters=net.parameters())
    m = hapi.Model(net)
    m.prepare(opt, nn.CrossEntropyLoss(), metric.Accuracy(topk=(1, 5)))
    return net, m


def _cifar_data(size, mode, train):
    from paddle_tpu_torch.vision import datasets as D
    from paddle_tpu_torch.vision import transforms as T

    aug = [T.RandomCrop(32, padding=4), T.RandomHorizontalFlip()] \
        if train else []
    return D.Cifar10(mode=mode, size=size, transform=T.Compose(
        aug + [T.ToTensor(), T.Normalize(CIFAR_MEAN, CIFAR_STD)]))


def _hapi_fit_parity(torch, np, pt, card):
    """A short fit on the CPU and on the card from the same weights on the
    same batches, each card step started from the CPU's state."""
    from paddle_tpu_torch.hapi import callbacks as C

    hp = HAPI_PARITY
    cpu, cm = _cifar_fit(pt, "cpu", 33, hp["lr"])
    gpu, gm = _cifar_fit(pt, DEVICE, 33, hp["lr"])
    kept, logs, after = [], [[], []], []

    class Keep(C.Callback):
        def on_train_batch_begin(self, step, logs_=None):
            vel = cm._optimizer._accumulators.get("velocity", {})
            kept.append(({k: v.clone() for k, v in cpu.state_dict().items()},
                         {n: vel[p].clone() for n, p in
                          cpu.named_parameters() if p in vel}))

        def on_train_batch_end(self, step, logs_=None):
            logs[0].append(dict(logs_))

    class Load(C.Callback):
        def on_train_batch_begin(self, step, logs_=None):
            state, vel = kept[step]
            with torch.no_grad():
                for k, v in gpu.state_dict().items():
                    v.copy_(state[k])
            named = dict(gpu.named_parameters())
            gm._optimizer._accumulators["velocity"] = {
                named[n]: v.to(DEVICE) for n, v in vel.items()}

        def on_train_batch_end(self, step, logs_=None):
            logs[1].append(dict(logs_))
            after.append({k: v.detach().cpu().clone()
                          for k, v in gpu.state_dict().items()})

    ds = _cifar_data(hp["batch"] * hp["iters"], "train", True)
    for m, cb in ((cm, Keep()), (gm, Load())):
        np.random.seed(0)
        m.fit(ds, batch_size=hp["batch"], epochs=1, num_iters=hp["iters"],
              verbose=0, callbacks=[cb])
    kept.append(({k: v.clone() for k, v in cpu.state_dict().items()}, {}))
    worst = dict(loss=0.0, acc=0.0, param=(0.0, ""), stat=(0.0, ""))
    for i, (lc, lg) in enumerate(zip(*logs)):
        worst["loss"] = max(worst["loss"],
                            abs(lg["loss"] - lc["loss"]) / abs(lc["loss"]))
        worst["acc"] = max([worst["acc"]] + [abs(a - b) for a, b in
                                            zip(lg["acc"], lc["acc"])])
        ref = kept[i + 1][0]
        for k, v in ref.items():
            if k.endswith(("_mean", "_variance")):
                worst["stat"] = max(worst["stat"],
                                    (_rel_err(after[i][k], v), k))
            else:
                worst["param"] = max(worst["param"], (
                    (after[i][k] - v).abs().max().item(), k))
    print(f"hapi fit parity [{card}]: {hp['iters']} fit iterations card vs "
          f"CPU (resnet18, batch {hp['batch']}, lr {hp['lr']}, the "
          f"augmenting chain, Accuracy top-1/5): loss max_rel="
          f"{worst['loss']:.3e}; accuracy worst diff {worst['acc']:.4f}; "
          f"params worst abs {worst['param'][0]:.3e} ({worst['param'][1]});"
          f" statistics worst rel {worst['stat'][0]:.3e} "
          f"({worst['stat'][1]})", flush=True)
    if not (len(logs[0]) == len(logs[1]) == hp["iters"]
            and worst["loss"] <= VISION_TOL["loss"]
            and worst["acc"] <= 1.0 / hp["batch"]
            and worst["param"][0] <= VISION_TOL["param"]
            and worst["stat"][0] <= VISION_TOL["stat"]):
        raise AssertionError(f"hapi fit card vs CPU failed: {worst}")
    del cpu, gpu, cm, gm


def phase_hapi_fit(torch, np, ops, card, batch_rate):
    """BASELINE config 1 through Model.fit with 4 loader workers, then
    evaluate, predict, save and load into a fresh model."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.optimizer  # noqa: F401  (pt.optimizer)
    from paddle_tpu_torch.hapi import callbacks as C
    from paddle_tpu_torch.io import DataLoader

    _hapi_fit_parity(torch, np, pt, card)
    _release(torch)
    hf = HAPI_FIT
    t0 = time.perf_counter()
    train = _cifar_data(hf["train"], "train", True)
    test = _cifar_data(hf["test"], "test", False)
    made = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    net, m = _cifar_fit(pt, DEVICE, 0, hf["lr"])
    loader = _TimedLoader(DataLoader(train, batch_size=hf["batch"],
                                     shuffle=True,
                                     num_workers=hf["workers"]))
    clock = {}

    class Clock(C.Callback):
        def on_epoch_begin(self, epoch, logs=None):
            clock["begin"] = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            clock["train_end"] = time.perf_counter()
            clock["steps"] = step + 1

        def on_epoch_end(self, epoch, logs=None):
            clock["logs"] = dict(logs)

    save_dir = _scratch_dir("hapi_fit")
    _reset_counts(ops)
    np.random.seed(0)
    t0 = time.perf_counter()
    m.fit(loader, eval_data=test, batch_size=hf["batch"], epochs=1,
          num_workers=hf["workers"], verbose=0,
          callbacks=[C.ModelCheckpoint(save_dir=save_dir),
                     C.EarlyStopping(), C.LRScheduler(), Clock()])
    fit_s = time.perf_counter() - t0
    counts = _no_kernel_ran(ops, "hapi fit")
    train_s = clock["train_end"] - clock["begin"]
    ips = hf["train"] / train_s
    logs = clock["logs"]
    shown = {k: round(v, 4) if isinstance(v, float) else
             [round(x, 4) for x in v] for k, v in logs.items()}
    print(f"hapi fit [{card}]: images_per_s={ips:.1f} (train_batch rate of "
          f"phase 34 in this run: {batch_rate:.1f}) loader_wait_share="
          f"{loader.wait / train_s:.4f} ({loader.wait:.2f} s of "
          f"{train_s:.2f} s) fit_s={fit_s:.2f} (with eval of "
          f"{hf['test']} and the checkpoints) steps={clock['steps']} "
          f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f} "
          f"data_made_s={made:.2f}; epoch logs {shown}; lr now "
          f"{m._optimizer.get_lr():.5f}; K1-K6 launches {counts}",
          flush=True)
    if not (math.isfinite(logs["loss"]) and math.isfinite(logs["eval_loss"])
            and clock["steps"] == len(loader)):
        raise AssertionError(f"hapi fit: {logs}, {clock}")
    written = sorted(os.listdir(save_dir))
    if written != ["0.pdopt", "0.pdparams", "final.pdopt",
                   "final.pdparams"]:
        raise AssertionError(f"ModelCheckpoint wrote {written}")
    t0 = time.perf_counter()
    ev = m.evaluate(test, batch_size=hf["batch"], num_workers=hf["workers"],
                    verbose=0)
    ev_s = time.perf_counter() - t0
    outs = m.predict(test, batch_size=hf["batch"],
                     num_workers=hf["workers"])
    n_out = sum(o.shape[0] for o in outs)
    if not (n_out == hf["test"] and all(o.shape[1] == 10 and bool(
            torch.isfinite(o).all()) for o in outs)):
        raise AssertionError(f"predict gave {n_out} rows")
    path = os.path.join(save_dir, "model")
    m.save(path)
    net2, m2 = _cifar_fit(pt, DEVICE, 1, hf["lr"])
    m2.load(path)
    same = all(torch.equal(a, b) for a, b in zip(
        net.state_dict().values(), net2.state_dict().values()))
    ev2 = m2.evaluate(test, batch_size=hf["batch"], num_workers=0, verbose=0)
    rel = abs(ev2["loss"] - ev["loss"]) / abs(ev["loss"])
    print(f"hapi evaluate/predict/save/load [{card}]: evaluate {ev} in "
          f"{ev_s:.2f} s; predict {len(outs)} batches, {n_out} rows; "
          f"reloaded model: state equal {same}, eval loss rel diff "
          f"{rel:.3e}, acc {ev2['acc']}", flush=True)
    if not (same and rel <= 1e-6 and ev2["acc"] == ev["acc"]):
        raise AssertionError("the reloaded model differs")
    _no_kernel_ran(ops, "hapi evaluate/predict")
    del net, net2, m, m2, outs, train, test
    _release(torch)
    return counts


def dygraph_encoder(pt, cfg, device):
    """The Paddle-layer encoder classifier of phases 40-41 (and of
    tests/test_torch_amp.py's card arm): token + learned position
    embeddings, LayerNorm, a TransformerEncoder (dropout 0, gelu), a Linear
    head on the first token. Weights from the global generator of
    ``device`` (seed it first)."""
    from paddle_tpu_torch import nn

    class Encoder(nn.Layer):
        def __init__(self):
            super().__init__()
            h = cfg["hidden"]
            self.word = nn.Embedding(cfg["vocab"], h, device=device)
            self.pos = nn.Embedding(cfg["max_pos"], h, device=device)
            self.norm = nn.LayerNorm(h, device=device)
            self.encoder = nn.TransformerEncoder(nn.TransformerEncoderLayer(
                h, cfg["heads"], cfg["ffn"], dropout=0.0, activation="gelu",
                device=device), cfg["layers"])
            self.head = nn.Linear(h, cfg["labels"], device=device)

        def forward(self, ids):
            pos = pt.arange(ids.shape[1]).unsqueeze(0)
            x = self.norm(self.word(ids) + self.pos(pos))
            return self.head(self.encoder(x)[:, 0])

    return Encoder()


def dygraph_step(pt, model, opt, scaler, ids, labels, level, dtype,
                 keep_grads=False):
    """One step of JAX's form of the reference's dygraph AMP loop (the
    scaler's minimize runs the backward); returns the unscaled loss. With
    ``keep_grads`` the (unscaled) gradients stay for the caller to read
    and clear."""
    import paddle_tpu_torch.nn.functional as PF

    with pt.amp.auto_cast(level=level, dtype=dtype):
        loss = PF.cross_entropy(model(ids), labels)
    scaler.minimize(opt, scaler.scale(loss))
    if not keep_grads:
        opt.clear_grad()
    return loss


def _dygraph_opt(pt, model, lr):
    from paddle_tpu_torch import nn, optimizer

    return optimizer.AdamW(lr, parameters=model.parameters(),
                           weight_decay=0.01,
                           grad_clip=nn.ClipGradByGlobalNorm(1.0))


def _dygraph_batch(pt, np, cfg, batch, seq, device, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg["vocab"], (batch, seq))
    labels = rng.integers(0, cfg["labels"], (batch,))
    return (pt.to_tensor(ids, place=device),
            pt.to_tensor(labels, place=device))


def amp_grad_errors(grads, refs):
    """The dygraph AMP gradient check's readings (see AMP_GRAD_TOL):
    ``grads`` and ``refs`` map parameter names to float64 numpy arrays.
    Returns (worst error, its name, the names measured against the largest
    gradient of all as noise)."""
    import numpy as np

    top = max(float(np.abs(r).max()) for r in refs.values())
    worst, noise = (0.0, ""), []
    for name, ref in refs.items():
        scale = float(np.abs(ref).max())
        if scale <= AMP_NOISE_SHARE * top:
            noise.append(name)
            scale = top
        err = float(np.abs(grads[name] - ref).max()) / scale
        worst = max(worst, (err, name))
    return worst[0], worst[1], noise


def _step_grads(model):
    """{name: the parameter's gradient as float64 numpy} (a step's
    gradients, read before the optimizer clears them)."""
    return {n: p.grad.detach().double().cpu().numpy()
            for n, p in model.named_parameters()}


def phase_dygraph_parity(torch, np, ops, card):
    """Phase 40: the small encoder card vs CPU, 3 dygraph AMP O1 bf16
    steps."""
    import paddle_tpu_torch as pt

    c, a = SMALL_ENCODER, SMALL_AMP
    runs = {}
    for dev in ("cpu", DEVICE):
        pt.set_device(dev)   # the forward's positions: paddle.arange
        pt.seed(a["seed"])
        model = dygraph_encoder(pt, c, "cpu")
        if dev != "cpu":
            ref = model
            model = dygraph_encoder(pt, c, dev)
            model.set_state_dict(ref.state_dict())
        opt = _dygraph_opt(pt, model, a["lr"])
        scaler = pt.amp.GradScaler(init_loss_scaling=1024)
        ids, labels = _dygraph_batch(pt, np, c, a["batch"], a["seq"], dev)
        _reset_counts(ops)
        grads, losses = None, []
        for _ in range(a["steps"]):
            losses.append(dygraph_step(
                pt, model, opt, scaler, ids, labels, "O1", "bfloat16",
                keep_grads=grads is None).item())
            if grads is None:
                grads = _step_grads(model)
                opt.clear_grad()
        runs[dev] = (losses, grads, _read_counts(ops))
    pt.set_device(DEVICE)
    (l_cpu, g_cpu, _), (l_card, g_card, counts) = runs["cpu"], runs[DEVICE]
    loss_err = max(abs(x - y) / abs(y) for x, y in zip(l_card, l_cpu))
    L, n = c["layers"], a["steps"]
    err, where, noise = amp_grad_errors(g_card, g_cpu)
    print(f"dygraph parity [{card}]: losses card {l_card} cpu {l_cpu} "
          f"(max rel err {loss_err:.3e}, tol {a['tol']}); step-1 gradients "
          f"worst err {err:.3e} of the largest ({where}, tol "
          f"{AMP_GRAD_TOL}; against the largest of all as noise: {noise}); "
          f"card launches {counts}", flush=True)
    if not (loss_err <= a["tol"] and err <= AMP_GRAD_TOL):
        raise AssertionError(f"dygraph AMP card vs CPU: losses {loss_err}, "
                             f"gradients {err} ({where})")
    if [counts[k] for k in ("k1_lse", "k2", "k3")] != [L * n] * 3:
        raise AssertionError(f"dygraph AMP parity: launches {counts}")
    _release(torch)


def phase_dygraph_bert(torch, np, ops, card):
    """Phase 41: the three AMP arms at BERT-base width; returns the bf16
    arms' (K1-lse, K2, K3) launches and the fp16 arm's (K1, K1-lse, K2,
    K3) launches."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core import op_registry
    from paddle_tpu_torch.framework import numeric_guard

    c, d = DYGRAPH_BERT, DYGRAPH
    L, steps = c["layers"], d["steps"]
    bf16_counts, fp16_counts = [0, 0, 0], None
    pt.set_device(DEVICE)   # the forward's positions: paddle.arange
    for arm, level, dtype, init_scale in DYGRAPH_ARMS:
        torch.cuda.reset_peak_memory_stats()
        pt.seed(0)
        model = dygraph_encoder(pt, c, DEVICE)
        opt = _dygraph_opt(pt, model, d["lr"])
        if level == "O2":
            model, opt = pt.amp.decorate(model, opt, level="O2", dtype=dtype)
        scaler = (pt.amp.GradScaler() if init_scale is None
                  else pt.amp.GradScaler(init_loss_scaling=init_scale))
        ids, labels = _dygraph_batch(pt, np, c, d["batch"], d["seq"], DEVICE)

        def step():
            return dygraph_step(pt, model, opt, scaler, ids, labels, level,
                                dtype)

        for _ in range(d["warmup"]):
            step()
        sync()
        _reset_counts(ops)
        op_registry.dispatched = 0
        t0 = time.perf_counter()
        losses = [step() for _ in range(steps)]
        sync()
        wall = time.perf_counter() - t0
        counts = _read_counts(ops)
        ops_per_step = op_registry.dispatched / steps
        syncs = _sync_count(torch, step)

        def forward():
            with pt.amp.auto_cast(level=level, dtype=dtype):
                return model(ids)

        enqueue, queued = host_enqueue_s(torch, forward)
        op_registry.dispatched = 0
        forward()
        fwd_ops = op_registry.dispatched
        vals = torch.stack([x.detach() for x in losses]).float().cpu()
        per_step = [counts[k] / steps for k in ("k1_lse", "k2", "k3")]
        tok_s = d["batch"] * d["seq"] * steps / wall
        DYGRAPH_MS[arm] = wall / steps * 1e3
        print(f"dygraph bert {arm} [{card}]: ms_per_step="
              f"{wall / steps * 1e3:.2f} tokens_per_s={tok_s:.1f} "
              f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f} "
              f"launches per step k1_lse/k2/k3={per_step} primal_k1="
              f"{counts['k1']} host_syncs_per_step={len(syncs)} "
              f"dispatched_ops_per_step={ops_per_step:.0f} "
              f"forward_host_us_per_op={enqueue / max(fwd_ops, 1) * 1e6:.1f}"
              f" ({fwd_ops} ops, forward enqueue {enqueue * 1e3:.2f} ms "
              f"behind a spin kernel, card idle throughout={queued}) "
              f"loss_scale={scaler._scale} losses "
              f"{[round(x, 4) for x in vals.tolist()]}", flush=True)
        for msg in syncs[:5]:
            print(f"  {msg[:160]}", flush=True)
        if per_step != [L, L, L] or counts["k1"]:
            raise AssertionError(f"dygraph bert {arm}: launches {counts}")
        if len(syncs) != 1:
            raise AssertionError(f"dygraph bert {arm}: {len(syncs)} host "
                                 f"syncs a step, not the scaler's one")
        if not bool(vals.isfinite().all()):
            raise AssertionError(f"dygraph bert {arm}: losses {vals}")
        if dtype == "bfloat16":
            bf16_counts = [x + counts[k] for x, k in
                           zip(bf16_counts, ("k1_lse", "k2", "k3"))]
        else:
            # eval forward: the primal fp16 K1, once a layer
            _reset_counts(ops)
            model.eval()
            with pt.no_grad(), pt.amp.auto_cast(level=level, dtype=dtype):
                model(ids)
            model.train()
            primal = _read_counts(ops)["k1"]
            if primal != L:
                raise AssertionError(f"dygraph bert eval: primal K1 "
                                     f"{primal}")
            fp16_counts = (primal, counts["k1_lse"], counts["k2"],
                           counts["k3"])
            # a step forced to overflow: the scaler must skip it
            before = [p.detach().clone() for p in model.parameters()]
            scale0 = OVERFLOW_SCALE
            scaler.set_init_loss_scaling(scale0)
            numeric_guard.consume_health()
            step()
            word = numeric_guard.consume_health()
            same = all(torch.equal(a, p.detach()) for a, p in
                       zip(before, model.parameters()))
            print(f"dygraph bert overflow [{card}]: found_inf="
                  f"{scaler._found_inf} parameters_unchanged={same} health="
                  f"{numeric_guard.describe_health(word)} scale "
                  f"{scale0} -> {scaler._scale}", flush=True)
            if not (scaler._found_inf and same
                    and word & numeric_guard.OVERFLOW
                    and scaler._scale == scale0 / 2):
                raise AssertionError("dygraph bert: the fp16 overflow step "
                                     "was not skipped")
        del model, opt, scaler, losses, ids, labels
        _release(torch)
    for name, (ms, tok_s) in READINGS.items():
        print(f"reading, phase 32's Engine {name} step (another code path, "
              f"not a target): ms_per_step={ms:.2f} tokens_per_s={tok_s:.1f}",
              flush=True)
    return tuple(bf16_counts), fp16_counts


def nn_sweep_cases(torch):
    """Phase 42's cases: (name, build, inputs, grad, heavy). ``build()``
    returns the callable (a functional's closure or a layer built on the
    CPU, which the sweep copies to the card); ``inputs`` are (kind, shape)
    specs ("f" normal, "p" in (0.05, 0.95), "pos" |normal| + 0.5, "s" +-1,
    "mask" bool, ("i", hi) integers);
    ``grad`` lists the inputs differentiated; ``heavy`` cases take an fp32
    CPU reference in bf16 (see NN_SWEEP_TOL). Phase 44 adds ("a", array)
    (the array itself), ("spd", shape) (symmetric positive definite) and
    ("sym", shape) / ("sep", shape) (symmetric / general with eigen /
    singular values 1..n, a gap of 1, so that the vectors, and the
    gradients built from them, are well conditioned)."""
    import paddle_tpu_torch.nn.functional as PF
    from paddle_tpu_torch import nn

    A, L, M, M1, M3 = NN_ACT, NN_LOGITS, NN_MAP, NN_MAP1, NN_MAP3
    b, t, h = NN_SEQ
    cases = []

    def add(name, build, inputs, grad=(0,), heavy=False):
        cases.append((name, build, inputs, grad, heavy))

    def fn(f):
        return lambda: f

    for name, kw in (
            ("relu", {}), ("relu6", {}), ("leaky_relu", {}), ("elu", {}),
            ("selu", {}), ("celu", {}), ("gelu", {}),
            ("gelu", dict(approximate=True)), ("silu", {}), ("mish", {}),
            ("hardswish", {}), ("hardsigmoid", {}), ("hardtanh", {}),
            ("hardshrink", {}), ("softshrink", {}), ("tanhshrink", {}),
            ("thresholded_relu", {}), ("softplus", {}), ("softsign", {}),
            ("sigmoid", {}), ("logsigmoid", {}), ("tanh", {}),
            ("softmax", {}), ("log_softmax", {}), ("rrelu", {}),
            ("glu", {}), ("maxout", dict(groups=2, axis=-1))):
        f = getattr(PF, name)
        add(f"F.{name}{'_tanh' if kw.get('approximate') else ''}",
            fn(lambda x, f=f, kw=kw: f(x, **kw)), [("f", A)])
    add("F.prelu", fn(PF.prelu), [("f", M), ("p", (M[1],))], (0, 1))
    # in place, into a copy (the inputs are shared with the reference)
    add("F.relu_", fn(lambda x: PF.relu_(x.clone())), [("f", A)])
    add("F.softmax_", fn(lambda x: PF.softmax_(x.clone())), [("f", A)])
    for cls in ("ReLU", "ReLU6", "LeakyReLU", "ELU", "CELU", "SELU", "GELU",
                "Silu", "Swish", "Mish", "Hardswish", "Hardsigmoid",
                "Hardtanh", "Hardshrink", "Softshrink", "Tanhshrink",
                "ThresholdedReLU", "Softplus", "Softsign", "Sigmoid",
                "LogSigmoid", "Tanh", "Softmax", "LogSoftmax", "GLU",
                "RReLU"):
        add(f"nn.{cls}", lambda c=cls: getattr(nn, c)().eval(),
            [("f", A)])
    add("nn.Maxout", lambda: nn.Maxout(4), [("f", M)])
    add("nn.PReLU", lambda: nn.PReLU(M[1], device="cpu"), [("f", M)])

    logits, labels = ("f", L), (("i", L[1]), (L[0],))
    add("F.cross_entropy", fn(lambda x, y: PF.cross_entropy(
        x, y, ignore_index=3)), [logits, labels])
    add("F.cross_entropy_weight_smooth", fn(lambda x, y, w: PF.cross_entropy(
        x, y, w, label_smoothing=0.1)), [logits, labels, ("p", (L[1],))],
        (0, 2))
    add("F.cross_entropy_soft", fn(lambda x, y: PF.cross_entropy(
        x, y, soft_label=True)), [logits, ("p", L)], (0, 1))
    add("F.softmax_with_cross_entropy", fn(
        lambda x, y: PF.softmax_with_cross_entropy(
            x, y.unsqueeze(-1), return_softmax=True)), [logits, labels])
    add("F.nll_loss", fn(lambda x, y: PF.nll_loss(
        torch.log_softmax(x.float(), -1).to(x.dtype), y)), [logits, labels])
    for name in ("mse_loss", "l1_loss", "smooth_l1_loss", "huber_loss",
                 "square_error_cost"):
        add(f"F.{name}", fn(getattr(PF, name)), [("f", A), ("f", A)], (0, 1))
    add("F.binary_cross_entropy", fn(PF.binary_cross_entropy),
        [("p", A), ("p", A)], (0, 1))
    add("F.bce_with_logits", fn(lambda z, y, w:
                                PF.binary_cross_entropy_with_logits(
                                    z, y, pos_weight=w)),
        [("f", A), ("p", A), ("p", (A[-1],))], (0, 2))
    add("F.kl_div", fn(lambda x, y: PF.kl_div(x, y, "batchmean")),
        [("f", A), ("p", A)], (0, 1))
    add("F.margin_ranking_loss", fn(PF.margin_ranking_loss),
        [("f", (1 << 20,)), ("f", (1 << 20,)), ("s", (1 << 20,))], (0, 1))
    add("F.hinge_embedding_loss", fn(PF.hinge_embedding_loss),
        [("f", A), ("s", A)])
    add("F.cosine_embedding_loss", fn(PF.cosine_embedding_loss),
        [("f", L), ("f", L), ("s", (L[0],))], (0, 1))
    add("F.triplet_margin_loss", fn(PF.triplet_margin_loss),
        [("f", L), ("f", L), ("f", L)], (0, 1, 2))
    add("F.sigmoid_focal_loss", fn(PF.sigmoid_focal_loss),
        [("f", A), ("p", A)])
    add("F.log_loss", fn(PF.log_loss), [("p", (L[0], 1)), ("p", (L[0], 1))])
    add("F.dice_loss", fn(PF.dice_loss), [("p", (64, 512, 32)),
                                          (("i", 32), (64, 512, 1))])
    for cls, ins, grad in (
            ("CrossEntropyLoss", [logits, labels], (0,)),
            ("NLLLoss", [logits, labels], (0,)),
            ("MSELoss", [("f", A), ("f", A)], (0, 1)),
            ("L1Loss", [("f", A), ("f", A)], (0, 1)),
            ("SmoothL1Loss", [("f", A), ("f", A)], (0, 1)),
            ("HuberLoss", [("f", A), ("f", A)], (0, 1)),
            ("BCELoss", [("p", A), ("p", A)], (0, 1)),
            ("BCEWithLogitsLoss", [("f", A), ("p", A)], (0, 1)),
            ("KLDivLoss", [("f", A), ("p", A)], (0, 1)),
            ("MarginRankingLoss", [("f", (1 << 20,)), ("f", (1 << 20,)),
                                   ("s", (1 << 20,))], (0, 1)),
            ("HingeEmbeddingLoss", [("f", A), ("s", A)], (0,)),
            ("CosineEmbeddingLoss", [("f", L), ("f", L), ("s", (L[0],))],
             (0, 1)),
            ("TripletMarginLoss", [("f", L), ("f", L), ("f", L)], (0, 1, 2))):
        add(f"nn.{cls}", lambda c=cls: getattr(nn, c)(), ins, grad)

    c = M[1]
    add("F.batch_norm_train", fn(lambda x: PF.batch_norm(
        x, x.new_zeros(c, dtype=torch.float32),
        x.new_ones(c, dtype=torch.float32), training=True)), [("f", M)])
    add("F.instance_norm", fn(lambda x, w, bb: PF.instance_norm(
        x, weight=w, bias=bb)), [("f", M), ("p", (c,)), ("f", (c,))],
        (0, 1, 2))
    add("F.group_norm", fn(lambda x, w, bb: PF.group_norm(x, 32, 1e-5, w,
                                                           bb)),
        [("f", M), ("p", (c,)), ("f", (c,))], (0, 1, 2))
    add("F.group_norm_nhwc", fn(lambda x: PF.group_norm(
        x, 32, data_format="NHWC")), [("f", (M[0], M[2], M[3], c))])
    add("F.local_response_norm", fn(lambda x: PF.local_response_norm(x, 5)),
        [("f", M)])
    add("F.rms_norm", fn(PF.rms_norm), [("f", A), ("p", (A[-1],))], (0, 1))
    add("F.layer_norm", fn(lambda x, w, bb: PF.layer_norm(x, A[-1], w, bb)),
        [("f", A), ("p", (A[-1],)), ("f", (A[-1],))], (0, 1, 2))
    add("F.spectral_norm", fn(lambda w, u, v: PF.spectral_norm(
        w, u, v, power_iters=2)), [("f", (c, c * 9)), ("f", (c,)),
                                   ("f", (c * 9,))], (0,), True)
    for cls, shape in (("BatchNorm", M), ("BatchNorm1D", M1),
                       ("BatchNorm2D", M), ("BatchNorm3D", M3),
                       ("SyncBatchNorm", M), ("InstanceNorm1D", M1),
                       ("InstanceNorm2D", M), ("InstanceNorm3D", M3)):
        add(f"nn.{cls}", lambda k=cls, n=shape[1]: getattr(nn, k)(
            n, device="cpu"), [("f", shape)])
    add("nn.GroupNorm", lambda: nn.GroupNorm(32, c, device="cpu"),
        [("f", M)])
    add("nn.LocalResponseNorm", lambda: nn.LocalResponseNorm(5), [("f", M)])
    add("nn.RMSNorm", lambda: nn.RMSNorm(A[-1], device="cpu"), [("f", A)])
    add("nn.LayerNorm", lambda: nn.LayerNorm(A[-1], device="cpu"),
        [("f", A)])

    for n, shape in ((1, M1), (2, M), (3, M3)):
        add(f"F.max_pool{n}d", fn(lambda x, n=n: getattr(
            PF, f"max_pool{n}d")(x, 3, 2, 1)), [("f", shape)])
        add(f"F.avg_pool{n}d", fn(lambda x, n=n: getattr(
            PF, f"avg_pool{n}d")(x, 3, 2, 1, exclusive=False)),
            [("f", shape)])
        add(f"F.adaptive_avg_pool{n}d", fn(lambda x, n=n: getattr(
            PF, f"adaptive_avg_pool{n}d")(x, 5)), [("f", shape)])
        add(f"F.adaptive_max_pool{n}d_mask", fn(lambda x, n=n: getattr(
            PF, f"adaptive_max_pool{n}d")(x, 5, return_mask=True)),
            [("f", shape)])
        for cls, args in (("MaxPool", (2,)), ("AvgPool", (2,)),
                          ("AdaptiveAvgPool", (7,)),
                          ("AdaptiveMaxPool", (7,))):
            add(f"nn.{cls}{n}D", lambda k=f"{cls}{n}D", a=args: getattr(
                nn, k)(*a), [("f", shape)])
    add("F.max_pool2d_mask_ceil", fn(lambda x: PF.max_pool2d(
        x, 3, 2, 0, return_mask=True, ceil_mode=True)), [("f", M)])
    add("F.avg_pool2d_divisor", fn(lambda x: PF.avg_pool2d(
        x, 3, 2, 1, divisor_override=4)), [("f", M)])
    add("F.max_pool2d_nhwc", fn(lambda x: PF.max_pool2d(
        x, 3, 2, 1, data_format="NHWC")), [("f", (M[0], M[2], M[3], c))])
    add("F.lp_pool1d", fn(lambda x: PF.lp_pool1d(x, 2, 3, 2)),
        [("f", M1)])
    add("F.lp_pool2d", fn(lambda x: PF.lp_pool2d(x, 3, 3, 2)), [("f", M)])

    for n, shape, co in ((1, M1, 64), (2, M, 64), (3, M3, 32)):
        ci = shape[1]
        k = (3,) * n
        add(f"F.conv{n}d", fn(lambda x, w, bb, n=n: getattr(
            PF, f"conv{n}d")(x, w, bb, padding=1)),
            [("f", shape), ("f", (co, ci) + k), ("f", (co,))], (0, 1, 2),
            True)
        add(f"F.conv{n}d_transpose", fn(lambda x, w, bb, n=n: getattr(
            PF, f"conv{n}d_transpose")(x, w, bb, stride=2, padding=1,
                                       output_padding=1, groups=2)),
            [("f", shape), ("f", (ci, co // 2) + k), ("f", (co,))],
            (0, 1, 2), True)
        add(f"nn.Conv{n}D", lambda n=n, ci=ci, co=co: getattr(
            nn, f"Conv{n}D")(ci, co, 3, padding=1, device="cpu"),
            [("f", shape)], (0,), True)
        add(f"nn.Conv{n}DTranspose", lambda n=n, ci=ci, co=co: getattr(
            nn, f"Conv{n}DTranspose")(ci, co, 2, stride=2, device="cpu"),
            [("f", shape)], (0,), True)
    add("F.conv2d_nhwc_groups", fn(lambda x, w: PF.conv2d(
        x, w, padding=1, groups=32, data_format="NHWC")),
        [("f", (M[0], M[2], M[3], c)), ("f", (c, c // 32, 3, 3))], (0, 1),
        True)
    add("nn.Conv2D_reflect", lambda: nn.Conv2D(
        c, 64, 3, padding=1, padding_mode="reflect", device="cpu"),
        [("f", M)], (0,), True)

    for name, kw in (("dropout2d", {}), ("dropout3d", {}),
                     ("alpha_dropout", {})):
        add(f"F.{name}_eval", fn(lambda x, f=getattr(PF, name):
                                 f(x, 0.3, training=False)),
            [("f", M3 if name == "dropout3d" else M)])
    for cls, shape in (("Dropout2D", M), ("Dropout3D", M3),
                       ("AlphaDropout", A)):
        add(f"nn.{cls}_eval", lambda k=cls: getattr(nn, k)(0.3).eval(),
            [("f", shape)])
    add("F.one_hot", fn(lambda y: PF.one_hot(y, L[1])), [labels], ())
    add("F.label_smooth", fn(PF.label_smooth), [("p", L)])
    add("F.cosine_similarity", fn(PF.cosine_similarity), [("f", L),
                                                           ("f", L)],
        (0, 1))
    add("F.normalize", fn(PF.normalize), [("f", M)])
    add("F.pad_reflect", fn(lambda x: PF.pad(x, [1, 2, 3, 0],
                                             mode="reflect")), [("f", M)])
    for mode, shape, size in (
            ("nearest", M, (56, 56)), ("nearest", M, (14, 14)),
            ("bilinear", M, (56, 56)), ("bilinear", M, (14, 14)),
            ("bicubic", M, (56, 56)), ("bicubic", M, (14, 14)),
            ("area", M, (14, 14)), ("linear", M1, (1568,)),
            ("trilinear", M3, (32, 42, 42)), ("nearest", M3, (8, 14, 14))):
        add(f"F.interpolate_{mode}_{'x'.join(map(str, size))}",
            fn(lambda x, m=mode, s=size: PF.interpolate(
                x, size=list(s), mode=m,
                data_format="NC" + "DHW"[-len(s):])),
            [("f", shape)], (0,), mode != "nearest")
    add("F.interpolate_bilinear_align_corners", fn(lambda x: PF.interpolate(
        x, scale_factor=2, mode="bilinear", align_corners=True)),
        [("f", M)], (0,), True)
    add("F.upsample", fn(lambda x: PF.upsample(x, scale_factor=2)),
        [("f", M)])
    add("F.unfold", fn(lambda x: PF.unfold(x, 3, paddings=1)),
        [("f", (M[0], 64, 28, 28))])
    add("F.fold", fn(lambda x: PF.fold(x, [28, 28], 3, paddings=1)),
        [("f", (M[0], 64 * 9, 784))])
    add("F.bilinear", fn(PF.bilinear), [("f", (512, 64)), ("f", (512, 64)),
                                        ("f", (32, 64, 64)),
                                        ("f", (1, 32))], (0, 1, 2, 3), True)
    add("F.pixel_shuffle", fn(lambda x: PF.pixel_shuffle(x, 2)), [("f", M)])
    add("F.pixel_unshuffle", fn(lambda x: PF.pixel_unshuffle(x, 2)),
        [("f", M)])
    add("F.channel_shuffle", fn(lambda x: PF.channel_shuffle(x, 8)),
        [("f", M)])
    for cls, args, shape, heavy in (
            ("Identity", (), M, False), ("Flatten", (), M, False),
            ("Upsample", (None, 2, "bilinear"), M, True),
            ("UpsamplingBilinear2D", (None, 2), M, True),
            ("UpsamplingNearest2D", (None, 2), M, False),
            ("Pad1D", ([2, 1], "replicate"), M1, False),
            ("Pad2D", ([1, 1, 2, 0],), M, False),
            ("Pad3D", ([1, 0, 1, 0, 2, 1], "reflect"), M3, False),
            ("ZeroPad2D", ([1, 2, 1, 0],), M, False),
            ("PixelShuffle", (2,), M, False),
            ("PixelUnshuffle", (2,), M, False),
            ("ChannelShuffle", (4,), M, False),
            ("Unfold", (3, 1, 1), (M[0], 64, 28, 28), False),
            ("Fold", ([28, 28], 3, 1, 1), (M[0], 576, 784), False)):
        add(f"nn.{cls}", lambda k=cls, a=args: getattr(nn, k)(*a),
            [("f", shape)], (0,), heavy)
    add("nn.CosineSimilarity", lambda: nn.CosineSimilarity(axis=-1),
        [("f", L), ("f", L)], (0, 1))
    add("nn.Bilinear", lambda: nn.Bilinear(64, 64, 32, device="cpu"),
        [("f", (512, 64)), ("f", (512, 64))], (0, 1), True)

    for cls, kw in (("SimpleRNN", {}), ("LSTM", {}), ("GRU", {})):
        add(f"nn.{cls}", lambda k=cls: getattr(nn, k)(
            h, h, 2, direction="bidirect", device="cpu").eval(),
            [("f", NN_SEQ)], (0,), True)
    for cls in ("SimpleRNNCell", "LSTMCell", "GRUCell"):
        add(f"nn.{cls}", lambda k=cls: getattr(nn, k)(h, h, device="cpu"),
            [("f", (b, h))], (0,), True)
    add("nn.RNN(GRUCell)", lambda: nn.RNN(nn.GRUCell(h, h, device="cpu")),
        [("f", (b, 16, h))], (0,), True)
    return cases


def _nn_inputs(torch, np, specs, seed):
    """fp32 / int64 CPU tensors of ``specs`` (see nn_sweep_cases)."""
    rng = np.random.default_rng(seed)
    out = []
    for kind, shape in specs:
        if kind == "a":                 # a given array
            out.append(torch.from_numpy(np.asarray(shape)))
            continue
        if kind == "spd":               # symmetric positive definite
            a = rng.standard_normal(shape, dtype=np.float32)
            n = shape[-1]
            arr = (a @ np.swapaxes(a, -1, -2) / n + np.eye(n)).astype(
                np.float32)
        elif kind in ("sym", "sep"):    # eigen / singular values 1..n
            n = shape[-1]
            q1 = np.linalg.qr(rng.standard_normal(shape))[0]
            q2 = q1 if kind == "sym" else np.linalg.qr(
                rng.standard_normal(shape))[0]
            arr = ((q1 * np.arange(1, n + 1)) @ np.swapaxes(q2, -1, -2)
                   ).astype(np.float32)
        elif kind == "f":
            arr = rng.standard_normal(shape, dtype=np.float32)
        elif kind == "p":
            arr = rng.uniform(0.05, 0.95, shape).astype(np.float32)
        elif kind == "pos":             # |normal| + 0.5
            arr = (np.abs(rng.standard_normal(shape)) + 0.5).astype(
                np.float32)
        elif kind == "mask":
            arr = rng.standard_normal(shape) > 0
        elif kind == "s":
            arr = np.where(rng.standard_normal(shape) >= 0, 1.0,
                           -1.0).astype(np.float32)
        else:
            arr = rng.integers(0, kind[1], shape)
        out.append(torch.from_numpy(arr))
    return out


def _nn_flat(out):
    if isinstance(out, (list, tuple)):
        return [y for o in out for y in _nn_flat(o)]
    return [out]


def _nn_call(torch, np, f, params, ins, grad, dtype, device, seed, cots):
    """``f`` on ``ins`` cast to ``dtype`` (floats) on ``device``: its
    outputs and the gradients of sum(out * cotangent) for the inputs in
    ``grad`` and the parameters ``params``. ``cots`` holds the fp32
    cotangents: drawn from ``seed`` by the first call and appended to it,
    reused by the later calls of the case (same shapes)."""
    xs = [(x.to(dtype) if x.is_floating_point() else x).to(device)
          for x in ins]
    xs = [x.requires_grad_(i in grad) if x.is_floating_point() else x
          for i, x in enumerate(xs)]
    outs = _nn_flat(f(*xs))
    floats = [o for o in outs if o.is_floating_point()]
    wrt = [xs[i] for i in grad] + list(params)
    grads = []
    if wrt and any(o.requires_grad for o in floats):
        if not cots:
            rng = np.random.default_rng(seed)
            cots.extend(torch.from_numpy(rng.standard_normal(
                tuple(o.shape), dtype=np.float32)) for o in floats)
        loss = sum((o.float() * c.to(device)).sum()
                   for o, c in zip(floats, cots))
        grads = list(torch.autograd.grad(loss, wrt, allow_unused=True,
                                         materialize_grads=True))
    return outs, grads


def _seed_build(torch, seed):
    """Seed the port's generators and torch's before a case's ``build()``,
    so a layer built here and in the reference process holds the same
    weights."""
    import paddle_tpu_torch as pt

    pt.seed(seed)
    torch.manual_seed(seed)


def _cpu_ref(torch, np, case, dtype, seed, ins, cots):
    """A case's CPU reference in ``dtype`` (fp32 for a heavy case, and for
    one whose op has no CPU bf16 kernel): (outputs, gradients, whether it
    fell back to fp32), the layer built from ``seed``."""
    from paddle_tpu_torch import device

    build, grad, heavy = case[1], case[3], case[4]
    ins = [x.to(dtype) if x.is_floating_point() else x for x in ins]
    place, device._PLACE = device._PLACE, torch.device("cpu")
    try:
        return _cpu_call(torch, np, build, grad, dtype,
                         torch.float32 if heavy else dtype, seed, ins, cots)
    finally:
        device._PLACE = place


def _cpu_call(torch, np, build, grad, dtype, ref_dtype, seed, ins, cots):
    """_cpu_ref's calls, on the CPU place (see there)."""
    fallback = False
    while True:
        _seed_build(torch, seed)
        f_cpu = build()
        is_layer = isinstance(f_cpu, torch.nn.Module)
        if is_layer:   # rounded to dtype first, as the card's copy is
            f_cpu.to(device="cpu", dtype=dtype).to(dtype=ref_dtype)
        try:
            outs, grads = _nn_call(torch, np, f_cpu, list(f_cpu.parameters())
                                   if is_layer else [], ins, grad, ref_dtype,
                                   "cpu", seed + 1, cots)
            break
        except (NotImplementedError, RuntimeError) as e:
            if ref_dtype != torch.bfloat16 or "BFloat16" not in str(e):
                raise
            ref_dtype, fallback = torch.float32, True
    return ([o.detach() for o in outs], [g.detach() for g in grads],
            fallback)


def _nn_case(torch, np, case, dtype, seed, ins, cots, ref):
    """One case in one dtype on the case's fp32 inputs ``ins`` and
    cotangents ``cots`` (see _nn_call), held to its CPU reference ``ref``
    (_cpu_ref): ((worst error, what), outputs and gradients compared,
    whether the CPU reference ran in fp32 for want of a CPU bf16
    kernel)."""
    import copy

    name, build, specs, grad, heavy = case[:5]
    ins = [x.to(dtype) if x.is_floating_point() else x for x in ins]
    _seed_build(torch, seed)
    f_cpu = build()
    is_layer = isinstance(f_cpu, torch.nn.Module)
    f_card = f_cpu
    if is_layer:
        f_cpu.to(dtype=dtype)
        f_card = copy.deepcopy(f_cpu).to(DEVICE)
    out = _nn_call(torch, np, f_card, list(f_card.parameters())
                   if is_layer else [], ins, grad, dtype, DEVICE, seed + 1,
                   cots)
    ref_outs, ref_grads, fallback = ref
    worst = (0.0, "")
    for what, a, r in ([("out", a, r) for a, r in zip(out[0], ref_outs)]
                       + [("grad", a, r) for a, r in zip(out[1],
                                                         ref_grads)]):
        if a.device.type != torch.device(DEVICE).type \
                or tuple(a.shape) != tuple(r.shape):
            raise AssertionError(f"nn sweep {name} {dtype}: {what} on "
                                 f"{a.device} shape {tuple(a.shape)} vs "
                                 f"{tuple(r.shape)}")
        if not a.is_floating_point():
            if not torch.equal(a.cpu(), r):
                raise AssertionError(f"nn sweep {name}: {what} differs")
            continue
        worst = max(worst, (_rel_err(a, r), what))
    return worst, len(out[0]) + len(out[1]), fallback


def sweep_specs(torch, np):
    """The sweeps whose CPU references the reference process computes, in
    the order main() runs them: (label, cases, seed0)."""
    return [("nn sweep", [c + (True, None) for c in nn_sweep_cases(torch)],
             1000),
            ("extras sweep", extras_sweep_cases(torch, np), 4400),
            ("tensor extras sweep", tensor_sweep_cases(torch, np), 4600)]


def _sweep_refs(torch, np, label, cases, seed0):
    """Yield ((label, case index, dtype name), reference) for every case
    and dtype of a sweep, in _sweep's order."""
    for i, case in enumerate(cases):
        ins = _nn_inputs(torch, np, case[2], seed0 + i)
        cots = []
        for name in NN_SWEEP_TOL:
            if name != "float32" and not case[5]:
                continue
            yield (label, i, name), _cpu_ref(
                torch, np, case, getattr(torch, name), seed0 + i, ins, cots)


def _ref_worker(conn, core, root):
    """The reference process (started at phase 1, ROADMAP Queue 1 p): the
    sweeps' CPU references computed off the card's critical path, each
    saved under ``root`` and its path sent to main() (in _sweep's order,
    with the seconds since the process started when it was ready; bytes
    through the pipe itself took 18-23 s a sweep). It runs on the CPU
    only, one thread pinned to ``core`` (with 3 threads, niced or not, its
    OpenMP barriers thrashed against main()'s own CPU references)."""
    import queue
    import threading
    import traceback

    import numpy as np
    import torch

    import paddle_tpu_torch as pt

    t0 = time.perf_counter()
    if core is not None:
        os.sched_setaffinity(0, {core})
    torch.set_num_threads(1)
    pt.set_device("cpu")
    q = queue.Queue()

    def sender():
        while True:
            item = q.get()
            conn.send(item)
            if item[0] is None:
                return

    t = threading.Thread(target=sender, daemon=True)
    t.start()
    try:
        for label, cases, seed0 in sweep_specs(torch, np):
            for key, ref in _sweep_refs(torch, np, label, cases, seed0):
                path = os.path.join(root, "_".join(map(str, key)) + ".pt")
                torch.save(ref, path)
                q.put((key, path, time.perf_counter() - t0))
        q.put((None, "done", time.perf_counter() - t0))
    except BaseException:
        q.put((None, traceback.format_exc(), time.perf_counter() - t0))
    t.join()
    conn.close()


class RefClient:
    """main()'s side of the reference process: ``get(key)`` returns the
    next reference, which must be ``key``'s. The process gets the last
    core of this one's affinity set, and this process (its torch threads
    and the children it starts) the others, until ``close``."""

    def __init__(self):
        import multiprocessing

        import torch

        self.cores = sorted(os.sched_getaffinity(0))
        self.threads = torch.get_num_threads()
        core = self.cores[-1] if len(self.cores) > 1 else None
        ctx = multiprocessing.get_context("spawn")
        self.conn, child = ctx.Pipe(duplex=False)
        self.root = _scratch_dir("refs")
        self.proc = ctx.Process(target=_ref_worker,
                                args=(child, core, self.root), daemon=True)
        self.proc.start()
        child.close()
        if core is not None:
            os.sched_setaffinity(0, set(self.cores[:-1]))
            torch.set_num_threads(min(self.threads, len(self.cores) - 1))
        self.waited = 0.0
        self.ready_at = 0.0

    def get(self, torch, key):
        t0 = time.perf_counter()
        got, path, self.ready_at = self.conn.recv()
        if got != key:
            raise AssertionError(f"reference process: expected {key}, got "
                                 f"{got}: {path if got is None else ''}")
        ref = torch.load(path, weights_only=False, mmap=True)
        os.remove(path)     # the mapping outlives the name
        self.waited += time.perf_counter() - t0
        return ref

    def close(self):
        import torch

        self.conn.close()
        self.proc.terminate()
        self.proc.join(10)
        shutil.rmtree(self.root, ignore_errors=True)
        os.sched_setaffinity(0, set(self.cores))
        torch.set_num_threads(self.threads)


# main()'s reference process (None: each sweep computes its references
# inline, as a phase run alone does)
REFS = None


def _sweep(torch, np, cases, seed0, label, card):
    """Phases 42, 44 and 46: each case (name, build, inputs, grad, heavy,
    bf16, tol) card against CPU in fp32 and, where ``bf16``, in bf16,
    within ``tol`` (fp32) or NN_SWEEP_TOL; its inputs and cotangents drawn
    once (from ``seed0`` + its index) for both dtypes; the CPU references
    from the reference process (REFS) where main() started one. Prints a
    line a dtype (the worst error over its tolerance, the next five, the
    seconds that dtype took on the card) and raises, after both, on any
    case beyond tolerance."""
    stats = {name: dict(rows=[], tensors=0, fallbacks=[], secs=0.0, n=0)
             for name in NN_SWEEP_TOL}
    failed = []
    waited = REFS.waited if REFS is not None else 0.0
    for i, case in enumerate(cases):
        t0 = time.perf_counter()
        ins = _nn_inputs(torch, np, case[2], seed0 + i)
        cots = []
        share = (time.perf_counter() - t0) / (2 if case[5] else 1)
        for name, tol in NN_SWEEP_TOL.items():
            if name != "float32" and not case[5]:
                continue
            st, dt = stats[name], getattr(torch, name)
            if REFS is not None:
                ref = REFS.get(torch, (label, i, name))
            else:
                ref = _cpu_ref(torch, np, case, dt, seed0 + i, ins, cots)
            t_ref = time.perf_counter()
            (err, what), n, fallback = _nn_case(
                torch, np, case, dt, seed0 + i, ins, cots, ref)
            case_tol = case[6] if case[6] and name == "float32" else tol
            st["rows"].append((err / case_tol, err, case[0], what, case_tol))
            st["tensors"] += n
            st["n"] += 1
            st["secs"] += time.perf_counter() - t_ref + share
            if fallback:
                st["fallbacks"].append(case[0])
            if not err <= case_tol:
                failed.append(f"{case[0]} {name} {what} {err:.3e} > "
                              f"{case_tol}")
    for name, st in stats.items():
        rows = sorted(st["rows"], reverse=True)
        print(f"{label} {getattr(torch, name)} [{card}]: {st['n']} cases, "
              f"{st['tensors']} outputs and gradients on the card, worst "
              f"card vs CPU error {rows[0][1]:.3e} ({rows[0][2]} "
              f"{rows[0][3]}; tol {rows[0][4]}) in {st['secs']:.1f}s; next "
              f"by error over tolerance: "
              + ", ".join(f"{n} {w} {e:.2e} (tol {t})"
                          for _, e, n, w, t in rows[1:6])
              + (f"; CPU reference in fp32 (no CPU bf16 kernel): "
                 f"{', '.join(st['fallbacks'])}" if st["fallbacks"] else ""),
              flush=True)
    if REFS is not None:
        print(f"{label}: CPU references from the reference process (the "
              f"last ready {REFS.ready_at:.1f}s after it started; waited "
              f"{REFS.waited - waited:.1f}s for them)", flush=True)
    if failed:
        raise AssertionError(f"{label}, card vs CPU beyond tolerance: "
                             + "; ".join(failed))
    _release(torch)


def _nn_random_on_card(torch, card):
    """The random functionals in training on the card: masks at their
    rates (6 binomial standard deviations), whole channels for
    dropout2d/3d, rrelu's slopes in [lower, upper], gumbel_softmax rows
    distributions."""
    import paddle_tpu_torch.nn.functional as PF

    gen = torch.Generator(device=DEVICE).manual_seed(42)
    x = torch.ones(NN_MAP, device=DEVICE)
    d2 = PF.dropout2d(x, 0.25, generator=gen).flatten(2)
    kept = (d2[..., 0] != 0).float().mean().item()
    sd = (0.75 * 0.25 / d2[..., 0].numel()) ** 0.5
    whole = bool((d2 == d2[..., :1]).all())
    d3 = PF.dropout3d(torch.ones(NN_MAP3, device=DEVICE), 0.5,
                      generator=gen).flatten(2)
    a = PF.alpha_dropout(torch.randn(NN_ACT, device=DEVICE, generator=gen),
                         0.2, generator=gen)
    r = PF.rrelu(-torch.ones(NN_ACT, device=DEVICE), 0.1, 0.3,
                 training=True, generator=gen)
    g = PF.gumbel_softmax(torch.randn(NN_LOGITS, device=DEVICE,
                                      generator=gen), generator=gen)
    ok = (abs(kept - 0.75) < 6 * sd and whole
          and bool((d3 == d3[..., :1]).all())
          and abs(a.mean().item()) < 0.01 and abs(a.std().item() - 1) < 0.01
          and -0.3 <= r.min().item() and r.max().item() <= -0.1
          and torch.allclose(g.sum(-1), torch.ones(NN_LOGITS[0],
                                                   device=DEVICE))
          and all(t.device.type == torch.device(DEVICE).type
                  for t in (d2, d3, a, r, g)))
    print(f"nn sweep random [{card}]: dropout2d kept {kept:.5f} (0.75 +- "
          f"{6 * sd:.5f}, whole channels {whole}), alpha_dropout mean "
          f"{a.mean().item():.4f} std {a.std().item():.4f}, rrelu slopes "
          f"[{-r.max().item():.4f}, {-r.min().item():.4f}]", flush=True)
    if not ok:
        raise AssertionError("nn sweep: a random functional on the card "
                             "missed its rate")


def phase_nn_sweep(torch, np, ops, card):
    """Phase 42: every functional and layer of the nn slice, forward and
    backward, fp32 and bf16, card against CPU (NN_SWEEP_TOL); K1-K6 must
    not launch."""
    import paddle_tpu_torch as pt

    pt.set_device(DEVICE)
    _reset_counts(ops)
    _sweep(torch, np, [c + (True, None) for c in nn_sweep_cases(torch)],
           1000, "nn sweep", card)
    _nn_random_on_card(torch, card)
    counts = _no_kernel_ran(ops, "nn sweep")
    print(f"nn sweep: K1-K6 launches {counts}", flush=True)
    _release(torch)


def _unique_unpool(np, rng, nc, spatial, k):
    """Pooled values' flat indices for max_unpool: one element of each
    non-overlapping k-window (unique, so the scatter is defined)."""
    out_sp = [s // k for s in spatial]
    grids = np.meshgrid(*[np.arange(o) for o in out_sp], indexing="ij")
    flat = np.zeros(tuple(nc) + tuple(out_sp), np.int64)
    for d, g in enumerate(grids):
        coord = g[None, None] * k + rng.integers(0, k, tuple(nc)
                                                 + tuple(out_sp))
        flat = flat * spatial[d] + coord
    return flat.astype(np.int32), out_sp


def extras_sweep_cases(torch, np):
    """Phase 44's cases: (name, build, inputs, grad, heavy, bf16, tol) as
    in nn_sweep_cases, bf16 marking the cases also run in bf16 and tol,
    where not None, the case's fp32 tolerance (EXTRAS_LATTICE_TOL,
    EXTRAS_SPECTRAL_TOL). The nn
    extras (every functional and layer of nn/functional/extras.py and
    nn/layer/extras.py), the five arguments the nn slice refused, and
    every paddle.linalg function (fp32: cuSOLVER has no bf16). Functions
    defined up to a sign or phase (qr, svd, eig, eigh, the low-rank SVDs)
    compare their reconstructions and values."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.nn.functional as PF
    from paddle_tpu_torch import nn

    rng = np.random.default_rng(44)
    M, A, L = NN_MAP, NN_ACT, NN_LOGITS
    cases = []

    def add(name, build, inputs, grad=(0,), heavy=False, bf16=True,
            tol=None):
        cases.append((name, build, inputs, grad, heavy, bf16, tol))

    def fn(f):
        return lambda: f

    def arr(a):
        return ("a", a)

    # pools, unpools, padding
    add("F.max_pool2d_with_mask", fn(lambda x: PF.max_pool2d_with_mask(
        x, 3, 2, 1)), [("f", M)])
    for n, sp in ((1, (M[2] * M[3],)), (2, M[2:]), (3, NN_MAP3[2:])):
        nc = (M[0], M[1]) if n < 3 else NN_MAP3[:2]
        idx, osp = _unique_unpool(np, rng, nc, sp, 2)
        add(f"F.max_unpool{n}d", fn(lambda x, i, n=n: getattr(
            PF, f"max_unpool{n}d")(x, i, 2)),
            [("f", tuple(nc) + tuple(osp)), arr(idx)])
    add("nn.MaxUnPool2D", lambda: nn.MaxUnPool2D(2),
        [("f", (M[0], M[1], M[2] // 2, M[3] // 2)),
         arr(_unique_unpool(np, rng, M[:2], M[2:], 2)[0])])
    for n, shape, out in ((2, M, [11, 9]), (3, NN_MAP3, [7, 11, 9])):
        add(f"F.fractional_max_pool{n}d_mask", fn(
            lambda x, n=n, o=out: getattr(PF, f"fractional_max_pool{n}d")(
                x, o, random_u=0.37, return_mask=True)), [("f", shape)])
    add("nn.FractionalMaxPool2D", lambda: nn.FractionalMaxPool2D(
        13, random_u=0.6), [("f", M)])
    add("F.zeropad2d", fn(lambda x: PF.zeropad2d(x, [1, 2, 0, 3])),
        [("f", M)])
    add("nn.ZeroPad1D", lambda: nn.ZeroPad1D([2, 1]), [("f", NN_MAP1)])
    add("nn.ZeroPad3D", lambda: nn.ZeroPad3D([1, 0, 2, 1, 0, 1]),
        [("f", NN_MAP3)])
    add("nn.LPPool1D", lambda: nn.LPPool1D(2, 3, 2), [("f", NN_MAP1)])
    add("nn.LPPool2D", lambda: nn.LPPool2D(3, 2), [("f", M)])

    # losses
    lab = ("i", L[1]), (L[0],)
    add("F.soft_margin_loss", fn(PF.soft_margin_loss), [("f", A), ("s", A)],
        (0,))
    add("F.multi_label_soft_margin_loss", fn(
        lambda x, y, w: PF.multi_label_soft_margin_loss(x, y, w)),
        [("f", L), ("a", rng.integers(0, 2, L).astype(np.float32)),
         ("p", (L[1],))])
    add("F.multi_margin_loss", fn(lambda x, y, w: PF.multi_margin_loss(
        x, y, 2, 0.7, w)), [("f", L), lab, ("p", (L[1],))])
    add("F.poisson_nll_loss", fn(lambda x, y: PF.poisson_nll_loss(
        x, y, full=True)), [("f", A), ("p", A)])
    add("F.gaussian_nll_loss", fn(lambda x, y, v: PF.gaussian_nll_loss(
        x, y, v, full=True)), [("f", A), ("f", A), ("p", A)], (0, 1, 2))
    add("F.pairwise_distance", fn(lambda x, y: PF.pairwise_distance(
        x, y, 3.0)), [("f", L), ("f", L)], (0, 1))
    add("F.triplet_margin_with_distance_loss", fn(
        lambda a, p, n: PF.triplet_margin_with_distance_loss(
            a, p, n, swap=True)), [("f", L), ("f", L), ("f", L)], (0, 1, 2))
    add("F.npair_loss", fn(PF.npair_loss), [("f", (512, 256)),
                                            ("f", (512, 256)),
                                            (("i", 64), (512,))], (0, 1))
    add("F.margin_cross_entropy", fn(lambda x, y: PF.margin_cross_entropy(
        torch.tanh(x), y, return_softmax=True)), [("f", L), lab])
    for cls, ins, grad in (
            ("SoftMarginLoss", [("f", A), ("s", A)], (0,)),
            ("MultiMarginLoss", [("f", L), lab], (0,)),
            ("PoissonNLLLoss", [("f", A), ("p", A)], (0,)),
            ("GaussianNLLLoss", [("f", A), ("f", A), ("p", A)], (0, 1, 2)),
            ("TripletMarginWithDistanceLoss", [("f", L), ("f", L),
                                               ("f", L)], (0, 1, 2)),
            ("PairwiseDistance", [("f", L), ("f", L)], (0, 1))):
        add(f"nn.{cls}", lambda c=cls: getattr(nn, c)(), ins, grad)
    add("nn.MultiLabelSoftMarginLoss", lambda: nn.MultiLabelSoftMarginLoss(),
        [("f", L), ("a", rng.integers(0, 2, L).astype(np.float32))])

    # CTC and RNN-T at EXTRAS_CTC / EXTRAS_RNNT
    t, b, c = EXTRAS_CTC["T"], EXTRAS_CTC["batch"], EXTRAS_CTC["classes"]
    lo, hi = EXTRAS_CTC["labels"]
    ll = rng.integers(lo, hi + 1, b)
    ctc_in = [("f", (t, b, c)), arr(rng.integers(1, c, (b, hi))),
              arr(rng.integers(t // 2, t + 1, b)), arr(ll)]
    for red in ("mean", "none"):
        add(f"F.ctc_loss_{red}", fn(lambda x, y, il, ll, r=red: PF.ctc_loss(
            x, y, il, ll, reduction=r)), ctc_in, (0,), False, red == "mean",
            EXTRAS_LATTICE_TOL)
    add("F.ctc_loss_norm_by_times", fn(lambda x, y, il, ll: PF.ctc_loss(
        x, y, il, ll, norm_by_times=True)), ctc_in, (0,), False, False,
        EXTRAS_LATTICE_TOL)
    add("nn.CTCLoss", lambda: nn.CTCLoss(reduction="sum"), ctc_in, (0,),
        False, False, EXTRAS_LATTICE_TOL)
    rb, rt, ru, rc = (EXTRAS_RNNT[k] for k in ("batch", "T", "U", "classes"))
    rnnt_in = [("f", (rb, rt, ru + 1, rc)), arr(rng.integers(1, rc, (rb, ru))),
               arr(np.array([rt, rt - 37, rt // 2, rt - 1][:rb])),
               arr(np.array([ru, ru - 9, ru // 3, 1][:rb]))]
    add("F.rnnt_loss_fastemit", fn(lambda x, y, tl, ul: PF.rnnt_loss(
        x, y, tl, ul, fastemit_lambda=0.01)), rnnt_in, (0,), False, False,
        EXTRAS_LATTICE_TOL)
    add("nn.RNNTLoss", lambda: nn.RNNTLoss(reduction="none"), rnnt_in, (0,),
        False, False, EXTRAS_LATTICE_TOL)

    # hierarchical sigmoid, adaptive softmax
    hv, hf = 1000, 256
    add("F.hsigmoid_loss", fn(lambda x, y, w, bb: PF.hsigmoid_loss(
        x, y, hv, w, bb)), [("f", (512, hf)), (("i", hv), (512,)),
                            ("f", (hv - 1, hf)), ("f", (hv - 1,))],
        (0, 2, 3))
    table = np.array([[0, 1, 3, -1], [0, 1, 4, 6], [0, 2, 5, -1],
                      [0, 2, 5, 7]])
    code = np.array([[0, 0, 1, 0], [0, 1, 0, 1], [1, 0, 1, 0], [1, 0, 0, 1]])
    add("F.hsigmoid_loss_custom", fn(lambda x, y, w: PF.hsigmoid_loss(
        x, y, 4, w, path_table=table, path_code=code)),
        [("f", (512, hf)), (("i", 4), (512,)), ("f", (8, hf))], (0, 2))
    add("nn.HSigmoidLoss", lambda: nn.HSigmoidLoss(hf, hv, device="cpu"),
        [("f", (512, hf)), (("i", hv), (512,))])
    add("nn.AdaptiveLogSoftmaxWithLoss", lambda: nn.AdaptiveLogSoftmaxWithLoss(
        512, 20000, [2000, 10000], head_bias=True, device="cpu"),
        [("f", (256, 512)), (("i", 20000), (256,))], (0,), True)

    # sampling, shifts, masks
    n, ch, hh, ww = EXTRAS_GRID
    add("F.affine_grid", fn(lambda th: PF.affine_grid(th, [n, ch, hh, ww])),
        [("f", (n, 2, 3))])
    add("F.affine_grid_3d", fn(lambda th: PF.affine_grid(
        th, [2, 3, 8, 16, 16], align_corners=False)), [("f", (2, 3, 4))])
    for mode, pm, ac in (("bilinear", "zeros", True),
                         ("bilinear", "border", False),
                         ("bilinear", "reflection", True),
                         ("bilinear", "reflection", False),
                         ("nearest", "zeros", False),
                         ("nearest", "reflection", True)):
        add(f"F.grid_sample_{mode}_{pm}_{ac}", fn(
            lambda x, g, m=mode, p=pm, a=ac: PF.grid_sample(
                x, g * 1.2, m, p, a)),
            [("f", (n, ch, hh, ww)), ("p", (n, hh, ww, 2))],
            (0, 1) if mode == "bilinear" else (0,))
    add("F.temporal_shift", fn(lambda x: PF.temporal_shift(x, 8)),
        [("f", M)])
    add("F.softmax_2d", fn(PF.softmax_2d), [("f", M)])
    add("nn.Softmax2D", lambda: nn.Softmax2D(), [("f", M)])
    add("nn.Unflatten", lambda: nn.Unflatten(1, [16, 16]), [("f", M)])
    add("F.sequence_mask", fn(lambda x: PF.sequence_mask(x, 512, "float32")),
        [(("i", 512), (4096,))], ())
    sb, sh, ss, sd = 4, 8, 256, 64
    rows = rng.integers(1, 32, (sb, sh, ss))
    off = np.concatenate([np.zeros((sb, sh, 1), np.int64),
                          np.cumsum(rows, -1)], -1).astype(np.int32)
    cols = rng.integers(0, ss, (sb, sh, int(off[..., -1].max())))
    add("F.sparse_attention", fn(lambda q, k, v, o, c, m: PF.sparse_attention(
        q, k, v, o, c, key_padding_mask=m)),
        [("f", (sb, sh, ss, sd))] * 3 + [arr(off), arr(cols.astype(np.int32)),
                                         arr((rng.uniform(size=(sb, ss)) > 0.1)
                                             .astype(np.float32))],
        (0, 1, 2))
    add("F.gather_tree", fn(PF.gather_tree), [(("i", 1000), (64, 32, 8)),
                                              (("i", 8), (64, 32, 8))], ())
    for name, args in (("elu_", (0.7,)), ("hardtanh_", (-0.5, 0.4)),
                       ("leaky_relu_", (0.2,)), ("tanh_", ()),
                       ("thresholded_relu_", (0.3,))):
        add(f"F.{name}", fn(lambda x, n=name, a=args: getattr(PF, n)(
            x * 1.0, *a)), [("f", A)])
    add("F.feature_alpha_dropout_eval", fn(lambda x: PF.feature_alpha_dropout(
        x, 0.3, training=False)), [("f", M)])
    add("nn.SpectralNorm", lambda: nn.SpectralNorm([256, 64, 3, 3],
                                                   power_iters=3,
                                                   device="cpu"),
        [("f", (256, 64, 3, 3))], (0,), True)

    # the five arguments
    add("F.conv2d_transpose_same", fn(lambda x, w: PF.conv2d_transpose(
        x, w, stride=2, padding="SAME")), [("f", M), ("f", (M[1], 64, 3, 3))],
        (0, 1), True)
    add("F.interpolate_bilinear_align_mode1", fn(lambda x: PF.interpolate(
        x, size=[41, 50], mode="bilinear", align_mode=1)), [("f", M)], (0,),
        True)
    add("F.interpolate_trilinear_align_mode1", fn(lambda x: PF.interpolate(
        x, scale_factor=1.5, mode="trilinear", align_mode=1,
        data_format="NCDHW")), [("f", NN_MAP3)], (0,), True)
    add("F.instance_norm_running", fn(lambda x, rm, rv: PF.instance_norm(
        x, rm, rv, use_input_stats=False)),
        [("f", M), ("f", (M[1],)), ("p", (M[1],))])
    add("F.cross_entropy_soft_weight", fn(lambda x, y, w: PF.cross_entropy(
        x, y, w, soft_label=True)), [("f", L), ("p", L), ("p", (L[1],))],
        (0, 1, 2))
    b_, t_, h_ = NN_SEQ
    lens = rng.integers(t_ // 4, t_ + 1, b_)

    class _SeqLen(torch.nn.Module):
        """A recurrent layer called with ``sequence_length`` (host ints)."""

        def __init__(self, layer, lengths):
            super().__init__()
            self.layer, self.lengths = layer, lengths

        def forward(self, x):
            return self.layer(x, sequence_length=self.lengths)

    for cls in ("SimpleRNN", "LSTM", "GRU"):
        add(f"nn.{cls}_sequence_length", lambda k=cls: _SeqLen(getattr(nn, k)(
            h_, h_, 2, direction="bidirect", device="cpu").eval(), lens),
            [("f", NN_SEQ)], (0,), True)
    add("nn.BiRNN_sequence_length", lambda: _SeqLen(nn.BiRNN(
        nn.GRUCell(h_, h_, device="cpu"), nn.GRUCell(h_, h_, device="cpu")),
        lens), [("f", (b_, 16, h_))], (0,), True)
    g = EXTRAS_GRU
    glens = rng.integers(g["frames"] // 4, g["frames"] + 1, g["batch"])
    add("nn.GRU_ds2_width_sequence_length", lambda: _SeqLen(nn.GRU(
        g["input"], g["hidden"], direction="bidirect", device="cpu").eval(),
        glens), [("f", (g["batch"], g["frames"], g["input"]))], (0,), True,
        False)

    # paddle.linalg (fp32; bf16 only for the products and norms)
    lb, ln = EXTRAS_LINALG
    sq, spd = ("f", (lb, ln, ln)), ("spd", (lb, ln, ln))
    sym, sep = ("sym", (lb, ln, ln)), ("sep", (lb, ln, ln))
    well = ("a", (rng.standard_normal((lb, ln, ln)) * 0.3 / ln ** 0.5
                  + np.eye(ln)).astype(np.float32))
    LA = pt.linalg

    def la(name, f, inputs, grad=(0,), bf16=False, tol=None):
        add(f"linalg.{name}", fn(f), inputs, grad, False, bf16, tol)

    la("dot", LA.dot, [("f", (4096, 256)), ("f", (4096, 256))], (0, 1), True)
    la("bmm", LA.bmm, [sq, sq], (0, 1), True)
    la("mv", LA.mv, [("f", (4096, 1024)), ("f", (1024,))], (0, 1), True)
    la("multi_dot", lambda a, b, c: LA.multi_dot([a, b, c]),
       [("f", (512, 256)), ("f", (256, 1024)), ("f", (1024, 64))], (0, 1, 2),
       True)
    for p, ax in ((None, None), ("fro", [1, 2]), ("nuc", [1, 2]), (2, -1),
                  ("inf", None), (1, [1, 2])):
        la(f"norm_{p}_{ax}", lambda a, p=p, ax=ax: LA.norm(a, p, ax), [sq],
           (0,), p in (None, "fro", 2))
    la("vector_norm", lambda a: LA.vector_norm(a, 3.0, [1, 2]), [sq])
    la("matrix_norm", lambda a: LA.matrix_norm(a, 2), [sq])
    la("cond", LA.cond, [well], ())
    la("cholesky", lambda a: LA.cholesky(a, upper=True), [spd])
    chol = ("a", np.linalg.cholesky(well[1] @ np.swapaxes(well[1], -1, -2))
            .astype(np.float32))
    la("cholesky_solve", LA.cholesky_solve, [("f", (lb, ln, 16)), chol],
       (0, 1))
    la("cholesky_inverse", LA.cholesky_inverse, [chol])
    la("inv", LA.inv, [well])
    la("pinv", LA.pinv, [("f", (lb, ln, ln // 2))])
    la("det", LA.det, [well])
    la("slogdet", LA.slogdet, [well])
    la("solve", LA.solve, [well, ("f", (lb, ln, 16))], (0, 1))
    la("triangular_solve", lambda a, b: LA.triangular_solve(
        a, b, upper=False, transpose=True), [("a", np.tril(
            rng.standard_normal((lb, ln, ln)) * 0.1).astype(np.float32)
            + 2 * np.eye(ln, dtype=np.float32)), ("f", (lb, ln, 16))], (0, 1))
    la("lstsq", LA.lstsq, [("f", (256, 128)), ("f", (256, 16))], ())
    la("lu", LA.lu, [well], ())
    lu_np = torch.linalg.lu_factor(torch.from_numpy(well[1]))
    la("lu_unpack", LA.lu_unpack, [arr(lu_np[0].numpy()),
                                   arr(lu_np[1].numpy())], ())
    la("matrix_power", lambda a: LA.matrix_power(a, 3), [well])
    low = rng.standard_normal((lb, ln, 8)) @ rng.standard_normal((8, ln))
    la("matrix_rank", LA.matrix_rank, [arr(low.astype(np.float32))], ())
    la("matrix_exp", LA.matrix_exp, [("a", (rng.standard_normal(
        (lb, 32, 32)) * 0.1).astype(np.float32))])
    la("eigvalsh", LA.eigvalsh, [sym], tol=EXTRAS_SPECTRAL_TOL)
    la("svdvals", LA.svdvals, [sep], tol=EXTRAS_SPECTRAL_TOL)
    la("cross", lambda a, b: LA.cross(a, b), [("f", (64, 3, 4096)),
                                             ("f", (64, 3, 4096))], (0, 1),
       True)
    geqrf = torch.geqrf(torch.from_numpy(rng.standard_normal(
        (lb, ln, 64)).astype(np.float32)))
    la("householder_product", LA.householder_product,
       [arr(geqrf[0].numpy()), arr(geqrf[1].numpy())], (0, 1))
    la("ormqr", lambda a, tau, y: LA.ormqr(a, tau, y, transpose=True),
       [arr(geqrf[0].numpy()), arr(geqrf[1].numpy()), ("f", (lb, ln, 16))],
       (2,))
    la("corrcoef", LA.corrcoef, [("f", (128, 4096))])
    la("cov", lambda a, fw, aw: LA.cov(a, fweights=fw, aweights=aw),
       [("f", (128, 4096)), arr(rng.integers(1, 4, 4096)),
        ("p", (4096,))], (0,))
    # Hopper's fp8 MMA accumulates with ~14 bits of mantissa (DeepSeek-V3
    # report, section 3.3.2; 2.9e-4 seen): tolerance 1e-3
    add("linalg.fp8_gemm", fn(lambda a, b, bb: LA.fp8_fp8_half_gemm_fused(
        a, b, bb, output_dtype="float32", activation_type="gelu")),
        [("f", (1024, 512)), ("f", (512, 1024)), ("f", (1024,))], (), False,
        False, 1e-3)
    # up to sign or phase: reconstructions and values
    la("qr", lambda a: (lambda q, r: (q @ r, r.abs(), q.mT @ q))(
        *LA.qr(a)), [well])
    la("svd", lambda a: (lambda u, s, v: (u * s[..., None, :] @ v.mT, s))(
        *LA.svd(a)), [sep], tol=EXTRAS_SPECTRAL_TOL)
    la("eigh", lambda a: (lambda w, v: (w, v * w[..., None, :] @ v.mT))(
        *LA.eigh(a)), [sym], tol=EXTRAS_SPECTRAL_TOL)

    def _sorted(w):
        w = w[torch.argsort(w.imag, stable=True)]
        w = w[torch.argsort(w.real, stable=True)]
        return torch.stack([w.real, w.imag])

    la("eig_values", lambda a: _sorted(LA.eig(a)[0]), [("f", (ln, ln))], ())
    la("eigvals", lambda a: _sorted(LA.eigvals(a)), [("f", (ln, ln))], ())
    la("pca_lowrank", lambda a: (lambda u, s, v: (u * s @ v.T, s))(
        *LA.pca_lowrank(a, 8)), [("sep", (128, 128))],
       tol=EXTRAS_SPECTRAL_TOL)
    # a rank-8 matrix sketched by 12 vectors (oversampled: the sketch's
    # conditioning, and so its error, does not hang on one 8 x 8 draw);
    # the two devices' generators draw different sketches
    la("svd_lowrank", lambda a: (lambda u, s, v: u * s[..., None, :] @ v.mT)(
        *LA.svd_lowrank(a, 12, niter=0)), [arr(low.astype(np.float32))], (),
       tol=EXTRAS_SPECTRAL_TOL)
    return cases


def _extras_random_on_card(torch, card):
    """The random extras on the card: feature_alpha_dropout drops whole
    channels at its rate; class_center_sample keeps every positive, sorted,
    its remap inverting; a fractional pool without random_u draws new
    intervals from the port's CPU generator."""
    import paddle_tpu_torch.nn.functional as PF

    gen = torch.Generator(device=DEVICE).manual_seed(44)
    x = torch.randn(NN_MAP, device=DEVICE, generator=gen)
    y = PF.feature_alpha_dropout(x, 0.3, generator=gen)
    q, alpha_p = 0.7, -1.7580993408473766
    a = (q + alpha_p ** 2 * q * 0.3) ** -0.5
    # a dropped element is exactly a alpha' + b in fp32 (a kept one equals
    # it only where x == alpha'); isclose would also take kept neighbours
    dropped = y == a * torch.full_like(y, alpha_p) - a * alpha_p * 0.3
    frac = dropped.flatten(2).float().mean(-1)
    rate = frac.mean().item()
    sd = (0.3 * 0.7 / frac.numel()) ** 0.5
    labels = torch.randint(0, 50000, (4096,), device=DEVICE, generator=gen)
    remap, chosen = PF.class_center_sample(labels, 50000, 8192)
    kept = bool(torch.equal(chosen[remap], labels)
                and (chosen[1:] > chosen[:-1]).all())
    z = torch.randn(NN_MAP, device=DEVICE, generator=gen)
    draws = {tuple(PF.fractional_max_pool2d(z, 11).flatten()[:64].tolist())
             for _ in range(4)}
    ok = (bool(((frac == 0) | (frac == 1)).all()) and abs(rate - 0.3) < 6 * sd
          and kept and len(draws) > 1
          and all(t.device.type == "cuda" for t in (y, remap, chosen)))
    print(f"extras sweep random [{card}]: feature_alpha_dropout dropped "
          f"{rate:.5f} of whole channels (0.3 +- {6 * sd:.5f}); "
          f"class_center_sample kept every positive of 4096 labels among "
          f"8192 of 50000 classes: {kept}; fractional pool draws "
          f"{len(draws)} distinct of 4", flush=True)
    if not ok:
        raise AssertionError("extras sweep: a random extra on the card "
                             "missed its rule")


def phase_extras_sweep(torch, np, ops, card):
    """Phase 44: every new function and layer of the nn extras, the five
    arguments and paddle.linalg, forward and backward, card against CPU
    (fp32, and bf16 where the case takes it; NN_SWEEP_TOL); K1-K6 must not
    launch."""
    import paddle_tpu_torch as pt

    pt.set_device(DEVICE)
    _reset_counts(ops)
    _sweep(torch, np, extras_sweep_cases(torch, np), 4400, "extras sweep",
           card)
    _extras_random_on_card(torch, card)
    counts = _no_kernel_ran(ops, "extras sweep")
    print(f"extras sweep: K1-K6 launches {counts}", flush=True)
    _release(torch)


def _ds2_parity(torch, np, pt, card, feats=None, lens=None):
    """DS2_PARITY: the first step's loss and every gradient, card vs CPU
    from the same weights (BatchNorm in training), on ds2_batch's
    features or on ``feats`` [batch, frames, freq] of ``lens``."""
    p = DS2_PARITY
    drawn, drawn_lens, labels, lab_lens = ds2_batch(np, p, 45)
    if feats is None:
        feats, lens = drawn, drawn_lens
    runs = []
    pt.seed(0)
    cpu = deepspeech2(pt, p, "cpu")
    gpu = deepspeech2(pt, p, DEVICE)
    _copy_state(torch, gpu, cpu)
    for m, dev in ((cpu, "cpu"), (gpu, DEVICE)):
        pt.set_device(dev)
        loss = ds2_loss(pt, m, pt.to_tensor(feats), lens,
                        pt.to_tensor(labels), pt.to_tensor(lab_lens))
        runs.append((loss.item(), torch.autograd.grad(
            loss, list(m.parameters()))))
    pt.set_device(DEVICE)
    (lc, gc), (lg, gg) = runs
    loss_rel = abs(lg - lc) / abs(lc)
    top = max(a.abs().max().item() for a in gc)
    names = [n for n, _ in cpu.named_parameters()]
    worst = max((((b.cpu() - a).abs().max()
                  / max(a.abs().max().item(), top / 256)).item(), n)
                for n, a, b in zip(names, gc, gg))
    on_card = all(g.device.type == "cuda" for g in gg)
    print(f"ds2 parity [{card}]: channels {p['channels']}, GRUs of "
          f"{p['hidden']}, {p['vocab']} classes, batch {p['batch']} of "
          f"{lens.min()}-{lens.max()} frames: first step loss cpu {lc:.6f} "
          f"card {lg:.6f} (rel {loss_rel:.3e}); gradients worst "
          f"{worst[0]:.3e} of the parameter's largest (or 2^-8 of the "
          f"largest of all) ({worst[1]}, tol {p['tol']})", flush=True)
    if not (loss_rel <= p["tol"] and worst[0] <= p["tol"] and on_card):
        raise AssertionError(f"ds2 card vs CPU: loss {loss_rel}, gradients "
                             f"{worst}, on card {on_card}")


def phase_ds2(torch, np, ops, card):
    """Phase 45: the DeepSpeech2-class acoustic model of DS2 trained with
    CTC (Adam, the global-norm clip; eager loss.backward / step /
    clear_grad) on one fixed batch; K1-K6 must not launch."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import nn, optimizer

    c, t = DS2, DS2_TIMED
    pt.set_device(DEVICE)
    _reset_counts(ops)
    t_parity = time.perf_counter()
    _ds2_parity(torch, np, pt, card)
    t_parity = time.perf_counter() - t_parity
    _release(torch)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    pt.seed(0)
    model = deepspeech2(pt, c, DEVICE)
    opt = optimizer.Adam(c["lr"], parameters=model.parameters(),
                         grad_clip=nn.ClipGradByGlobalNorm(c["clip"]))
    feats, lens, labels, lab_lens = ds2_batch(np, c, 0)
    x, y, yl = (pt.to_tensor(a) for a in (feats, labels, lab_lens))

    def step():
        loss = ds2_loss(pt, model, x, lens, y, yl)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    def eval_loss():
        model.eval()
        with torch.no_grad():
            out = ds2_loss(pt, model, x, lens, y, yl).item()
        model.train()
        return out

    before = eval_loss()
    losses = [step().item() for _ in range(t["warmup"])]
    sync()
    t0 = time.perf_counter()
    timed = [step() for _ in range(t["steps"])]
    sync()
    wall = time.perf_counter() - t0
    losses += [v.item() for v in timed]
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    after = eval_loss()
    t_prof = time.perf_counter()
    kernels = _kernels_per_step(torch, step)
    t_prof = time.perf_counter() - t_prof
    n_params = sum(p.numel() for p in model.parameters())
    ms = wall / t["steps"] * 1e3
    frames = int(lens.sum())
    print(f"ds2 [{card}]: ms_per_step={ms:.2f} utterances_per_s="
          f"{c['batch'] * t['steps'] / wall:.1f} frames_per_s="
          f"{frames * t['steps'] / wall:.1f} peak_mem_gb={peak:.3f} (over "
          f"the {base / 1e9:.3f} GB earlier phases hold) kernels_per_step="
          f"{kernels if kernels else 'not measured (no device event)'} "
          f"({n_params / 1e6:.2f}M params; 2 x Conv2D(32) + BatchNorm2D + "
          f"Hardtanh(0, 20), 3 x bidirectional GRU {c['hidden']} with "
          f"sequence_length, Linear(2048, {c['vocab']}), CTC; batch "
          f"{c['batch']} of {lens.min()}-{lens.max()} frames ({frames} in "
          f"all), labels {lab_lens.min()}-{lab_lens.max()}; fp32, TF32 off; "
          f"Adam lr {c['lr']} clip {c['clip']}; {t['steps']} timed steps "
          f"after {t['warmup']}; cut: the sequence-wise batch norm inside "
          f"the GRU stack); eval loss on the fixed batch {before:.4f} -> "
          f"{after:.4f}; train losses {[round(v, 3) for v in losses]}; "
          f"the parity check took {t_parity:.1f}s, the profiled step "
          f"{t_prof:.1f}s", flush=True)
    if not (all(math.isfinite(v) for v in losses + [before, after])
            and after < before):
        raise AssertionError(f"ds2: losses {losses}, eval {before} -> "
                             f"{after}")
    counts = _no_kernel_ran(ops, "ds2")
    print(f"ds2: K1-K6 launches {counts}", flush=True)
    del model, opt
    _release(torch)


def tensor_sweep_cases(torch, np):
    """Phase 46's cases, as extras_sweep_cases: every function of
    tensor/extras.py and tensor/toplevel_extras.py, fft, signal and the
    audio functions and layers, each in-place variant of the family, at
    TX_* sizes. Complex results are compared through view_as_real; the
    functions whose JAX counterpart refuses bf16, or that take complex or
    integer inputs, run in fp32 only; reductions (heavy) take an fp32 CPU
    reference in bf16. The pairwise norms and logcumsumexp run in fp32
    only: in bf16 their gradients follow rounding (the inf-norm's argmax,
    the 1-norm's signs, a running log-sum over 65536 terms), 4e-2 to 8e-1
    off an fp32 reference on the CPU itself."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import audio
    from paddle_tpu_torch.tensor import toplevel_extras as tx

    rng = np.random.default_rng(46)
    E, M, S = TX_ELEM, TX_MAT, TX_SIGNAL
    R = torch.view_as_real
    cases = []

    def add(name, f, inputs, grad=(0,), heavy=False, bf16=True, tol=None):
        cases.append((name, lambda f=f: f, inputs, grad, heavy, bf16, tol))

    def with_inf():
        a = rng.standard_normal(E).astype(np.float32)
        a.flat[:64] = np.inf
        a.flat[64:128] = -np.inf
        a.flat[128:192] = -0.0
        return ("a", a)

    nans = rng.standard_normal(E).astype(np.float32)
    nans.flat[::7] = np.nan
    ints = ("a", rng.integers(-3, 4, E))
    # ---- tensor/extras.py ----
    for n in ("isreal", "isneginf", "isposinf", "signbit"):
        add(n, getattr(pt, n), [with_inf()], ())
    add("addmm", lambda i, a, b: pt.addmm(i, a, b, 0.5, 2.0),
        [("f", (256, 512)), ("f", (256, 1024)), ("f", (1024, 512))],
        (0, 1, 2), True)
    for p in (2.0, 1.0, float("inf")):
        add(f"cdist p={p}", lambda a, b, p=p: pt.cdist(a, b, p),
            [("f", TX_CDIST[0]), ("f", TX_CDIST[1])], (0, 1), True, False)
    for p in (2, 0, float("inf"), 1.5):
        add(f"dist p={p}", lambda a, b, p=p: pt.dist(a, b, p),
            [("f", E), ("f", E)], (0, 1) if p else (), True)
    add("diff", lambda a: pt.diff(a), [("f", E)])
    add("diff n=2 axis=0 prepend append", lambda a, b, c: pt.diff(
        a, 2, 0, b, c), [("f", E), ("f", (3, E[1])), ("f", (2, E[1]))],
        (0, 1, 2))
    add("frexp", pt.frexp, [("f", E)], ())
    add("ldexp", pt.ldexp, [("f", E), ints])
    add("gammaln", pt.gammaln, [("pos", E)])
    add("gammainc", pt.gammainc, [("pos", E), ("pos", E)], (1,))
    add("gammaincc", pt.gammaincc, [("pos", E), ("pos", E)], (1,))
    add("multigammaln", lambda a: pt.multigammaln(a + 1.5, 3), [("pos", E)])
    for n in (0, 1, 2):
        add(f"polygamma n={n}", lambda a, n=n: pt.polygamma(a, n),
            [("pos", E)])
    for n in ("i0e", "i1e", "sgn", "sinc"):
        add(n, getattr(pt, n), [("f", E)])
    add("logit", pt.logit, [("p", E)])
    add("logit eps", lambda a: pt.logit(a, 0.1), [("p", E)])
    add("logcumsumexp", pt.logcumsumexp, [("f", E)], (0,), True, False)
    add("logcumsumexp axis", lambda a: pt.logcumsumexp(a, axis=1),
        [("f", E)], (0,), True, False)
    add("isin", pt.isin, [(("i", 1000), E),
                          ("a", rng.integers(0, 1000, 300))], ())
    add("isin invert", lambda a, b: pt.isin(a, b, invert=True),
        [(("i", 1000), E), ("a", rng.integers(0, 1000, 300))], ())
    add("trapezoid dx", lambda a: pt.trapezoid(a, dx=0.5), [("f", E)],
        (0,), True)
    add("trapezoid x", lambda a, x: pt.trapezoid(a, x, axis=0),
        [("f", E), ("a", np.sort(rng.standard_normal(E[0])).astype(
            np.float32))], (0,), True)
    add("cumulative_trapezoid", lambda a: pt.cumulative_trapezoid(
        a, dx=0.5), [("f", E)], (0,), True)
    add("nanquantile", lambda a: pt.nanquantile(a, 0.3, axis=1,
                                                keepdim=True),
        [("a", nans)], ())
    add("nanquantile q list", lambda a: pt.nanquantile(
        a, [0.1, 0.5, 0.9], axis=0, interpolation="midpoint"),
        [("a", nans)], ())
    add("reduce_as", pt.reduce_as, [("f", (8,) + E), ("f", (E[0], 1))],
        (0,), True)
    add("renorm", lambda a: pt.renorm(a, 2.0, 0, 20.0), [("f", E)], (0,),
        True)
    add("vander", lambda a: pt.vander(a, 16, True), [("f", (E[0],))])
    add("inverse", pt.inverse, [("spd", M)], (0,), False, False)
    add("block_diag", lambda a, b: pt.block_diag([a, b]),
        [("f", (64, 32)), ("f", (16, 48))], (0, 1))
    for n in ("hsplit", "vsplit", "dsplit"):
        add(n, lambda a, n=n: getattr(pt, n)(a, 2), [("f", M)])
        add(f"{n} indices", lambda a, n=n: getattr(pt, n)(a, [3, 9]),
            [("f", M)])
    add("tensor_split", lambda a: pt.tensor_split(a, 3, axis=1), [("f", E)])
    add("tensor_split indices", lambda a: pt.tensor_split(a, [7, 33]),
        [("f", E)])
    add("reverse", lambda a: pt.reverse(a, [0, 2]), [("f", M)])
    add("unflatten", lambda a: pt.unflatten(a, 1, [32, 32]), [("f", E)])
    add("unfold", lambda a: pt.unfold(a, 1, 64, 16), [("f", E)])
    add("as_strided", lambda a: pt.as_strided(a, [60, 128, 64],
                                              [1024, 8, 1], 3), [("f", E)])
    add("index_fill", lambda a, i: pt.index_fill(a, i, 1, 2.5),
        [("f", E), ("a", rng.choice(E[1], 100, replace=False))])
    add("masked_scatter", pt.masked_scatter,
        [("f", E), ("mask", E), ("f", (E[0] * E[1],))], (0, 2))
    for off in (0, 5, -5):
        add(f"diagonal_scatter offset={off}", lambda a, b, o=off:
            pt.diagonal_scatter(a, b, o, 1, 2),
            [("f", M), ("f", (M[0], M[1] - abs(off)))], (0, 1))
    add("select_scatter", lambda a, b: pt.select_scatter(a, b, 1, 9),
        [("f", M), ("f", (M[0], M[2]))], (0, 1))
    add("slice_scatter", lambda a, b: pt.slice_scatter(
        a, b, [1, 2], [4, 0], [60, 64], [4, 2]),
        [("f", M), ("f", (M[0], 14, 32))], (0, 1))
    add("histogram_bin_edges", lambda a: pt.histogram_bin_edges(a, 50),
        [("f", E)], ())
    add("histogram_bin_edges range", lambda a: pt.histogram_bin_edges(
        a, 50, -1.0, 2.0), [("f", E)], ())
    add("histogramdd", lambda a: pt.histogramdd(a, bins=8),
        [("f", TX_HIST)], ())
    add("histogramdd ranges density", lambda a: pt.histogramdd(
        a, bins=[4, 8, 16], ranges=[-1, 1, -2, 2, -3, 3], density=True),
        [("f", TX_HIST)], ())
    add("histogramdd weights", lambda a, w: pt.histogramdd(
        a, bins=6, weights=w), [("f", TX_HIST), ("pos", TX_HIST[:1])], ())
    # ---- tensor/toplevel_extras.py ----
    add("mm", pt.mm, [("f", (256, 512)), ("f", (512, 128))], (0, 1), True)
    for p in (2.0, 1.0, float("inf")):
        add(f"pdist p={p}", lambda a, p=p: pt.pdist(a, p),
            [("f", (256, 64))], (0,), True, False)
    for n in ("hstack", "vstack", "dstack", "column_stack", "row_stack"):
        add(n, lambda a, b, n=n: getattr(pt, n)([a, b]),
            [("f", E), ("f", E)], (0, 1))
    add("cartesian_prod", lambda a, b: pt.cartesian_prod([a, b]),
        [("f", (64,)), ("f", (32,))], (0, 1))
    # each element's gradient sums ~2000 cotangents: the CPU sums them in
    # bf16 one by one, the card's index backward in fp32 (heavy: an fp32
    # reference)
    add("combinations", lambda a: pt.combinations(a, 3), [("f", (64,))],
        (0,), True)
    add("combinations with_replacement", lambda a: pt.combinations(
        a, 2, True), [("f", (64,))], (0,), True)
    add("shape", pt.shape, [("f", M)], ())
    add("rank", pt.rank, [("f", M)], ())
    # ---- fft ----
    for n in ("fft", "ifft", "rfft", "ihfft"):
        add(n, lambda a, n=n: R(getattr(pt.fft, n)(a)), [("f", E)])
        add(f"{n} n axis ortho", lambda a, n=n: R(getattr(pt.fft, n)(
            a, 48, 0, "ortho")), [("f", E)])
    for n in ("irfft", "hfft"):
        add(n, lambda a, n=n: getattr(pt.fft, n)(torch.view_as_complex(a)),
            [("f", E + (2,))], (0,), False, False)
    for n in ("fft2", "ifft2", "rfft2", "fftn", "ifftn", "rfftn"):
        add(n, lambda a, n=n: R(getattr(pt.fft, n)(a)), [("f", M)])
    for n in ("irfft2", "irfftn"):
        add(n, lambda a, n=n: getattr(pt.fft, n)(torch.view_as_complex(a)),
            [("f", M + (2,))], (0,), False, False)
    add("fftshift", pt.fft.fftshift, [("f", M)])
    add("ifftshift axes", lambda a: pt.fft.ifftshift(a, axes=[1]),
        [("f", M)])
    add("fftfreq", lambda a: [pt.fft.fftfreq(1000, 0.5),
                              pt.fft.rfftfreq(1000, 0.25)], [("f", (1,))],
        (), False, False)
    # ---- signal ----
    add("frame", lambda a: pt.signal.frame(a, 400, 160), [("f", S)])
    add("frame axis=0", lambda a: pt.signal.frame(a, 400, 160, axis=0),
        [("f", S[::-1])])
    add("overlap_add", lambda a: pt.signal.overlap_add(a, 160),
        [("f", (S[0], 400, 98))])
    add("overlap_add axis=0", lambda a: pt.signal.overlap_add(a, 160, 0),
        [("f", (98, 400, S[0]))])
    for kw in (dict(), dict(center=False), dict(win_length=320),
               dict(normalized=True), dict(onesided=False)):
        tag = " ".join(f"{k}={v}" for k, v in kw.items())
        add(f"stft {tag}".strip(), lambda a, kw=kw: R(pt.signal.stft(
            a, 400, 160, **kw)), [("f", S)])
    add("stft window", lambda a, w: R(pt.signal.stft(a, 320, 160, window=w)),
        [("f", S), ("a", np.hanning(320).astype(np.float32))])
    add("istft(stft)", lambda a, w: pt.signal.istft(pt.signal.stft(
        a, 320, 160, window=w), 320, 160, window=w, length=S[1]),
        [("f", S), ("a", np.hanning(320).astype(np.float32) + 0.05)])
    add("istft nola floor", lambda a: pt.signal.istft(
        torch.view_as_complex(a), 8, 8, window=torch.tensor(
            [0, 0, 1, 1, 1, 1, 0, 0.0], device=a.device), center=False),
        [("f", (S[0], 5, 500, 2))], (0,), False, False)
    # ---- audio ----
    A = audio.functional
    add("power_to_db", lambda a: A.power_to_db(a * a, 1.0, 1e-10, 80.0),
        [("f", E)], (0,), False, False)
    add("hz_to_mel mel_to_hz", lambda a: [A.hz_to_mel(a * 4000),
                                          A.mel_to_hz(a * 40, True)],
        [("pos", E)], (0,), False, False)
    for cls, kw in (("Spectrogram", DS2_FRONT),
                    ("MelSpectrogram", dict(sr=16000, n_fft=512,
                                            n_mels=80)),
                    ("LogMelSpectrogram", dict(sr=16000, n_fft=512,
                                               n_mels=80, top_db=80.0)),
                    ("MFCC", dict(sr=16000, n_mfcc=40, n_fft=512,
                                  n_mels=80))):
        cases.append((f"audio.{cls}", lambda c=cls, kw=kw: getattr(
            audio.features, c)(**kw), [("f", S)], (0,), False, False, None))
    # ---- the in-place family ----
    two = ("floor_divide", "remainder", "mod", "floor_mod", "pow", "divide",
           "multiply", "copysign", "hypot", "equal", "less_than",
           "less_equal", "greater_equal", "greater_than", "gammainc",
           "gammaincc")
    intg = ("bitwise_and", "bitwise_or", "bitwise_xor", "gcd", "lcm",
            "bitwise_left_shift", "bitwise_right_shift")
    extra = dict(cumsum=(1,), cumprod=(1,), unsqueeze=(0,), squeeze=(1,),
                 triu=(1,), tril=(-1,), cast=("float64",),
                 transpose=([1, 0],), renorm=(2.0, 0, 20.0),
                 multigammaln=(2,), polygamma=(1,), masked_fill=(0.5,))
    for base in tx.INPLACE_BASES:
        fn = getattr(pt, base + "_")
        ex = extra.get(base, ())
        if base in intg:
            specs, grad, b16 = [(("i", 64), E), (("i", 4), E)], (), False
        elif base == "bitwise_not":
            specs, grad, b16 = [(("i", 64), E)], (), False
        elif base in ("logical_and", "logical_or"):
            specs, grad, b16 = [("mask", E), ("mask", E)], (), False
        elif base == "logical_not":
            specs, grad, b16 = [("mask", E)], (), False
        elif base in two:
            specs, grad, b16 = [("pos", E), ("pos", E)], (0,), True
        elif base == "addmm":
            specs, grad, b16 = [("f", (256, 256)), ("f", (256, 512)),
                                ("f", (512, 256))], (0, 1, 2), True
        elif base == "squeeze":
            specs, grad, b16 = [("f", (E[0], 1, E[1]))], (0,), True
        elif base in ("ldexp",):
            specs, grad, b16 = [("f", E), ints], (0,), True
        elif base in ("masked_fill",):
            specs, grad, b16 = [("f", E), ("mask", E)], (0,), True
        elif base == "masked_scatter":
            specs, grad, b16 = [("f", E), ("mask", E),
                                ("f", (E[0] * E[1],))], (0, 2), True
        elif base == "nan_to_num":
            specs, grad, b16 = [with_inf()], (0,), True
        elif base in ("acos", "logit"):
            specs, grad, b16 = [("p", E)], (0,), True
        else:
            specs, grad, b16 = [("pos", E)], (0,), True
        if base in ("cast", "cumprod", "multigammaln", "polygamma"):
            b16 = False
        if base in ("equal", "less_than", "less_equal", "greater_equal",
                    "greater_than", "t", "unsqueeze", "squeeze", "transpose",
                    "flatten", "cast", "floor_divide"):
            grad = ()     # a new dtype or shape (no in-place autograd), or
            #               no derivative (floor_divide)
        if base in ("gammainc", "gammaincc"):
            grad = (1,)   # torch has no gradient for the first argument

        def f(x, *rest, fn=fn, ex=ex):
            return fn(x.clone(), *rest, *ex)

        add(f"{base}_", f, specs, grad, base in ("addmm", "cumsum"), b16)
    add("where_", lambda c, x, y: pt.where_(c, x.clone(), y),
        [("mask", E), ("f", E), ("f", E)], (1, 2))
    return cases


def _moments_ok(x, mean, std, n_sd=6.0):
    """|sample mean - mean| within n_sd standard errors and the sample std
    within 2% of std."""
    m, s = x.mean().item(), x.std().item()
    return abs(m - mean) <= n_sd * std / x.numel() ** 0.5 \
        and abs(s - std) <= 0.02 * std, m, s


def _tensor_random_on_card(torch, np, card):
    """The random functions on the card by their moments (log_normal,
    standard_gamma and the in-place fills log_normal_, cauchy_ by its
    quartiles, geometric_ continuous), and top_p_sampling on TOP_P logits:
    every draw inside its row's nucleus (JAX's keep rule), TOP_P_DRAWS
    draws of one row against the nucleus's renormalised probabilities
    (chi-square, p > 1e-3), and the same seed giving the same draws."""
    import scipy.stats

    import paddle_tpu_torch as pt

    n = 1 << 22
    pt.seed(46)
    lines, ok = [], True
    w = pt.log_normal(0.5, 0.25, [n])
    good, m, sd = _moments_ok(torch.log(w), 0.5, 0.25)
    ok &= good and w.device.type == torch.device(DEVICE).type
    lines.append(f"log_normal log-mean {m:.5f} log-std {sd:.5f}")
    g = pt.standard_gamma(pt.full([n], 3.0))
    good, m, sd = _moments_ok(g, 3.0, 3.0 ** 0.5)
    ok &= good
    lines.append(f"standard_gamma(3) mean {m:.5f} std {sd:.5f}")
    x = pt.zeros([n])
    x.log_normal_(1.0, 0.5)
    good, m, sd = _moments_ok(torch.log(x), 1.0, 0.5)
    ok &= good
    lines.append(f"log_normal_ log-mean {m:.5f} log-std {sd:.5f}")
    pt.cauchy_(x, 1.0, 2.0)
    q = torch.quantile(x[:1 << 20], torch.tensor([0.25, 0.5, 0.75],
                                                 device=x.device)).tolist()
    ok &= abs(q[1] - 1.0) < 0.02 and abs((q[2] - q[0]) / 2 - 2.0) < 0.02
    lines.append(f"cauchy_ median {q[1]:.4f} half-IQR {(q[2] - q[0]) / 2:.4f}")
    pt.geometric_(x, 0.3)
    mean_g = 1 / -math.log1p(-0.3)
    frac = (x != torch.floor(x)).float().mean().item()
    good, m, sd = _moments_ok(x, mean_g, mean_g)
    ok &= good and frac > 0.99
    lines.append(f"geometric_(0.3) mean {m:.5f} (continuous {mean_g:.5f}), "
                 f"non-integer share {frac:.4f}")
    rows, vocab = TOP_P
    gen = torch.Generator(device=DEVICE).manual_seed(46)
    logits = torch.randn(rows, vocab, device=DEVICE, generator=gen) * 4
    ps = torch.rand(rows, device=DEVICE, generator=gen) * 0.8 + 0.1
    vals, idx = pt.top_p_sampling(logits, ps, seed=1)
    probs = torch.softmax(logits.float(), -1)
    sp, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    keep = (torch.cumsum(sp, -1) - sp) <= ps[:, None]
    rank = (order == idx).float().argmax(-1)
    inside = bool(keep.gather(1, rank[:, None]).all())
    same = torch.equal(idx, pt.top_p_sampling(logits, ps, seed=1)[1])
    other = not torch.equal(idx, pt.top_p_sampling(logits, ps, seed=2)[1])
    row = logits[:1].expand(TOP_P_DRAWS, vocab).contiguous()
    draws = pt.top_p_sampling(row, 0.5, seed=3)[1].flatten()
    sp0 = torch.sort(torch.softmax(logits[0].float(), -1), descending=True,
                     stable=True)
    k0 = (torch.cumsum(sp0.values, 0) - sp0.values) <= 0.5
    expect = (sp0.values[k0] / sp0.values[k0].sum()).double().cpu().numpy()
    pos = {int(t): j for j, t in enumerate(sp0.indices[k0].tolist())}
    counts = np.zeros(len(expect))
    outside = 0
    for t in draws.tolist():
        if t in pos:
            counts[pos[t]] += 1
        else:
            outside += 1
    # cells pooled (largest first) until each expects >= 5 draws
    exp_n = expect * TOP_P_DRAWS
    pool_o, pool_e, acc_o, acc_e = [], [], 0.0, 0.0
    for o, e in zip(counts, exp_n):
        acc_o, acc_e = acc_o + o, acc_e + e
        if acc_e >= 5:
            pool_o.append(acc_o)
            pool_e.append(acc_e)
            acc_o = acc_e = 0.0
    if acc_e:
        pool_o[-1] += acc_o
        pool_e[-1] += acc_e
    chi = float(sum((o - e) ** 2 / e for o, e in zip(pool_o, pool_e)))
    pval = float(scipy.stats.chi2.sf(chi, max(len(pool_o) - 1, 1)))
    ok &= inside and same and other and outside == 0 and pval > 1e-3
    lines.append(f"top_p_sampling on [{rows}, {vocab}]: every draw in its "
                 f"row's nucleus {inside}, same seed same draws {same}, "
                 f"another seed other draws {other}; {TOP_P_DRAWS} draws of "
                 f"row 0 (p 0.5, nucleus {len(expect)} tokens): chi2 {chi:.2f}"
                 f" over {len(pool_o) - 1} dof, p {pval:.4f}, outside the "
                 f"nucleus {outside}")
    print(f"tensor extras random [{card}]: " + "; ".join(lines), flush=True)
    if not ok:
        raise AssertionError("tensor extras sweep: a random function on the "
                             "card missed its law")


def phase_tensor_sweep(torch, np, ops, card):
    """Phase 46: every function of tensor/extras.py, toplevel_extras.py,
    fft, signal and audio, and each in-place variant, forward and
    backward, fp32 (bf16 where the case takes it), card against CPU
    (NN_SWEEP_TOL); then the random functions by their moments and
    top_p_sampling; K1-K6 must not launch."""
    import paddle_tpu_torch as pt

    pt.set_device(DEVICE)
    _reset_counts(ops)
    _sweep(torch, np, tensor_sweep_cases(torch, np), 4600,
           "tensor extras sweep", card)
    _tensor_random_on_card(torch, np, card)
    counts = _no_kernel_ran(ops, "tensor extras sweep")
    print(f"tensor extras sweep: K1-K6 launches {counts}", flush=True)
    _release(torch)


# the ops whose OpDef AMP casts to low precision (white): linear, conv
# and matmul, as in the JAX package (core/op_registry.py's docstring)
WHITE_OPDEFS = ("linear", "conv", "matmul")


def _white_ops(recs):
    """{op: calls} of the dumped records (first outputs) of the white
    OpDefs: what O1 ran in low precision."""
    return dict(collections.Counter(r["op"] for r in recs if r["out"] == 0
                                    and r["op"] in WHITE_OPDEFS))


def phase_amp_debugging(torch, np, ops, card):
    """Phase 47: amp.debugging on phase 41's BERT-base dygraph encoder
    (DYGRAPH_BERT, seed-0 weights and batch): one fp32 step (forward,
    cross entropy, backward) dumped twice (compare_accuracy flags 0 rows),
    one O1 bf16 step dumped and compared with the fp32 dump (aligned op
    for op: no MISSING row; flagged count and worst op printed), the op
    statistics of the O1 step equal to the white ops its dump holds, the
    tensor checker on an inf planted in one layer's weight (raises naming
    the first op; warn mode warns and the health word carries the bits),
    and the step's ms and host syncs with the dump on and off. Returns the
    dumped steps' K1-lse, K2 and K3 launches (12 each a step)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.framework import numeric_guard

    dbg = pt.amp.debugging
    c, d = DYGRAPH_BERT, DYGRAPH
    L = c["layers"]
    pt.set_device(DEVICE)
    pt.seed(0)
    model = dygraph_encoder(pt, c, DEVICE)
    ids, labels = _dygraph_batch(pt, np, c, d["batch"], d["seq"], DEVICE)
    root = _scratch_dir("amp_debugging")

    def step(amp=None):
        with pt.amp.auto_cast(**amp) if amp else contextlib.nullcontext():
            loss = pt.nn.functional.cross_entropy(model(ids), labels)
        loss.backward()
        model.clear_gradients()
        return loss

    def dumped(path, amp=None):
        with dbg.dump_tensor_stats(path):
            return step(amp)

    def dumped_o1(path):
        """The O1 bf16 step dumped, its op statistics collected inside
        auto_cast (they live in its AMP state)."""
        with dbg.dump_tensor_stats(path):
            with pt.amp.auto_cast(level="O1", dtype="bfloat16"):
                with dbg.enable_operator_stats_collection():
                    loss = pt.nn.functional.cross_entropy(model(ids),
                                                          labels)
                    got = dbg.collect_operator_stats()
            loss.backward()
            model.clear_gradients()
        return got

    step()
    sync()
    _reset_counts(ops)
    paths = [os.path.join(root, f"{n}.jsonl") for n in ("a", "b", "o1")]
    dumped(paths[0])
    dumped(paths[1])
    stats = dumped_o1(paths[2])
    counts = _read_counts(ops)
    launches = (counts["k1_lse"], counts["k2"], counts["k3"])
    same = dbg.compare_accuracy(paths[0], paths[1],
                                os.path.join(root, "fp32.csv"))
    mixed = dbg.compare_accuracy(paths[0], paths[2],
                                 os.path.join(root, "bf16.csv"))
    recs = [json.loads(line) for line in open(paths[2])]
    missing = [r for r in mixed if r["status"].startswith("MISSING")]
    with open(os.path.join(root, "bf16.csv")) as f:
        rows = [r for r in csv.DictReader(f) if r["status"] != "MISSING_IN_A"
                and r["status"] != "MISSING_IN_B"]
    worst = max(rows, key=lambda r: float(r["max_abs_err"]) / max(
        float(r["max_abs_a"]), 1e-6), default=None)
    white = _white_ops(recs)
    print(f"amp debugging [{card}]: BERT-base dygraph step (batch "
          f"{d['batch']} x {d['seq']}, {L} layers): {len(recs)} records a "
          f"dumped step; fp32 vs fp32 flagged {len(same)}; fp32 vs O1 bf16 "
          f"flagged {len(mixed)} of {len(recs)} at rtol 1e-2 (missing "
          f"{len(missing)}; largest max |x| change: "
          f"{worst['op'] if worst else None} call "
          f"{worst['call'] if worst else None}, "
          f"{worst['max_abs_a'] if worst else None} -> "
          f"{worst['max_abs_b'] if worst else None}); operator stats "
          f"{stats} (white ops in the dump {white}); launches k1_lse/k2/k3 "
          f"{launches} over 3 dumped steps", flush=True)
    if same or missing or stats != white or not stats:
        raise AssertionError(f"amp debugging: fp32 dumps flagged {same[:3]},"
                             f" missing {missing[:3]}, stats {stats} vs "
                             f"{white}")
    if list(launches) != [3 * L] * 3:
        raise AssertionError(f"amp debugging: launches {launches}")

    # host syncs and ms a step, the dump off and on
    def timed(fn, n=3):
        sync()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        sync()
        return (time.perf_counter() - t0) / n * 1e3

    off_ms = timed(step)
    on_ms = timed(lambda: dumped(paths[1]))
    off_syncs = _sync_count(torch, step)
    on_syncs = _sync_count(torch, lambda: dumped(paths[1]))
    print(f"amp debugging [{card}]: ms a step dump off {off_ms:.2f} on "
          f"{on_ms:.2f}; host syncs a step off {len(off_syncs)} on "
          f"{len(on_syncs)} (the dump's one read of every record's "
          f"statistics; JAX's recorder reads 4 host scalars an output, "
          f"{4 * len(recs)} a step)", flush=True)
    if len(on_syncs) - len(off_syncs) > 1:
        raise AssertionError(f"amp debugging: the dump adds "
                             f"{len(on_syncs) - len(off_syncs)} host syncs "
                             f"a step: {on_syncs[:3]}")

    # the tensor checker on an inf in layer 3's first FFN weight
    w = model.encoder.layers[3].linear1.weight
    saved = w.detach().clone()
    with torch.no_grad():
        w[0, 0] = float("inf")
    try:
        dbg.enable_tensor_checker(dbg.TensorCheckerConfig(
            debug_mode=dbg.DebugMode.CHECK_NAN_INF_AND_ABORT))
        try:
            with torch.no_grad():
                model(ids)
            raised = None
        except FloatingPointError as e:
            raised = str(e)
        dbg.enable_tensor_checker(dbg.TensorCheckerConfig(
            debug_mode=dbg.DebugMode.CHECK_NAN_INF))
        numeric_guard.consume_health()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            with torch.no_grad():
                model(ids)
        word = numeric_guard.consume_health()
    finally:
        dbg.disable_tensor_checker()
        with torch.no_grad():
            w.copy_(saved)
    warned = [str(m.message) for m in seen if "Operator" in str(m.message)]
    print(f"amp debugging checker [{card}]: abort mode raised "
          f"{raised!r}; warn mode warned {len(warned)} times (first "
          f"{warned[0] if warned else None!r}), health "
          f"{numeric_guard.describe_health(word)}", flush=True)
    if not (raised and raised.startswith("Operator linear") and warned
            and word & (numeric_guard.NAN_GRAD | numeric_guard.INF_GRAD)):
        raise AssertionError("amp debugging: the tensor checker missed the "
                             "planted inf")
    del model
    _release(torch)
    return launches


def _trace_kernels(prof_mod, path, names):
    """{name: calls} of the events of a device trace whose names hold
    each of ``names`` (demangled or not)."""
    res = prof_mod.load_profiler_result(path)
    out = {}
    for n in names:
        hits = {k: d["calls"] for k, d in res.summary.items() if n in k}
        out[n] = sum(hits.values())
        if len(hits) > 1:
            print(f"  trace names holding {n}: {hits}", flush=True)
    return out, len(res.events)


def _kineto_records_cuda(torch):
    """Whether torch.profiler records CUDA kernels on this machine (one
    small matmul traced)."""
    from torch.profiler import ProfilerActivity, profile

    a = torch.ones(64, 64, device=DEVICE)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        a @ a
        torch.cuda.synchronize()
    return any(e.device_type() == torch.autograd.DeviceType.CUDA
               for e in prof.profiler.kineto_results.events())


def phase_profiler(torch, np, ops, card):
    """Phase 48: the profiler around phase 9's Llama train step (852.6M,
    batch 2 x 4096, bf16): 4 steps under Profiler(make_scheduler(closed=1,
    ready=1, record=2), profile_memory=True, on_trace_ready=
    export_chrome_tracing(build/chip_smoke/profiler)) with RecordEvent
    scopes around the batch and the step: OverView's steps and
    OperatorView's calls equal the steps taken, MemoryView's peak within
    5% of torch.cuda.max_memory_allocated(), the device trace's
    flash_fwd_tc_kernel / dq_tc_kernel / dkv_tc_kernel counts equal to the
    wrappers' counters over the 2 recorded steps (2 x 16 each), and the
    step's ms recorded against not. Then the legacy serving engine of
    phase 6 (its llama-750M class, 8 slots, 16 short requests) under a
    Profiler with TraceRecorder(mirror_host_events=True): the recorder's
    span names and counts in OperatorView, K1 and K4 in the device trace
    equal to the wrappers' counters. Where Kineto records no CUDA activity
    on the machine, the profiler must refuse (raise) and the trace counts
    are printed as not measured. Returns (K1-lse, K2, K3, K1, K4)
    launches."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import profiler as P
    from paddle_tpu_torch.distributed import Engine
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cuda_traced = _kineto_records_cuda(torch)
    root = _scratch_dir("profiler")
    cfg = LlamaConfig(**TRAIN_CONFIG)
    L = cfg.num_hidden_layers
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = LlamaForCausalLM(cfg, device=DEVICE, seed=0)
    eng = Engine(model, lr=1e-4, clip_norm=1.0)
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))
               .astype(np.int32) for _ in range(PROFILE_STEPS)]
    warm = torch.from_numpy(batches[0]).to(DEVICE)
    for _ in range(TRAIN_WARMUP):
        eng.step(warm, warm)
    sync()
    P._host_events.reset()
    prof = P.Profiler(scheduler=P.make_scheduler(closed=1, ready=1,
                                                 record=2),
                      profile_memory=True,
                      on_trace_ready=P.export_chrome_tracing(root))
    ms, recorded, losses = [], [0, 0, 0], []
    refused = None
    try:
        prof.start()
        for i, b in enumerate(batches):
            _reset_counts(ops)
            t0 = time.perf_counter()
            with P.RecordEvent("batch"):
                ids = torch.from_numpy(b).to(DEVICE)
            with P.RecordEvent("step"):
                losses.append(eng.step(ids, ids))
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            c = _read_counts(ops)
            if prof._tracing:
                recorded = [x + c[k] for x, k in zip(
                    recorded, ("k1_lse", "k2", "k3"))]
            prof.step()
        prof.stop()
    except RuntimeError as e:
        if cuda_traced:
            raise
        refused = str(e)
    table = prof.summary() if refused is None else ""
    lines = table.splitlines()

    def row(name):
        r = next((ln.split() for ln in lines if ln.split()[:1] == [name]),
                 None)
        return r

    steps_row = row("steps")
    peak_rows = [float(ln.split()[2]) for ln in lines
                 if ln.split()[:1] in (["batch"], ["step"])
                 and len(ln.split()) == 3]
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    vals = torch.stack([x.detach() for x in losses]).float().cpu()
    print(f"profiler [{card}]: Llama {cfg.num_params() / 1e6:.1f}M batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} bf16, {PROFILE_STEPS} steps (closed "
          f"1, ready 1, record 2): ms a step {[round(x, 2) for x in ms]} "
          f"(recorded: steps 3-4); OverView steps "
          f"{steps_row[1] if steps_row else None}; OperatorView step/batch "
          f"calls {row('step')[1] if row('step') else None}/"
          f"{row('batch')[1] if row('batch') else None}; MemoryView peak "
          f"{max(peak_rows) if peak_rows else None} MB vs "
          f"max_memory_allocated {peak_mb:.2f} MB; losses "
          f"{[round(x, 4) for x in vals.tolist()]}", flush=True)
    if not bool(vals.isfinite().all()):
        raise AssertionError(f"profiler: losses {vals}")
    if refused is not None:
        print(f"profiler [{card}]: Kineto records no CUDA activity on this "
              f"machine; Profiler(targets=[GPU]) refused as designed "
              f"({refused}); device-trace counts not measured", flush=True)
        del eng, model
        _release(torch)
        return tuple(recorded) + (0, 0)
    if not (steps_row and int(steps_row[1]) == PROFILE_STEPS
            and row("step")[1] == row("batch")[1] == str(PROFILE_STEPS)
            and peak_rows and abs(max(peak_rows) - peak_mb) <= 0.05 * peak_mb):
        raise AssertionError("profiler: the summary's views disagree with "
                             "the steps taken or the peak memory")
    trace = os.path.join(root, "device_trace.json")
    got, n_events = _trace_kernels(P, trace, ("flash_fwd_tc_kernel",
                                              "dq_tc_kernel",
                                              "dkv_tc_kernel"))
    want = dict(zip(("flash_fwd_tc_kernel", "dq_tc_kernel",
                     "dkv_tc_kernel"), recorded))
    print(f"profiler device trace [{card}]: {n_events} events, "
          f"{os.path.getsize(trace) / 2 ** 20:.1f} MB; kernels {got} vs the "
          f"wrappers' counters over the recorded steps {want}; overhead: "
          f"recorded steps {ms[2]:.2f}/{ms[3]:.2f} ms against "
          f"{ms[1]:.2f} (ready) and {ms[0]:.2f} (closed)", flush=True)
    if got != want or recorded != [2 * L] * 3:
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        ops_seen = collections.Counter(e["name"] for e in events
                                       if e.get("cat") == "cpu_op"
                                       and "paddle_tpu_torch::" in e["name"])
        kernels = [e for e in events if e.get("cat") == "kernel"
                   and "flash_fwd_tc_kernel" in e["name"]]
        print(f"profiler trace diagnosis: custom ops {dict(ops_seen)}; "
              f"flash_fwd kernel start times (us) "
              f"{sorted(e['ts'] for e in kernels)[:4]} ...; trace keys "
              f"{[k for k in json.load(open(trace)) if k != 'traceEvents']}",
              flush=True)
        raise AssertionError(f"profiler: trace {got} vs counters {want}")
    del eng, model, losses
    _release(torch)
    k1, k4 = _profiled_serving(torch, np, ops, card, P, root)
    return tuple(recorded) + (k1, k4)


def _profiled_serving(torch, np, ops, card, P, root):
    """The serving arm of phase 48 (see phase_profiler); returns its K1
    and K4 launches."""
    from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                    Request)
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.observability import TraceRecorder

    model = LlamaForCausalLM(LlamaConfig(**SERVE_CONFIG), device=DEVICE,
                             seed=0)
    tracer = TraceRecorder(mirror_host_events=True)
    eng = ContinuousBatchingEngine(model, device=DEVICE, tracer=tracer,
                                   **ENGINE)
    warm, prompts, _, rng = _legacy_wave(np, model.config.vocab_size)
    out = os.path.join(root, "serving")
    # step 0 (READY, Kineto's warm-up): the warm-up wave; step 1 recorded
    prof = P.Profiler(scheduler=P.make_scheduler(ready=1, record=1),
                      on_trace_ready=P.export_chrome_tracing(out))
    prof.start()
    for p in warm:
        eng.add_request(Request(p, max_new_tokens=4))
    eng.run_until_done()
    sync()
    prof.step()
    tracer.events.clear()
    P._host_events.reset()
    ops.flash_attention.launches = 0
    ops.paged_decode_attention.launches = 0
    reqs = [Request(p, max_new_tokens=PROFILE_SERVE_NEW) for p in prompts]
    for r in reqs:
        eng.add_request(r)
    eng.run_until_done()
    sync()
    prof.step()
    prof.stop()
    k1 = ops.flash_attention.launches
    k4 = ops.paged_decode_attention.launches
    spans = collections.Counter(e["name"] for e in tracer.events
                                if e["ph"] == "X")
    table = prof.summary()
    calls = {ln.split()[0]: int(ln.split()[1]) for ln in table.splitlines()
             if ln.split()[:1] and ln.split()[0] in spans}
    got, n_events = _trace_kernels(P, os.path.join(out, "device_trace.json"),
                                   ("flash_fwd_tc_kernel",
                                    "paged_decode_kernel"))
    print(f"profiler serving [{card}]: {len(reqs)} requests of "
          f"{PROFILE_SERVE_NEW} new tokens on the legacy engine; recorder "
          f"spans {dict(spans)} vs OperatorView calls {calls}; device trace "
          f"{n_events} events, kernels {got} vs counters K1 {k1} K4 {k4}",
          flush=True)
    if not (spans and calls == dict(spans) and all(
            len(r.output) == PROFILE_SERVE_NEW for r in reqs)
            and got == {"flash_fwd_tc_kernel": k1,
                        "paged_decode_kernel": k4} and k1 and k4):
        raise AssertionError("profiler serving: spans or kernels disagree")
    del eng, model
    _release(torch)
    return k1, k4


def ds2_waves(np, cfg, seed):
    """Phase 45's batch shape as 16 kHz waveforms: ds2_batch's frame
    counts (302-1174 from seed 0) as (frames - 1) x hop samples each
    (normal, zero past each length), padded to the longest; returns
    (waves [batch, samples], frame counts)."""
    rng = np.random.default_rng(seed)
    _, lens, _, _ = ds2_batch(np, cfg, seed)
    hop = DS2_FRONT["hop_length"]
    n = (lens - 1) * hop
    waves = rng.standard_normal((cfg["batch"], int(n.max())),
                                dtype=np.float32) * 0.1
    waves *= np.arange(waves.shape[1])[None] < n[:, None]
    return waves, lens


def ds2_front_end(pt, spec_layer, waves):
    """DS2's features: the linear power spectrogram's log
    (log(spec + 1e-14), PaddleSpeech's eps), [batch, frames, freq]."""
    spec = spec_layer(waves)                       # [batch, freq, frames]
    return pt.log(spec + 1e-14).transpose([0, 2, 1]), spec


def phase_ds2_front(torch, np, ops, card):
    """Phase 49: audio.features.Spectrogram(DS2_FRONT) and a log on phase
    45's batch shape (32 waveforms of 3-12 s at 16 kHz, 161 bins, 302-1174
    frames), card against CPU (the power within 1e-4 of its largest, the
    log features within 1e-3 where the power is above 1e-6 of its
    largest), ms a batch on the card; then one DS2 training step at full
    width fed by the card's features (finite loss), and phase 45's
    card-vs-CPU parity (DS2_PARITY) on the first rows' features."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import audio, nn, optimizer

    c = DS2
    _reset_counts(ops)
    waves, lens = ds2_waves(np, c, 0)
    out = {}
    for dev in ("cpu", DEVICE):
        pt.set_device(dev)
        layer = audio.features.Spectrogram(**DS2_FRONT)
        x = pt.to_tensor(waves)
        out[dev] = ds2_front_end(pt, layer, x)
    pt.set_device(DEVICE)
    feats, spec = out[DEVICE]
    ref_feats, ref_spec = out["cpu"]
    top = ref_spec.abs().max().item()
    spec_err = (spec.cpu() - ref_spec).abs().max().item() / top
    live = (ref_spec >= 1e-6 * top).transpose([0, 2, 1])
    feat_err = ((feats.cpu() - ref_feats).abs() * live).max().item()
    ms = cuda_ms(lambda: ds2_front_end(pt, layer, x), 10, 2)
    frames = feats.shape[1]
    print(f"ds2 front end [{card}]: Spectrogram(n_fft 320, hop 160, win 320,"
          f" hann, power 2) + log on {waves.shape[0]} waveforms of "
          f"{(lens.min() - 1) * 160 / 16000:.2f}-"
          f"{(lens.max() - 1) * 160 / 16000:.2f} s at 16 kHz (padded to "
          f"{waves.shape[1]} samples): features {list(feats.shape)} "
          f"({feats.shape[2]} bins, {frames} frames, rows' lengths "
          f"{lens.min()}-{lens.max()}); card vs CPU power error "
          f"{spec_err:.3e} of its largest (tol 1e-4), log error "
          f"{feat_err:.3e} where the power is live (tol 1e-3); "
          f"ms_per_batch={ms:.3f}", flush=True)
    if not (spec_err <= 1e-4 and feat_err <= 1e-3 and feats.shape[2]
            == c["freq"] and frames == int(lens.max())
            and feats.device.type == torch.device(DEVICE).type):
        raise AssertionError(f"ds2 front end: power {spec_err}, log "
                             f"{feat_err}, shape {list(feats.shape)}")
    # one full-width DS2 step on the card's features
    _, _, labels, lab_lens = ds2_batch(np, c, 0)
    pt.seed(0)
    model = deepspeech2(pt, c, DEVICE)
    opt = optimizer.Adam(c["lr"], parameters=model.parameters(),
                         grad_clip=nn.ClipGradByGlobalNorm(c["clip"]))
    loss = ds2_loss(pt, model, feats.detach(), lens, pt.to_tensor(labels),
                    pt.to_tensor(lab_lens))
    loss.backward()
    opt.step()
    opt.clear_grad()
    value = loss.item()
    n_params = sum(q.numel() for q in model.parameters())
    print(f"ds2 front end [{card}]: one DS2 step ({n_params / 1e6:.1f}M "
          f"params) on these features: loss {value:.4f}", flush=True)
    if not math.isfinite(value):
        raise AssertionError(f"ds2 front end: loss {value}")
    del model, opt
    _release(torch)
    # the parity of phase 45 on the features of the first rows
    p = DS2_PARITY
    n = p["batch"]
    cut = min(int(lens[:n].max()), DS2_FRONT_PARITY_FRAMES)
    f_small = feats[:n, :cut].cpu().numpy()
    l_small = np.minimum(lens[:n], cut)
    _ds2_parity(torch, np, pt, card, f_small, l_small)
    _no_kernel_ran(ops, "ds2 front end")


def lstm_lm(pt, cfg, hidden, dropout, device):
    """Zaremba et al.'s PTB language model (LSTM_LM) of the Paddle layers:
    Embedding, Dropout, two one-layer LSTMs with Dropout after each, a
    Linear head; every weight Uniform(-init, init) through ParamAttr. The
    hidden state starts at zero every batch (the paper carries it from one
    batch to the next)."""
    from paddle_tpu_torch import nn

    def attr():
        return pt.ParamAttr(initializer=nn.initializer.Uniform(
            -cfg["init"], cfg["init"]))

    def lstm():
        return nn.LSTM(hidden, hidden, weight_ih_attr=attr(),
                       weight_hh_attr=attr(), bias_ih_attr=attr(),
                       bias_hh_attr=attr(), device=device)

    class LSTMLM(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embedding = nn.Embedding(cfg["vocab"], hidden,
                                          weight_attr=attr(), device=device)
            self.dropout = nn.Dropout(dropout)
            self.lstm1, self.lstm2 = lstm(), lstm()
            self.head = nn.Linear(hidden, cfg["vocab"], weight_attr=attr(),
                                  bias_attr=attr(), device=device)

        def forward(self, ids):
            x = self.dropout(self.embedding(ids))
            x = self.dropout(self.lstm1(x)[0])
            x = self.dropout(self.lstm2(x)[0])
            return self.head(x)

    return LSTMLM()


def lstm_lm_loss():
    """The paper's loss: cross entropy summed over the unrolled steps,
    averaged over the batch."""
    from paddle_tpu_torch import nn

    class SequenceLoss(nn.Layer):
        def __init__(self):
            super().__init__()
            self.ce = nn.CrossEntropyLoss(reduction="sum")

        def forward(self, logits, labels):
            return self.ce(logits, labels) / logits.shape[0]

    return SequenceLoss()


def _lstm_lm_parity(torch, np, pt, ids, labels, card):
    """LSTM_LM_PARITY: the first step's loss and gradients, card vs CPU
    from the same weights."""
    p = LSTM_LM_PARITY
    pt.seed(0)
    cpu = lstm_lm(pt, LSTM_LM, p["hidden"], p["dropout"], "cpu")
    gpu = lstm_lm(pt, LSTM_LM, p["hidden"], p["dropout"], DEVICE)
    _copy_state(torch, gpu, cpu)
    loss_fn, runs = lstm_lm_loss(), []
    for m, dev in ((cpu, "cpu"), (gpu, DEVICE)):
        loss = loss_fn(m(ids.to(dev)), labels.to(dev))
        runs.append((loss.item(), torch.autograd.grad(
            loss, list(m.parameters()))))
    (lc, gc), (lg, gg) = runs
    loss_rel = abs(lg - lc) / abs(lc)
    names = [n for n, _ in cpu.named_parameters()]
    worst = max((((b.cpu() - a).abs().max() / a.abs().max()).item(), n)
                for n, a, b in zip(names, gc, gg))
    on_card = all(g.device.type == torch.device(DEVICE).type for g in gg)
    print(f"lstm lm parity [{card}]: hidden {p['hidden']}, dropout off, "
          f"first step loss cpu {lc:.6f} card {lg:.6f} (rel {loss_rel:.3e});"
          f" gradients worst {worst[0]:.3e} of the parameter's largest "
          f"({worst[1]}, tol {p['tol']})", flush=True)
    if not (loss_rel <= p["tol"] and worst[0] <= p["tol"] and on_card):
        raise AssertionError(f"lstm lm card vs CPU: loss {loss_rel}, "
                             f"gradients {worst}, on card {on_card}")


def _kernels_per_step(torch, step):
    """CUDA kernels torch.profiler records in one ``step()`` (copies and
    memsets left out), or None when it records none. Only device activity
    is traced, and the raw events are counted (building the profiler's
    event tree takes seconds for a step of 10^4 kernels)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA
            and not e.name().startswith(("Memcpy", "Memset")))
    return n or None


def phase_lstm_lm(torch, np, ops, card):
    """Phase 43: the large PTB LSTM of LSTM_LM trained through
    hapi.Model.train_batch with SGD and the global-norm clip; K1-K6 must
    not launch."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import hapi, nn, optimizer

    c, t = LSTM_LM, LSTM_LM_TIMED
    pt.set_device(DEVICE)
    _reset_counts(ops)
    toks = np.random.default_rng(0).integers(0, c["vocab"],
                                              (c["batch"], c["steps"] + 1))
    ids = torch.from_numpy(toks[:, :-1])
    labels = torch.from_numpy(toks[:, 1:])
    _lstm_lm_parity(torch, np, pt, ids, labels, card)
    _release(torch)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()   # what earlier phases still hold
    pt.seed(0)
    net = lstm_lm(pt, c, c["hidden"], c["dropout"], DEVICE)
    loss_fn = lstm_lm_loss()
    model = hapi.Model(net)
    model.prepare(optimizer.SGD(c["lr"], parameters=net.parameters(),
                                grad_clip=nn.ClipGradByGlobalNorm(c["clip"])),
                  loss_fn)
    x, y = ids.to(DEVICE), labels.to(DEVICE)

    def eval_loss():
        net.eval()
        with torch.no_grad():
            out = loss_fn(net(x), y).item()
        net.train()
        return out

    def step():
        return model.train_batch([x], [y])[0][0]

    before = eval_loss()
    losses = [step() for _ in range(t["warmup"])]
    sync()
    t0 = time.perf_counter()
    losses += [step() for _ in range(t["steps"])]
    sync()
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    after = eval_loss()
    kernels = _kernels_per_step(torch, step)
    n_params = sum(p.numel() for p in net.parameters())
    ms = wall / t["steps"] * 1e3
    tok_s = c["batch"] * c["steps"] * t["steps"] / wall
    print(f"lstm lm [{card}]: ms_per_step={ms:.2f} tokens_per_s={tok_s:.1f} "
          f"peak_mem_gb={peak:.3f} (over the {base / 1e9:.3f} GB earlier "
          f"phases hold) kernels_per_step="
          f"{kernels if kernels else 'not measured (no device event)'} "
          f"({n_params / 1e6:.2f}M params, vocab {c['vocab']}, 2 x LSTM "
          f"{c['hidden']}, batch {c['batch']} x {c['steps']} steps, fp32, "
          f"dropout {c['dropout']}, SGD lr {c['lr']} clip {c['clip']}, "
          f"{t['steps']} timed steps after {t['warmup']}); eval loss on "
          f"the fixed batch {before:.4f} -> {after:.4f} (per token "
          f"{before / c['steps']:.4f} -> {after / c['steps']:.4f}, ln vocab "
          f"{math.log(c['vocab']):.4f}); train losses "
          f"{[round(v, 3) for v in losses]}", flush=True)
    if not (all(math.isfinite(v) for v in losses + [before, after])
            and after < before):
        raise AssertionError(f"lstm lm: losses {losses}, eval {before} -> "
                             f"{after}")
    counts = _no_kernel_ran(ops, "lstm lm")
    print(f"lstm lm: K1-K6 launches {counts}", flush=True)
    del net, model
    _release(torch)


def deepspeech2(P, cfg, device=None):
    """DS2's acoustic model of ``P``'s Paddle layers (the port, or any
    package with Paddle's API): ``forward(x [batch, frames, freq], lengths
    (host ints))`` returns the per-frame logits [batch, frames / 3, vocab]
    and the post-conv lengths. Each conv block's output is multiplied by
    the frame mask; the GRUs take the lengths as ``sequence_length``."""
    import numpy as np

    nn = P.nn
    kw = {} if device is None else {"device": device}
    c, h = cfg["channels"], cfg["hidden"]
    feat = c * ((((cfg["freq"] - 1) // 2 + 1) - 1) // 2 + 1)

    class DeepSpeech2(nn.Layer):
        def __init__(self):
            super().__init__()
            self.conv1 = nn.Conv2D(1, c, (41, 11), (2, 3), (20, 5), **kw)
            self.bn1 = nn.BatchNorm2D(c, **kw)
            self.conv2 = nn.Conv2D(c, c, (21, 11), (2, 1), (10, 5), **kw)
            self.bn2 = nn.BatchNorm2D(c, **kw)
            self.act = nn.Hardtanh(0.0, 20.0)
            self.rnns = nn.LayerList([
                nn.GRU(feat if i == 0 else 2 * h, h, direction="bidirect",
                       **kw) for i in range(cfg["layers"])])
            self.head = nn.Linear(2 * h, cfg["vocab"], **kw)

        def forward(self, x, lengths):
            lens = (np.asarray(lengths) - 1) // 3 + 1
            y = x.transpose([0, 2, 1]).unsqueeze(1)       # [b, 1, freq, t]
            y = self.act(self.bn1(self.conv1(y)))
            mask = P.to_tensor((np.arange(y.shape[3])[None] < lens[:, None])
                               .astype(np.float32)[:, None, None, :])
            y = y * mask
            y = self.act(self.bn2(self.conv2(y))) * mask
            b, ch, f, t = y.shape
            y = y.transpose([0, 3, 1, 2]).reshape([b, t, ch * f])
            for rnn in self.rnns:
                y = rnn(y, sequence_length=lens)[0]
            return self.head(y), lens

    return DeepSpeech2()


def ds2_batch(np, cfg, seed):
    """Features [batch, frames, freq] (normal; zero past each length),
    lengths, labels [batch, longest] in 1..vocab-1 (0 is the blank) and
    label lengths, from ``seed``."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(cfg["frames"][0], cfg["frames"][1] + 1, cfg["batch"])
    feats = rng.standard_normal((cfg["batch"], int(lens.max()), cfg["freq"]),
                                dtype=np.float32)
    feats *= (np.arange(feats.shape[1])[None] < lens[:, None])[..., None]
    lab_lens = rng.integers(cfg["labels"][0], cfg["labels"][1] + 1,
                            cfg["batch"])
    labels = rng.integers(1, cfg["vocab"], (cfg["batch"], int(lab_lens.max())))
    return feats, lens, labels, lab_lens


def ds2_loss(P, model, feats, lens, labels, lab_lens, reduction="mean"):
    """CTC of the model's logits over each row's post-conv length."""
    logits, out_lens = model(feats, lens)
    return P.nn.functional.ctc_loss(logits.transpose([1, 0, 2]), labels,
                                    P.to_tensor(out_lens), lab_lens,
                                    reduction=reduction)


def _graph_break_count(torch):
    return sum(torch._dynamo.utils.counters["graph_break"].values())


def phase_to_static_bert(torch, np, ops, card):
    """Phase 50: phase 41's arm (a) (O1 bf16, GradScaler(1024), AdamW) at
    JIT_BERT's 4 layers with pt.jit.to_static(model): the first step's
    loss and gradients against the eager step's on the same seed-0
    weights and batch, then JIT_STATIC warm-up and timed steps; one Dynamo
    graph for the forward, no graph break and no recompile across the
    timed steps, one each of K1-lse, K2, K3 a layer a step, finite losses
    that fall. Returns the timed steps' (K1-lse, K2, K3) launches."""
    import paddle_tpu_torch as pt

    c, d, j = JIT_BERT, DYGRAPH, JIT_STATIC
    L = c["layers"]
    pt.set_device(DEVICE)
    torch.cuda.reset_peak_memory_stats()
    pt.seed(0)
    eager = dygraph_encoder(pt, c, DEVICE)
    model = dygraph_encoder(pt, c, DEVICE)
    model.set_state_dict(eager.state_dict())
    pt.jit.to_static(model)
    ids, labels = _dygraph_batch(pt, np, c, d["batch"], d["seq"], DEVICE)
    breaks0 = _graph_break_count(torch)
    first = {}
    for name, m in (("eager", eager), ("compiled", model)):
        # the compiled arm's optimizer and scaler go on to the timed steps
        opt = _dygraph_opt(pt, m, d["lr"])
        scaler = pt.amp.GradScaler(init_loss_scaling=1024)
        sync()
        t0 = time.perf_counter()
        loss = dygraph_step(pt, m, opt, scaler, ids, labels, "O1",
                            "bfloat16", keep_grads=True)
        sync()
        first[name] = (loss.item(), _step_grads(m),
                       time.perf_counter() - t0)
        opt.clear_grad()
    del eager
    _release(torch)
    (l_e, g_e, _), (l_c, g_c, compile_s) = first["eager"], first["compiled"]
    loss_err = abs(l_c - l_e) / abs(l_e)
    err, where, noise = amp_grad_errors(g_c, g_e)

    def step():
        return dygraph_step(pt, model, opt, scaler, ids, labels, "O1",
                            "bfloat16")

    warm, losses = [], [l_c]
    for _ in range(j["warmup"]):
        t0 = time.perf_counter()
        losses.append(step().item())
        warm.append(time.perf_counter() - t0)
    graphs0 = model.forward.traces
    sync()
    _reset_counts(ops)
    t0 = time.perf_counter()
    timed = [step() for _ in range(j["steps"])]
    sync()
    wall = time.perf_counter() - t0
    counts = _read_counts(ops)
    losses += [x.item() for x in timed]
    graphs, breaks = model.forward.traces, _graph_break_count(torch) - breaks0
    per_step = [counts[k] / j["steps"] for k in ("k1_lse", "k2", "k3")]
    eager_ms = DYGRAPH_MS.get("a O1 bf16")
    ms = wall / j["steps"] * 1e3
    print(f"to_static bert [{card}]: first step (Dynamo capture + Inductor "
          f"compile of forward and backward) {compile_s:.2f} s, warm-up "
          f"steps {[round(x, 3) for x in warm]} s; ms_per_step={ms:.2f} "
          f"at {L} layers (phase 41 (a) eager at 12 layers in this run: "
          f"{'not measured' if eager_ms is None else f'{eager_ms:.2f}'}) "
          f"tokens_per_s={d['batch'] * d['seq'] / ms * 1e3:.1f} "
          f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}; "
          f"graphs {graphs} (before the timed steps {graphs0}), graph "
          f"breaks {breaks}; first step vs eager: loss {l_c:.6f} / "
          f"{l_e:.6f} (rel err {loss_err:.3e}, tol {SMALL_AMP['tol']}), "
          f"gradients worst err {err:.3e} of the largest ({where}, tol "
          f"{AMP_GRAD_TOL}; as noise: {len(noise)} leaves); launches per "
          f"step k1_lse/k2/k3={per_step} primal_k1={counts['k1']}; losses "
          f"{[round(x, 4) for x in losses]}", flush=True)
    if not (loss_err <= SMALL_AMP["tol"] and err <= AMP_GRAD_TOL):
        raise AssertionError(f"to_static bert vs eager: loss {loss_err}, "
                             f"gradients {err} ({where})")
    if graphs != 1 or graphs0 != graphs or breaks:
        raise AssertionError(f"to_static bert: {graphs} graphs ({graphs0} "
                             f"before the timed steps), {breaks} breaks")
    if per_step != [L, L, L] or counts["k1"]:
        raise AssertionError(f"to_static bert: launches {counts}")
    if not (all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]):
        raise AssertionError(f"to_static bert: losses {losses}")
    del model, opt, scaler, timed
    _release(torch)
    return counts["k1_lse"], counts["k2"], counts["k3"]


def _bf16_ulp_err(np, ref, got):
    """(largest |got - ref|, whether each row's is within DEPLOY_ULPS bf16
    ulps of that row's largest |ref|)."""
    ref = ref.astype(np.float64)
    diff = np.abs(got.astype(np.float64) - ref)
    top = np.abs(ref).max(axis=-1)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(top, 1e-30))) - 7)
    return float(diff.max()), bool((diff.max(axis=-1)
                                    <= DEPLOY_ULPS * ulp).all())


def _timed_ms(fn, iters):
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - t0) / iters * 1e3


def phase_deploy_bert(torch, np, ops, card):
    """Phase 51: the encoder in eval, its weights cast to bf16: jit.save
    with InputSpec([batch, seq], "int64") under build/, jit.load and
    create_predictor(Config(path)); logits against the eager model's
    (identical, else within DEPLOY_ULPS bf16 ulps of each row's largest);
    the .pdmodel run by a fresh process that imports only
    paddle_tpu_torch.inference; 12 primal K1 launches a forward; ms a
    batch for eager, loaded and Predictor; enable_bf16 on an fp32 save
    against the fp32 logits. Returns the checked forwards' primal K1
    launches (eager, loaded, Predictor)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import inference

    c, d, j = DYGRAPH_BERT, DYGRAPH, JIT_STATIC
    L = c["layers"]
    pt.set_device(DEVICE)
    pt.seed(0)
    model = dygraph_encoder(pt, c, DEVICE)
    model.eval()
    fp32_state = {k: v.detach().clone() for k, v in
                  model.state_dict().items()}
    model.to(torch.bfloat16)
    ids, _ = _dygraph_batch(pt, np, c, d["batch"], d["seq"], DEVICE)
    ids_np = ids.cpu().numpy()
    root = _scratch_dir("deploy")
    path = os.path.join(root, "bert")
    spec = [pt.static.InputSpec([d["batch"], d["seq"]], "int64")]
    t0 = time.perf_counter()
    pt.jit.save(model, path, input_spec=spec)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = pt.jit.load(path)
    pred = inference.create_predictor(inference.Config(path))
    load_s = time.perf_counter() - t0
    k1 = {}
    with torch.no_grad():
        outs = {}
        for name, fn in (("eager", lambda: model(ids)),
                         ("loaded", lambda: loaded(ids)),
                         ("predictor", lambda: pred.run([ids_np])[0])):
            _reset_counts(ops)
            out = fn()
            sync()
            k1[name] = ops.flash_attention.launches
            outs[name] = (out.float().cpu().numpy()
                          if isinstance(out, torch.Tensor) else out)
        ms = {"eager": _timed_ms(lambda: model(ids), j["deploy_iters"]),
              "loaded": _timed_ms(lambda: loaded(ids), j["deploy_iters"]),
              "predictor": _timed_ms(lambda: pred.run([ids_np]),
                                     j["deploy_iters"])}
    ref = outs["eager"]
    errs = {n: _bf16_ulp_err(np, ref, outs[n]) for n in ("loaded", "predictor")}
    same = {n: bool(np.array_equal(ref, outs[n])) for n in errs}

    # a fresh process that imports only paddle_tpu_torch.inference runs the
    # .pdmodel beside the untimed enable_bf16 case (its import and CUDA
    # context take seconds of host time; it launches one forward)
    ids_path = os.path.join(root, "ids.npy")
    out_path = os.path.join(root, "fresh.npy")
    np.save(ids_path, ids_np)
    code = ("import sys\n"
            "import numpy as np\n"
            "import paddle_tpu_torch.inference as inf\n"
            f"ids = np.load({ids_path!r})\n"
            f"(o,) = inf.create_predictor(inf.Config({path!r})).run([ids])\n"
            f"np.save({out_path!r}, o)\n"
            "fa = sys.modules['paddle_tpu_torch.ops.flash_attention']\n"
            "print(fa.flash_attention.launches)\n")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)))
    fresh_t0 = time.perf_counter()
    fresh_proc = subprocess.Popen([sys.executable, "-c", code],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True, env=env)
    try:
        # enable_bf16 on an fp32 save
        model32 = dygraph_encoder(pt, c, DEVICE)
        model32.set_state_dict(fp32_state)
        model32.eval()
        path32 = os.path.join(root, "bert32")
        pt.jit.save(model32, path32, input_spec=spec)
        cfg = inference.Config(path32)
        cfg.enable_bf16()
        with torch.no_grad():
            ref32 = model32(ids).float().cpu().numpy()
        (got16,) = inference.create_predictor(cfg).run([ids_np])
        err16 = float(np.abs(got16 - ref32).max()) / max(
            1.0, float(np.abs(ref32).max()))
    except BaseException:
        fresh_proc.kill()       # no process outlives the phase
        fresh_proc.communicate()
        raise
    try:
        stdout, stderr = fresh_proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        fresh_proc.kill()
        fresh_proc.communicate()
        raise AssertionError("deploy bert: the fresh process ran past 600 s")
    fresh_s = time.perf_counter() - fresh_t0
    if fresh_proc.returncode != 0:
        raise AssertionError(f"deploy bert: the fresh process failed: "
                             f"{stderr[-2000:]}")
    fresh = np.load(out_path)
    fresh_k1 = int(stdout.split()[-1])
    fresh_err = _bf16_ulp_err(np, ref, fresh)
    print(f"deploy bert [{card}]: jit.save {save_s:.2f} s (torch.export of "
          f"the bf16 forward), jit.load + create_predictor {load_s:.2f} s; "
          f"logits vs eager: identical {same}, largest diff / within "
          f"{DEPLOY_ULPS} bf16 ulps of each row's largest "
          f"{ {n: e for n, e in errs.items()} }; fresh process "
          f"({fresh_s:.1f} s beside the enable_bf16 case, K1 launches "
          f"{fresh_k1}) {fresh_err}; primal "
          f"K1 a forward {k1}; ms a batch { {n: round(v, 3) for n, v in ms.items()} }; "
          f"enable_bf16 on the fp32 save vs fp32 eager: {err16:.3e} of the "
          f"largest (tol {BF16_WEIGHT_TOL})", flush=True)
    for name, (_, ok) in list(errs.items()) + [("fresh", fresh_err)]:
        if not ok:
            raise AssertionError(f"deploy bert: {name} logits off "
                                 f"{errs.get(name, fresh_err)}")
    if set(k1.values()) != {L} or fresh_k1 != L:
        raise AssertionError(f"deploy bert: primal K1 {k1}, fresh "
                             f"{fresh_k1}")
    if not err16 <= BF16_WEIGHT_TOL:
        raise AssertionError(f"deploy bert: enable_bf16 {err16}")
    del model, model32, loaded, pred
    _release(torch)
    return sum(k1.values())


def phase_static_bert(torch, np, ops, card):
    """Phase 52: the encoder at JIT_BERT's 4 layers in fp32 (TF32 off) as
    a static program: static.data ids [batch, seq] int64 and labels
    [batch] int64, cross entropy, AdamW.minimize, Executor.run; the first
    step's loss against the eager fp32 step's on the same weights and
    batch (STATIC_LOSS_TOL), JIT_STATIC warm-up and timed steps with the
    loss falling, one cached signature, the recorded ops and
    apply_default_passes' counts (on a clone), one each of K1-lse, K2, K3
    a layer a step; disable_static() after. Returns the timed steps'
    (K1-lse, K2, K3) launches."""
    import paddle_tpu_torch as pt

    c, d, j = JIT_BERT, DYGRAPH, JIT_STATIC
    L = c["layers"]
    pt.set_device(DEVICE)
    pt.seed(0)
    ref = dygraph_encoder(pt, c, DEVICE)
    model = dygraph_encoder(pt, c, DEVICE)
    model.set_state_dict(ref.state_dict())
    ids, labels = _dygraph_batch(pt, np, c, d["batch"], d["seq"], DEVICE)
    opt = _dygraph_opt(pt, ref, d["lr"])
    loss = pt.nn.functional.cross_entropy(ref(ids), labels)
    loss.backward()
    opt.step()
    eager_loss = loss.item()
    del ref, opt, loss
    _release(torch)
    pt.enable_static()
    try:
        main = pt.static.Program()
        with pt.static.program_guard(main):
            x = pt.static.data("ids", [d["batch"], d["seq"]], "int64")
            y = pt.static.data("labels", [d["batch"]], "int64")
            loss = pt.nn.functional.cross_entropy(model(x), y)
            _dygraph_opt(pt, model, d["lr"]).minimize(loss)
        n_ops = main.num_ops
        passes = pt.static.apply_default_passes(main.clone(), [loss])
        exe = pt.static.Executor()
        feed = {"ids": ids, "labels": labels}
        t0 = time.perf_counter()
        losses = [float(exe.run(main, feed=feed, fetch_list=[loss])[0])]
        compile_s = time.perf_counter() - t0
        for _ in range(j["static_warmup"]):
            losses.append(float(exe.run(main, feed=feed,
                                        fetch_list=[loss])[0]))
        sync()
        _reset_counts(ops)
        t0 = time.perf_counter()
        for _ in range(j["static_steps"]):
            losses.append(float(exe.run(main, feed=feed,
                                        fetch_list=[loss])[0]))
        wall = time.perf_counter() - t0
        counts = _read_counts(ops)
        sigs = exe.cache_signatures()
    finally:
        pt.disable_static()
    err = abs(losses[0] - eager_loss) / abs(eager_loss)
    per_step = [counts[k] / j["static_steps"] for k in ("k1_lse", "k2",
                                                         "k3")]
    print(f"static bert [{card}]: {L} layers, {n_ops} recorded ops, passes on a clone "
          f"{passes}; first run (record replay, Dynamo capture, Inductor "
          f"compile) {compile_s:.2f} s; first loss {losses[0]:.6f} vs eager "
          f"fp32 {eager_loss:.6f} (rel err {err:.3e}, tol {STATIC_LOSS_TOL})"
          f"; ms_per_step={wall / j['static_steps'] * 1e3:.2f} (a fetched "
          f"loss read each step); cached signatures {len(sigs)}; launches "
          f"per step k1_lse/k2/k3={per_step} primal_k1={counts['k1']}; "
          f"losses {[round(x, 5) for x in losses]}", flush=True)
    if not err <= STATIC_LOSS_TOL:
        raise AssertionError(f"static bert: loss {losses[0]} vs eager "
                             f"{eager_loss}")
    if per_step != [L, L, L] or counts["k1"] or len(sigs) != 1:
        raise AssertionError(f"static bert: launches {counts}, signatures "
                             f"{sigs}")
    if not (all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]):
        raise AssertionError(f"static bert: losses {losses}")
    del model, exe, main
    _release(torch)
    return counts["k1_lse"], counts["k2"], counts["k3"]


def _count_layers(model, cls):
    return sum(isinstance(m, cls) for m in model.sublayers())


def phase_compression(torch, np, ops, card):
    """Phase 53: model compression of phase 41's BERT-base encoder (batch
    32 x 128, seed-0 weights). (a) QAT: QuantConfig() puts QuantedLinear
    in place of the 73 Linears; COMPRESS warm-up and timed O1 bf16 steps
    (GradScaler(1024), AdamW): 12 each of K1-lse, K2, K3 a step, a finite
    loss that falls, ms a step beside phase 41 (a)'s. (b) PTQ: absmax
    observers calibrated on COMPRESS["calib"] batches in eval (12 primal
    K1 a forward), convert: 73 ConvertedLinear, the int8 forward with 73
    int8 products (torch._int_mm, none routed to a float product) and 12
    primal K1; its logits against the fake-quant model's on the same
    scales within the head's one-step bound (below); ms a batch beside the
    float model's bf16 eval forward; the int8 GEMM at COMPRESS["int8_gemm"]
    against the dense int8 peak and bf16's. (c) ASP: prune_model(2, 4,
    "mask_1d") and decorate(AdamW): every pruned weight 2:4 at density
    0.5 after COMPRESS["asp_steps"] O1 bf16 steps, 12 each of K1-lse, K2,
    K3 a step. Returns ((a)'s and (c)'s K1-lse, K2, K3 launches, (b)'s
    checked forwards' primal K1 launches)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import quantization as Q
    from paddle_tpu_torch.incubate import asp

    c, d, q = DYGRAPH_BERT, DYGRAPH, COMPRESS
    L = c["layers"]
    n_linear = 6 * L + 1
    pt.set_device(DEVICE)
    ids, labels = _dygraph_batch(pt, np, c, d["batch"], d["seq"], DEVICE)
    eager_ms = DYGRAPH_MS.get("a O1 bf16")
    train = [0, 0, 0]

    def timed_steps(model, opt, scaler, n_warm, n_steps):
        def step():
            return dygraph_step(pt, model, opt, scaler, ids, labels, "O1",
                                "bfloat16")

        losses = [step().item() for _ in range(n_warm)]
        sync()
        _reset_counts(ops)
        t0 = time.perf_counter()
        timed = [step() for _ in range(n_steps)]
        sync()
        wall = time.perf_counter() - t0
        counts = _read_counts(ops)
        losses += [x.item() for x in timed]
        for i, k in enumerate(("k1_lse", "k2", "k3")):
            train[i] += counts[k]
        per = [counts[k] / n_steps for k in ("k1_lse", "k2", "k3")]
        return wall / n_steps * 1e3, per, counts, losses

    # (a) QAT
    pt.seed(0)
    model = dygraph_encoder(pt, c, DEVICE)
    Q.QAT(Q.QuantConfig()).quantize(model)
    nq = _count_layers(model, Q.QuantedLinear)
    opt = _dygraph_opt(pt, model, d["lr"])
    scaler = pt.amp.GradScaler(init_loss_scaling=1024)
    ms, per, counts, losses = timed_steps(model, opt, scaler, q["warmup"],
                                          q["steps"])
    print(f"compression (a) QAT [{card}]: {nq} QuantedLinear; ms_per_step="
          f"{ms:.2f} (phase 41 (a) eager float in this run: "
          f"{'not measured' if eager_ms is None else f'{eager_ms:.2f}'}) "
          f"tokens_per_s={d['batch'] * d['seq'] / ms * 1e3:.1f}; launches "
          f"per step k1_lse/k2/k3={per} primal_k1={counts['k1']}; losses "
          f"{[round(x, 4) for x in losses]}", flush=True)
    if nq != n_linear or per != [L, L, L] or counts["k1"]:
        raise AssertionError(f"QAT: {nq} quanted layers, launches {counts}")
    if not (all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]):
        raise AssertionError(f"QAT: losses {losses}")
    del model, opt, scaler
    _release(torch)

    # (b) PTQ, convert, the int8 forward
    pt.seed(0)
    model = dygraph_encoder(pt, c, DEVICE)
    model.eval()
    k1_checked = 0
    with torch.no_grad():
        def bf16_forward():
            with pt.amp.auto_cast(level="O1", dtype="bfloat16"):
                return model(ids)

        bf16_ms = _timed_ms(bf16_forward, q["forward_iters"])
        ptq = Q.PTQ()
        ptq.quantize(model)
        calib_k1 = []
        for i in range(q["calib"]):
            batch, _ = _dygraph_batch(pt, np, c, d["batch"], d["seq"],
                                      DEVICE, seed=100 + i)
            _reset_counts(ops)
            model(batch)
            sync()
            calib_k1.append(ops.flash_attention.launches)
        k1_checked += sum(calib_k1)
        for layer in model.sublayers():
            if isinstance(layer, Q.QuantedLinear):
                layer._calibrating = False
        fake = model(ids).float()
        fake_ms = _timed_ms(lambda: model(ids), q["forward_iters"])
        ptq.convert(model)
        nconv = _count_layers(model, Q.ConvertedLinear)
        Q.quantized_linear.launches = 0
        _reset_counts(ops)
        int8 = model(ids).float()
        sync()
        int8_products, int8_k1 = (Q.quantized_linear.launches,
                                  ops.flash_attention.launches)
        k1_checked += int8_k1
        int8_ms = _timed_ms(lambda: model(ids), q["forward_iters"])
    head = model.head
    w_head = head.qweight.float() * (head._w_scale / head._w_qmax)
    a_step = float(head._a_scale) / head._a_qmax
    # every head input one activation step off, all in the worst direction
    tol = a_step * float(w_head.abs().sum(0).max())
    err = float((int8 - fake).abs().max())
    print(f"compression (b) PTQ [{card}]: calibration primal K1 a forward "
          f"{calib_k1}; {nconv} ConvertedLinear; int8 forward: "
          f"{int8_products} int8 products (torch._int_mm), primal K1 "
          f"{int8_k1}; logits vs the fake-quant model on the same scales: "
          f"max abs diff {err:.4e} (bound {tol:.4e}: the head's "
          f"activation step {a_step:.4e} x its largest column |w| sum; "
          f"largest |logit| {float(fake.abs().max()):.4f}); ms a batch: "
          f"int8 {int8_ms:.3f}, fake-quant fp32 {fake_ms:.3f}, float "
          f"model bf16 eval (O1) {bf16_ms:.3f}", flush=True)
    if calib_k1 != [L] * q["calib"] or int8_k1 != L:
        raise AssertionError(f"PTQ: primal K1 {calib_k1}, {int8_k1}")
    if nconv != n_linear or int8_products != n_linear:
        raise AssertionError(f"PTQ: {nconv} converted, {int8_products} "
                             f"int8 products")
    if not (bool(torch.isfinite(int8).all()) and err <= tol):
        raise AssertionError(f"PTQ: int8 logits off by {err} (bound {tol})")
    del model, fake, int8
    _release(torch)
    m, k, n = q["int8_gemm"]
    g = torch.Generator(device=DEVICE).manual_seed(0)
    a8 = torch.randint(-127, 128, (m, k), device=DEVICE, dtype=torch.int8,
                       generator=g)
    b8 = torch.randint(-127, 128, (n, k), device=DEVICE, dtype=torch.int8,
                       generator=g).t()   # column-major, as ConvertedLinear
    exact = torch.equal(Q.int8_matmul(a8, b8).cpu(),
                        torch._int_mm(a8.cpu(), b8.cpu().contiguous()))
    ms8 = device_ms(torch, lambda: Q.int8_matmul(a8, b8))
    b_row = b8.contiguous()
    ms8_row = device_ms(torch, lambda: torch._int_mm(a8, b_row))
    ab, bb = a8.to(torch.bfloat16), b8.to(torch.bfloat16)
    ms16 = device_ms(torch, lambda: ab @ bb)
    ops8 = 2.0 * m * n * k
    bound8 = max(ops8 / INT8_PEAK * 1e3,
                 (m * k + k * n + 4 * m * n) / PEAK_BYTES * 1e3)
    print(f"int8 GEMM [{m}, {k}] x [{k}, {n}] [{card}]: exact vs the CPU "
          f"{exact}; device_ms {ms8:.4f} ({ops8 / ms8 / 1e9:.1f} TOPS, "
          f"{bound8 / ms8:.1%} of the bound {bound8:.4f} ms at "
          f"{INT8_PEAK / 1e12:.0f} TOPS dense int8; B column-major); "
          f"_int_mm on a row-major B {ms8_row:.4f} ms; bf16 matmul "
          f"{ms16:.4f} ms", flush=True)
    if not exact:
        raise AssertionError("int8 GEMM differs from the CPU's")
    del a8, b8, b_row, ab, bb

    # (c) ASP
    pt.seed(0)
    model = dygraph_encoder(pt, c, DEVICE)
    t0 = time.perf_counter()
    masks = asp.prune_model(model, 2, 4, "mask_1d")
    prune_s = time.perf_counter() - t0
    opt = asp.decorate(_dygraph_opt(pt, model, d["lr"]))
    scaler = pt.amp.GradScaler(init_loss_scaling=1024)
    ms, per, counts, losses = timed_steps(model, opt, scaler, 0,
                                          q["asp_steps"])
    pruned = [p for n_, p in model.named_parameters() if n_ in masks]
    sparse_ok = all(asp.check_sparsity(p.detach().t(), "1d") for p in pruned)
    density = sorted({asp.calculate_density(p) for p in pruned})
    print(f"compression (c) ASP [{card}]: prune_model {prune_s:.2f} s "
          f"({len(masks)} weights); {q['asp_steps']} steps ms_per_step="
          f"{ms:.2f}; after them 2:4 {sparse_ok}, densities {density}; "
          f"launches per step k1_lse/k2/k3={per}; losses "
          f"{[round(x, 4) for x in losses]}", flush=True)
    if not (len(masks) == n_linear and sparse_ok and density == [0.5]):
        raise AssertionError(f"ASP: {len(masks)} masks, 2:4 {sparse_ok}, "
                             f"densities {density}")
    if per != [L, L, L] or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"ASP: launches {counts}, losses {losses}")
    del model, opt, scaler
    _release(torch)
    return tuple(train), k1_checked


def _rel(torch, got, ref):
    """max |got - ref| / max(1, max |ref|), on the CPU in fp32."""
    got, ref = got.detach().float().cpu(), ref.detach().float().cpu()
    return float((got - ref).abs().max()) / max(1.0, float(ref.abs().max()))


def _fmt_weights(torch, cfg, gen):
    """fused_multi_transformer's per-layer weights at GPT-3 6.7B width,
    fp32 on the CPU from ``gen``, rounded to bf16 (the card's dtype)."""
    h, f, L = cfg["hidden"], cfg["ffn"], cfg["layers"]

    def w(*shape, scale=0.02, one=False):
        t = torch.randn(shape, generator=gen) * scale + (1.0 if one else 0.0)
        return t.to(torch.bfloat16).float()

    return dict(
        ln_scales=[w(h, one=True) for _ in range(L)],
        ln_biases=[w(h) for _ in range(L)],
        qkv_weights=[w(3 * h, h) for _ in range(L)],
        qkv_biases=[w(3 * h) for _ in range(L)],
        linear_weights=[w(h, h) for _ in range(L)],
        linear_biases=[w(h) for _ in range(L)],
        ffn_ln_scales=[w(h, one=True) for _ in range(L)],
        ffn_ln_biases=[w(h) for _ in range(L)],
        ffn1_weights=[w(h, f) for _ in range(L)],
        ffn1_biases=[w(f) for _ in range(L)],
        ffn2_weights=[w(f, h) for _ in range(L)],
        ffn2_biases=[w(h) for _ in range(L)])


def _fmt_run(torch, IF, ws, x, steps, device, dtype, nh, cache_len):
    kw = {k: [t.to(device, dtype) for t in v] for k, v in ws.items()}
    b, s, h = x.shape
    caches = [torch.zeros(2, b, nh, cache_len, h // nh, device=device,
                          dtype=dtype) for _ in range(len(ws["ln_scales"]))]
    outs, times = [], []
    for i, xi in enumerate([x] + steps):
        t0 = time.perf_counter()
        outs.append(IF.fused_multi_transformer(
            xi.to(device, dtype), cache_kvs=caches, num_heads=nh,
            time_step=None if i == 0 else s + i - 1, **kw))
        if device != "cpu":
            sync()
        times.append(time.perf_counter() - t0)
    return outs, caches, times


def phase_fused_family(torch, np, ops, card):
    """Phase 54: the incubate.nn.functional fused family on the card
    against CPU runs of the same functions on the same (bf16-rounded)
    values in fp32. fused_multi_transformer at GPT-3 6.7B width (FMT: 2
    layers, hidden 4096, 32 heads of 128, ffn 16384, bf16, weights from
    seed 0): prefill 8 x 512 into per-layer caches, then 16 decode steps
    through time_step; 2 K1 launches the prefill and 2 each decode step
    (a 1-row query over the longer end-aligned causal key); every output
    and the caches against the CPU run of batch row 0 (the rows are
    independent) within FAMILY_TOL["bfloat16"]. masked_multihead_attention
    on a dense cache MMHA ([2, 8, 32, 2048, 128] bf16), written in place.
    The other thirteen at BERT-base width (32 x 128 tokens, hidden 768,
    12 heads of 64, ffn 3072) in bf16 and fp32 (TF32 off), each within
    FAMILY_TOL of its dtype; variable_length_memory_efficient_attention
    launches K1 once a call. Returns the checked calls' primal K1
    launches."""
    import paddle_tpu_torch.incubate.nn.functional as IF

    f = FMT
    gen = torch.Generator().manual_seed(0)
    nh, s, steps_n = f["heads"], f["prefill"], f["decode"]
    ws = _fmt_weights(torch, f, gen)
    x = torch.randn(f["batch"], s, f["hidden"], generator=gen)
    steps = [torch.randn(f["batch"], 1, f["hidden"], generator=gen)
             for _ in range(steps_n)]
    cache_len = s + steps_n
    with torch.no_grad():
        _reset_counts(ops)
        outs, caches, times = _fmt_run(torch, IF, ws, x, steps, DEVICE,
                                       torch.bfloat16, nh, cache_len)
        k1 = ops.flash_attention.launches
        ref, ref_caches, ref_times = _fmt_run(
            torch, IF, ws, x[:1], [t[:1] for t in steps], "cpu",
            torch.float32, nh, cache_len)
    errs = [_rel(torch, o[:1], r) for o, r in zip(outs, ref)]
    cerr = max(_rel(torch, c_[:, :1], r) for c_, r in zip(caches,
                                                          ref_caches))
    want_k1 = f["layers"] * (1 + steps_n)
    tok_prefill = f["batch"] * s / times[0]
    decode_ms = sum(times[2:]) / max(len(times) - 2, 1) * 1e3
    print(f"fused_multi_transformer [{card}]: GPT-3 6.7B width, "
          f"{f['layers']} layers, bf16: prefill {f['batch']} x {s} "
          f"{times[0] * 1e3:.2f} ms ({tok_prefill:.1f} tokens/s, first call "
          f"included), decode steps {decode_ms:.3f} ms each (steps 2-"
          f"{steps_n}); K1 launches {k1} (want {want_k1}); row 0 vs the CPU "
          f"fp32 run: prefill {errs[0]:.3e}, decode worst "
          f"{max(errs[1:]):.3e}, caches {cerr:.3e} (tol "
          f"{FAMILY_TOL['bfloat16']}); CPU run {sum(ref_times):.2f} s",
          flush=True)
    if k1 != want_k1:
        raise AssertionError(f"fused_multi_transformer: K1 {k1}")
    if max(errs + [cerr]) > FAMILY_TOL["bfloat16"]:
        raise AssertionError(f"fused_multi_transformer: {errs}, {cerr}")
    del outs, caches, ref, ref_caches, ws
    _release(torch)
    k1_total = k1

    # masked_multihead_attention on a dense cache
    m = MMHA
    b, h, ms_, hd = m["batch"], m["heads"], m["max_seq"], m["head_dim"]
    cache = (torch.randn(2, b, h, ms_, hd, generator=gen) * 0.5).to(
        torch.bfloat16)
    xq = torch.randn(b, 3 * h * hd, generator=gen).to(torch.bfloat16)
    lens = torch.randint(1, ms_ - 1, (b, 1), generator=gen,
                         dtype=torch.int32)
    card_cache, xq_d, lens_d = cache.to(DEVICE), xq.to(DEVICE), lens.to(
        DEVICE)
    with torch.no_grad():
        out, _ = IF.masked_multihead_attention(xq_d, card_cache,
                                               sequence_lengths=lens_d)
        cpu_cache = cache.float()
        ref, _ = IF.masked_multihead_attention(xq.float(), cpu_cache,
                                               sequence_lengths=lens)
        written = all(torch.equal(
            card_cache[j, r, :, int(lens[r])].cpu(),
            xq.reshape(b, 3, h, hd)[r, 1 + j]) for j in (0, 1)
            for r in range(b))
        ms_mmha = device_ms(torch, lambda: IF.masked_multihead_attention(
            xq_d, card_cache, sequence_lengths=lens_d))
    e = _rel(torch, out, ref)
    nbytes = card_cache.numel() * 2
    print(f"masked_multihead_attention [{card}]: cache {list(cache.shape)} "
          f"bf16, lengths {lens.reshape(-1).tolist()}: error {e:.3e} (tol "
          f"{FAMILY_TOL['bfloat16']}), cache written at each row's "
          f"position {written}; device_ms {ms_mmha:.4f} (reads the whole "
          f"cache, as in JAX: bound {nbytes / PEAK_BYTES * 1e3:.4f} ms, "
          f"bytes)", flush=True)
    if e > FAMILY_TOL["bfloat16"] or not written:
        raise AssertionError(f"masked_multihead_attention: {e}, {written}")
    del cache, card_cache, cpu_cache
    _release(torch)

    # the other thirteen at BERT-base width, bf16 and fp32
    B, S, H, NH, FF = 32, 128, 768, 12, 3072
    HD = H // NH

    def r(*shape, scale=1.0, one=False):
        t = torch.randn(shape, generator=gen) * scale + (1.0 if one else 0.0)
        return t.to(torch.bfloat16).float()

    xs, res = r(B, S, H), r(B, S, H)
    vec = [r(H, scale=0.1) for _ in range(6)]
    gamma = r(H, scale=0.1, one=True)
    qk = [r(B, S, NH, HD) for _ in range(3)]
    w_in, w_out = r(H, FF, scale=0.02), r(FF, H, scale=0.02)
    b_ff = r(FF, scale=0.1)
    qkv_w = r(3, NH, HD, H, scale=0.02)
    qkv_b = r(3, NH, HD, scale=0.1)
    proj = r(H, H, scale=0.02)
    mask = torch.where(torch.rand(B, 1, S, S, generator=gen) < 0.9, 0.0,
                       -1e4)
    cases = {
        "fused_rms_norm": lambda t: IF.fused_rms_norm(
            t(xs), t(gamma), t(vec[0]), residual=t(res)),
        "fused_layer_norm": lambda t: IF.fused_layer_norm(
            t(xs), t(gamma), t(vec[0]), residual=t(res)),
        "swiglu": lambda t: IF.swiglu(t(xs), t(res)),
        "fused_rotary_position_embedding": lambda t: torch.cat(
            IF.fused_rotary_position_embedding(t(qk[0]), t(qk[1]))[:2]),
        "fused_bias_act": lambda t: IF.fused_bias_act(t(xs), t(vec[1])),
        "fused_linear": lambda t: IF.fused_linear(t(xs), t(w_in), t(b_ff)),
        "fused_linear_activation": lambda t: IF.fused_linear_activation(
            t(xs).reshape(-1, H), t(w_in), t(b_ff)),
        "fused_dropout_add": lambda t: IF.fused_dropout_add(
            t(xs), t(res), p=0.1, training=False),
        "fused_matmul_bias": lambda t: IF.fused_matmul_bias(
            t(xs), t(w_in), t(b_ff)),
        "fused_bias_dropout_residual_layer_norm":
            lambda t: IF.fused_bias_dropout_residual_layer_norm(
                t(xs), t(res), t(vec[1]), t(gamma), t(vec[2]),
                dropout_rate=0.1, training=False),
        "fused_multi_head_attention":
            lambda t: IF.fused_multi_head_attention(
                t(xs), t(qkv_w), t(proj), pre_layer_norm=True,
                pre_ln_scale=t(gamma), pre_ln_bias=t(vec[3]),
                qkv_bias=t(qkv_b), linear_bias=t(vec[4]),
                attn_mask=t(mask), training=False),
        "fused_feedforward": lambda t: IF.fused_feedforward(
            t(xs), t(w_in), t(w_out), t(b_ff), t(vec[5]), t(gamma),
            t(vec[0]), activation="gelu", pre_layer_norm=True,
            training=False),
        "variable_length_memory_efficient_attention":
            lambda t: IF.variable_length_memory_efficient_attention(
                t(qk[0]), t(qk[1]), t(qk[2]), causal=True),
    }
    worst = {}
    with torch.no_grad():
        for name, fn in cases.items():
            ref = fn(lambda a: a)
            for dtype in ("bfloat16", "float32"):
                dt = getattr(torch, dtype)
                _reset_counts(ops)
                got = fn(lambda a: a.to(DEVICE, dt))
                sync()
                n_k1 = ops.flash_attention.launches
                k1_total += n_k1
                want = 1 if name.startswith("variable_length") else 0
                e = _rel(torch, got, ref)
                worst[f"{name} {dtype}"] = (e, n_k1)
                if e > FAMILY_TOL[dtype] or n_k1 != want:
                    raise AssertionError(f"{name} {dtype}: error {e}, K1 "
                                         f"{n_k1}")
    print(f"fused family at BERT-base width [{card}]: error vs CPU fp32 "
          f"(tol {FAMILY_TOL}) and K1 launches: "
          f"{ {k: (round(v[0], 6), v[1]) for k, v in worst.items()} }",
          flush=True)
    print("fused_multi_transformer against the port's GPT block: not held; "
          "the block's MLP is the tanh GELU (jax.nn.gelu's default) and "
          "fused_multi_transformer's Paddle's exact GELU, so they compute "
          "other functions", flush=True)
    _release(torch)
    return k1_total


_CPP_OPS = r"""
#include <cstdint>
extern "C" const char* pt_op_list() { return "relu6"; }
extern "C" void relu6(const float* x, float* y, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        float v = x[i] < 0 ? 0 : x[i];
        y[i] = v > 6 ? 6 : v;
    }
}
extern "C" void relu6_grad(const float* x, const float* gy, float* gx,
                           int64_t n) {
    for (int64_t i = 0; i < n; ++i)
        gx[i] = (x[i] > 0 && x[i] < 6) ? gy[i] : 0;
}
"""


def _on_float_ids(pt, model):
    """``model`` behind a cast of its input to int64 ids (``flops`` feeds
    a float32 zero input)."""
    class OnFloatIds(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.m = model

        def forward(self, x):
            return self.m(x.long())

    return OnFloatIds()


def phase_packages(torch, np, ops, card):
    """Phase 55: the packages on the card against CPU runs: sparse matmul
    (SpMM) and masked_matmul (SDDMM, against cuSPARSE's sampled_addmm) at
    SPARSE; every distribution's log_prob, entropy and KL on DIST_N-element
    batches; send_u_recv sum, mean and max on a graph of ogbn-arxiv's
    published size (OGBN_ARXIV; edges from seed 0, no dataset read);
    viterbi_decode at VITERBI; a custom_op with a vjp and a cpp_extension
    op (g++, a host round trip) on card tensors; flops of the encoder
    beside 2 x its parameters x tokens. Errors max |card - cpu| / max(1,
    max |cpu|) within PACKAGE_TOL; K1-K6 not launched."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.distribution as D
    from paddle_tpu_torch import geometric, sparse, text
    from paddle_tpu_torch.utils import cpp_extension, custom_op

    gen = torch.Generator().manual_seed(0)
    tol = PACKAGE_TOL
    _reset_counts(ops)
    report = {}

    # sparse
    sp = SPARSE
    n = sp["n"]
    nnz = int(n * n * sp["density"])
    flat = torch.randperm(n * n, generator=gen)[:nnz]
    idx = torch.stack([flat // n, flat % n])
    vals = torch.randn(nnz, generator=gen)
    dense = torch.randn(n, sp["cols"], generator=gen)
    xs = torch.randn(n, sp["k"], generator=gen)
    ys = torch.randn(sp["k"], n, generator=gen)
    A = sparse.sparse_coo_tensor(idx.to(DEVICE), vals.to(DEVICE), [n, n])
    Ac = sparse.sparse_coo_tensor(idx, vals, [n, n], place="cpu")
    d_dense, d_x, d_y = dense.to(DEVICE), xs.to(DEVICE), ys.to(DEVICE)
    got = sparse.matmul(A, d_dense)
    e_mm = _rel(torch, got, sparse.matmul(Ac, dense))
    ms_mm = cuda_ms(lambda: sparse.matmul(A, d_dense))
    got = sparse.masked_matmul(d_x, d_y, A)
    e_sd = _rel(torch, got.values, sparse.masked_matmul(xs, ys, Ac).values)
    ms_sd = cuda_ms(lambda: sparse.masked_matmul(d_x, d_y, A))
    csr = torch.sparse_coo_tensor(idx, vals, (n, n)).coalesce(
    ).to_sparse_csr().to(DEVICE)
    ms_lib = cuda_ms(lambda: torch.sparse.sampled_addmm(csr, d_x, d_y,
                                                         beta=0.0))
    ms_dense = cuda_ms(lambda: d_x @ d_y)
    report["sparse"] = (e_mm, e_sd)
    print(f"sparse [{card}]: {n}x{n} at {sp['density']:.0%} ({nnz} "
          f"entries): matmul with [{n}, {sp['cols']}] error {e_mm:.3e}, "
          f"ms {ms_mm:.4f} (torch.sparse.mm, cuSPARSE; CUDA events "
          f"over chained calls); masked_matmul of [{n}, {sp['k']}] x "
          f"[{sp['k']}, {n}] error {e_sd:.3e}, ms {ms_sd:.4f} (gathers, in chunks of "
          f"{sparse._SDDMM_CHUNK}); cuSPARSE sampled_addmm {ms_lib:.4f}; "
          f"the dense product {ms_dense:.4f}", flush=True)
    del A, d_dense, d_x, d_y, csr
    _release(torch)

    # distributions
    nd = DIST_N

    def u(lo, hi):
        return torch.rand(nd, generator=gen) * (hi - lo) + lo

    a1, a2, loc, real = u(0.5, 2.5), u(0.5, 2.5), torch.randn(
        nd, generator=gen), torch.randn(nd, generator=gen)
    p1, unit, cnt = u(0.1, 0.9), u(0.05, 0.95), torch.randint(
        0, 6, (nd,), generator=gen).float()
    dists = {
        "Normal": ((loc, a1), real), "Uniform": ((loc, loc + a1), loc + 0.3),
        "Bernoulli": ((p1,), (unit > 0.5).float()),
        "Exponential": ((a1,), a2), "Beta": ((a1, a2), unit),
        "Gamma": ((a1, a2), a2), "Cauchy": ((loc, a1), real),
        "Laplace": ((loc, a1), real), "LogNormal": ((loc, a1 * 0.3), a2),
        "Gumbel": ((loc, a1), real), "Geometric": ((p1,), cnt),
        "Poisson": ((a1 * 3,), cnt),
        "Binomial": ((torch.full((nd,), 6.0), p1), cnt),
        "Chi2": ((a1 * 3,), a2), "StudentT": ((a1 * 3, loc, a1), real),
        "ContinuousBernoulli": ((p1,), unit),
    }
    kl_pairs = {"Normal", "Uniform", "Laplace", "Poisson", "Geometric"}
    derr = {}
    t0 = time.perf_counter()
    for name, (args, value) in dists.items():
        cls = getattr(D, name)
        dc = cls(*[a.to(DEVICE) for a in args])
        dh = cls(*args)
        derr[name] = _rel(torch, dc.log_prob(value.to(DEVICE)),
                          dh.log_prob(value))
        try:
            ent = (dc.entropy(), dh.entropy())
        except NotImplementedError:
            ent = None
        if ent is not None:
            derr[name] = max(derr[name], _rel(torch, *ent))
        if name in kl_pairs:
            q_args = [a.flip(0) for a in args]
            derr[name] = max(derr[name], _rel(
                torch, D.kl_divergence(dc, cls(*[a.to(DEVICE)
                                                 for a in q_args])),
                D.kl_divergence(dh, cls(*q_args))))
    sync()
    dist_s = time.perf_counter() - t0
    report["distribution"] = max(derr.values())
    print(f"distributions [{card}]: log_prob, entropy and KL on {nd} "
          f"elements, card vs CPU: { {k: float(f'{v:.3e}') for k, v in derr.items()} } "
          f"(tol {tol}); {dist_s:.2f} s with the CPU runs", flush=True)

    # send_u_recv on ogbn-arxiv's size
    g = OGBN_ARXIV
    rng = np.random.default_rng(0)
    src = torch.from_numpy(rng.integers(0, g["nodes"], g["edges"]))
    dst = torch.from_numpy(rng.integers(0, g["nodes"], g["edges"]))
    feat = torch.randn(g["nodes"], g["features"], generator=gen)
    d_feat, d_src, d_dst = feat.to(DEVICE), src.to(DEVICE), dst.to(DEVICE)
    gerr, gms = {}, {}
    for op in ("sum", "mean", "max"):
        gerr[op] = _rel(torch, geometric.send_u_recv(d_feat, d_src, d_dst,
                                                     op),
                        geometric.send_u_recv(feat, src, dst, op))
        gms[op] = device_ms(torch, lambda: geometric.send_u_recv(
            d_feat, d_src, d_dst, op), iters=10)
    gbytes = (g["edges"] * g["features"] * 4 * 2 + g["edges"] * 16
              + g["nodes"] * g["features"] * 4)
    lib = device_ms(torch, lambda: torch.zeros_like(d_feat).index_add_(
        0, d_dst, d_feat[d_src]), iters=10)
    report["geometric"] = max(gerr.values())
    print(f"send_u_recv [{card}]: {g['nodes']} nodes, {g['edges']} edges, "
          f"{g['features']} features (ogbn-arxiv's size, seed-0 edges): "
          f"error {gerr}, device_ms {gms} (bound "
          f"{gbytes / PEAK_BYTES * 1e3:.4f} ms, bytes: a gathered row "
          f"read and added per edge; index_add_ alone {lib:.4f})",
          flush=True)
    del d_feat, d_src, d_dst, feat
    _release(torch)

    # viterbi
    v = VITERBI
    emit = torch.randn(v["batch"], v["seq"], v["tags"], generator=gen)
    trans = torch.randn(v["tags"], v["tags"], generator=gen)
    lens = torch.randint(1, v["seq"] + 1, (v["batch"],), generator=gen)
    e_d, t_d, l_d = emit.to(DEVICE), trans.to(DEVICE), lens.to(DEVICE)
    sc, path = text.viterbi_decode(e_d, t_d, l_d)
    rsc, rpath = text.viterbi_decode(emit, trans, lens)
    e_v = _rel(torch, sc, rsc)
    same = torch.equal(path.cpu(), rpath)
    ms_v = cuda_ms(lambda: text.viterbi_decode(e_d, t_d, l_d), iters=5)
    report["viterbi"] = e_v
    print(f"viterbi_decode [{card}]: {v['batch']} x {v['seq']} x "
          f"{v['tags']} tags: scores error {e_v:.3e}, paths equal {same}; "
          f"ms {ms_v:.3f} ({v['seq'] - 1} steps forward and back)",
          flush=True)
    if not same:
        raise AssertionError("viterbi_decode: paths differ from the CPU's")

    # a custom op with a vjp, and a cpp_extension op
    @custom_op("chip_smoke_scaled_tanh",
               vjp=lambda x, g_: g_ * 2.0 * (1 - torch.tanh(x) ** 2))
    def scaled_tanh(x):
        return 2.0 * torch.tanh(x)

    xc = torch.randn(1 << 20, generator=gen)
    xd = xc.to(DEVICE).clone().requires_grad_(True)
    scaled_tanh(xd).sum().backward()
    xh = xc.clone().requires_grad_(True)
    scaled_tanh(xh).sum().backward()
    e_op = max(_rel(torch, scaled_tanh(xd), scaled_tanh(xh)),
               _rel(torch, xd.grad, xh.grad))
    root = _scratch_dir("cpp_extension")
    src_path = os.path.join(root, "ops.cc")
    with open(src_path, "w") as fh:
        fh.write(_CPP_OPS)
    t0 = time.perf_counter()
    ext = cpp_extension.load("chip_smoke_ops", [src_path])
    build_s = time.perf_counter() - t0
    xe = (xc * 4).to(DEVICE).clone().requires_grad_(True)
    ye = ext.relu6(xe)
    (ye * 3).sum().backward()
    ref_y = (xc * 4).clamp(0, 6)
    inside = ((xc * 4) > 0) & ((xc * 4) < 6)
    e_cpp = max(_rel(torch, ye, ref_y),
                _rel(torch, xe.grad, inside.float() * 3))
    on_card = ye.device == xe.device and xe.grad.device == xe.device
    ms_cpp = cuda_ms(lambda: ext.relu6(xe.detach()), iters=5)
    report["ops"] = (e_op, e_cpp)
    print(f"custom_op and cpp_extension [{card}]: custom_op (vjp) on "
          f"{xc.numel()} elements error {e_op:.3e}; cpp_extension relu6 "
          f"(g++ {build_s:.2f} s) error {e_cpp:.3e}, results on the card "
          f"{on_card}, {ms_cpp:.3f} ms a call (one host round trip)",
          flush=True)

    counts = _read_counts(ops)

    # flops of the encoder (its forward launches K1, not counted here)
    pt.set_device(DEVICE)
    pt.seed(0)
    enc = dygraph_encoder(pt, DYGRAPH_BERT, DEVICE)
    d = DYGRAPH
    tokens = d["batch"] * d["seq"]
    t0 = time.perf_counter()
    counted = pt.flops(_on_float_ids(pt, enc), [d["batch"], d["seq"]])
    flops_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in enc.parameters())
    print(f"flops of the encoder [{card}]: {counted} for {tokens} tokens "
          f"(XLA's rules over the aten ops, {flops_s:.2f} s); 2 x "
          f"{n_params} parameters x tokens = {2 * n_params * tokens} "
          f"(ratio {counted / (2 * n_params * tokens):.4f}: the embedding "
          f"tables are parameters that do no product, the attention's "
          f"products are not parameters)", flush=True)
    del enc
    worst = max([report["distribution"], report["geometric"],
                 report["viterbi"], *report["sparse"], *report["ops"]])
    if worst > tol or not on_card:
        raise AssertionError(f"packages: errors {report}, cpp op on the "
                             f"card {on_card}")
    if any(counts.values()):
        raise AssertionError(f"packages: port kernels ran: {counts}")
    _release(torch)

# ---- phase 56: distributed training -----------------------------------

def _start_world(rank, world, port, backend):
    """This process as rank ``rank`` of a torch.distributed world."""
    os.environ.update(PADDLE_TRAINER_ID=str(rank),
                      PADDLE_TRAINERS_NUM=str(world),
                      PADDLE_RANK_IN_NODE=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port), PADDLE_DISTRI_BACKEND=backend)
    from paddle_tpu_torch.distributed import init_parallel_env

    init_parallel_env()


def _dist_batches(torch, np, cfg, batch, steps):
    rng = np.random.default_rng(56)
    return [torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, TRAIN_SEQ)).astype(np.int32)).to(DEVICE)
        for _ in range(steps)]


def _dist_steps(torch, ops, eng, batches):
    """The engine's steps on ``batches``, each timed to its end, with every
    launch count set to 0 just before and read just after."""
    sync()
    _reset_counts(ops)
    losses, ms = [], []
    for ids in batches:
        t0 = time.perf_counter()
        losses.append(eng.step(ids, ids))
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = _read_counts(ops)
    return torch.stack(losses).float().cpu(), ms, counts


def phase_dist_one_rank(torch, np, ops, card):
    """(a): one NCCL rank, the full-width dense step through the mesh path
    against mesh=None; returns the mesh path's (K1-lse, K2, K3) launches."""
    from paddle_tpu_torch.distributed import Engine, destroy_process_group
    from paddle_tpu_torch.distributed.auto_parallel import make_mesh
    from paddle_tpu_torch.distributed.parallel import free_port
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(**TRAIN_CONFIG)
    _start_world(0, 1, free_port(), DIST_BACKEND)
    batches = _dist_batches(torch, np, cfg, TRAIN_BATCH, DIST_STEPS)
    runs = {}
    for arm in ("mesh=None", "mesh"):
        torch.cuda.empty_cache()
        model = LlamaForCausalLM(cfg, device=DEVICE, seed=0)
        mesh = make_mesh(MESH_1) if arm == "mesh" else None
        eng = Engine(model, mesh, lr=DIST_LR, clip_norm=1.0)
        losses, ms, counts = _dist_steps(torch, ops, eng, batches)
        host_s, spinning = host_enqueue_s(
            torch, lambda: eng.step(batches[0], batches[0]))
        runs[arm] = dict(losses=losses, ms=ms, counts=counts, host_s=host_s,
                         spinning=spinning)
        del eng, model
    destroy_process_group()
    torch.cuda.empty_cache()
    a, b = runs["mesh=None"], runs["mesh"]
    rel = ((b["losses"] - a["losses"]).abs() / a["losses"].abs()).max().item()
    keys = ("k1_lse", "k2", "k3")
    print(f"dist (a) [{card}]: one NCCL rank, mesh {MESH_1}, "
          f"{cfg.num_hidden_layers} layers, batch {TRAIN_BATCH} x seq "
          f"{TRAIN_SEQ}, bf16, {DIST_STEPS} steps: losses mesh "
          f"{[round(x, 5) for x in b['losses'].tolist()]} mesh=None "
          f"{[round(x, 5) for x in a['losses'].tolist()]} max_rel={rel:.3e}"
          f"; launches k1_lse/k2/k3 mesh {[b['counts'][k] for k in keys]} "
          f"mesh=None {[a['counts'][k] for k in keys]}", flush=True)
    for arm, r in runs.items():
        print(f"dist (a) {arm}: step ms {[round(x, 2) for x in r['ms']]} "
              f"median {sorted(r['ms'])[1]:.2f}; host enqueue of one step "
              f"{r['host_s'] * 1e3:.2f} ms (card still on the spin when "
              f"queued: {r['spinning']})", flush=True)
    print(f"dist (a): the mesh path adds "
          f"{sorted(b['ms'])[1] - sorted(a['ms'])[1]:.2f} ms a step (median)"
          f" and {(b['host_s'] - a['host_s']) * 1e3:.2f} ms of host "
          f"enqueue", flush=True)
    _check_losses(a["losses"], "dist (a)")
    need = DIST_STEPS * cfg.num_hidden_layers
    if not (rel <= DIST_LOSS_RTOL and all(
            b["counts"][k] == a["counts"][k] == need for k in keys)):
        raise AssertionError(f"dist (a): losses max_rel {rel} (tol "
                             f"{DIST_LOSS_RTOL}) or launches differ from "
                             f"{need} each")
    return tuple(b["counts"][k] for k in keys)


def _dist_need(label, n_layers):
    """K1-lse, K2 (dense), K2 (GLSE) and K3 launches on each rank over
    DIST_STEPS steps of a (b) mesh: dp=2, the rank's L layers once a step
    each; sep=2, ring attention's 2n + 1 = 5 stripe pairs a layer, forward
    and backward, K2 in GLSE mode (the merge differentiates each pair's
    lse); pp=2, the stage's L/2 layers (VPP: two chunks of L/4) for each
    of the 2 microbatches; zero-bubble runs the flash backward twice a
    layer and microbatch, in B (the activation's cotangent) and again in W
    (the q, k, v weights' gradients need dq, dk, dv)."""
    s = DIST_STEPS
    if label == "dp2":
        n = n_layers * s
        return dict(k1_lse=n, k2=n, k2_glse=0, k3=n)
    if label == "sep2":
        n = 5 * n_layers * s
        return dict(k1_lse=n, k2=0, k2_glse=n, k3=n)
    n = n_layers // 2 * 2 * s
    twice = 2 if label == "pp2_zb" else 1
    return dict(k1_lse=n, k2=twice * n, k2_glse=0, k3=twice * n)


@contextlib.contextmanager
def _c10d_calls(torch):
    """{name: calls} of torch.distributed's collectives made inside the
    block (the module functions, counted as they are called)."""
    dist = torch.distributed
    names = ("all_reduce", "broadcast", "all_gather_into_tensor",
             "reduce_scatter_tensor")
    counts = {}
    saved = {n: getattr(dist, n) for n in names}

    def counted(name, fn):
        def call(*args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            return fn(*args, **kwargs)
        return call

    for n in names:
        setattr(dist, n, counted(n, saved[n]))
    try:
        yield counts
    finally:
        for n in names:
            setattr(dist, n, saved[n])


def _param_errors(torch, got, ref, init, ulps=None, mant=7):
    """``got``'s parameters against ``ref``'s, both trained from ``init``
    ({name: tensor}, on the card): each element within p_tol = 2 * lr *
    steps plus |w| * 2**-(mant + 1) (one rounding of a float with ``mant``
    mantissa bits), or, with ``ulps``, plus ``ulps`` ulps at |w| + p_tol;
    each parameter's update within DIST_UPDATE_RTOL of ``ref``'s (2-norms;
    a parameter that ``ref`` does not move must not move). Returns (worst
    abs error, its name), the names past the first bound (``far``) and the
    second (``stale``), the elements past p_tol + |w| / 256, the element
    count, the worst error over its tolerance, and (the worst update
    error, its name)."""
    p_tol = 2 * DIST_LR * DIST_STEPS
    worst, far, stale, beyond, total_n, ratio = (0.0, ""), [], [], 0, 0, 0.0
    upd = (0.0, "")
    for name, want in ref.items():
        want, g, w0 = want.float(), got[name].float(), init[name].float()
        err = (g - want).abs()
        worst = max(worst, (err.max().item(), name))
        if ulps is None:
            tol = p_tol + want.abs() * 2.0 ** -(mant + 1)
        else:
            tol = p_tol + ulps * torch.exp2(
                torch.floor(torch.log2(want.abs() + p_tol)) - mant)
        beyond += int((err > p_tol + want.abs() * 2.0 ** -8).sum())
        total_n += err.numel()
        ratio = max(ratio, (err / tol).max().item())
        if bool((err > tol).any()):
            far.append(name)
        du_ref = want - w0
        n_ref = du_ref.norm().item()
        n_err = (g - w0 - du_ref).norm().item()
        rel = n_err / n_ref if n_ref > 0 else (0.0 if n_err == 0
                                               else float("inf"))
        upd = max(upd, (rel, name))
        if rel > DIST_UPDATE_RTOL:
            stale.append(name)
    return dict(worst=worst, far=far, stale=stale, beyond=beyond,
                total_n=total_n, ratio=ratio, upd=upd)


def _stage1_layers(axes, kw, n_layers):
    """The layers pipeline stage 1 of 2 holds on a pp mesh (VPP: its
    chunks, in vpp_layer_order), else the second half."""
    from paddle_tpu_torch.distributed.auto_parallel.pipeline import \
        vpp_layer_order

    v = kw.get("pp_interleave", 1) if "pp" in axes else 1
    order = vpp_layer_order(n_layers, 2, v)
    half = n_layers // 2
    return sorted(order[half:])


def _dist_rank(meshes, n_layers, dtype, ref_path, init_path, out_path):
    """One rank of phase 56 (b) (a spawned process sharing the card): for
    each (label, mesh, keywords) of ``meshes``, Engine over it on
    DIST_STEPS global batches, each rank keeping its shard; every rank
    saves each mesh's losses, step ms and launches, rank 0 also the
    collectives and point-to-point transfers of one more step and its
    gathered parameters' errors against the mesh=None run's
    (``ref_path``; both from ``init_path``'s weights), held on the card,
    and those of a planted fault: the same parameters with pp stage 1's
    blocks (_stage1_layers) put back to their initial values."""
    import numpy as np
    import torch
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode

    from paddle_tpu_torch import ops
    from paddle_tpu_torch.distributed import (Engine, destroy_process_group,
                                              init_parallel_env)
    from paddle_tpu_torch.distributed.auto_parallel import make_mesh
    from paddle_tpu_torch.distributed.communication.functional import \
        exchange
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    init_parallel_env()
    rank = torch.distributed.get_rank()
    cfg = LlamaConfig(**dict(TRAIN_CONFIG, num_hidden_layers=n_layers,
                             dtype=dtype))
    batches = _dist_batches(torch, np, cfg, TRAIN_BATCH, DIST_STEPS)
    if rank == 0:
        ref = torch.load(ref_path, map_location=DEVICE)
        init = torch.load(init_path, map_location=DEVICE)
    mant = 23 if dtype == "float32" else 7
    out = {}
    for label, axes, kw in meshes:
        eng = Engine(LlamaForCausalLM(cfg, device=DEVICE, seed=0),
                     make_mesh(axes), lr=DIST_LR, clip_norm=1.0, **kw)
        losses, ms, counts = _dist_steps(torch, ops, eng, batches)
        # the parameters whole (under pp every rank's copy of each block
        # takes its stage's values first): a collective call
        eng.sync_model()
        got = {n: (p.full_tensor() if isinstance(p, DTensor) else p)
               .detach().clone() for n, p in eng.model.named_parameters()}
        exchange.sends = exchange.recvs = 0
        if "pp" in axes:
            # a pp stage calls each block once a microbatch, which
            # CommDebugMode's module tracker cannot follow; its collectives
            # are c10d's own calls, counted where they are made
            with _c10d_calls(torch) as comms:
                eng.step(batches[0], batches[0])
                sync()
        else:
            with CommDebugMode() as comm:
                eng.step(batches[0], batches[0])
                sync()
            comms = {str(k).split(".")[-1]: v
                     for k, v in comm.get_comm_counts().items()}
        p2p = dict(sends=exchange.sends, recvs=exchange.recvs)
        print(f"dist (b) rank {rank} {label} {axes} {kw} {dtype}: step ms "
              f"{[round(x, 2) for x in ms]}; launches k1_lse/k2/k2_glse/k3 "
              f"{[counts[k] for k in ('k1_lse', 'k2', 'k2_glse', 'k3')]}; "
              f"collectives a step {comms}; point-to-point a step {p2p}",
              flush=True)
        out[label] = dict(losses=losses, ms=ms, counts=counts, comms=comms,
                          p2p=p2p)
        if rank == 0:
            ulps = (DIST_STEPS if dtype == "float32"
                    else DIST_SEP_ULPS.get(label))
            out[label]["params"] = _param_errors(torch, got, ref, init,
                                                 ulps, mant)
            frozen = tuple(f"model.layers.{i}."
                           for i in _stage1_layers(axes, kw, n_layers))
            planted = {n: init[n] if n.startswith(frozen) else t
                       for n, t in got.items()}
            out[label]["planted"] = dict(
                names=sorted(n for n in got if n.startswith(frozen)),
                moved=sorted(n for n in got if n.startswith(frozen)
                             and not torch.equal(ref[n], init[n])),
                caught=_param_errors(torch, planted, ref, init, ulps,
                                     mant)["stale"])
        del eng, got
        torch.cuda.empty_cache()
    torch.save(out, f"{out_path}.{rank}")
    destroy_process_group()


def dist_gloo_run(torch, np, ops, meshes, dtype="bfloat16"):
    """One process's mesh=None steps at DIST_DP_LAYERS layers of
    TRAIN_CONFIG in ``dtype``, then two processes sharing the card over
    gloo on each mesh of ``meshes`` over the same global batch: (mesh=None
    losses, its step ms, each rank's results from :func:`_dist_rank`)."""
    from paddle_tpu_torch.distributed import Engine, spawn
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(**dict(TRAIN_CONFIG, num_hidden_layers=DIST_DP_LAYERS,
                             dtype=dtype))
    batches = _dist_batches(torch, np, cfg, TRAIN_BATCH, DIST_STEPS)
    scratch = _scratch_dir(f"dist_{dtype}")
    init_path = os.path.join(scratch, "init.pt")
    ref_path = os.path.join(scratch, "mesh_none.pt")
    model = LlamaForCausalLM(cfg, device=DEVICE, seed=0)
    torch.save({n: p.detach().cpu() for n, p in model.named_parameters()},
               init_path)
    ref = Engine(model, lr=DIST_LR, clip_norm=1.0)
    losses, ms, _ = _dist_steps(torch, ops, ref, batches)
    torch.save({n: p.detach().cpu() for n, p in ref.model.named_parameters()},
               ref_path)
    del ref, model
    torch.cuda.empty_cache()
    out = os.path.join(scratch, "ranks.pt")
    spawn(_dist_rank, args=(meshes, DIST_DP_LAYERS, dtype, ref_path,
                            init_path, out),
          nprocs=2, backend="gloo", timeout=DIST_SPAWN_S)
    return losses, ms, [torch.load(f"{out}.{r}") for r in range(2)]


def phase_dist_dp(torch, np, ops, card):
    """(b): :func:`dist_gloo_run` over DIST_GLOO_MESHES in bf16. Returns
    the launches both ranks made (k1_lse, k2, k2_glse, k3), which every
    mesh checks against ``_dist_need``."""
    losses, ms, ranks = dist_gloo_run(torch, np, ops, DIST_GLOO_MESHES)
    p_tol = 2 * DIST_LR * DIST_STEPS
    total = dict(k1_lse=0, k2=0, k2_glse=0, k3=0)
    keys = tuple(total)
    for label, axes, kw in DIST_GLOO_MESHES:
        got = ranks[0][label]
        pe, pl = got["params"], got["planted"]
        need = _dist_need(label, DIST_DP_LAYERS)
        rel = max(((r[label]["losses"] - losses).abs()
                   / losses.abs()).max().item() for r in ranks)
        launches = [[r[label]["counts"][k] for k in keys] for r in ranks]
        bound = (f"{DIST_SEP_ULPS[label]} bf16 ulps" if label in
                 DIST_SEP_ULPS else "|w| / 256")
        print(f"dist (b) [{card}]: {label} {axes} {kw} over gloo, two ranks "
              f"on one card, {DIST_DP_LAYERS} layers at full width, "
              f"{TRAIN_BATCH} x {TRAIN_SEQ} global, bf16: losses "
              f"{[round(x, 5) for x in got['losses'].tolist()]} mesh=None "
              f"{[round(x, 5) for x in losses.tolist()]} max_rel={rel:.3e}; "
              f"params worst abs {pe['worst'][0]:.3e} ({pe['worst'][1]}; tol "
              f"{p_tol} + {bound}: worst {pe['ratio']:.3f}x; "
              f"{pe['beyond']} of {pe['total_n']} elements beyond {p_tol} + "
              f"|w| / 256); updates worst rel {pe['upd'][0]:.3e} "
              f"({pe['upd'][1]}; tol {DIST_UPDATE_RTOL}); planted fault "
              f"(stage 1's {len(pl['names'])} block parameters at their "
              f"initial values): caught {len(pl['caught'])} of the "
              f"{len(pl['moved'])} that mesh=None moves; rank 0 step ms "
              f"{[round(x, 2) for x in got['ms']]} against mesh=None "
              f"{[round(x, 2) for x in ms]}; launches k1_lse/k2/k2_glse/k3 "
              f"by rank {launches} (each {[need[k] for k in keys]}); "
              f"collectives a step {got['comms']}; point-to-point a step "
              f"{got['p2p']}", flush=True)
        if not (rel <= DIST_LOSS_RTOL and not pe["far"] and not pe["stale"]
                and all(r[label]["counts"][k] == need[k] for r in ranks
                        for k in keys)):
            raise AssertionError(f"dist (b) {label}: losses max_rel {rel}, "
                                 f"params beyond tolerance {pe['far']}, "
                                 f"updates beyond tolerance {pe['stale']}, "
                                 f"or launches {launches} != {need}")
        if not pl["moved"] or set(pl["caught"]) != set(pl["moved"]):
            raise AssertionError(f"dist (b) {label}: the planted fault "
                                 f"(stage 1's blocks frozen) caught "
                                 f"{pl['caught']}, not {pl['moved']}")
        for r in ranks:
            for k in keys:
                total[k] += r[label]["counts"][k]
    return total


# ---- phase 57: the numeric guard and the resilience trainer -------------
def _state_snapshot(eng):
    """Copies of an engine's parameters and AdamW moments."""
    return [t.detach().clone() for t in eng.params + eng.m + eng.v]


def _state_equal(torch, eng, snap):
    return all(torch.equal(t.detach(), s) for t, s in zip(
        eng.params + eng.m + eng.v, snap))


def phase_guard(torch, np, ops, card):
    """57 (a): bench_guard at full width; returns the timed waves'
    (K1-lse, K2, K3) launches (both engines)."""
    from paddle_tpu_torch.distributed import Engine
    from paddle_tpu_torch.distributed.resilience import FaultPlan, FaultSpec
    from paddle_tpu_torch.framework import numeric_guard as ng
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(**GUARD_CONFIG)
    rng = np.random.default_rng(0)
    batches = [torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (GUARD_BATCH, GUARD_SEQ)).astype(np.int32)).to(
        DEVICE) for _ in range(GUARD_ITERS)]
    torch.cuda.empty_cache()

    def make(guard):
        eng = Engine(LlamaForCausalLM(cfg, device=DEVICE, seed=0),
                     lr=1e-4, clip_norm=1.0, guard=guard)
        eng.step(batches[0], batches[0])
        sync()
        return eng

    words, losses = [], {"plain": [], "guarded": []}

    def wave(eng, name):
        sync()
        t0 = time.perf_counter()
        for ids in batches:
            losses[name].append(eng.step(ids, ids))
            if eng.guard is not None:
                words.append(eng.last_health)
        sync()
        return time.perf_counter() - t0

    plain, guarded = make(None), make(ng.GuardPolicy())
    dt = {"plain": float("inf"), "guarded": float("inf")}
    _reset_counts(ops)
    for _ in range(GUARD_WAVES):
        dt["plain"] = min(dt["plain"], wave(plain, "plain"))
        dt["guarded"] = min(dt["guarded"], wave(guarded, "guarded"))
    counts = _read_counts(ops)
    pct = (dt["guarded"] - dt["plain"]) / dt["plain"] * 100.0
    words = torch.stack(words).cpu().tolist()
    for name in losses:
        losses[name] = torch.stack(losses[name]).float().cpu()
        _check_losses(losses[name], f"guard {name}")
    # a healthy guarded step is the plain step's arithmetic: the same
    # losses, parameters and moments, bit for bit
    same = (torch.equal(losses["plain"], losses["guarded"]),
            _state_equal(torch, guarded, plain.params + plain.m + plain.v))
    # the fault drills on the guarded engine (warm: every step healthy)
    drills = {}
    plan = FaultPlan(seed=57, specs=[
        FaultSpec("numeric.step", "nan_grad", at=0),
        FaultSpec("numeric.step", "loss_spike", at=1)])
    with plan:
        for name in ("nan_grad", "loss_spike"):
            snap = _state_snapshot(guarded)
            n0 = int(guarded.step_count)
            guarded.step(batches[0], batches[0])
            drills[name] = (int(guarded.last_health),
                            _state_equal(torch, guarded, snap),
                            int(guarded.step_count) - n0)
            del snap
    n_params = sum(p.numel() for p in guarded.params)
    need = 2 * GUARD_WAVES * GUARD_ITERS * cfg.num_hidden_layers
    print(f"guard (a) [{card}]: guard_overhead_pct {pct:.4f} (guarded vs "
          f"unguarded step, llama {n_params / 1e6:.1f}M, batch "
          f"{GUARD_BATCH} x seq {GUARD_SEQ}, {cfg.dtype}, {GUARD_ITERS} steps "
          f"best of {GUARD_WAVES}: {dt['guarded'] * 1e3:.2f} ms against "
          f"{dt['plain'] * 1e3:.2f} ms a wave, "
          f"{dt['guarded'] * 1e3 / GUARD_ITERS:.2f} / "
          f"{dt['plain'] * 1e3 / GUARD_ITERS:.2f} ms a step); words of the "
          f"timed guarded steps {sorted(set(words))}; launches k1_lse/k2/k3 "
          f"{[counts[k] for k in ('k1_lse', 'k2', 'k3')]} (need {need} "
          f"each); guarded against plain, bitwise: losses {same[0]}, "
          f"parameters and moments {same[1]}; drills (word, state "
          f"bit-identical, counter advance) {drills}", flush=True)
    del plain, guarded
    _release(torch)
    if any(words):
        raise AssertionError(f"guard (a): a healthy timed step's word was "
                             f"not 0: {words}")
    if not all(same):
        raise AssertionError(f"guard (a): the guarded engine's healthy steps "
                             f"differ from the plain engine's (losses, "
                             f"state bitwise equal: {same}): "
                             f"{losses['plain'].tolist()} against "
                             f"{losses['guarded'].tolist()}")
    if not all(counts[k] == need for k in ("k1_lse", "k2", "k3")):
        raise AssertionError(f"guard (a): launches {counts} != {need} each")
    want = {"nan_grad": ng.NAN_GRAD, "loss_spike": ng.SPIKE}
    for name, (word, same, adv) in drills.items():
        if not (word & want[name] and same and adv == 1):
            raise AssertionError(f"guard (a) {name}: word {word}, state "
                                 f"bit-identical {same}, counter +{adv}")
    return tuple(counts[k] for k in ("k1_lse", "k2", "k3"))


def _publish_data(np, vocab):
    def data_fn(step):
        ids = np.random.default_rng(5700 + step).integers(
            0, vocab, PUBLISH_BATCH).astype(np.int32)
        return ids, ids
    return data_fn


def phase_lifecycle(torch, np, ops, card):
    """57 (b): train -> checkpoint -> publish -> serve at
    bench_checkpoint_publish's config; returns (K1-lse, K2, K3) of the
    trainer's steps and (K1, K4) of the fleets' waves."""
    from paddle_tpu_torch.distributed import (CheckpointCorruptionError,
                                              CheckpointPublisher, Engine,
                                              GuardPolicy, ResilientTrainer)
    from paddle_tpu_torch.distributed.resilience import (FaultPlan,
                                                         FaultSpec,
                                                         lifecycle)
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            FleetRouter, Request)
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(**PUBLISH_CONFIG)
    data_fn = _publish_data(np, cfg.vocab_size)
    policy = GuardPolicy(action="rollback", warmup_steps=3, rewarm_steps=0)

    def build(alive):
        return Engine(LlamaForCausalLM(cfg, device=DEVICE, seed=0),
                      lr=1e-4, clip_norm=1.0, guard=policy)

    root = _scratch_dir("lifecycle")
    lifecycle.reset_lifecycle_stats()
    # the uninterrupted run (one save, at its end)
    ref = ResilientTrainer(build, os.path.join(root, "ref"),
                           save_every=PUBLISH_STEPS).fit(
        data_fn, PUBLISH_STEPS)
    del ref["engine"]
    ckpt = os.path.join(root, "ckpt")
    trainer = ResilientTrainer(build, ckpt, save_every=PUBLISH_SAVE_EVERY)
    sync()
    _reset_counts(ops)
    t0 = time.perf_counter()
    with FaultPlan(seed=57, specs=[FaultSpec(
            "numeric.step", "loss_spike", at=PUBLISH_SPIKE_AT)]):
        out = trainer.fit(data_fn, PUBLISH_STEPS)
    sync()
    fit_s = time.perf_counter() - t0
    train_counts = _read_counts(ops)
    del out["engine"]
    _release(torch)
    tail = range(out["rollback_at"][0] + 1, PUBLISH_STEPS + 1) \
        if out["rollback_at"] else range(0)
    # the same steps from the same seed twice, before the spike: is a step
    # bitwise repeatable on the card?
    deterministic = all(out["losses"][s] == ref["losses"][s]
                        for s in range(1, out["rollback_at"][0] + 1))
    replay_err = max((abs(out["losses"][s] - ref["losses"][s])
                      / abs(ref["losses"][s]) for s in tail), default=None)
    replay_ok = all(
        (out["losses"][s] == ref["losses"][s]) if deterministic
        else abs(out["losses"][s] - ref["losses"][s])
        <= PUBLISH_REPLAY_RTOL * abs(ref["losses"][s]) for s in tail)
    print(f"lifecycle (b) train [{card}]: {PUBLISH_STEPS} guarded steps of "
          f"{PUBLISH_BATCH[0]} x {PUBLISH_BATCH[1]}, async saves every "
          f"{PUBLISH_SAVE_EVERY}, loss_spike at step {PUBLISH_SPIKE_AT + 1}:"
          f" rollbacks {out['numeric_rollbacks']} to {out['rollback_at']},"
          f" events {out['numeric_events']}; {fit_s:.2f} s; the steps "
          f"before the rollback's checkpoint, run twice from one seed, "
          f"bitwise equal on the card: {deterministic}; replayed "
          f"losses against the uninterrupted run max rel {replay_err} "
          f"({'byte for byte' if deterministic else 'tol ' + str(PUBLISH_REPLAY_RTOL)}); "
          f"launches k1_lse/k2/k3 "
          f"{[train_counts[k] for k in ('k1_lse', 'k2', 'k3')]}",
          flush=True)
    if not (out["numeric_rollbacks"] == 1 and replay_ok
            and out["final_step"] == PUBLISH_STEPS):
        raise AssertionError(f"lifecycle (b) train: {out}, ref "
                             f"{ref['losses']}")
    _check_losses(torch.tensor([out["losses"][s]
                                for s in sorted(out["losses"])]),
                  "lifecycle train")

    # the serving fleet: warm, then the publish swaps it
    serve = LlamaForCausalLM(cfg, device=DEVICE, seed=1)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (PUBLISH_ENGINE[
        "page_size"],)).astype(np.int32) for _ in range(PUBLISH_REQUESTS)]

    def fleet_of(model, name):
        return FleetRouter(lambda: ContinuousBatchingEngine(
            model, device=DEVICE, **PUBLISH_ENGINE),
            os.path.join(root, name), num_replicas=2)

    def run(fleet):
        reqs = [Request(p, max_new_tokens=PUBLISH_NEW) for p in prompts]
        for r in reqs:
            fleet.submit(r)
        fleet.run_until_done(max_steps=100000)
        sync()
        if any(r.failed or len(r.output) != PUBLISH_NEW for r in reqs):
            raise AssertionError("lifecycle (b): a request failed or came "
                                 "short")
        return [list(r.output) for r in reqs]

    _zero_serving_counts(ops)
    fleet = fleet_of(serve, "warm")
    before = run(fleet)
    pub = CheckpointPublisher(ckpt).publish(serve, fleet)
    swapped = run(fleet)
    fleet.close()
    cold_model = LlamaForCausalLM(cfg, device=DEVICE, seed=2)
    CheckpointPublisher(ckpt).load_weights(cold_model, pub["step"])
    cold_fleet = fleet_of(cold_model, "cold")
    cold = run(cold_fleet)
    cold_fleet.close()
    serve_counts = _serving_counts(ops)
    # a flipped byte in one shard: refused, the serving weights intact
    shard = os.path.join(ckpt, f"step_{pub['step']:08d}", "0_0.distcp")
    with open(shard, "rb") as f:
        blob = bytearray(f.read())
    blob[len(blob) // 2] ^= 0xFF
    with open(shard, "wb") as f:
        f.write(bytes(blob))
    held = {n: t.clone() for n, t in serve.state_dict().items()}
    try:
        CheckpointPublisher(ckpt).publish(serve)
        refused = None
    except CheckpointCorruptionError as e:
        refused = e.code
    intact = all(torch.equal(t, held[n])
                 for n, t in serve.state_dict().items())
    stats = lifecycle.lifecycle_stats()
    differ = sum(a != b for a, b in zip(swapped, cold))
    print(f"lifecycle (b) publish [{card}]: checkpoint_publish_time_s "
          f"{pub['time_s']:.4f} (digest-verify {pub['shards']} shard(s) + "
          f"in-place load of {pub['params']} params + rolling hot-swap of 2 "
          f"warm replicas, gen {pub['generation']}, step {pub['step']}); "
          f"swapped streams against a cold fleet from the checkpoint: "
          f"{differ} of {len(cold)} differ (streams before the publish "
          f"differ from after in {sum(a != b for a, b in zip(before, swapped))}"
          f"); corrupt shard refused: {refused}, serving weights intact: "
          f"{intact}; lifecycle stats {stats}; launches k1/k4 "
          f"{[serve_counts[k] for k in ('k1', 'k4')]}", flush=True)
    del serve, cold_model, held
    _release(torch)
    if differ or refused is None or not intact \
            or stats["publish_total"] != 1 \
            or stats["publish_failures"] != 1:
        raise AssertionError(f"lifecycle (b) publish: {differ} streams "
                             f"differ, refused {refused}, intact {intact}, "
                             f"stats {stats}")
    if not (min(train_counts[k] for k in ("k1_lse", "k2", "k3")) > 0
            and serve_counts["k1"] > 0 and serve_counts["k4"] > 0):
        raise AssertionError(f"lifecycle (b): a kernel of the path did "
                             f"not launch: {train_counts} {serve_counts}")
    return (tuple(train_counts[k] for k in ("k1_lse", "k2", "k3")),
            (serve_counts["k1"], serve_counts["k4"]))


def _k4_alive(torch, ops):
    """After a worker's SIGKILL this process's context still launches K4
    and agrees with the plain version."""
    gen = torch.Generator(device=DEVICE).manual_seed(29)
    q, kc, vc, tables, lens = _k4_inputs(torch, gen, torch.bfloat16, 16, 16,
                                         128, 16, 4, [0, 1, 37, 64])
    n = ops.paged_decode_attention.launches
    out = ops.paged_decode_attention(q, kc, vc, tables, lens)
    err = (out.float() - ops.paged_decode_reference(
        q, kc, vc, tables, lens).float()).abs().max().item()
    ops.paged_decode_attention.launches = n
    if not err <= TOL["bfloat16"]:
        raise AssertionError(f"K4 after the worker kill: error {err}")


def _phase(name, fn, *args):
    """``fn(*args)``, then a line with the phase's wall time."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {name}: {time.perf_counter() - t0:.1f}s", flush=True)
    return out


def _compile_caches():
    """Inductor's and Triton's caches under the checkout's build/ (listed
    in .gitignore), not the temporary directory."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                          os.path.join(root, "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(root, "triton"))


def main():
    _compile_caches()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np
    import torch.nn.functional as F

    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops import _build

    global REFS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    # the sweeps' CPU references, computed meanwhile (ROADMAP Queue 1 p)
    REFS = RefClient()
    try:
        return _main(torch, np, F, ops, _build, card, start)
    finally:
        REFS.close()


def _main(torch, np, F, ops, _build, card, start):
    """The phases of main(), the reference process running."""
    t0 = time.perf_counter()
    _build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.2f}s", flush=True)
    for name in _build.KERNELS:
        for fn, regs, spill in ptxas_summary(_build.build_log(name)):
            print(f"  {name}: {fn} registers={regs} spill_store_bytes="
                  f"{spill}", flush=True)

    k1, k1_fp16 = _phase("2 k1", phase_k1, torch, F, ops)
    k4 = _phase("3 k4", phase_k4, torch, ops)
    k1_lse, k1_lse_fp16 = _phase("4 k1_lse", phase_k1_lse, torch, F, ops)
    k2, k3, k2_fp16, k3_fp16 = _phase("5 k2k3", phase_k2k3, torch, F, ops)
    k1_launches, k4_launches = _phase("6 serving", phase_serving, torch, np,
                                      ops, card)
    k4_fused, fused_cold = _phase("7 fused serving", phase_serving_fused,
                                  torch, np, ops, card)
    k4_launches += k4_fused
    k4_int8 = _phase("7b k4_int8", phase_k4_int8, torch, ops)
    k4_fp_spec, k4_int8_launches = _phase("7c spec serving",
                                          phase_serving_spec, torch, np,
                                          ops, card)
    k4_launches += k4_fp_spec
    _phase("8 train parity", phase_train_parity, torch, np, ops)
    lse_launches, k2_launches, k3_launches = _phase(
        "9 train", phase_train_full, torch, np, ops, card)
    k5, k6, k5_decode = _phase("10 pgmm", phase_pgmm, torch, np, ops)
    _phase("11 moe parity", phase_moe_parity, torch, np, ops)
    k5_launches, k6_launches, pgmm_line = _phase(
        "12 moe train", phase_moe_train, torch, np, ops, card)
    for path in (_phase("13 remat train", phase_remat_train, torch, np, ops,
                        card),
                 _phase("14 moe auto train", phase_moe_auto_train, torch,
                        np, ops, card, pgmm_line)):
        lse_launches += path[0]
        k2_launches += path[1]
        k3_launches += path[2]
    moe_serving = _phase("15 moe serving", phase_moe_serving, torch, np,
                         ops, card, k5_decode)
    k1_gen, k4_gen = _phase("16 generate", phase_generate, torch, np, ops,
                            card)
    k4_brownout = _phase("17 brownout", phase_brownout, torch, np, ops, card,
                         fused_cold)
    k1_launches += moe_serving["k1"] + k1_gen
    k4_launches += moe_serving["k4"] + k4_gen + k4_brownout
    k5_launches += moe_serving["k5"]
    seg = _phase("18 varlen", phase_varlen, torch, F, ops)
    rowmask = _phase("19 flashmask", phase_flashmask, torch, F, ops)
    glse, glse_lse = _phase("20 lse cotangent", phase_lse_cotangent, torch,
                            F, ops)
    bmha_k1, bmha_k4 = _phase("21 block_mha", phase_block_mha, torch, np,
                              ops)
    _phase("22 fused_moe", phase_fused_moe, torch, np)
    k1_rec, k4_rec, serve_model, serve_ref, single_tok_s = _phase(
        "23 recovery", phase_recovery, torch, np, ops, card)
    k1_fleet, k4_fleet = _phase("24 fleet", phase_fleet, torch, np, ops,
                                card, serve_model, serve_ref, single_tok_s)
    k4_disagg, k4_int8_disagg = _phase("25 disagg", phase_disagg, torch, np,
                                       ops, card, serve_model, serve_ref,
                                       single_tok_s)
    k4_obs = _phase("26 observability", phase_observability, torch, np, ops,
                    card, serve_model)
    k4_slo = _phase("27 slo burst", phase_slo_burst, torch, np, ops, card,
                    serve_model)
    k4_dburst = _phase("28 disagg burst", phase_disagg_burst, torch, np,
                       ops, card, serve_model)
    k1_proc, k4_proc = _phase("29 procfleet", phase_procfleet, torch, np,
                              ops, card, serve_model, serve_ref)
    del serve_model
    _release(torch)
    gpt_train = _phase("30 gpt train", phase_gpt_train, torch, np, ops, card)
    k1_gpt, k4_gpt = _phase("31 gpt serving", phase_gpt_serving, torch, np,
                            ops, card)
    bert = _phase("32 bert", phase_bert, torch, np, ops, card)
    _phase("33 vision parity", phase_vision_parity, torch, np, ops, card)
    resnet_rate = _phase("34 bench_resnet", phase_bench_resnet, torch, np,
                         ops, card)
    _phase("35 bench_vit", phase_bench_vit, torch, np, ops, card)
    _phase("36 bench_unet", phase_bench_unet, torch, np, ops, card)
    opt_train = _phase("37 engine optimizer", phase_engine_optimizer, torch,
                       np, ops, card)
    _phase("38 hapi fit", phase_hapi_fit, torch, np, ops, card, resnet_rate)
    _phase("40 dygraph parity", phase_dygraph_parity, torch, np, ops, card)
    dygraph_bf16, dygraph_fp16 = _phase("41 dygraph bert", phase_dygraph_bert,
                                        torch, np, ops, card)
    _phase("42 nn sweep", phase_nn_sweep, torch, np, ops, card)
    _phase("43 lstm lm", phase_lstm_lm, torch, np, ops, card)
    _phase("44 extras sweep", phase_extras_sweep, torch, np, ops, card)
    _phase("45 ds2", phase_ds2, torch, np, ops, card)
    _phase("46 tensor extras sweep", phase_tensor_sweep, torch, np, ops,
           card)
    debug_launches = _phase("47 amp debugging", phase_amp_debugging, torch,
                            np, ops, card)
    prof_launches = _phase("48 profiler", phase_profiler, torch, np, ops,
                           card)
    _phase("49 ds2 front end", phase_ds2_front, torch, np, ops, card)
    static_bert = _phase("50 to_static bert", phase_to_static_bert, torch,
                         np, ops, card)
    k1_deploy = _phase("51 deploy bert", phase_deploy_bert, torch, np, ops,
                       card)
    static_prog = _phase("52 static bert", phase_static_bert, torch, np,
                         ops, card)
    compress_train, compress_k1 = _phase("53 compression",
                                         phase_compression, torch, np, ops,
                                         card)
    family_k1 = _phase("54 fused family", phase_fused_family, torch, np, ops,
                       card)
    _phase("55 packages", phase_packages, torch, np, ops, card)
    dist_a = _phase("56a dist one rank", phase_dist_one_rank, torch, np,
                    ops, card)
    dist_b = _phase("56b dist gloo meshes", phase_dist_dp, torch, np, ops,
                    card)
    guard_train = _phase("57a guard", phase_guard, torch, np, ops, card)
    life_train, (k1_life, k4_life) = _phase(
        "57b lifecycle", phase_lifecycle, torch, np, ops, card)
    k1_launches += k1_life
    k4_launches += k4_life
    k1_launches += k1_deploy + compress_k1 + family_k1
    k1_launches += prof_launches[3]
    k4_launches += prof_launches[4]
    # phase 56 (b)'s two ranks, dense K2 in k2 and GLSE K2 in glse's row
    glse["launches"] += dist_b["k2_glse"]
    for path in (gpt_train, bert, opt_train, dygraph_bf16, debug_launches,
                 prof_launches, static_bert, static_prog, compress_train,
                 dist_a, guard_train, life_train,
                 (dist_b["k1_lse"], dist_b["k2"], dist_b["k3"])):
        lse_launches += path[0]
        k2_launches += path[1]
        k3_launches += path[2]
    k1_launches += k1_gpt
    k4_launches += k4_gpt
    k1_launches += bmha_k1 + k1_rec + k1_fleet + k1_proc
    k4_launches += (bmha_k4 + k4_rec + k4_fleet + k4_disagg + k4_obs
                    + k4_slo + k4_dburst + k4_proc)
    k4_int8_launches += k4_int8_disagg
    lse_launches += glse_lse

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
        dict(name="paged_decode_int8", route="cuda",
             source="paddle_tpu_torch/ops/csrc/paged_decode.cu",
             replaces="paddle_tpu/ops/paged_attention.py:174",
             launches=k4_int8_launches, **k4_int8),
        dict(name="pgmm", route="cuda",
             source="paddle_tpu_torch/ops/csrc/grouped_matmul.cu",
             replaces="paddle_tpu/ops/grouped_matmul.py:38",
             launches=k5_launches, **k5),
        dict(name="pgmm_dw", route="cuda",
             source="paddle_tpu_torch/ops/csrc/grouped_matmul.cu",
             replaces="paddle_tpu/ops/grouped_matmul.py:93",
             launches=k6_launches, **k6),
    ]
    for mode, rows in (("seg", seg), ("rowmask", rowmask)):
        for kname, line, row in zip(
                ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                (117, 337, 420), rows):
            kernels.append(dict(
                name=f"{kname}_{mode}", route="cuda",
                source="paddle_tpu_torch/ops/csrc/" + (
                    "flash_fwd.cu" if kname == "flash_fwd"
                    else "flash_bwd.cu"),
                replaces=f"paddle_tpu/ops/flash_attention.py:{line}", **row))
    kernels.append(dict(name="flash_bwd_dq_glse", route="cuda",
                        source="paddle_tpu_torch/ops/csrc/flash_bwd.cu",
                        replaces="paddle_tpu/ops/flash_attention.py:337",
                        **glse))
    for kname, line, src, launches, row in zip(
            ("flash_fwd_fp16", "flash_fwd_lse_fp16", "flash_bwd_dq_fp16",
             "flash_bwd_dkv_fp16"), (117, 117, 337, 420),
            ("flash_fwd.cu", "flash_fwd.cu", "flash_bwd.cu", "flash_bwd.cu"),
            dygraph_fp16, (k1_fp16, k1_lse_fp16, k2_fp16, k3_fp16)):
        kernels.append(dict(
            name=kname, route="cuda",
            source=f"paddle_tpu_torch/ops/csrc/{src}",
            replaces=f"paddle_tpu/ops/flash_attention.py:{line}",
            launches=launches, **row))
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - start:.1f}s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
