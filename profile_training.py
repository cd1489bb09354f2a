#!/usr/bin/env python3
"""Where the port's training time goes on one CUDA card.

    python3 profile_training.py        # from the root of a checkout

Four arms, each chip_smoke.py's training
configuration at full width and depth with random weights from seed 0
under Engine(lr=1e-4, clip 1.0):

  - dense: the headline config (bench.py's
    llama_pretrain_tokens_per_sec_per_chip: 853M params, 16 layers, 16 q /
    4 kv heads of 128, batch 2 x seq 4096, bf16, fused CE, no remat);
  - moe: the Mixtral-class MoE config of bench.py's bench_moe (8 layers,
    hidden 1024, 8 swiglu experts of 2816, top-2 GShard gate, batch 8 x seq
    2048, bf16) with the dropless pgmm dispatch (K5/K6);
  - remat: bench.py's llama_853M_seq4096_remat line (the dense model with
    recompute=True and the flash_qkv policy, batch 4 x seq 4096);
  - moe_auto: the moe arm at its default dispatch, "auto", which resolves
    to scatter at this shape.

Each arm measures one train step (forward, fused CE, backward, clip, AdamW)
after two warm-up steps, three ways (profile_serving.measure): device span
(CUDA events), host enqueue (host clock without a synchronise) and device
busy time (torch.profiler's kernel times, summed), with the top kernels by
device time and the kernels per step. busy / span is the device's busy
share. It then runs one more step under torch.cuda.set_sync_debug_mode
("warn") and prints how many synchronizing operations PyTorch reported (the
step must read nothing on the host; the mode is a prototype and does not
see every kind of synchronisation). Exits non-zero without a CUDA device.
"""

import sys

import chip_smoke
import profile_serving

STEPS = 3


def profile_arm(torch, np, name, cfg_dict, batch, seq):
    from paddle_tpu_torch.distributed import Engine
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(**cfg_dict)
    model = LlamaForCausalLM(cfg, seed=0)
    eng = Engine(model, lr=1e-4, clip_norm=1.0)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq)))
    ids = ids.cuda()
    profile_serving.measure(
        torch, f"{name} train step [{batch} x {seq}, "
        f"{cfg.num_hidden_layers} layers]",
        lambda: eng.step(ids, ids), STEPS, top=15)
    syncs = chip_smoke._sync_count(torch, lambda: eng.step(ids, ids))
    print(f"{name}: synchronizing operations reported in one step: "
          f"{len(syncs)}", flush=True)
    for msg in syncs[:5]:
        print(f"  {msg[:120]}", flush=True)
    del eng, model
    torch.cuda.empty_cache()


def main():
    import torch

    if not torch.cuda.is_available():
        print("profile_training: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.card_line(), flush=True)
    profile_arm(torch, np, "dense", chip_smoke.TRAIN_CONFIG,
                chip_smoke.TRAIN_BATCH, chip_smoke.TRAIN_SEQ)
    profile_arm(torch, np, "moe", chip_smoke.MOE_CONFIG,
                chip_smoke.MOE_BATCH, chip_smoke.MOE_SEQ)
    profile_arm(torch, np, "remat", chip_smoke.REMAT_CONFIG,
                chip_smoke.REMAT_BATCH, chip_smoke.TRAIN_SEQ)
    profile_arm(torch, np, "moe_auto", chip_smoke.MOE_AUTO_CONFIG,
                chip_smoke.MOE_BATCH, chip_smoke.MOE_SEQ)
    return 0


if __name__ == "__main__":
    sys.exit(main())
