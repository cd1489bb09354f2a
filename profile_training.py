#!/usr/bin/env python3
"""Where the port's training time goes on one CUDA card.

    python3 profile_training.py        # from the root of a checkout

Builds chip_smoke.py's headline training configuration (bench.py's
llama_pretrain_tokens_per_sec_per_chip: 853M params, 16 layers, 16 q / 4 kv
heads of 128, batch 2 x seq 4096, bf16, fused CE, no remat; random weights
from seed 0) under Engine(lr=1e-4, clip 1.0) and measures one train step
(forward, fused CE, backward, clip, AdamW) after two warm-up steps, three
ways (profile_serving.measure): device span (CUDA events), host enqueue
(host clock without a synchronise) and device busy time (torch.profiler's
kernel times, summed), with the top kernels by device time. busy / span is
the device's busy share. It then runs one more step under
torch.cuda.set_sync_debug_mode("warn") and prints how many synchronizing
operations PyTorch reported (the step must read nothing on the host; the
mode is a prototype and does not see every kind of synchronisation).
Exits non-zero without a CUDA device.
"""

import sys
import warnings

import chip_smoke
import profile_serving

STEPS = 3


def main():
    import torch

    if not torch.cuda.is_available():
        print("profile_training: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    from paddle_tpu_torch.distributed import Engine
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.card_line(), flush=True)
    cfg = LlamaConfig(**chip_smoke.TRAIN_CONFIG)
    model = LlamaForCausalLM(cfg, seed=0)
    eng = Engine(model, lr=1e-4, clip_norm=1.0)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (chip_smoke.TRAIN_BATCH, chip_smoke.TRAIN_SEQ)))
    ids = ids.cuda()
    profile_serving.measure(
        torch, f"train step [{chip_smoke.TRAIN_BATCH} x "
        f"{chip_smoke.TRAIN_SEQ}, {cfg.num_hidden_layers} layers]",
        lambda: eng.step(ids, ids), STEPS, top=15)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        eng.step(ids, ids)
        torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message) for w in seen
             if "synchroniz" in str(w.message).lower()
             and "prototype" not in str(w.message)]
    print(f"synchronizing operations reported in one step: {len(syncs)}",
          flush=True)
    for msg in syncs[:5]:
        print(f"  {msg[:120]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
