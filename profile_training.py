#!/usr/bin/env python3
"""Where the port's training time goes on one CUDA card.

    python3 profile_training.py [ARM ...]   # from the root of a checkout

Nine arms (all of them unless named on the command line), each
chip_smoke.py's training configuration at full width and depth with random
weights from seed 0; the first five under Engine(lr=1e-4, clip 1.0):

  - dense: the headline config (bench.py's
    llama_pretrain_tokens_per_sec_per_chip: 853M params, 16 layers, 16 q /
    4 kv heads of 128, batch 2 x seq 4096, bf16, fused CE, no remat);
  - moe: the Mixtral-class MoE config of bench.py's bench_moe (8 layers,
    hidden 1024, 8 swiglu experts of 2816, top-2 GShard gate, batch 8 x seq
    2048, bf16) with the dropless pgmm dispatch (K5/K6);
  - remat: bench.py's llama_853M_seq4096_remat line (the dense model with
    recompute=True and the flash_qkv policy, batch 4 x seq 4096);
  - moe_auto: the moe arm at its default dispatch, "auto", which resolves
    to scatter at this shape;
  - bert: bench.py's bench_bert (BERT-base sequence classification, batch
    32 x seq 128, bf16, dropout 0) under Engine(lr=2e-5, clip 1.0,
    loss_fn=model.loss_fn), as chip_smoke.py's phase 32 runs it;
  - resnet: bench.py's bench_resnet (resnet18, batch 256 of 3 x 32 x 32
    fp32, Momentum lr 0.1) through hapi.Model.train_batch, which reads
    the loss on the host once a step (chip_smoke.py phase 34);
  - vit: bench_vit (ViT-L/16, bf16, batch 32 at 224 px) and
  - unet: bench_unet (the SD-class UNet, bf16, batch 8 of 32 x 32
    latents, context 77), each through bench's step: the loss's gradients,
    then p - 1e-4 g (phases 35 and 36);
  - lstm: the large PTB LSTM of chip_smoke.py phase 43 (LSTM_LM: vocab
    10000, two LSTMs of 1500, batch 20 x 35 steps, fp32, dropout 0.65)
    through hapi.Model.train_batch with SGD(lr 1) and the global-norm
    clip at 10, which reads the loss on the host once a step.
  - ds2: the DeepSpeech2-class CTC model of chip_smoke.py phase 45 (DS2:
    two Conv2D(32) + BatchNorm2D + Hardtanh blocks, three bidirectional
    GRUs of 1024 with sequence_length, Linear(2048, 4301), CTC; batch 32
    of 300-1200 frames, fp32, TF32 off) with Adam and the global-norm clip
    at 5 (loss.backward, step, clear_grad; the CTC lengths are host ints).

Each arm measures one train step (forward, loss, backward and the
update: clip and AdamW, Momentum, or SGD) after three warm-up steps, three ways (profile_serving.measure): device span
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
    profile_step(torch, name, eng, model, ids, ids, batch, seq)


def profile_bert(torch, np):
    from paddle_tpu_torch.distributed import Engine
    from paddle_tpu_torch.models import (BertConfig,
                                         BertForSequenceClassification)

    cfg = BertConfig(**chip_smoke.BERT_CONFIG)
    model = BertForSequenceClassification(cfg, seed=0)
    eng = Engine(model, lr=chip_smoke.BERT_LR, clip_norm=1.0,
                 loss_fn=model.loss_fn)
    batch, seq = chip_smoke.BERT_BATCH, chip_smoke.BERT_SEQ
    (ids, labels), = chip_smoke._bert_batches(
        np, np.random.default_rng(0), cfg, 1, batch, seq, False)
    profile_step(torch, "bert", eng, model, torch.from_numpy(ids).cuda(),
                 torch.from_numpy(labels).cuda(), batch, seq)


def profile_vision(torch, np, name):
    from paddle_tpu_torch.models import UNet2DConditionModel, UNetConfig
    from paddle_tpu_torch.vision.models import vit_l_16

    if name == "resnet":
        model, m, batches = chip_smoke.resnet_bench(torch, np)
        step = lambda: m.train_batch(*batches[0])   # noqa: E731
        what = f"batch {chip_smoke.RESNET_BENCH['batch']} x 3 x 32 x 32"
    elif name == "vit":
        model = vit_l_16(dtype="bfloat16", seed=0)
        imgs, labels = chip_smoke.vit_bench_inputs(
            torch, np, model.config, chip_smoke.VIT_BENCH_BATCH, "cuda")
        step = lambda: chip_smoke.sgd_bench_step(   # noqa: E731
            torch, model, lambda: model.loss_fn(imgs, labels))
        what = f"batch {chip_smoke.VIT_BENCH_BATCH} x 3 x 224 x 224 bf16"
    else:
        cfg = UNetConfig(**chip_smoke.UNET_BENCH_CONFIG)
        model = UNet2DConditionModel(cfg, seed=0)
        batch = chip_smoke.unet_bench_batch(
            torch, np, cfg, chip_smoke.UNET_BENCH_BATCH,
            chip_smoke.UNET_BENCH_HW, chip_smoke.UNET_BENCH_CTX, "cuda")
        step = lambda: chip_smoke.sgd_bench_step(   # noqa: E731
            torch, model, lambda: model.loss_fn(batch))
        what = (f"batch {chip_smoke.UNET_BENCH_BATCH} x 4 x "
                f"{chip_smoke.UNET_BENCH_HW} x {chip_smoke.UNET_BENCH_HW} "
                f"bf16, context {chip_smoke.UNET_BENCH_CTX}")
    n = sum(1 for _ in model.parameters())
    profile_serving.measure(torch, f"{name} train step [{what}, {n} "
                            f"parameter tensors]", step, STEPS, top=15)
    syncs = chip_smoke._sync_count(torch, step)
    print(f"{name}: synchronizing operations reported in one step: "
          f"{len(syncs)}", flush=True)
    for msg in syncs[:5]:
        print(f"  {msg[:120]}", flush=True)
    del model
    torch.cuda.empty_cache()


def profile_lstm(torch, np):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import hapi, nn, optimizer

    c = chip_smoke.LSTM_LM
    pt.set_device("cuda")
    pt.seed(0)
    net = chip_smoke.lstm_lm(pt, c, c["hidden"], c["dropout"], "cuda")
    m = hapi.Model(net)
    m.prepare(optimizer.SGD(c["lr"], parameters=net.parameters(),
                            grad_clip=nn.ClipGradByGlobalNorm(c["clip"])),
              chip_smoke.lstm_lm_loss())
    toks = np.random.default_rng(0).integers(0, c["vocab"],
                                             (c["batch"], c["steps"] + 1))
    x = torch.from_numpy(toks[:, :-1]).cuda()
    y = torch.from_numpy(toks[:, 1:]).cuda()
    step = lambda: m.train_batch([x], [y])   # noqa: E731
    profile_serving.measure(
        torch, f"lstm train step [batch {c['batch']} x {c['steps']}, 2 x "
        f"LSTM {c['hidden']}, vocab {c['vocab']}, fp32]", step, STEPS,
        top=15)
    syncs = chip_smoke._sync_count(torch, step)
    print(f"lstm: synchronizing operations reported in one step: "
          f"{len(syncs)} (train_batch reads the loss)", flush=True)
    for msg in syncs[:5]:
        print(f"  {msg[:120]}", flush=True)
    del net, m
    torch.cuda.empty_cache()


def profile_ds2(torch, np):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import nn, optimizer

    c = chip_smoke.DS2
    pt.set_device("cuda")
    pt.seed(0)
    model = chip_smoke.deepspeech2(pt, c, "cuda")
    opt = optimizer.Adam(c["lr"], parameters=model.parameters(),
                         grad_clip=nn.ClipGradByGlobalNorm(c["clip"]))
    feats, lens, labels, lab_lens = chip_smoke.ds2_batch(np, c, 0)
    x, y, yl = (pt.to_tensor(a) for a in (feats, labels, lab_lens))

    def step():
        chip_smoke.ds2_loss(pt, model, x, lens, y, yl).backward()
        opt.step()
        opt.clear_grad()

    profile_serving.measure(
        torch, f"ds2 train step [batch {c['batch']} of {lens.min()}-"
        f"{lens.max()} frames, 3 x bidirectional GRU {c['hidden']}, vocab "
        f"{c['vocab']}, fp32]", step, STEPS, top=15)
    syncs = chip_smoke._sync_count(torch, step)
    print(f"ds2: synchronizing operations reported in one step: "
          f"{len(syncs)}", flush=True)
    for msg in syncs[:5]:
        print(f"  {msg[:120]}", flush=True)
    del model, opt
    torch.cuda.empty_cache()


def profile_step(torch, name, eng, model, ids, labels, batch, seq):
    profile_serving.measure(
        torch, f"{name} train step [{batch} x {seq}, "
        f"{model.config.num_hidden_layers} layers, {len(eng.params)} "
        f"parameter tensors]",
        lambda: eng.step(ids, labels), STEPS, top=15)
    syncs = chip_smoke._sync_count(torch, lambda: eng.step(ids, labels))
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

    arms = {
        "dense": (chip_smoke.TRAIN_CONFIG, chip_smoke.TRAIN_BATCH,
                  chip_smoke.TRAIN_SEQ),
        "moe": (chip_smoke.MOE_CONFIG, chip_smoke.MOE_BATCH,
                chip_smoke.MOE_SEQ),
        "remat": (chip_smoke.REMAT_CONFIG, chip_smoke.REMAT_BATCH,
                  chip_smoke.TRAIN_SEQ),
        "moe_auto": (chip_smoke.MOE_AUTO_CONFIG, chip_smoke.MOE_BATCH,
                     chip_smoke.MOE_SEQ),
        "bert": None, "resnet": None, "vit": None, "unet": None,
        "lstm": None,
        "ds2": None,
    }
    names = sys.argv[1:] or list(arms)
    unknown = [n for n in names if n not in arms]
    if unknown:
        print(f"profile_training: unknown arms {unknown}; the arms are "
              f"{list(arms)}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False   # as chip_smoke.py's main
    print(chip_smoke.card_line(), flush=True)
    for name in names:
        if name == "bert":
            profile_bert(torch, np)
        elif name == "lstm":
            profile_lstm(torch, np)
        elif name == "ds2":
            profile_ds2(torch, np)
        elif name in ("resnet", "vit", "unet"):
            profile_vision(torch, np, name)
        else:
            profile_arm(torch, np, name, *arms[name])
    return 0


if __name__ == "__main__":
    sys.exit(main())
