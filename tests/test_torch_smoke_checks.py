"""The checks ``chip_smoke.py`` holds the MoE serving path to on the card
(phase 15), run here on the CPU at a tiny size (fp32) so that a check which
passes everything is caught before it reaches the card.

``_recorded_wave`` reruns a wave and records the experts the engine picks
for every emitted position (the fused engine's first-token step pads its
group as ``ContinuousBatchingEngine._first_token_group`` says);
``_moe_margin_check`` forces them into the dense forward and holds both the
emitted tokens (the teacher-forced margin) and the routing itself (the
forward's own gate must rank the engine's experts within ``GATE_MARGIN``)
to it. Routes shifted by one expert keep the emitted tokens inside the
margin on this model, so only the routing witness catches them.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                PrefixCacheConfig, Request)
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXPERTS = 4


@pytest.fixture
def smoke(monkeypatch):
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "DEVICE", "cpu")
    return mod


def _wave():
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, (20 + i,)).astype(np.int32)
               for i in range(6)]
    return prompts, [4 + i for i in range(6)]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "legacy"])
def test_moe_margin_check_holds_the_routing_to_the_dense_forward(smoke,
                                                                 fused):
    model = LlamaForCausalLM(LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, num_experts=EXPERTS, moe_topk=2,
        moe_dispatch="pgmm"), device="cpu", seed=0)
    kw = dict(prefix_cache=PrefixCacheConfig(extra_blocks=8)) if fused \
        else {}
    eng = ContinuousBatchingEngine(model, device="cpu", max_batch=4,
                                   max_len=64, page_size=16, block_size=4,
                                   fused=fused, **kw)
    prompts, news = _wave()
    streams, routes = smoke._recorded_wave(torch, np, eng, Request, prompts,
                                           news)
    assert [len(s) for s in streams] == news
    # every emitted token's position carries the engine's choices
    assert all((i, len(p) - 1 + j) in routes
               for i, (p, k) in enumerate(zip(prompts, news))
               for j in range(k))
    smoke._moe_margin_check(torch, np, model, prompts, streams, routes,
                            "tiny", "cpu")
    shifted = {key: [[(e + 1) % EXPERTS for e in layer] for layer in route]
               for key, route in routes.items()}
    with pytest.raises(AssertionError, match="gate logits are"):
        smoke._moe_margin_check(torch, np, model, prompts, streams, shifted,
                                "shifted", "cpu")


@pytest.mark.parametrize("mask", ["none", "seg", "row1", "rowh",
                                  "flashmask_doc", "flashmask_band"])
@pytest.mark.parametrize("causal", [True, False])
def test_masked_pairs_counts_the_plain_masks_visible_pairs(smoke, mask,
                                                           causal):
    # the bound of phases 18-19 counts visible (q, k) pairs on the host from
    # the ids or bounds; it must equal the count of the plain versions' own
    # mask (the causal mask and the ids / bounds), summed over the q heads
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    b, s, hq, hkv = 2, 96, 4, 2
    rng = np.random.default_rng(3)
    kw, keep = {}, None
    if mask == "seg":
        ids = np.sort(rng.integers(0, 5, (b, s)), axis=1).astype(np.int32)
        kw = dict(q_seg=ids, kv_seg=ids)
        keep = fa._seg_keep(torch.from_numpy(ids), torch.from_numpy(ids))
    elif mask != "none":
        if mask.startswith("flashmask"):
            smoke.FLASHMASK_DOCS = (48, 24, 24)
            smoke.FLASHMASK_WINDOWS = (8, 40)
            smoke.FLASHMASK_BAND = 16
            idx = smoke._flashmask_indices(torch, mask.split("_")[1], b, s,
                                           hkv)
            start = idx[..., 0].numpy()
            end = (idx[..., 1].numpy() if idx.shape[-1] > 1
                   else np.full_like(start, 2 * s))
        else:
            hm = 1 if mask == "row1" else hkv
            start = rng.integers(0, s, (b, hm, s)).astype(np.int32)
            end = start + rng.integers(0, 40, (b, hm, s)).astype(np.int32)
        kw = dict(start=start, end=end)
        keep = fa._row_keep(torch.from_numpy(start), torch.from_numpy(end),
                            hq, s)
    full = torch.ones(b, hq, s, s, dtype=torch.bool)
    if causal:
        full &= torch.ones(s, s, dtype=torch.bool).tril()
    if keep is not None:
        full &= keep
    got = smoke.masked_pairs(np, b, s, s, hq, causal, **kw)
    assert isinstance(got, float) and got == full.sum().item()


@pytest.mark.parametrize("best,trail,ulps", [(5.0, 3 / 32, 3.0),
                                             (3.0, 6 / 64, 6.0),
                                             (3.0, 7 / 64, 7.0),
                                             (-0.75, 1 / 256, 1.0)])
def test_teacher_forced_trail_counts_ulps_of_the_row_max(smoke, best, trail,
                                                          ulps):
    # the margin bounds max logit - emitted logit in bf16 ulps of the max
    # (2 ** (floor(log2 |max|) - 7)); 6 ulps pass, 7 do not
    logits = torch.full((2, 3, 8), -4.0)
    logits[..., 0] = best
    logits[1, 2, 5] = best - trail
    emitted = torch.zeros(2, 3, dtype=torch.long)
    emitted[1, 2] = 5
    tf = smoke.Trail(torch)
    tf.add(logits, emitted, lambda r, t: f"row {r} pos {t}")
    assert tf.ulps == ulps and tf.abs == pytest.approx(trail)
    assert tf.n == 6 and tf.top1 == 5 and "row 1 pos 2" in str(tf)
    assert "emitted token's rank 2" in str(tf)
    assert tf.ok() == (ulps <= smoke.MARGIN_ULPS)
