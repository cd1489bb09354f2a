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
