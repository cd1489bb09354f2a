"""Port kernels on the card: each CUDA kernel against its plain PyTorch
version on the same inputs.

These tests need a CUDA device and skip without one (the kernels have no
CPU mode). They import neither JAX nor the JAX package, so they also run on
a machine without JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances (max abs error): 1e-4 in fp32 (fp32 math, other summation
order) and 2e-2 in bf16 (the output's bf16 rounding of O(1) values); the
backward's gradients are held to tol x max(1, max |plain|). The train step
on the card is held against the same step on the CPU (fp32, TF32 off).
"""

import pytest
import torch

from paddle_tpu_torch.distributed import Engine
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import (flash_attention, flash_attention_backward,
                                  flash_attention_backward_reference,
                                  flash_attention_forward,
                                  flash_attention_reference,
                                  flash_attention_reference_lse,
                                  paged_decode_attention,
                                  paged_decode_reference)

torch.set_num_threads(1)



@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("s_q,s_kv,hq,hkv,d,causal", [
    (128, 128, 4, 4, 128, True), (77, 77, 4, 2, 64, False),
    (40, 100, 8, 2, 128, True)])
def test_flash_kernel_matches_plain_on_card(cuda, dtype, tol, s_q, s_kv, hq,
                                            hkv, d, causal):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(2, s_q, hq, d, device=cuda, generator=g).to(dtype)
    k = torch.randn(2, s_kv, hkv, d, device=cuda, generator=g).to(dtype)
    v = torch.randn(2, s_kv, hkv, d, device=cuda, generator=g).to(dtype)
    n0 = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    ref = flash_attention_reference(q, k, v, causal)
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("hkv", [16, 4])
def test_paged_kernel_matches_plain_on_card(cuda, dtype, tol, hkv):
    g = torch.Generator(device=cuda).manual_seed(0)
    b, hq, d, page, maxp = 8, 16, 128, 16, 40
    npages = b * maxp
    q = torch.randn(b, hq, d, device=cuda, generator=g).to(dtype)
    kc = torch.randn(npages, hkv, page, d, device=cuda, generator=g).to(dtype)
    vc = torch.randn(npages, hkv, page, d, device=cuda, generator=g).to(dtype)
    tables = torch.randperm(npages, device=cuda, generator=g).reshape(
        b, maxp).to(torch.int32)
    lens = torch.tensor([0, 1, 16, 64, 100, 333, 512, 640], device=cuda,
                        dtype=torch.int32)
    n0 = paged_decode_attention.launches
    out = paged_decode_attention(q, kc, vc, tables, lens)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == n0 + 1
    ref = paged_decode_reference(q, kc, vc, tables, lens)
    assert (out.float() - ref.float()).abs().max().item() <= tol


_BWD_SHAPES = [(128, 128, 4, 4, 128, True), (77, 77, 4, 2, 64, False),
               (40, 100, 8, 2, 128, True), (100, 40, 4, 2, 64, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("s_q,s_kv,hq,hkv,d,causal", _BWD_SHAPES)
def test_flash_lse_and_backward_match_plain_on_card(cuda, dtype, tol, s_q,
                                                    s_kv, hq, hkv, d, causal):
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(2, s_q, hq, d, device=cuda, generator=g).to(dtype)
    k = torch.randn(2, s_kv, hkv, d, device=cuda, generator=g).to(dtype)
    v = torch.randn(2, s_kv, hkv, d, device=cuda, generator=g).to(dtype)
    do = torch.randn(2, s_q, hq, d, device=cuda, generator=g).to(dtype)
    n0 = flash_attention_forward.launches
    out, lse = flash_attention_forward(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_forward.launches == n0 + 1
    ref_out, ref_lse = flash_attention_reference_lse(q, k, v, causal)
    # q longer than kv: the first s_q - s_kv rows see no key; there the
    # kernel (like the Pallas kernel) writes 0 or the mean of the columns of
    # its tiles, the plain version the mean of all columns. Both give such
    # rows an lse of about NEG_INF, hence zero gradient (checked below).
    seen = max(0, s_q - s_kv) if causal else 0
    assert (out[:, seen:].float() - ref_out[:, seen:].float()).abs().max(
    ).item() <= tol
    lse_tol = 5e-3 if dtype == torch.bfloat16 else 1e-4
    assert (lse - ref_lse).abs().max().item() <= lse_tol
    nq, nk = (flash_attention_backward.launches_dq,
              flash_attention_backward.launches_dkv)
    grads = flash_attention_backward(q, k, v, out, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_backward.launches_dq == nq + 1
    assert flash_attention_backward.launches_dkv == nk + 1
    refs = flash_attention_backward_reference(q, k, v, out, lse, do, causal)
    for name, a, r in zip(("dq", "dk", "dv"), grads, refs):
        assert a.shape == r.shape and a.dtype == r.dtype
        err = (a.float() - r.float()).abs().max().item()
        assert err <= tol * max(1.0, r.float().abs().max().item()), (name,
                                                                     err)


@pytest.mark.cuda
def test_engine_step_on_card_matches_cpu(cuda):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=256)
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=3)
    card = LlamaForCausalLM(cfg, device=cuda, seed=3)
    with torch.no_grad():
        for pc, pg in zip(cpu.parameters(), card.parameters()):
            pg.copy_(pc)
    ids = torch.randint(0, cfg.vocab_size, (2, 100),
                        generator=torch.Generator().manual_seed(0))
    ec, eg = Engine(cpu, lr=1e-3), Engine(card, lr=1e-3)
    n0 = flash_attention_backward.launches_dkv
    lc = ec.step(ids, ids)
    lg = eg.step(ids.to(cuda), ids.to(cuda))
    torch.cuda.synchronize()
    assert flash_attention_backward.launches_dkv == n0 + 2
    assert abs(lg.item() - lc.item()) <= 1e-4 * abs(lc.item())
    # one Adam step moves an element by at most ~lr: 2 * lr bounds the
    # difference of an element whose gradient is rounding noise
    for (name, pc), pg in zip(cpu.named_parameters(), card.parameters()):
        err = (pg.detach().cpu() - pc.detach()).abs().max().item()
        assert err <= 2e-3, (name, err)
