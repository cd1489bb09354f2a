"""Port kernels on the card: each CUDA kernel against its plain PyTorch
version on the same inputs.

These tests need a CUDA device and skip without one (the kernels have no
CPU mode). They import neither JAX nor the JAX package, so they also run on
a machine without JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances (max abs error): 1e-4 in fp32 (fp32 math, other summation
order) and 2e-2 in bf16 (the output's bf16 rounding of O(1) values).
"""

import pytest
import torch

from paddle_tpu_torch.ops import (flash_attention, flash_attention_reference,
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
