"""Port kernels on the card: each CUDA kernel against its plain PyTorch
version on the same inputs.

These tests need a CUDA device and skip without one (the kernels have no
CPU mode). They import neither JAX nor the JAX package, so they also run on
a machine without JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances (max abs error): 1e-4 in fp32 (fp32 math, other summation
order) and 2e-2 in bf16 (the output's bf16 rounding of O(1) values, and P
rounded to bf16 before P V); the forward's lse to 1e-4 in fp32 and 5e-3 in
bf16 (it is computed in fp32 from bf16 inputs, so only the order of the
sums differs); the backward's gradients are held to tol x max(1, max
|plain|) and the grouped matmuls (K5, K6) to tol x max |plain|. The dense
and MoE train steps on the card are held against the same steps on the CPU
(fp32, TF32 off).
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed import Engine
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import (flash_attention, flash_attention_backward,
                                  flash_attention_backward_reference,
                                  flash_attention_forward,
                                  flash_attention_reference,
                                  flash_attention_reference_lse,
                                  padded_group_layout,
                                  paged_decode_attention,
                                  paged_decode_reference, pgmm, pgmm_dw,
                                  pgmm_dw_reference, pgmm_raw,
                                  pgmm_reference)

torch.set_num_threads(1)

NEG_INF = -1e30   # the kernels' finite mask value


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
    _check_bwd(q, k, v, do, causal, tol, out, lse)
    assert flash_attention_backward.launches_dq == nq + 1
    assert flash_attention_backward.launches_dkv == nk + 1


def _bwd_inputs(cuda, dtype, b, s_q, s_kv, hq, hkv, d, seed=2):
    g = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, device=cuda, generator=g).to(dtype)
    return (rnd(b, s_q, hq, d), rnd(b, s_kv, hkv, d), rnd(b, s_kv, hkv, d),
            rnd(b, s_q, hq, d))


def _check_fwd(q, k, v, causal):
    """K1 in both modes against the plain forward with lse: out within tol
    on the rows that see a key (q longer than kv: the first s_q - s_kv rows
    see none, see test_flash_lse_and_backward_match_plain_on_card), lse
    within its tolerance on every row, and the primal path's out equal to
    the lse path's bit for bit; returns the lse path's (out, lse)."""
    out, lse = flash_attention_forward(q, k, v, causal=causal)
    primal = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ref, ref_lse = flash_attention_reference_lse(q, k, v, causal)
    bf16 = q.dtype == torch.bfloat16
    seen = max(0, q.shape[1] - k.shape[1]) if causal else 0
    err = (out[:, seen:].float() - ref[:, seen:].float()).abs().max().item()
    assert err <= (2e-2 if bf16 else 1e-4), err
    lse_err = (lse - ref_lse).abs().max().item()
    assert lse_err <= (5e-3 if bf16 else 1e-4), lse_err
    assert torch.equal(primal, out)
    return out, lse


def _check_bwd(q, k, v, do, causal, tol, out=None, lse=None):
    """K2/K3 against the plain backward on the same (q, k, v, o, lse, do),
    o and lse from the forward kernel unless given; returns the kernels'
    (dq, dk, dv)."""
    if out is None:
        out, lse = flash_attention_forward(q, k, v, causal=causal)
    grads = flash_attention_backward(q, k, v, out, lse, do, causal=causal)
    torch.cuda.synchronize()
    refs = flash_attention_backward_reference(q, k, v, out, lse, do, causal)
    for name, a, r in zip(("dq", "dk", "dv"), grads, refs):
        assert a.shape == r.shape and a.dtype == r.dtype
        err = (a.float() - r.float()).abs().max().item()
        assert err <= tol * max(1.0, r.float().abs().max().item()), (name,
                                                                     err)
    return grads


# the bf16 kernels' tiles: 128 rows a block (two 64-row warpgroups; K1 at
# head_dim 64: 192, three), 64-row streamed tiles; these lengths sit on and
# beside every edge. The forward (both modes) and the backward on the
# forward's (out, lse).
@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 128, 129, 191, 192, 193])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_tile_edges_on_card(cuda, s, d, causal):
    q, k, v, do = _bwd_inputs(cuda, torch.bfloat16, 2, s, s, 8, 2, d)
    out, lse = _check_fwd(q, k, v, causal)
    _check_bwd(q, k, v, do, causal, 2e-2, out, lse)


@pytest.mark.cuda
@pytest.mark.parametrize("hq,hkv", [(4, 4), (16, 4), (16, 2)])  # group 1/4/8
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s_q,s_kv", [(300, 300), (200, 520), (300, 100)])
def test_flash_backward_groups_on_card(cuda, hq, hkv, d, s_q, s_kv):
    q, k, v, do = _bwd_inputs(cuda, torch.bfloat16, 2, s_q, s_kv, hq, hkv, d)
    out, lse = _check_fwd(q, k, v, True)
    dq, _, _ = _check_bwd(q, k, v, do, True, 2e-2, out, lse)
    if s_q > s_kv:   # rows that see no key: lse ~ NEG_INF, no gradient
        assert (lse[:, :, : s_q - s_kv] <= NEG_INF / 2).all()
        assert not dq[:, : s_q - s_kv].any()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_flash_backward_strided_views_on_card(cuda, d):
    # q, k and v as strided views of one [b, s, 3, h, d] buffer: the tensor
    # maps follow the strides
    g = torch.Generator(device=cuda).manual_seed(3)
    qkv = torch.randn(2, 200, 3, 8, d, device=cuda, generator=g).to(
        torch.bfloat16)
    do = torch.randn(2, 200, 8, d, device=cuda, generator=g).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    out, lse = _check_fwd(q, k, v, True)
    _check_bwd(q, k, v, do, True, 2e-2, out, lse)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_flash_backward_is_deterministic_on_card(cuda, d):
    q, k, v, do = _bwd_inputs(cuda, torch.bfloat16, 2, 1000, 1000, 16, 4, d)
    out, lse = flash_attention_forward(q, k, v, causal=True)
    out2, lse2 = flash_attention_forward(q, k, v, causal=True)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    first = flash_attention_backward(q, k, v, out, lse, do, causal=True)
    second = flash_attention_backward(q, k, v, out, lse, do, causal=True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


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


def _pgmm_case(cuda, dtype, k, n, tile_m, n_rows=700, e=4):
    """A skewed routing that leaves expert 2 with no row, its padded layout
    and seeded operands on the card."""
    rng = np.random.default_rng(0)
    flat_e = torch.from_numpy(rng.choice([0, 1, 3], size=n_rows,
                                         p=[0.6, 0.3, 0.1])).to(cuda)
    _, _, gids, p = padded_group_layout(flat_e, e, n_rows, tile_m)
    assert 2 not in gids.tolist()
    g = torch.Generator(device=cuda).manual_seed(2)

    def rnd(*shape):
        return torch.randn(*shape, device=cuda, generator=g).to(dtype)
    return gids, rnd(p, k), rnd(e, k, n), rnd(p, n)


def _rel_err(a, r):
    return ((a.float() - r.float()).abs().max()
            / r.float().abs().max().clamp_min(1e-30)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("k,n,tile_m", [(256, 384, 128), (200, 136, 256)])
def test_pgmm_kernels_match_plain_on_card(cuda, dtype, tol, k, n, tile_m):
    gids, x, w, dout = _pgmm_case(cuda, dtype, k, n, tile_m)
    n5, n6 = pgmm.launches, pgmm_dw.launches
    out = pgmm_raw(x, w, gids, tile_m)
    dx = pgmm_raw(dout, w, gids, tile_m, trans_w=True)
    dw = pgmm_dw(x, dout, gids, 4, tile_m)
    torch.cuda.synchronize()
    assert (pgmm.launches, pgmm_dw.launches) == (n5 + 2, n6 + 1)
    assert out.dtype == dx.dtype == dtype and dw.dtype == torch.float32
    assert _rel_err(out, pgmm_reference(x, w, gids, tile_m)) <= tol
    assert _rel_err(dx, pgmm_reference(dout, w, gids, tile_m,
                                       trans_w=True)) <= tol
    assert _rel_err(dw, pgmm_dw_reference(x, dout, gids, 4, tile_m)) <= tol
    assert (dw[2] == 0).all()   # the tileless expert, zeroed in the kernel


@pytest.mark.cuda
def test_pgmm_kernels_refuse_what_they_cannot_take(cuda):
    gids, x, w, _ = _pgmm_case(cuda, torch.bfloat16, 256, 384, 128)
    with pytest.raises(ValueError, match="multiple"):
        pgmm_raw(x[:, :252].contiguous(), w[:, :252].contiguous(), gids, 128)
    with pytest.raises(ValueError, match="row tile"):
        pgmm_raw(x, w, torch.cat([gids, gids]), 64)
    with pytest.raises(ValueError, match="contiguous"):
        pgmm_raw(x, w.transpose(1, 2).contiguous().transpose(1, 2), gids, 128)


@pytest.mark.cuda
def test_moe_engine_step_on_card_matches_cpu(cuda):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=384,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=256,
                      num_experts=4, moe_dispatch="pgmm")
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=3)
    card = LlamaForCausalLM(cfg, device=cuda, seed=3)
    with torch.no_grad():
        for pc, pg in zip(cpu.parameters(), card.parameters()):
            pg.copy_(pc)
    ids = torch.randint(0, cfg.vocab_size, (2, 100),
                        generator=torch.Generator().manual_seed(0))
    ec, eg = Engine(cpu, lr=1e-3), Engine(card, lr=1e-3)
    n5, n6 = pgmm.launches, pgmm_dw.launches
    lc = ec.step(ids, ids)
    lg = eg.step(ids.to(cuda), ids.to(cuda))
    torch.cuda.synchronize()
    assert (pgmm.launches - n5, pgmm_dw.launches - n6) == (12, 6)
    assert abs(lg.item() - lc.item()) <= 1e-4 * abs(lc.item())
    for (name, pc), pg in zip(cpu.named_parameters(), card.parameters()):
        err = (pg.detach().cpu() - pc.detach()).abs().max().item()
        assert err <= 2e-3, (name, err)
