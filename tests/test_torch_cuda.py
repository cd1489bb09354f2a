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
sums differs); K4 on int8 pools is held to the same tolerances against the
dense-gather version on the same int8 bytes and scales (both dequantize in
fp32, only where the scale multiplies and the summation order differ); the backward's gradients are held to tol x max(1, max
|plain|) and the grouped matmuls (K5, K6) to tol x max |plain|. The dense
and MoE train steps on the card are held against the same steps on the CPU
(fp32, TF32 off). The fused serving engine's captured decode step is held
bitwise against the same step run eagerly on the card; K5 at the MoE
decode layouts is held bitwise between a graph replay and an eager launch;
the fused MoE engine's greedy streams (fp32) equal the legacy engine's,
and paged ``generate`` the engine's.
"""

import importlib

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed import Engine
from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                PrefixCacheConfig, Request,
                                                SpecConfig)
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import (copy_pages, flash_attention,
                                  flash_attention_backward,
                                  flash_attention_backward_reference,
                                  flash_attention_forward,
                                  flash_attention_reference,
                                  flash_attention_reference_lse,
                                  padded_group_layout,
                                  paged_decode_attention,
                                  paged_decode_reference, pgmm, pgmm_dw,
                                  QuantizedKVPool,
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


def _paged_case(cuda, dtype, hq, hkv, d, page, maxp, lens):
    """Seeded q and pools on the card, rows' tables a permutation of the
    pool's pages with -1 past each row's last page, and the lengths."""
    g = torch.Generator(device=cuda).manual_seed(0)
    b = len(lens)
    npages = b * maxp
    q = torch.randn(b, hq, d, device=cuda, generator=g).to(dtype)
    kc = torch.randn(npages, hkv, page, d, device=cuda, generator=g).to(dtype)
    vc = torch.randn(npages, hkv, page, d, device=cuda, generator=g).to(dtype)
    tables = torch.randperm(npages, device=cuda, generator=g).reshape(
        b, maxp).to(torch.int32)
    for row, n in enumerate(lens):
        tables[row, -(-n // page):] = -1     # unassigned past the length
    return q, kc, vc, tables, torch.tensor(lens, device=cuda,
                                           dtype=torch.int32)


def _check_paged(args, tol):
    n0 = paged_decode_attention.launches
    out = paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == n0 + 1
    ref = paged_decode_reference(*args)
    assert (out.float() - ref.float()).abs().max().item() <= tol
    for row, n in enumerate(args[4].tolist()):
        if n == 0:
            assert (out[row] == 0).all()       # parked rows stay inert
    return out


# lengths 0, 1, page - 1, page, page + 1, 8 pages (the end of a block's
# page range at every cluster size, 1 to 8), 8 pages + 1 and the full table
_PAGE, _MAXP = 16, 24
_EDGE_LENS = [0, 1, _PAGE - 1, _PAGE, _PAGE + 1, 8 * _PAGE, 8 * _PAGE + 1,
              _MAXP * _PAGE]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d", [64, 128])
# groups 1, 4 and 8; 16 takes two clusters of 8 q heads per kv head
@pytest.mark.parametrize("hq,hkv", [(8, 8), (16, 4), (16, 2), (32, 2)])
def test_paged_kernel_edges_on_card(cuda, dtype, tol, d, hq, hkv):
    _check_paged(_paged_case(cuda, dtype, hq, hkv, d, _PAGE, _MAXP,
                             _EDGE_LENS), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_all_rows_empty_on_card(cuda, dtype):
    args = _paged_case(cuda, dtype, 16, 4, 128, _PAGE, 4, [0] * 6)
    out = _check_paged(args, 0.0)
    assert (out == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_paged_kernel_long_gqa_on_card(cuda, dtype, tol):
    # 4 rows, 32 q / 8 kv heads of 128, 256 pages of 16 a row: the ring
    # turns many times in the blocks of the long rows
    _check_paged(_paged_case(cuda, dtype, 32, 8, 128, 16, 256,
                             [1, 1000, 2500, 4096]), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_is_deterministic_on_card(cuda, dtype):
    args = _paged_case(cuda, dtype, 16, 4, 128, 16, 40,
                       [0, 1, 16, 64, 100, 333, 512, 640])
    assert torch.equal(paged_decode_attention(*args),
                       paged_decode_attention(*args))


@pytest.mark.cuda
def test_paged_kernel_replays_in_a_cuda_graph(cuda):
    # 12 launches (one decode step of 12 layers) captured once, replayed
    # after the lengths and tables are rewritten in place: the grid does
    # not depend on them, so the replay equals eager calls bit for bit
    layers, page, maxp = 12, 16, 40
    q, kc, vc, tables, lens = _paged_case(cuda, torch.bfloat16, 16, 16, 128,
                                          page, maxp, [5, 17, 64, 100, 200,
                                                       333, 512, 640])
    qs = [torch.randn_like(q, dtype=torch.float32).to(q.dtype)
          for _ in range(layers)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for x in qs:                          # warm-up off the capture
            paged_decode_attention(x, kc, vc, tables, lens)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [paged_decode_attention(x, kc, vc, tables, lens) for x in qs]
    g = torch.Generator(device=cuda).manual_seed(5)
    for new_lens in ([640, 0, 1, 333, 17, 512, 64, 100],
                     [0, 0, 0, 0, 0, 0, 0, 0]):
        lens.copy_(torch.tensor(new_lens, dtype=torch.int32))
        tables.copy_(torch.randperm(tables.numel(), device=cuda,
                                    generator=g).reshape(tables.shape))
        graph.replay()
        torch.cuda.synchronize()
        for x, o in zip(qs, outs):
            assert torch.equal(o, paged_decode_attention(x, kc, vc, tables,
                                                         lens))
        ref = paged_decode_reference(qs[0], kc, vc, tables, lens)
        assert (outs[0].float() - ref.float()).abs().max().item() <= 2e-2


def _int8_case(cuda, dtype, hq, hkv, d, page, maxp, lens):
    """``_paged_case`` with int8 pools: random bytes in [-127, 127] and
    random per-(page, kv head) scales in [0.5, 3)."""
    q, _, _, tables, lens_t = _paged_case(cuda, dtype, hq, hkv, d, page,
                                          maxp, lens)
    g = torch.Generator(device=cuda).manual_seed(1)
    npages = tables.numel()

    def pool():
        data = torch.randint(-127, 128, (npages, hkv, page, d), device=cuda,
                             generator=g, dtype=torch.int32).to(torch.int8)
        scale = 0.5 + 2.5 * torch.rand(npages, hkv, device=cuda, generator=g)
        return QuantizedKVPool(data, scale)

    return q, pool(), pool(), tables, lens_t


def _check_paged_int8(args, tol):
    n0, i0 = (paged_decode_attention.launches,
              paged_decode_attention.int8_launches)
    out = _check_paged(args, tol)
    assert paged_decode_attention.int8_launches == i0 + 1
    assert paged_decode_attention.launches == n0 + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d", [64, 128])
# groups 1, 2, 4 and 8; 16 takes two clusters of 8 q heads per kv head
@pytest.mark.parametrize("hq,hkv", [(8, 8), (8, 4), (16, 4), (16, 2),
                                    (32, 2)])
def test_paged_kernel_int8_edges_on_card(cuda, dtype, tol, d, hq, hkv):
    _check_paged_int8(_int8_case(cuda, dtype, hq, hkv, d, _PAGE, _MAXP,
                                 _EDGE_LENS), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_paged_kernel_int8_long_gqa_and_empty_on_card(cuda, dtype, tol):
    _check_paged_int8(_int8_case(cuda, dtype, 32, 8, 128, 16, 256,
                                 [1, 1000, 2500, 4096]), tol)
    out = _check_paged_int8(_int8_case(cuda, dtype, 16, 4, 128, _PAGE, 4,
                                       [0] * 6), 0.0)
    assert (out == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_int8_is_deterministic_on_card(cuda, dtype):
    args = _int8_case(cuda, dtype, 16, 4, 128, 16, 40,
                      [0, 1, 16, 64, 100, 333, 512, 640])
    assert torch.equal(paged_decode_attention(*args),
                       paged_decode_attention(*args))


@pytest.mark.cuda
def test_paged_kernel_int8_replays_in_a_cuda_graph(cuda):
    """As test_paged_kernel_replays_in_a_cuda_graph, on int8 pools whose
    bytes and scales also change between replays (in place)."""
    layers, page, maxp = 12, 16, 40
    q, kc, vc, tables, lens = _int8_case(cuda, torch.bfloat16, 16, 16, 128,
                                         page, maxp, [5, 17, 64, 100, 200,
                                                      333, 512, 640])
    qs = [torch.randn_like(q, dtype=torch.float32).to(q.dtype)
          for _ in range(layers)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for x in qs:
            paged_decode_attention(x, kc, vc, tables, lens)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [paged_decode_attention(x, kc, vc, tables, lens) for x in qs]
    g = torch.Generator(device=cuda).manual_seed(5)
    for new_lens in ([640, 0, 1, 333, 17, 512, 64, 100],
                     [0, 0, 0, 0, 0, 0, 0, 0]):
        lens.copy_(torch.tensor(new_lens, dtype=torch.int32))
        tables.copy_(torch.randperm(tables.numel(), device=cuda,
                                    generator=g).reshape(tables.shape))
        kc.scale.mul_(1.5)
        vc.data.copy_(vc.data.flip(0))
        graph.replay()
        torch.cuda.synchronize()
        for x, o in zip(qs, outs):
            assert torch.equal(o, paged_decode_attention(x, kc, vc, tables,
                                                         lens))
        ref = paged_decode_reference(qs[0], kc, vc, tables, lens)
        assert (outs[0].float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.cuda
def test_paged_kernel_int8_refuses_what_it_cannot_take(cuda):
    q, kc, vc, tables, lens = _int8_case(cuda, torch.bfloat16, 8, 4, 128,
                                         16, 4, [3, 5])
    with pytest.raises(TypeError, match="both"):
        paged_decode_attention(q, kc, vc.data, tables, lens)
    bad = QuantizedKVPool(kc.data, kc.scale.half())
    with pytest.raises(TypeError, match="float32"):
        paged_decode_attention(q, bad, vc, tables, lens)
    bad = QuantizedKVPool(kc.data, kc.scale[:, :1].contiguous())
    with pytest.raises(ValueError, match="scales"):
        paged_decode_attention(q, bad, vc, tables, lens)
    bad = QuantizedKVPool(kc.data, kc.scale.t().contiguous().t())
    with pytest.raises(ValueError, match="contiguous"):
        paged_decode_attention(q, bad, vc, tables, lens)


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


# a small serving model whose head_dim (64) the paged decode kernel takes
_SERVE_CFG = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, max_position_embeddings=256)


def _card_model(cuda, dtype="float32"):
    """The small model on the CPU and the same weights on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LlamaConfig(dtype=dtype, **_SERVE_CFG)
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=3)
    card = LlamaForCausalLM(cfg, device=cuda, seed=3)
    with torch.no_grad():
        for pc, pg in zip(cpu.parameters(), card.parameters()):
            pg.copy_(pc)
    return cpu, card


def _fused_engine(model, device, **kw):
    return ContinuousBatchingEngine(
        model, max_batch=8, max_len=64, page_size=16, block_size=4,
        fused=True, device=device,
        prefix_cache=PrefixCacheConfig(prefill_chunk=16, extra_blocks=8),
        **kw)


def _step_state(eng):
    """Everything a decode step writes: the pools, the token carry, the
    positions, the token output and its step index."""
    return ([t for kv in eng.caches["kv"] for t in kv]
            + [eng._last_tok, eng._dev_pos, eng._out, eng._step_i])


def _set_rows(eng, rows, gen):
    """Activate ``rows`` (slot -> position) over random distinct pages;
    every other slot parked."""
    maxp = eng._maxp
    pages = torch.randperm(eng._park, generator=gen).numpy()
    for i in range(eng.max_batch):
        if i in rows:
            eng._queue_update(i, pages[i * maxp:(i + 1) * maxp], rows[i],
                              True)
        else:
            eng._queue_update(i, None, 0, False)
    eng._flush_updates()


def _replay_vs_eager(eng, steps):
    """``steps`` graph replays, then the same steps eagerly from the same
    state: every tensor the step writes must be bitwise equal."""
    start = [t.clone() for t in _step_state(eng)]
    for _ in range(steps):
        eng._graph.replay()
    replayed = [t.clone() for t in _step_state(eng)]
    for t, s0 in zip(_step_state(eng), start):
        t.copy_(s0)
    with torch.no_grad():
        for _ in range(steps):
            eng._fused_step()
    torch.cuda.synchronize()
    for a, b in zip(replayed, _step_state(eng)):
        assert torch.equal(a, b)
    return replayed


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_replay_equals_eager_step_on_card(cuda, dtype):
    _, card = _card_model(cuda, dtype)
    eng = _fused_engine(card, cuda)
    assert eng.stats["graph_captures"] == 1
    assert eng._graph_counts[0] == card.config.num_hidden_layers
    gen = torch.Generator().manual_seed(0)
    g = torch.Generator(device=cuda).manual_seed(1)
    for k, v in eng.caches["kv"]:
        k.copy_(torch.randn(k.shape, device=cuda, generator=g))
        v.copy_(torch.randn(v.shape, device=cuda, generator=g))
    eng._last_tok.copy_(torch.randint(0, 512, (8,), device=cuda,
                                      generator=g))
    _set_rows(eng, {0: 9, 3: 30, 5: 17}, gen)
    eng._step_i.zero_()
    out = _replay_vs_eager(eng, 3)
    pos = out[-3]
    assert pos.tolist() == [12, 0, 0, 33, 0, 20, 0, 0]


@pytest.mark.cuda
def test_replay_after_flush_follows_the_new_state_on_card(cuda):
    """Tables, positions and the active mask change through
    _flush_updates (in place); the same graph then replays the new state
    exactly as an eager step would."""
    _, card = _card_model(cuda)
    eng = _fused_engine(card, cuda)
    gen = torch.Generator().manual_seed(2)
    g = torch.Generator(device=cuda).manual_seed(3)
    for k, v in eng.caches["kv"]:
        k.copy_(torch.randn(k.shape, device=cuda, generator=g))
        v.copy_(torch.randn(v.shape, device=cuda, generator=g))
    _set_rows(eng, {0: 5, 3: 20}, gen)
    eng._step_i.zero_()
    _replay_vs_eager(eng, 2)
    _set_rows(eng, {1: 40, 3: 7, 7: 60}, gen)  # new rows, tables, positions
    eng._step_i.zero_()
    pos = _replay_vs_eager(eng, 2)[-3]
    assert pos.tolist() == [0, 42, 0, 9, 0, 0, 0, 62]
    assert eng.stats["graph_captures"] == 1


@pytest.mark.cuda
def test_fused_engine_on_card_replays_without_recapture(cuda):
    """A churning wave (more requests than slots, shared prefixes, a warm
    re-serve with full-prompt hits): every greedy block replays the one
    graph, K4 runs its captured launches at each replay, and the streams
    equal the legacy engine's on the card."""
    _, card = _card_model(cuda)
    rng = np.random.default_rng(0)
    system = rng.integers(0, 512, (16,)).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(0, 512, (n,)).astype(
        np.int32)]) for n in (0, 3, 16, 9, 5, 16, 1, 30, 7, 12, 4, 2)]
    news = [4 + (i % 4) * 3 for i in range(len(prompts))]

    def serve(eng):
        reqs = [Request(p, max_new_tokens=k) for p, k in zip(prompts, news)]
        for r in reqs:
            eng.add_request(r)
        eng.run_until_done(max_steps=500)
        return [r.tokens for r in reqs]

    legacy = serve(ContinuousBatchingEngine(
        card, max_batch=2, max_len=64, page_size=16, block_size=4,
        device=cuda))
    eng = _fused_engine(card, cuda)
    n0 = paged_decode_attention.launches
    assert serve(eng) == legacy and serve(eng) == legacy
    st = eng.stats
    assert st["graph_captures"] == 1 and st["eager_decode_steps"] == 0
    assert st["graph_replays"] == st["decode_steps"] > 0
    assert st["cow_copies"] > 0 and st["hit_tokens"] > 0
    assert (paged_decode_attention.launches - n0
            >= st["graph_replays"] * card.config.num_hidden_layers)
    assert (eng.caches["tables"] == eng._park).all()
    # a sampled block runs the same step eagerly
    r = Request(prompts[1], max_new_tokens=5, temperature=0.9, seed=4)
    eng.add_request(r)
    eng.run_until_done(max_steps=50)
    assert len(r.tokens) == 5 and st["eager_decode_steps"] > 0


@pytest.mark.cuda
def test_copy_pages_and_packed_prefill_on_card_match_cpu(cuda):
    gen = torch.Generator().manual_seed(4)
    kc, vc = (torch.randn(12, 2, 16, 64, generator=gen) for _ in range(2))
    ck, cv = kc.clone().to(cuda), vc.clone().to(cuda)
    for src, dst in ((3, 7), ([1, 2, 9, 9], [5, 6, 9, 9])):
        copy_pages(kc, vc, src, dst)
        copy_pages(ck, cv, src, dst)
        assert torch.equal(ck.cpu(), kc) and torch.equal(cv.cpu(), vc)
    # packed prefill: two rows of one sequence at starts 0 and 16, one row
    # of another, and a parked dummy row
    cpu, card = _card_model(cuda)
    ids = torch.randint(0, 512, (4, 16), generator=gen)
    starts = torch.tensor([0, 16, 0, 0], dtype=torch.int32)
    rows = torch.tensor([[0, 1, 2, 3], [0, 1, 2, 3], [4, 5, 6, 7],
                         [8, 8, 8, 8]], dtype=torch.int32)
    out = []
    for model, dev in ((cpu, "cpu"), (card, cuda)):
        caches = model._init_paged_caches(2, 64, 16, num_blocks=9,
                                          device=dev)
        sub = {"kv": caches["kv"], "tables": rows.to(dev)}
        model.paged_prefill_chunk(ids.to(dev), sub, starts.to(dev))
        out.append([t.cpu() for kv in caches["kv"] for t in kv])
    for a, b in zip(*out):
        assert (a[:8] - b[:8]).abs().max().item() <= 1e-4


# chip_smoke.py's PARITY_CONFIG: head_dim 128, group 2
_PARITY_CFG = dict(vocab_size=1024, hidden_size=512, intermediate_size=1024,
                   num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=2, max_position_embeddings=256)


def _spec_wave(vocab, n=8):
    """Greedy requests whose prompts are a random 8-token motif tiled (the
    n-gram drafter's food) or random, with uneven lengths."""
    rng = np.random.default_rng(0)
    prompts = [np.tile(rng.integers(0, vocab, (8,)).astype(np.int32), 3)
               if i % 2 == 0 else
               rng.integers(0, vocab, (9 + i,)).astype(np.int32)
               for i in range(n)]
    return prompts, [8 + (i % 4) * 6 for i in range(n)]


def _serve_card(eng, prompts, news):
    reqs = [Request(p, max_new_tokens=k) for p, k in zip(prompts, news)]
    for r in reqs:
        eng.add_request(r)
    eng.run_until_done(max_steps=1000)
    return [r.tokens for r in reqs]


@pytest.mark.cuda
@pytest.mark.parametrize("kv_cache", [None, "int8"])
def test_spec_streams_equal_non_spec_fp32_on_card(cuda, kv_cache):
    """fp32 on the card: the speculative engine's greedy streams equal the
    non-speculative engine's (the decode steps run K4, the verify step the
    plain gather; in fp32 their logits agree far inside the gaps between
    a random model's top logits). Every spec dispatch replays the one
    captured spec graph. On int8 pools rejected drafts' appends move the
    block scales, so there spec is held to the teacher-free contract of
    the JAX package: two identical engines give identical bytes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    model = LlamaForCausalLM(LlamaConfig(**_PARITY_CFG), device=cuda, seed=3)
    prompts, news = _spec_wave(_PARITY_CFG["vocab_size"])

    def build(**kw):
        return ContinuousBatchingEngine(
            model, max_batch=4, max_len=128, page_size=16, block_size=4,
            fused=True, device=cuda, kv_cache=kv_cache,
            prefix_cache=PrefixCacheConfig(extra_blocks=8), **kw)

    ref = _serve_card(build(), prompts, news)
    eng = build(speculative=SpecConfig(k=4))
    got = _serve_card(eng, prompts, news)
    st = eng.stats
    assert st["spec_graph_captures"] == 1 and st["graph_captures"] == 1
    assert st["eager_spec_steps"] == 0
    assert st["spec_graph_replays"] == st["spec_steps"] > 0
    assert st["spec_accepted"] > 0
    assert [len(t) for t in got] == news
    if kv_cache is None:
        assert got == ref
    else:
        assert _serve_card(build(speculative=SpecConfig(k=4)), prompts,
                           news) == got
        assert _serve_card(eng, prompts, news) == got     # warm == cold


@pytest.mark.cuda
def test_spec_graph_replays_equal_eager_spec_steps_on_card(cuda):
    """The captured spec step against the same step run eagerly from the
    same state: every tensor it writes (pools, ring, positions, carry,
    outputs) bitwise equal, after the state changed through
    _flush_updates. Three places hold garbage that no live row reads and
    are left out: the parking page, where the parked rows' windows land
    with duplicate indices (which of them wins a scatter is not fixed),
    the parked rows' verify outputs, computed from that page, and the
    ring's spare column, where each row's tokens not emitted go."""
    _, card = _card_model(cuda)
    eng = _fused_engine(card, cuda, speculative=SpecConfig(k=3))
    assert eng.stats["spec_graph_captures"] == 1
    gen = torch.Generator().manual_seed(0)
    g = torch.Generator(device=cuda).manual_seed(1)
    for k, v in eng.caches["kv"]:
        k.copy_(torch.randn(k.shape, device=cuda, generator=g))
        v.copy_(torch.randn(v.shape, device=cuda, generator=g))
    eng._last_tok.copy_(torch.randint(0, 512, (8,), device=cuda,
                                      generator=g))
    _set_rows(eng, {0: 9, 3: 30, 5: 17}, gen)
    eng._dev_caps.fill_(4)
    state = ([t for kv in eng.caches["kv"] for t in kv]
             + [eng._last_tok, eng._dev_pos, eng._dev_hist, eng._dev_hlen,
                eng._spec_out, eng._spec_emit])
    start = [t.clone() for t in state]
    for _ in range(2):
        eng._spec_graph.replay()
    replayed = [t.clone() for t in state]
    for t, s0 in zip(state, start):
        t.copy_(s0)
    with torch.no_grad():
        for _ in range(2):
            eng._spec_step()
    torch.cuda.synchronize()
    live = torch.arange(eng._park + 1, device=cuda) != eng._park
    n_pools = 2 * len(eng.caches["kv"])
    for i, (a, b) in enumerate(zip(replayed, state)):
        if i < n_pools:
            a, b = a[live], b[live]
        elif b is eng._dev_hist:
            a, b = a[:, :-1], b[:, :-1]
        elif b is eng._spec_out:
            a, b = a[[0, 3, 5]], b[[0, 3, 5]]
        assert torch.equal(a, b), i
    emitted = eng._dev_pos - start[-5]
    assert (emitted[[0, 3, 5]] >= 2).all() and emitted.sum() == \
        emitted[[0, 3, 5]].sum()


# ---- remat and the MoE dispatches (the flash custom ops) ----

_REMAT_CFG = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
                  num_hidden_layers=3, num_attention_heads=4,
                  num_key_value_heads=2, max_position_embeddings=256)


@pytest.mark.cuda
@pytest.mark.parametrize("policy,every,lse_launches", [
    ("flash", 1, 3), ("flash_qkv", 1, 3), ("flash_mlp", 1, 3),
    ("full", 1, 6), ("full", 2, 5)])
def test_remat_on_card_equals_no_remat(cuda, policy, every, lse_launches):
    """fp32, 3 layers: remat replays the forward's ops on the same values,
    so the loss and every gradient equal no remat (tolerance 1e-5 x
    max(1, max |no-remat|): the same kernels, K2/K3 deterministic); K1-lse
    runs once a layer when the policy saves it, again in the backward for
    each checkpointed layer under 'full'."""
    torch.backends.cuda.matmul.allow_tf32 = False
    ids = torch.randint(0, 512, (2, 100), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(0))
    out = []
    for over in (dict(recompute=False),
                 dict(recompute=True, remat_policy=policy,
                      remat_every=every)):
        model = LlamaForCausalLM(LlamaConfig(**_REMAT_CFG, **over),
                                 device=cuda, seed=3)
        n0 = (flash_attention_forward.launches,
              flash_attention_backward.launches_dq, flash_attention.launches)
        loss = model.loss_fn(ids, ids)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        torch.cuda.synchronize()
        out.append((loss, grads, (flash_attention_forward.launches - n0[0],
                                  flash_attention_backward.launches_dq
                                  - n0[1], flash_attention.launches - n0[2])))
    (loss0, g0, c0), (loss, g, c) = out
    assert c0 == (3, 3, 0) and c == (lse_launches, 3, 0)
    assert abs(loss.item() - loss0.item()) <= 1e-5 * abs(loss0.item())
    for a, b in zip(g, g0):
        err = (a - b).abs().max().item()
        assert err <= 1e-5 * max(1.0, b.abs().max().item())


@pytest.mark.cuda
def test_flash_custom_ops_equal_the_direct_launches_bitwise(cuda):
    """The training shape [2, 4096, 16/4, 128] in bf16: the ops
    paddle_tpu_torch::flash_fwd_lse and ::flash_bwd give bitwise the
    outputs of the kernel launches they wrap (K1 with lse; K2 then K3)."""
    # the module (the package attribute ``ops.flash_attention`` is the
    # function)
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    g = torch.Generator(device=cuda).manual_seed(4)

    def rnd(*shape):
        return torch.randn(*shape, device=cuda, generator=g).to(
            torch.bfloat16)
    q, k, v = rnd(2, 4096, 16, 128), rnd(2, 4096, 4, 128), \
        rnd(2, 4096, 4, 128)
    dout = rnd(2, 4096, 16, 128)
    scale = 128 ** -0.5
    out, lse = torch.ops.paddle_tpu_torch.flash_fwd_lse(q, k, v, True,
                                                        scale)
    out2, lse2 = fa._launch_forward(q, k, v, True, scale, with_lse=True)
    dq, dk, dv = torch.ops.paddle_tpu_torch.flash_bwd(q, k, v, out, lse,
                                                      dout, True, scale)
    dq2, delta = fa._launch_dq(q, k, v, out, lse, dout, True, scale)
    dk2, dv2 = fa._launch_dkv(q, k, v, dout, lse, delta, True, scale)
    torch.cuda.synchronize()
    for a, b in ((out, out2), (lse, lse2), (dq, dq2), (dk, dk2), (dv, dv2)):
        assert torch.equal(a, b)


def _moe_card_pair(cuda, **over):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=384,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=256,
                      num_experts=4, **over)
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=3)
    card = LlamaForCausalLM(cfg, device=cuda, seed=3)
    with torch.no_grad():
        for pc, pg in zip(cpu.parameters(), card.parameters()):
            pg.copy_(pc)
    return cpu, card


@pytest.mark.cuda
@pytest.mark.parametrize("dispatch,k5,k6", [
    ("einsum", 0, 0), ("scatter", 0, 0), ("ragged", 12, 6), ("auto", 0, 0)])
def test_moe_dispatch_step_on_card_matches_cpu(cuda, dispatch, k5, k6):
    """One Engine step (fp32) on the card against the CPU from the same
    weights, capacity factor 0.5 (the capacity modes drop choices): the
    loss to 1e-4 relative and every parameter within 2 lr; ``ragged`` runs
    K5 (3 forward + 3 dx a layer) and K6 (3 a layer), the others neither."""
    cpu, card = _moe_card_pair(cuda, moe_dispatch=dispatch,
                               moe_capacity_factor=0.5)
    ids = torch.randint(0, 512, (2, 100),
                        generator=torch.Generator().manual_seed(0))
    ec, eg = Engine(cpu, lr=1e-3), Engine(card, lr=1e-3)
    n5, n6 = pgmm.launches, pgmm_dw.launches
    lc = ec.step(ids, ids)
    lg = eg.step(ids.to(cuda), ids.to(cuda))
    torch.cuda.synchronize()
    assert (pgmm.launches - n5, pgmm_dw.launches - n6) == (k5, k6)
    assert abs(lg.item() - lc.item()) <= 1e-4 * abs(lc.item())
    for (name, pc), pg in zip(cpu.named_parameters(), card.parameters()):
        err = (pg.detach().cpu() - pc.detach()).abs().max().item()
        assert err <= 2e-3, (name, err)


@pytest.mark.cuda
def test_scatter_moe_step_syncs_nothing_on_card(cuda):
    """A bf16 MoE step with the scatter dispatch under
    set_sync_debug_mode("error"): routing, capacity drops, the slot writes
    and the gathers never wait for the device."""
    model = LlamaForCausalLM(LlamaConfig(
        vocab_size=512, hidden_size=256, intermediate_size=384,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, num_experts=4, dtype="bfloat16",
        moe_dispatch="scatter", moe_capacity_factor=0.5), device=cuda,
        seed=3)
    eng = Engine(model, lr=1e-3)
    ids = torch.randint(0, 512, (2, 128), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(0))
    eng.step(ids, ids)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = eng.step(ids, ids)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(loss).item()


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [16, 256])
def test_pgmm_decode_layout_replays_in_a_cuda_graph(cuda, rows):
    """K5 at the MoE serving decode layouts: 8 or 128 tokens x top-2 over 8
    experts in 512-row tiles, 4608 padded rows, at bench_moe's widths in
    bf16. Captured in a CUDA graph, then replayed after the tokens and the
    routing change in place: the replay equals an eager launch bitwise and
    the plain version within 2e-2 x max |plain|."""
    e, k, n, tile = 8, 1024, 2816, 512
    g = torch.Generator(device=cuda).manual_seed(0)
    w = (torch.randn(e, k, n, device=cuda, generator=g)
         * k ** -0.5).to(torch.bfloat16)

    def routed(seed):
        """A routing of ``rows`` choices and x with those rows filled."""
        flat = torch.randint(0, e, (rows,), device=cuda, generator=torch.
                             Generator(device=cuda).manual_seed(seed))
        order, pos_sorted, gids, p = padded_group_layout(flat, e, rows, tile)
        pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
        xs = torch.zeros(p, k, device=cuda, dtype=torch.bfloat16)
        xs[pos] = torch.randn(rows, k, device=cuda,
                              generator=g).to(torch.bfloat16)
        return xs, gids

    x, gids = routed(1)
    assert x.shape[0] == 4608
    pgmm_raw(x, w, gids)                       # build and warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pgmm_raw(x, w, gids)
    x2, gids2 = routed(2)
    x.copy_(x2)
    gids.copy_(gids2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, pgmm_raw(x, w, gids))
    assert _rel_err(out, pgmm_reference(x, w, gids, tile)) <= 2e-2


@pytest.mark.cuda
def test_moe_fused_engine_equals_legacy_fp32_on_card(cuda):
    """A small fp32 MoE model (pgmm, 4 experts) on the card: the fused
    prefix-cache engine, K5 captured in its decode graph and every decode
    block replayed, gives the legacy engine's greedy streams cold and
    warm. Each replay credits K5 with the 3 launches a layer it replays;
    K6 never runs. A witness outside the port's kernels: the plain CPU
    forward of the same weights, routing by its own gates, puts every
    emitted token within fp32 rounding (1e-4) of its position's maximum
    logit."""
    cpu, card = _moe_card_pair(cuda, moe_dispatch="pgmm")
    prompts, news = _spec_wave(512)
    legacy = ContinuousBatchingEngine(card, max_batch=4, max_len=128,
                                      page_size=16, block_size=4,
                                      fused=False, device=cuda)
    ref = _serve_card(legacy, prompts, news)
    eng = ContinuousBatchingEngine(
        card, max_batch=8, max_len=128, page_size=16, block_size=4,
        fused=True, device=cuda,
        prefix_cache=PrefixCacheConfig(extra_blocks=8))
    L = card.config.num_hidden_layers
    assert eng._graph_counts[2:] == (3 * L, 0)
    n5, n6 = pgmm.launches, pgmm_dw.launches
    cold = _serve_card(eng, prompts, news)
    warm = _serve_card(eng, prompts, news)
    st = eng.stats
    assert cold == warm == ref
    assert st["graph_captures"] == 1 and st["eager_decode_steps"] == 0
    assert st["graph_replays"] == st["decode_steps"] > 0
    assert pgmm.launches - n5 >= 3 * L * st["graph_replays"]
    assert pgmm_dw.launches == n6
    with torch.no_grad():
        for p, out in zip(prompts, ref):
            seq = np.concatenate([p, np.asarray(out[:-1], np.int32)])
            logits = cpu(torch.from_numpy(seq[None]))[0, len(p) - 1:]
            got = logits.gather(1, torch.tensor(out)[:, None])[:, 0]
            assert (logits.max(-1).values - got).max().item() <= 1e-4


@pytest.mark.cuda
def test_paged_generate_equals_engine_greedy_fp32_on_card(cuda):
    """fp32 on the card: generate with the paged cache (K1 for the prompt,
    K4 for each token) gives the legacy engine's greedy stream of each
    prompt, and the dense cache (plain attention) the same tokens."""
    torch.backends.cuda.matmul.allow_tf32 = False
    model = LlamaForCausalLM(LlamaConfig(**_PARITY_CFG), device=cuda, seed=3)
    L = model.config.num_hidden_layers
    ids = np.random.default_rng(1).integers(
        0, _PARITY_CFG["vocab_size"], (4, 24)).astype(np.int32)
    k1, k4 = flash_attention.launches, paged_decode_attention.launches
    paged = model.generate(ids, max_new_tokens=20, temperature=0.0,
                           cache_impl="paged", page_size=16)
    torch.cuda.synchronize()
    assert flash_attention.launches - k1 == L
    assert paged_decode_attention.launches - k4 == 19 * L
    dense = model.generate(ids, max_new_tokens=20, temperature=0.0)
    eng = ContinuousBatchingEngine(model, max_batch=4, max_len=64,
                                   page_size=16, block_size=4, device=cuda)
    ref = _serve_card(eng, list(ids), [20] * 4)
    assert paged.tolist() == ref
    assert dense.tolist() == ref


# ---- K1-K3 in the segment and row-bound modes, K2 with the lse cotangent --
# Masks where every row sees a key (its own diagonal): documents of packed
# sequences, and row bounds with start[c] > c. Out, lse and gradients are
# held to the dense kernels' tolerances against the plain versions on the
# same inputs.

def _fa():
    return importlib.import_module("paddle_tpu_torch.ops.flash_attention")


def _masks(cuda, kind, b, s, hkv):
    """(mask kwargs for the plain backward, positional mask operands) of a
    seeded mask in which every row sees its diagonal: "seg" documents of
    s // 3, s // 5 and the rest tokens (the second row one document);
    "row1"/"rowh" bounds [b, 1 or hkv, s] with start[c] in (c, c + 64] and
    end = start + 40 (rowh: another band per kv head)."""
    g = torch.Generator(device="cpu").manual_seed(5)
    if kind == "seg":
        cut = [s // 3, s // 3 + s // 5]
        ids = torch.zeros(b, s, dtype=torch.int32)
        ids[0, cut[0]:] = 1
        ids[0, cut[1]:] = 2
        ids = ids.to(cuda)
        return dict(q_seg=ids, kv_seg=ids), (ids, ids)
    hm = 1 if kind == "row1" else hkv
    cols = torch.arange(s, dtype=torch.int32)
    start = cols + 1 + torch.randint(0, 64, (b, hm, s), generator=g,
                                     dtype=torch.int32)
    end = start + 40 + 40 * torch.arange(hm, dtype=torch.int32)[None, :, None]
    start, end = start.to(cuda), end.to(cuda)
    return dict(row_start=start, row_end=end), (start, end)


def _masked_fn(kind):
    fa = _fa()
    return (fa.flash_attention_varlen if kind == "seg"
            else fa.flash_attention_rowmask)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("kind", ["seg", "row1", "rowh"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [65, 300])
def test_flash_masked_modes_match_plain_on_card(cuda, dtype, tol, kind, d,
                                                causal, s):
    fa = _fa()
    q, k, v, do = _bwd_inputs(cuda, dtype, 2, s, s, 8, 2, d)
    kw, ops_ = _masks(cuda, kind, 2, s, 2)
    name = "seg" if kind == "seg" else "rowmask"
    # the primal forward (no grad): K1 in the mode, no lse
    n_primal = getattr(flash_attention, "launches_" + name)
    with torch.no_grad():
        primal = _masked_fn(kind)(q, k, v, *ops_, causal=causal)
    assert getattr(flash_attention, "launches_" + name) == n_primal + 1
    keep = fa._mask_keep(q, fa._make_mask(**kw))
    ref, ref_lse = fa._masked_reference_lse(q, k, v, keep, causal,
                                            d ** -0.5)
    # the training op: K1 with lse, then K2/K3 in the mode
    fwd = getattr(torch.ops.paddle_tpu_torch, "flash_fwd_lse_" + name)
    bwd = getattr(torch.ops.paddle_tpu_torch, "flash_bwd_" + name)
    out, lse = fwd(q, k, v, *ops_, causal, d ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(primal, out)
    assert (out.float() - ref.float()).abs().max().item() <= tol
    lse_tol = 5e-3 if dtype == torch.bfloat16 else 1e-4
    assert (lse - ref_lse).abs().max().item() <= lse_tol
    fb = flash_attention_backward
    nq, nk = (getattr(fb, "launches_dq_" + name),
              getattr(fb, "launches_dkv_" + name))
    grads = bwd(q, k, v, out, lse, do, *ops_, causal, d ** -0.5)
    torch.cuda.synchronize()
    assert getattr(fb, "launches_dq_" + name) == nq + 1
    assert getattr(fb, "launches_dkv_" + name) == nk + 1
    refs = flash_attention_backward_reference(q, k, v, out, lse, do, causal,
                                              **kw)
    for gname, a, r in zip(("dq", "dk", "dv"), grads, refs):
        err = (a.float() - r.float()).abs().max().item()
        assert err <= tol * max(1.0, r.float().abs().max().item()), (gname,
                                                                     err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s_q,s_kv,causal", [(300, 300, True),
                                             (77, 77, False),
                                             (200, 520, True)])
def test_flash_glse_matches_plain_on_card(cuda, dtype, tol, d, s_q, s_kv,
                                          causal):
    fa = _fa()
    q, k, v, do = _bwd_inputs(cuda, dtype, 2, s_q, s_kv, 8, 2, d)
    out, lse = fa.flash_attention_with_lse(q, k, v, causal)
    g = torch.Generator(device=cuda).manual_seed(6)
    glse = torch.randn(lse.shape, device=cuda, generator=g)
    n0 = flash_attention_backward.launches_glse
    grads = torch.ops.paddle_tpu_torch.flash_bwd_glse(
        q, k, v, out, lse, do, glse, causal, d ** -0.5)
    torch.cuda.synchronize()
    assert flash_attention_backward.launches_glse == n0 + 1
    refs = flash_attention_backward_reference(q, k, v, out, lse, do, causal,
                                              g_lse=glse)
    for gname, a, r in zip(("dq", "dk", "dv"), grads, refs):
        err = (a.float() - r.float()).abs().max().item()
        assert err <= tol * max(1.0, r.float().abs().max().item()), (gname,
                                                                     err)
    # through autograd: the loss uses both outputs
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q, k, v))
    o2, l2 = fa.flash_attention_with_lse(qg, kg, vg, causal)
    loss = (o2.float() * do.float()).sum() + (l2 * glse).sum()
    auto = torch.autograd.grad(loss, (qg, kg, vg))
    for a, b_ in zip(auto, grads):
        assert torch.equal(a, b_)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_all_zero_segments_bitwise_dense_on_card(cuda, dtype, d,
                                                       causal):
    # one segment: the segment mode masks nothing, and gives the dense
    # kernels' bits
    fa = _fa()
    q, k, v, do = _bwd_inputs(cuda, dtype, 2, 300, 300, 8, 2, d)
    ids = torch.zeros(2, 300, dtype=torch.int32, device=cuda)
    out, lse = torch.ops.paddle_tpu_torch.flash_fwd_lse_seg(
        q, k, v, ids, ids, causal, d ** -0.5)
    dense, dense_lse = flash_attention_forward(q, k, v, causal=causal)
    assert torch.equal(out, dense) and torch.equal(lse, dense_lse)
    with torch.no_grad():
        assert torch.equal(fa.flash_attention_varlen(q, k, v, ids, ids,
                                                     causal), dense)
    grads = torch.ops.paddle_tpu_torch.flash_bwd_seg(
        q, k, v, out, lse, do, ids, ids, causal, d ** -0.5)
    dense_grads = flash_attention_backward(q, k, v, dense, dense_lse, do,
                                           causal=causal)
    for a, b_ in zip(grads, dense_grads):
        assert torch.equal(a, b_)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_masked_rows_without_keys_on_card(cuda, dtype):
    # q rows 100-139 are a segment of their own that no kv column carries:
    # they see no key, come out finite with lse NEG_INF and get no gradient
    fa = _fa()
    q, k, v, do = _bwd_inputs(cuda, dtype, 1, 200, 200, 8, 2, 64)
    q_seg = torch.zeros(1, 200, dtype=torch.int32, device=cuda)
    q_seg[0, 100:140] = 7
    kv_seg = torch.zeros_like(q_seg)
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q, k, v))
    out = fa.flash_attention_varlen(qg, kg, vg, q_seg, kv_seg, True)
    dq, dk, dv = torch.autograd.grad((out.float() * do.float()).sum(),
                                     (qg, kg, vg))
    _, lse = torch.ops.paddle_tpu_torch.flash_fwd_lse_seg(
        q, k, v, q_seg, kv_seg, True, 0.125)
    assert torch.isfinite(out.float()).all()
    assert (lse[:, :, 100:140] <= NEG_INF / 2).all()
    assert not dq[:, 100:140].any()
    for t in (dq, dk, dv):
        assert torch.isfinite(t.float()).all()
    ref = fa.flash_attention_varlen_reference(q, k, v, q_seg, kv_seg, True)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    rows = torch.ones(200, dtype=torch.bool)
    rows[100:140] = False
    assert (out[:, rows].float() - ref[:, rows].float()).abs().max() <= tol


_FIRST_BACKWARD = """
import importlib, sys, torch
from paddle_tpu_torch import ops
g = torch.Generator(device="cuda").manual_seed(0)
q, k, v, do = (torch.randn(1, 256, 4, 64, device="cuda", generator=g)
               .to(torch.bfloat16).requires_grad_() for _ in range(4))
ids = torch.zeros(1, 256, dtype=torch.int32, device="cuda")
out = (ops.flash_attention(q, k, v, causal=True) if sys.argv[1] == "dense"
       else ops.flash_attention_varlen(q, k, v, ids, ids, True))
torch.autograd.grad(out, (q, k, v), do.detach())
torch.cuda.synchronize()
print("ok")
"""


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["dense", "varlen"])
def test_flash_backward_is_the_first_launch_of_a_fresh_process(cuda, path):
    # the loss is the attention output itself, so the flash backward op is
    # the first launch of the autograd engine's worker thread, in a process
    # that has run nothing else
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", _FIRST_BACKWARD, path],
                         cwd=root, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


# ---- the functional surface on the card -----------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
def test_block_mha_on_card_matches_cpu(cuda, quant):
    # 2 prefill rows (K1 each), 3 decode rows (one K4 call), bf16 qkv; raw
    # int8 caches with static scales through K4's int8 mode
    imod = importlib.import_module("paddle_tpu_torch.incubate.nn.functional")
    nh, kv, hd, page, maxp = 8, 2, 128, 64, 4
    enc = np.array([100, 64, 0, 0, 0])
    dec = np.array([0, 0, 10, 130, 200])
    this = np.array([100, 64, 1, 1, 1])
    b, tok = len(enc), int(this.sum())
    g = torch.Generator().manual_seed(7)
    qkv = torch.randn(tok, (nh + 2 * kv) * hd, generator=g).to(torch.bfloat16)
    if quant:
        caches = [torch.randint(-127, 128, (b * maxp, kv, page, hd),
                                generator=g, dtype=torch.int8)
                  for _ in range(2)]
        qs = torch.tensor([30.0, 50.0])
        scales = dict(cache_k_quant_scales=qs, cache_v_quant_scales=qs * 2,
                      cache_k_dequant_scales=1 / qs,
                      cache_v_dequant_scales=1 / (qs * 2))
    else:
        caches = [torch.randn(b * maxp, kv, page, hd, generator=g).to(
            torch.bfloat16) for _ in range(2)]
        scales = {}
    tables = torch.randperm(b * maxp, generator=g).reshape(b, maxp).to(
        torch.int32)

    def lens(a):
        return torch.tensor(a, dtype=torch.int32)[:, None]

    def args(dev):
        cu = lens(np.concatenate([[0], np.cumsum(this)]))
        return dict(qkv=qkv.to(dev), key_cache=caches[0].clone().to(dev),
                    value_cache=caches[1].clone().to(dev),
                    seq_lens_encoder=lens(enc), seq_lens_decoder=lens(dec),
                    seq_lens_this_time=lens(this), padding_offsets=None,
                    cum_offsets=None, cu_seqlens_q=cu, cu_seqlens_k=cu,
                    block_tables=tables.to(dev), block_size=page,
                    **{n: s.to(dev) for n, s in scales.items()})

    on_card, on_cpu = args(cuda), args("cpu")
    n1, n4 = flash_attention.launches, paged_decode_attention.launches
    n8 = paged_decode_attention.int8_launches
    out = imod.block_multihead_attention(**on_card)[0]
    torch.cuda.synchronize()
    assert flash_attention.launches == n1 + 2
    assert paged_decode_attention.launches == n4 + 1
    assert paged_decode_attention.int8_launches == n8 + int(quant)
    ref = imod.block_multihead_attention(**on_cpu)[0]
    assert (out.cpu().float() - ref.float()).abs().max().item() <= 2e-2
    for name in ("key_cache", "value_cache"):
        assert torch.equal(on_card[name].cpu(), on_cpu[name])


@pytest.mark.cuda
def test_functional_surface_routes_to_the_kernels_on_card(cuda):
    F = importlib.import_module("paddle_tpu_torch.nn.functional")
    flags = importlib.import_module("paddle_tpu_torch.flags")
    q, k, v, _ = _bwd_inputs(cuda, torch.bfloat16, 2, 256, 256, 8, 2, 128)
    idx = (torch.arange(256, device=cuda, dtype=torch.int32) + 1).view(
        1, 1, 256, 1).expand(2, 1, 256, 1).contiguous()
    n_dense, n_row = flash_attention.launches, flash_attention.launches_rowmask
    F.flashmask_attention(q, k, v, idx, causal=True)
    F.flash_attention(q, k, v, causal=True)
    assert flash_attention.launches_rowmask == n_row + 1
    assert flash_attention.launches == n_dense + 1
    flags.set_flags({"use_pallas_attention": False})
    try:
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    finally:
        flags.set_flags({"use_pallas_attention": True})
    assert flash_attention.launches == n_dense + 1
    ref = flash_attention_reference(q, k, v, True)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    # varlen packed: one segment-mode K1 launch for the packed buffer
    qkv = torch.stack([q[0], k[0].repeat_interleave(4, 1),
                       v[0].repeat_interleave(4, 1)], 1)
    cu = torch.tensor([0, 100, 256], dtype=torch.int32)
    n_seg = flash_attention.launches_seg
    packed, _ = F.flash_attn_varlen_qkvpacked(qkv, cu, cu, 156, 156,
                                              causal=True)
    assert flash_attention.launches_seg == n_seg + 1
    alone = flash_attention_reference(qkv[None, 100:, 0], qkv[None, 100:, 1],
                                      qkv[None, 100:, 2], True)[0]
    assert (packed[100:].float() - alone.float()).abs().max().item() <= 2e-2


# ---- serving recovery and the fleet router on the card -------------------

def _recovery_wave(n=12, sampled=(0, 1, 5)):
    """Prompts sharing a 16-token prefix, uneven lengths and budgets; the
    ``sampled`` requests draw with their own seeds."""
    rng = np.random.default_rng(5)
    system = rng.integers(0, 512, (16,)).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(0, 512, (m,)).astype(
        np.int32)]) for m in rng.integers(1, 24, n)]
    kws = [dict(max_new_tokens=6 + 3 * (i % 5)) for i in range(n)]
    for i in sampled:
        kws[i].update(temperature=0.8, seed=100 + i)
    return prompts, kws


def _sup_wave(sup, prompts, kws):
    reqs = [Request(p, **kw) for p, kw in zip(prompts, kws)]
    for r in reqs:
        sup.submit(r)
    sup.run_until_done()
    assert all(r.done and not r.failed for r in reqs), \
        [r.error for r in reqs if r.failed]
    return [list(r.output) for r in reqs]


def _kill(at):
    from paddle_tpu_torch.distributed.resilience import FaultPlan, FaultSpec
    return FaultPlan(seed=7, specs=[FaultSpec("serving.step", "kill",
                                              at=at)])


@pytest.mark.cuda
def test_kill_replay_fp32_on_card_equals_cpu_port(cuda, tmp_path):
    """fp32: a serving.step kill mid-wave on the card; the supervisor
    rebuilds (a new engine, its graph captured once) and replays. Every
    stream equals the uninterrupted card run byte for byte, and the greedy
    ones equal the port's streams on the CPU (sampled draws come from
    per-device generators, so those are held on the card only)."""
    from paddle_tpu_torch.inference.recovery import ServingSupervisor

    cpu, card = _card_model(cuda)
    prompts, kws = _recovery_wave()
    sampled = [i for i, kw in enumerate(kws) if "temperature" in kw]
    ref_cpu = _serve_card(_fused_engine(cpu, "cpu"), prompts,
                          [kw["max_new_tokens"] for kw in kws])
    clean = _sup_wave(ServingSupervisor(lambda: _fused_engine(card, cuda),
                                        str(tmp_path / "a.jrnl")),
                      prompts, kws)
    sup = ServingSupervisor(lambda: _fused_engine(card, cuda),
                            str(tmp_path / "b.jrnl"))
    plan = _kill(4)
    with plan:
        got = _sup_wave(sup, prompts, kws)
    assert plan.fired() == {"serving.step": 1} and sup.recoveries == 1
    assert sup.stats["replayed_requests"] > 0
    st = sup.engine.stats
    assert st["graph_captures"] == 1 and st["graph_replays"] > 0
    assert got == clean
    assert [g for i, g in enumerate(got) if i not in sampled] == \
        [r for i, r in enumerate(ref_cpu) if i not in sampled]


@pytest.mark.cuda
def test_bf16_replay_equals_clean_run_on_card(cuda, tmp_path):
    """bf16: the replay re-admits every unfinished request at once into a
    fresh engine with an empty prefix cache, so its prefill runs other
    rows beside each prompt than the clean run did; the streams must
    still be byte-identical (kill and stall)."""
    import warnings

    from paddle_tpu_torch.distributed.resilience import FaultPlan, FaultSpec
    from paddle_tpu_torch.inference.recovery import ServingSupervisor

    _, card = _card_model(cuda, "bfloat16")
    prompts, kws = _recovery_wave(n=20, sampled=(0, 5, 15))
    sup = ServingSupervisor(lambda: _fused_engine(card, cuda),
                            str(tmp_path / "j.jrnl"), max_recoveries=4)
    clean = _sup_wave(sup, prompts, kws)
    for at in (2, 5, 9):
        sup.engine._radix.evict_lru(sup.engine._alloc.num_blocks)
        with _kill(at):
            assert _sup_wave(sup, prompts, kws) == clean
    sup.set_step_budget(0.5)
    sup.engine._radix.evict_lru(sup.engine._alloc.num_blocks)
    with FaultPlan(seed=7, specs=[FaultSpec("serving.stall", "stall", at=3,
                                            arg=1.5)]), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        assert _sup_wave(sup, prompts, kws) == clean
    assert [c for c, _ in sup.events] == ["PT-SRV-001"] * 3 + ["PT-SRV-002"]
    sup.close()


@pytest.mark.cuda
def test_rebuilds_free_the_old_engine_on_card(cuda, tmp_path):
    """Three recoveries: each crashed engine (its pools and its captured
    graph's memory pool) is freed once its recovery returns, so memory
    allocated after the third recovery equals that after the first."""
    import weakref

    from paddle_tpu_torch.inference.recovery import ServingSupervisor

    _, card = _card_model(cuda, "bfloat16")
    prompts, kws = _recovery_wave()
    built = []

    def build():
        eng = _fused_engine(card, cuda)
        built.append(weakref.ref(eng))
        return eng

    sup = ServingSupervisor(build, str(tmp_path / "j.jrnl"),
                            max_recoveries=3)
    clean = _sup_wave(sup, prompts, kws)
    mem = []
    for at in (3, 4, 5):
        sup.engine._radix.evict_lru(sup.engine._alloc.num_blocks)
        with _kill(at):
            assert _sup_wave(sup, prompts, kws) == clean
        torch.cuda.synchronize()
        mem.append(torch.cuda.memory_allocated())
    assert sup.recoveries == 3 and len(built) == 4
    assert [w() is None for w in built] == [True, True, True, False]
    assert abs(mem[2] - mem[0]) <= 1 << 20, mem
    sup.close()


@pytest.mark.cuda
def test_fleet_parallel_step_with_rebuild_and_restart_on_card(cuda,
                                                             tmp_path):
    """parallel_step=True on the card: a serving.step kill rebuilds one
    replica (capturing its graph) inside its stepping thread while the
    other threads step, and replica 2 is killed and restarted mid-wave.
    Every stream equals one supervisor's uninterrupted run. (The restart
    replaces replica 2's supervisor: count recoveries over every
    supervisor of the run.)"""
    from paddle_tpu_torch.distributed.resilience import FaultPlan, FaultSpec
    from paddle_tpu_torch.inference.fleet import FleetConfig, FleetRouter
    from paddle_tpu_torch.inference.recovery import ServingSupervisor

    _, card = _card_model(cuda, "bfloat16")
    prompts, kws = _recovery_wave(n=24, sampled=(1, 8))

    def build():
        return _fused_engine(card, cuda)

    clean = _sup_wave(ServingSupervisor(build, str(tmp_path / "ref.jrnl")),
                      prompts, kws)
    fleet = FleetRouter(build, str(tmp_path / "fleet"), num_replicas=3,
                        config=FleetConfig(parallel_step=True))
    reqs = [Request(p, **kw) for p, kw in zip(prompts, kws)]
    plan = FaultPlan(seed=7, specs=[
        FaultSpec("serving.step", "kill", at=6),
        FaultSpec("fleet.replica_kill", "kill", at=2, match="replica:2:")])
    sups = {}
    with plan:
        for r in reqs:
            fleet.submit(r)
        while fleet.has_work():
            sups.update((id(rep.sup), rep.sup) for rep in fleet.replicas)
            if fleet.replicas[2].state == "dead":
                fleet.restart(2)
            fleet.step()
    fleet.finished()
    sups.update((id(rep.sup), rep.sup) for rep in fleet.replicas)
    assert plan.fired() == {"serving.step": 1, "fleet.replica_kill": 1}
    assert sum(sup.recoveries for sup in sups.values()) == 1
    assert fleet.stats["replica_deaths"] == 1
    assert fleet.replicas[2].state == "alive" and fleet.replicas[2].gen == 1
    assert all(rep.sup.engine.stats["graph_captures"] == 1
               for rep in fleet.replicas)
    assert all(r.done and not r.failed for r in reqs)
    assert [list(r.output) for r in reqs] == clean
    fleet.close()


# ---- disaggregated tiers: KV-chain migration on the card -----------------

def _tiered_wave(router, prompts, kws):
    reqs = [Request(p, **kw) for p, kw in zip(prompts, kws)]
    for r in reqs:
        router.submit(r)
    router.run_until_done()
    assert all(r.done and not r.failed for r in reqs), \
        [r.error for r in reqs if r.failed]
    return [list(r.output) for r in reqs]


@pytest.mark.cuda
def test_tiered_migration_fp32_equals_single_with_graphs_on_card(cuda,
                                                                 tmp_path):
    """fp32, CUDA graphs on: a 1+1 TieredRouter over fused engines serves
    the wave (greedy and seeded) byte-identically to one supervisor, and
    its greedy streams equal the port's on the CPU. The decode engine
    replays the graph it captured at construction over spliced chains, so
    this is the in-place witness: pools or the last-token carry rebound
    by the splice would leave the replays reading the old buffers."""
    from paddle_tpu_torch.inference import ServingSupervisor, TieredRouter

    cpu, card = _card_model(cuda)
    prompts, kws = _recovery_wave()
    sampled = [i for i, kw in enumerate(kws) if "temperature" in kw]
    ref_cpu = _serve_card(_fused_engine(cpu, "cpu"), prompts,
                          [kw["max_new_tokens"] for kw in kws])
    clean = _sup_wave(ServingSupervisor(lambda: _fused_engine(card, cuda),
                                        str(tmp_path / "ref.jrnl")),
                      prompts, kws)
    tiered = TieredRouter(lambda: _fused_engine(card, cuda),
                          lambda: _fused_engine(card, cuda),
                          str(tmp_path / "tiers"), num_prefill=1,
                          num_decode=1)
    k4 = paged_decode_attention.launches
    got = _tiered_wave(tiered, prompts, kws)
    dec = tiered.replicas[1].sup.engine
    assert tiered.stats["migrations"] > 0
    assert tiered.stats["migration_corrupt"] == 0
    assert all(rep.sup.engine.stats["graph_captures"] == 1
               for rep in tiered.replicas)
    assert dec.stats["graph_replays"] > 0
    assert paged_decode_attention.launches - k4 >= \
        dec.stats["graph_replays"] * card.config.num_hidden_layers
    assert got == clean
    assert [g for i, g in enumerate(got) if i not in sampled] == \
        [list(r) for i, r in enumerate(ref_cpu) if i not in sampled]
    tiered.close()


@pytest.mark.cuda
def test_int8_chain_migration_round_trip_matches_plain_on_card(cuda):
    """int8 pools on the card: the chain functions give the CPU path's
    bytes and scales and write them back in place; an int8 spec+int8
    chain exported on the card continues in another card engine to the
    single engine's stream."""
    from paddle_tpu_torch.inference import KVChainCodec
    from paddle_tpu_torch.ops import gather_chain_pages, \
        gather_chain_scales, scatter_chain_pages

    g = torch.Generator().manual_seed(0)
    host = [tuple(QuantizedKVPool(
        torch.randint(-127, 128, (9, 2, 16, 64), generator=g,
                      dtype=torch.int8),
        torch.rand(9, 2, generator=g)) for _ in range(2)) for _ in range(3)]
    dev = [tuple(QuantizedKVPool(p.data.to(cuda), p.scale.to(cuda))
                 for p in pair) for pair in host]
    blocks, dst = [7, 2, 4], [0, 8, 5]
    for kv in (host, dev):
        pages = gather_chain_pages(kv, blocks)
        scales = gather_chain_scales(kv, blocks)
        ptrs = [p.data.data_ptr() for pair in kv for p in pair]
        assert scatter_chain_pages(kv, dst, pages, scales) is kv
        assert [p.data.data_ptr() for pair in kv for p in pair] == ptrs
    for hp, dp in zip(host, dev):
        for h, d in zip(hp, dp):
            assert torch.equal(h.data, d.data.cpu())
            assert torch.equal(h.scale, d.scale.cpu())

    torch.backends.cuda.matmul.allow_tf32 = False
    model = LlamaForCausalLM(LlamaConfig(**_PARITY_CFG), device=cuda, seed=3)
    prompts, news = _spec_wave(_PARITY_CFG["vocab_size"], n=4)

    def build():
        return ContinuousBatchingEngine(
            model, max_batch=4, max_len=128, page_size=16, block_size=4,
            fused=True, device=cuda, kv_cache="int8",
            speculative=SpecConfig(k=4),
            prefix_cache=PrefixCacheConfig(extra_blocks=8))

    ref = _serve_card(build(), prompts, news)
    src, out = build(), build()
    codec = KVChainCodec()
    reqs = [Request(p, max_new_tokens=k) for p, k in zip(prompts, news)]
    for r in reqs:
        src.add_request(r)
    moved = []
    while src.has_work():
        src.step()
        for rid in src.migration_ready():
            art = codec.export_chain(src, rid)
            assert "kv_scales" in codec.peek(art)
            src.withdraw_active(rid)
            moved.append(codec.import_chain(out, art))
    out.run_until_done()
    src.finished()
    assert moved and out.stats["spec_graph_replays"] > 0
    byid = {r.rid: r for r in moved}
    assert [byid.get(r.rid, r).tokens for r in reqs] == ref


@pytest.mark.cuda
def test_migration_export_right_after_a_replay_reads_its_bytes_on_card(
        cuda):
    """A graph replay queued behind a long device sleep, then the chain
    gathered at once: the host copy holds the bytes the replay wrote (it
    runs on the engine's stream, after the replay), equal to the pages
    read after a full synchronize."""
    from paddle_tpu_torch.ops import gather_chain_pages

    _, card = _card_model(cuda)
    eng = _fused_engine(card, cuda)
    req = Request(np.arange(5, 35, dtype=np.int32), max_new_tokens=20)
    eng.add_request(req)
    while req.rid not in eng.migration_ready():
        eng.step()
    eng._flush_updates()
    slot = eng.slot_of(req.rid)
    blocks = list(eng._slot_blocks[slot])
    before = gather_chain_pages(eng.caches["kv"], blocks)
    eng._step_i.zero_()
    torch.cuda._sleep(200_000_000)
    eng._graph.replay()
    got = gather_chain_pages(eng.caches["kv"], blocks)
    torch.cuda.synchronize()
    want = gather_chain_pages(eng.caches["kv"], blocks)
    assert any(not torch.equal(a, b) for pa, pb in zip(before, want)
               for a, b in zip(pa, pb))
    for pa, pb in zip(got, want):
        for a, b in zip(pa, pb):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [False, True], ids=["fused", "spec"])
def test_traced_fused_wave_adds_no_sync_and_keeps_streams_on_card(cuda,
                                                                  spec):
    """A TraceRecorder on the fused engine (every decode block a graph
    replay, or a spec dispatch) stamps host-side only: a traced wave
    reports no more synchronizing operations than the same wave bare, the
    streams are equal, the graphs are captured once and replayed, and
    every request's lifecycle closes."""
    import chip_smoke
    from paddle_tpu_torch.observability import TraceRecorder

    _, card = _card_model(cuda)
    rng = np.random.default_rng(5)
    system = rng.integers(0, 512, (16,)).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(0, 512, (n,)).astype(
        np.int32)]) for n in (0, 3, 16, 9, 5, 16, 1, 30, 7, 12, 4, 2)]
    news = [4 + (i % 4) * 3 for i in range(len(prompts))]
    kw = dict(speculative=SpecConfig(k=4)) if spec else {}
    tracer = TraceRecorder()
    bare = _fused_engine(card, cuda, **kw)
    traced = _fused_engine(card, cuda, tracer=tracer, **kw)

    def serve(eng, out):
        reqs = [Request(p, max_new_tokens=k) for p, k in zip(prompts, news)]
        for r in reqs:
            eng.add_request(r)
        eng.run_until_done(max_steps=500)
        out.append([r.tokens for r in reqs])
        return reqs

    warm_b, warm_t = [], []
    serve(bare, warm_b)
    reqs = serve(traced, warm_t)
    assert warm_t == warm_b
    out_b, out_t = [], []
    s_bare = chip_smoke._sync_count(torch, lambda: serve(bare, out_b))
    s_traced = chip_smoke._sync_count(torch, lambda: serve(traced, out_t))
    assert out_t == out_b
    assert len(s_traced) <= len(s_bare), (s_traced, s_bare)
    for eng in (bare, traced):
        st = eng.stats
        assert st["graph_captures"] == 1 and st["eager_decode_steps"] == 0
        if spec:
            assert st["spec_graph_replays"] > 0 and \
                st["eager_spec_steps"] == 0
    assert tracer.incomplete() == [] and tracer.dropped == 0
    for r in reqs:
        names = iter(tracer.lifecycle(r.rid))
        assert all(s in names for s in ("submit", "admit", "first_token",
                                        "finish"))


def _procfleet_config(**extra):
    """A process fleet whose CUDA workers build ``_fused_engine``'s
    geometry on ``_SERVE_CFG`` (fp32) from seed 3."""
    from paddle_tpu_torch.inference.procfleet import ProcFleetConfig

    return ProcFleetConfig(
        factory="paddle_tpu_torch.inference.procfleet.presets:llama_engine",
        factory_kwargs=dict(
            config=dict(_SERVE_CFG, dtype="float32"), seed=3, device="cuda",
            max_batch=8, max_len=64, page_size=16, block_size=4, fused=True,
            prefix_cache=dict(prefill_chunk=16, extra_blocks=8)),
        spawn_timeout_s=180.0, op_timeout_s=120.0, **extra)


def _gone(pid):
    import os

    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


@pytest.mark.cuda
def test_procfleet_cuda_worker_streams_equal_in_process_engine(cuda,
                                                               tmp_path):
    """One CUDA worker process (its own context, its own seed-3 weights)
    serves the recovery wave on a fused prefix engine: every stream,
    greedy and seeded, equals the same engine's in this process, and the
    worker's engine replayed its graph (its /metrics)."""
    from paddle_tpu_torch.inference.procfleet import ProcFleetRouter
    from paddle_tpu_torch.inference.recovery import ServingSupervisor
    from paddle_tpu_torch.observability import parse_prometheus_text

    torch.backends.cuda.matmul.allow_tf32 = False
    card = LlamaForCausalLM(LlamaConfig(dtype="float32", **_SERVE_CFG),
                            device=cuda, seed=3)
    prompts, kws = _recovery_wave()
    ref = _sup_wave(ServingSupervisor(lambda: _fused_engine(card, cuda),
                                      str(tmp_path / "ref.jrnl")),
                    prompts, kws)
    fleet = ProcFleetRouter(_procfleet_config(), str(tmp_path / "fleet"),
                            num_replicas=1)
    try:
        got = _sup_wave(fleet, prompts, kws)
        fams = parse_prometheus_text(fleet.replicas[0].sup.metrics_text())
    finally:
        fleet.close()
    assert got == ref
    replays = fams["pt_engine_graph_replays"].samples[0][2]
    assert fams["pt_engine_graph_captures"].samples[0][2] == 1
    assert replays > 0


@pytest.mark.cuda
def test_procfleet_sigkill_one_of_two_cuda_workers(cuda, tmp_path):
    """A SIGKILL of one of two CUDA workers mid-wave: its journal fails
    over to the survivor, every stream equals one supervisor's run in
    this process, the pid is gone, and this process's context still
    launches K4 (held to its plain version)."""
    from paddle_tpu_torch.distributed.resilience import FaultPlan, FaultSpec
    from paddle_tpu_torch.inference.procfleet import ProcFleetRouter
    from paddle_tpu_torch.inference.recovery import ServingSupervisor

    torch.backends.cuda.matmul.allow_tf32 = False
    card = LlamaForCausalLM(LlamaConfig(dtype="float32", **_SERVE_CFG),
                            device=cuda, seed=3)
    prompts, kws = _recovery_wave()
    ref = _sup_wave(ServingSupervisor(lambda: _fused_engine(card, cuda),
                                      str(tmp_path / "ref.jrnl")),
                    prompts, kws)
    fleet = ProcFleetRouter(_procfleet_config(), str(tmp_path / "fleet"),
                            num_replicas=2)
    plan = FaultPlan(seed=5, specs=[FaultSpec(
        "fleet.proc_kill", "kill", at=2, count=1, match="replica:0:")])
    try:
        pid0 = fleet.replicas[0].sup.worker_pid
        with plan:
            got = _sup_wave(fleet, prompts, kws)
    finally:
        fleet.close()
    assert plan.fired() == {"fleet.proc_kill": 1}
    assert fleet.stats["replica_deaths"] == 1
    assert got == ref
    assert _gone(pid0)
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(4, 4, 64, device=cuda, generator=g)
    kc = torch.randn(16, 2, 16, 64, device=cuda, generator=g)
    vc = torch.randn(16, 2, 16, 64, device=cuda, generator=g)
    tables = torch.randperm(16, device=cuda, generator=g).reshape(4, 4).to(
        torch.int32)
    lens = torch.tensor([0, 1, 37, 64], dtype=torch.int32, device=cuda)
    n = paged_decode_attention.launches
    out = paged_decode_attention(q, kc, vc, tables, lens)
    assert paged_decode_attention.launches == n + 1
    ref_out = paged_decode_reference(q, kc, vc, tables, lens)
    assert (out - ref_out).abs().max().item() <= 1e-4


# ---------------------------------------------------------------------------
# GPT and BERT on the card (the same weights on the CPU are the reference)
# ---------------------------------------------------------------------------

def _gpt_pair(cuda, d, dtype="float32"):
    """A small GPT with heads of ``d`` (4 heads, 2 layers) on the CPU and
    the same weights on the card."""
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GPTConfig(vocab_size=512, hidden_size=4 * d, num_hidden_layers=2,
                    num_attention_heads=4, max_position_embeddings=256,
                    dtype=dtype)
    cpu = GPTForCausalLM(cfg, device="cpu", seed=3)
    card = GPTForCausalLM(cfg, device=cuda, seed=3)
    with torch.no_grad():
        for pc, pg in zip(cpu.parameters(), card.parameters()):
            pg.copy_(pc)
    return cpu, card


def _gpt_wave(model, device, **kw):
    """Greedy streams of 6 requests through a 2-slot legacy engine (or
    ``kw``'s engine): bucketed prompts, exact and re-stepped."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, (n,)).astype(np.int32)
               for n in (32, 17, 25, 32, 9, 30)]
    eng = ContinuousBatchingEngine(
        model, device=device,
        **(kw or dict(max_batch=2, max_len=64, page_size=16, block_size=4,
                      prompt_buckets=[32])))
    reqs = [Request(p, max_new_tokens=6 + i % 3 * 5)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    eng.run_until_done(max_steps=500)
    return [r.tokens for r in reqs], eng


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_gpt_logits_and_decode_on_card_match_cpu(cuda, d):
    """The dense forward (K1 on strided q, k, v views) within 1e-4 of the
    CPU's; the legacy engine's greedy streams (K1 prefill, K4 decode on a
    contiguous copy of q) and paged generate equal the CPU's."""
    cpu, card = _gpt_pair(cuda, d)
    ids = torch.randint(0, 512, (2, 100),
                        generator=torch.Generator().manual_seed(1))
    n1 = flash_attention.launches
    with torch.no_grad():
        got = card(ids.to(cuda)).cpu()
        ref = cpu(ids)
    assert flash_attention.launches == n1 + 2
    assert (got - ref).abs().max().item() <= 1e-4 * max(
        1.0, ref.abs().max().item())
    n1, n4 = flash_attention.launches, paged_decode_attention.launches
    streams, eng = _gpt_wave(card, cuda)
    assert flash_attention.launches - n1 >= 2 * eng.stats["prefill_groups"]
    assert (paged_decode_attention.launches - n4
            >= 2 * eng.stats["decode_steps"])
    assert streams == _gpt_wave(cpu, "cpu")[0]
    p = ids[:1, :24]
    paged = card.generate(p.to(cuda), max_new_tokens=12, temperature=0.0,
                          cache_impl="paged", page_size=16)
    dense = cpu.generate(p, max_new_tokens=12, temperature=0.0)
    assert paged.cpu().tolist() == dense.tolist()


def _live_replay_vs_eager(eng, steps, live):
    """:func:`_replay_vs_eager` on what the ``live`` rows read and emit:
    every page but the parking page, the live rows' tokens, every
    position and the step index. The parked rows all write one slot of
    the parking page, duplicate indices whose winner a replay and an eager
    run may pick differently (GPT's k/v reach the scatter as strided
    views); no live row reads that page, and the parked rows' tokens,
    computed from it, are dropped."""
    park = eng._park
    state = _step_state(eng)
    start = [t.clone() for t in state]
    for _ in range(steps):
        eng._graph.replay()
    replayed = [t.clone() for t in state]
    for t, s0 in zip(state, start):
        t.copy_(s0)
    with torch.no_grad():
        for _ in range(steps):
            eng._fused_step()
    torch.cuda.synchronize()
    n_pools = 2 * len(eng.caches["kv"])
    for i, (a, b) in enumerate(zip(replayed, state)):
        if i < n_pools:
            assert torch.equal(a[:park], b[:park])
            assert torch.equal(a[park + 1:], b[park + 1:])
        elif i in (n_pools, n_pools + 2):     # _last_tok, _out
            assert torch.equal(a[live], b[live])
        else:
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpt_fused_engine_replays_its_graph_on_card(cuda, dtype):
    """GPT's token step captured once (2 K4 launches a replay), bitwise the
    eager step on random pools for every live row, and (fp32) a wave's
    streams equal the legacy engine's with every greedy block a replay."""
    _, card = _gpt_pair(cuda, 128, dtype)
    eng = _fused_engine(card, cuda)
    assert eng.stats["graph_captures"] == 1 and eng._graph_counts[0] == 2
    gen = torch.Generator().manual_seed(0)
    g = torch.Generator(device=cuda).manual_seed(1)
    for k, v in eng.caches["kv"]:
        k.copy_(torch.randn(k.shape, device=cuda, generator=g))
        v.copy_(torch.randn(v.shape, device=cuda, generator=g))
    eng._last_tok.copy_(torch.randint(0, 512, (8,), device=cuda,
                                      generator=g))
    rows = {0: 9, 3: 30, 5: 17}
    _set_rows(eng, rows, gen)
    eng._step_i.zero_()
    _live_replay_vs_eager(eng, 3, sorted(rows))
    if dtype == "bfloat16":
        return
    legacy, _ = _gpt_wave(card, cuda)
    fused, eng = _gpt_wave(card, cuda, max_batch=8, max_len=64, page_size=16,
                           block_size=4, fused=True,
                           prefix_cache=PrefixCacheConfig(extra_blocks=8))
    assert fused == legacy
    st = eng.stats
    assert st["graph_captures"] == 1 and st["eager_decode_steps"] == 0
    assert st["graph_replays"] == st["decode_steps"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("seq", [128, 77])
@pytest.mark.parametrize("head", ["seqcls", "mlm"])
def test_bert_engine_step_on_card_matches_cpu(cuda, seq, head):
    """One Engine step of BERT (heads of 64) on the card and on the CPU
    from the same weights: the non-causal K1-lse, K2 and K3 once a layer,
    the loss within 1e-4 relative, parameters within 2 * lr, and the first
    moments (the clipped gradients times 1 - beta1) within 1e-3 of their
    largest magnitude: Adam's update alone would hide a wrong gradient
    inside the parameters' 2 * lr."""
    import chip_smoke
    from paddle_tpu_torch.models import (BertConfig, BertForMaskedLM,
                                         BertForSequenceClassification)

    torch.backends.cuda.matmul.allow_tf32 = False
    cls = BertForMaskedLM if head == "mlm" else BertForSequenceClassification
    cfg = BertConfig(vocab_size=512, hidden_size=256, num_hidden_layers=2,
                     num_attention_heads=4, intermediate_size=512,
                     max_position_embeddings=256, hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0, num_labels=3)
    cpu, card = cls(cfg, device="cpu", seed=4), cls(cfg, device=cuda, seed=4)
    with torch.no_grad():
        for pc, pg in zip(cpu.parameters(), card.parameters()):
            pg.copy_(pc)
    g = torch.Generator().manual_seed(2)
    ids = torch.randint(0, 512, (4, seq), generator=g)
    if head == "mlm":
        labels = torch.where(torch.rand(4, seq, generator=g) < 0.3,
                             torch.randint(0, 512, (4, seq), generator=g),
                             -100)
    else:
        labels = torch.randint(0, 3, (4,), generator=g)
    ec = Engine(cpu, lr=1e-3, loss_fn=cpu.loss_fn)
    eg = Engine(card, lr=1e-3, loss_fn=card.loss_fn)
    n = (flash_attention_forward.launches,
         flash_attention_backward.launches_dq,
         flash_attention_backward.launches_dkv)
    lc = ec.step(ids, labels)
    lg = eg.step(ids.to(cuda), labels.to(cuda))
    torch.cuda.synchronize()
    assert (flash_attention_forward.launches - n[0],
            flash_attention_backward.launches_dq - n[1],
            flash_attention_backward.launches_dkv - n[2]) == (2, 2, 2)
    assert abs(lg.item() - lc.item()) <= 1e-4 * abs(lc.item())
    for (name, pc), pg in zip(cpu.named_parameters(), card.parameters()):
        err = (pg.detach().cpu() - pc.detach()).abs().max().item()
        assert err <= 2e-3, (name, err)
    # the key biases' gradients are rounding noise (softmax ignores a
    # shift of every key's logit): chip_smoke's floor holds them to a share
    # of the largest moment
    mc, mg = ec.state_dict()["m"], eg.state_dict()["m"]
    top = max(a.abs().max().item() for a in mc.values())
    for name, a in mc.items():
        err = (mg[name].cpu() - a).abs().max().item()
        scale = max(a.abs().max().item(), chip_smoke.BERT_MOMENT_FLOOR * top)
        assert err <= 1e-3 * scale, (name, err, scale)


@pytest.mark.cuda
def test_resnet18_train_batch_on_card_matches_cpu(cuda):
    """chip_smoke.py phase 33 (a): 3 hapi train_batch steps of resnet18
    (Momentum 0.9, lr 1e-3, batch 16 of 32 x 32) on the card and the CPU,
    each started on the card from the CPU's parameters, BatchNorm
    statistics and velocity; fp32 with TF32 off; the bounds are
    chip_smoke.VISION_TOL's (it raises past them). No K1-K6 launch."""
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n = (flash_attention.launches, flash_attention_forward.launches,
         pgmm.launches)
    chip_smoke._resnet_parity(torch, np, "card test")
    assert (flash_attention.launches, flash_attention_forward.launches,
            pgmm.launches) == n


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["vit", "unet"])
def test_vision_sgd_step_on_card_matches_cpu(cuda, name):
    """One bench step (the loss's gradients, then p - 1e-4 g) of the tiny
    ViT / UNet on the card and the CPU from the same weights (fp32, TF32
    off): the loss within 1e-4 relative, every parameter after the step
    within 1e-6 and every gradient within 1e-4 of its largest."""
    import chip_smoke
    from paddle_tpu_torch.models import UNet2DConditionModel, UNetConfig
    from paddle_tpu_torch.vision.models import ViTConfig, VisionTransformer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if name == "vit":
        cfg = ViTConfig.tiny()
        make = lambda dev: VisionTransformer(cfg, device=dev)  # noqa: E731
        imgs, labels = chip_smoke.vit_bench_inputs(torch, np, cfg, 4, "cpu")
        loss_of = lambda m, dev: m.loss_fn(  # noqa: E731
            imgs.to(dev), labels.to(dev))
    else:
        cfg = UNetConfig.tiny()
        make = lambda dev: UNet2DConditionModel(cfg, device=dev)  # noqa: E731
        batch = chip_smoke.unet_bench_batch(torch, np, cfg, 2, 16, 6, "cpu")
        loss_of = lambda m, dev: m.loss_fn(  # noqa: E731
            {k: v.to(dev) for k, v in batch.items()})
    cpu, card = make("cpu"), make(cuda)
    card.load_state_dict(cpu.state_dict())
    runs = []
    for m, dev in ((cpu, "cpu"), (card, cuda)):
        grads = torch.autograd.grad(loss_of(m, dev), list(m.parameters()))
        loss = chip_smoke.sgd_bench_step(torch, m, lambda: loss_of(m, dev))
        runs.append((loss.item(), [g.cpu() for g in grads]))
    (lc, gc), (lg, gg) = runs
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    for (pname, pc), pg, a, b in zip(cpu.named_parameters(),
                                     card.parameters(), gc, gg):
        assert (b - a).abs().max() <= 1e-4 * max(1.0, a.abs().max()), pname
        assert (pg.detach().cpu() - pc.detach()).abs().max() <= 1e-6, pname


# ---- fp16 flash kernels and dygraph AMP (the eager Paddle API slice) ----
# fp16 tolerance: 5e-3 max abs on O(1) outputs (fp16's rounding of the
# output, P rounded to fp16 before P V; measured 1e-3 to 2e-3 on the
# H100), gradients 5e-3 x max(1, max |plain|).

@pytest.mark.cuda
@pytest.mark.parametrize("b,s,hq,hkv,d,causal", [
    (32, 128, 12, 12, 64, False),       # BERT-base fine-tuning
    (2, 4096, 16, 4, 128, True)])       # the training shape
def test_fp16_flash_kernels_match_plain(cuda, b, s, hq, hkv, d, causal):
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v, do = (torch.randn(b, s, h, d, device=cuda, generator=g).half()
                   for h in (hq, hkv, hkv, hq))
    n0 = (flash_attention.launches, flash_attention_forward.launches,
          flash_attention_backward.launches_dq,
          flash_attention_backward.launches_dkv)
    out = flash_attention(q, k, v, causal=causal)
    o, lse = flash_attention_forward(q, k, v, causal=causal)
    grads = flash_attention_backward(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_forward.launches,
            flash_attention_backward.launches_dq,
            flash_attention_backward.launches_dkv) == tuple(
                x + 1 for x in n0)
    assert out.dtype == o.dtype == torch.float16 and lse.dtype == torch.float32
    ref = flash_attention_reference(q, k, v, causal)
    ref_o, ref_lse = flash_attention_reference_lse(q, k, v, causal)
    assert (out.float() - ref.float()).abs().max().item() <= 5e-3
    assert (o.float() - ref_o.float()).abs().max().item() <= 5e-3
    assert (lse - ref_lse).abs().max().item() <= 5e-3
    refs = flash_attention_backward_reference(q, k, v, o, lse, do, causal)
    for a, r in zip(grads, refs):
        assert a.dtype == torch.float16
        assert (a.float() - r.float()).abs().max().item() <= \
            5e-3 * max(1.0, r.float().abs().max().item())


@pytest.mark.cuda
def test_fp16_flash_refuses_mixed_dtypes(cuda):
    q = torch.randn(1, 64, 2, 64, device=cuda).half()
    with pytest.raises(TypeError, match="fp16"):
        flash_attention(q, q.bfloat16(), q)


@pytest.mark.cuda
def test_fp16_backward_overflow_is_non_finite_and_the_scaler_skips(cuda):
    """Under a large loss scale dS overflows fp16 before the dK / dQ
    products: the kernels give inf or NaN (never a finite wrong value), and
    GradScaler sees it and skips the step."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.framework import numeric_guard

    g = torch.Generator(device=cuda).manual_seed(6)
    q = (torch.randn(4, 128, 4, 64, device=cuda, generator=g) * 4).half()
    k, v = (torch.randn(4, 128, 4, 64, device=cuda, generator=g).half()
            for _ in range(2))
    o, lse = flash_attention_forward(q, k, v)
    do = (torch.randn(4, 128, 4, 64, device=cuda, generator=g)
          .clamp(-1, 1) * 60000).half()
    assert bool(torch.isfinite(do).all())
    dq, dk, dv = flash_attention_backward(q, k, v, o, lse, do)
    assert not bool(torch.isfinite(dq).all())
    assert not bool(torch.isfinite(dk).all())
    # the same through the Paddle API: the scaler must skip the step
    pt.seed(6)
    mha = pnn.MultiHeadAttention(256, 4, device=cuda)
    opt = pt.optimizer.SGD(learning_rate=0.1, parameters=mha.parameters())
    scaler = pt.amp.GradScaler(init_loss_scaling=2.0 ** 40)
    before = [p.detach().clone() for p in mha.parameters()]
    x = pt.to_tensor(np.random.default_rng(6).standard_normal(
        (4, 128, 256)).astype(np.float32), place=cuda)
    numeric_guard.consume_health()
    n0 = flash_attention_backward.launches_dq
    with pt.amp.auto_cast(dtype="float16"):
        loss = mha(x).astype("float32").mean()
    scaler.minimize(opt, scaler.scale(loss))
    assert flash_attention_backward.launches_dq == n0 + 1
    assert scaler._found_inf and scaler.get_init_loss_scaling() == 2.0 ** 39
    assert numeric_guard.consume_health() & numeric_guard.OVERFLOW
    for a, p in zip(before, mha.parameters()):
        assert torch.equal(a, p.detach())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_dygraph_amp_encoder_runs_the_flash_kernels(cuda, dtype):
    """A Paddle-layer encoder step under auto_cast on the card: the white
    projections hand low-precision q/k/v to the kernels (K1-lse forward,
    K2 and K3 backward, once a layer), no dense attention, finite loss."""
    import chip_smoke
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core import op_registry

    pt.seed(7)
    model = chip_smoke.dygraph_encoder(pt, dict(
        vocab=64, hidden=128, heads=2, ffn=256, layers=2, max_pos=64,
        labels=2), cuda)
    opt = pt.optimizer.AdamW(1e-4, parameters=model.parameters())
    scaler = pt.amp.GradScaler()
    rng = np.random.default_rng(7)
    ids = pt.to_tensor(rng.integers(0, 64, (4, 32)), place=cuda)
    labels = pt.to_tensor(rng.integers(0, 2, (4,)), place=cuda)
    n0 = (flash_attention_forward.launches,
          flash_attention_backward.launches_dq,
          flash_attention_backward.launches_dkv)
    prev = pt.device._PLACE
    pt.set_device(cuda)
    try:
        loss = chip_smoke.dygraph_step(pt, model, opt, scaler, ids, labels,
                                       "O1", dtype)
    finally:
        pt.device._PLACE = prev
    assert op_registry.amp_state is None
    assert (flash_attention_forward.launches,
            flash_attention_backward.launches_dq,
            flash_attention_backward.launches_dkv) == tuple(
                x + 2 for x in n0)
    assert bool(torch.isfinite(loss))


# ---- the nn slice on the card: each against the same call on the CPU ----
# (fp32 to 1e-4 and bf16 to 3e-2 of max(1, max |cpu|), TF32 off; bf16
# references run in fp32 on the same bf16-rounded values and weights,
# since torch's CPU RNN, resize and convolution kernels in bf16 are slow)

def _card_vs_cpu(fn_card, fn_cpu, inputs, dtype, tol):
    """Outputs and input gradients of sum(out * cotangent) on the card
    and the CPU; asserts every card tensor is on the card."""
    gen = torch.Generator().manual_seed(9)
    res = []
    for fn, dev, dt in ((fn_card, "cuda", dtype), (fn_cpu, "cpu",
                                                    torch.float32)):
        xs = [x.to(dtype).to(dt).to(dev).requires_grad_() for x in inputs]
        out = fn(*xs)
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        outs = [o for o in outs if torch.is_tensor(o)]
        if not res:
            cots = [torch.randn(o.shape, generator=gen) for o in outs]
        loss = sum((o.float() * c.to(dev)).sum() for o, c in zip(outs,
                                                                  cots))
        grads = torch.autograd.grad(loss, xs)
        res.append(outs + list(grads))
    card, cpu = res
    for a, b in zip(card, cpu):
        assert a.device.type == "cuda" and a.shape == b.shape
        err = (a.detach().float().cpu() - b.detach()).abs().max() \
            / b.detach().abs().max().clamp_min(1.0)
        assert err.item() <= tol, err.item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("cls", ["LSTM", "GRU", "SimpleRNN"])
@pytest.mark.parametrize("states", [False, True])
def test_recurrent_layers_on_card_match_cpu(cuda, dtype, tol, cls, states):
    """2 layers, bidirectional, batch 8 x 33 steps x 96 features, hidden
    128, with and without initial states (LSTM: h and c)."""
    import copy

    from paddle_tpu_torch import nn

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = getattr(nn, cls)(96, 128, 2, direction="bidirect", device="cpu")
    cpu.to(dtype=dtype)
    card = copy.deepcopy(cpu).to("cuda")
    cpu.to(dtype=torch.float32)
    g = torch.Generator().manual_seed(3)
    inputs = [torch.randn(8, 33, 96, generator=g)]
    if states:
        inputs += [torch.randn(4, 8, 128, generator=g)
                   for _ in range(2 if cls == "LSTM" else 1)]

    def run(m):
        def fn(x, *st):
            init = None if not st else (st[0] if len(st) == 1 else st)
            out, final = m(x, init)
            return [out] + (list(final) if isinstance(final, tuple)
                            else [final])
        return fn

    _card_vs_cpu(run(card), run(cpu), inputs, dtype, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("mode,shape,size", [
    ("nearest", (2, 16, 28, 28), (56, 41)),
    ("nearest", (2, 16, 28, 28), (14, 9)),
    ("bilinear", (2, 16, 28, 28), (56, 41)),
    ("bilinear", (2, 16, 28, 28), (14, 9)),
    ("bicubic", (2, 16, 28, 28), (56, 41)),
    ("bicubic", (2, 16, 28, 28), (14, 9)),
    ("area", (2, 16, 28, 28), (14, 14)),
    ("linear", (2, 16, 100), (257,)),
    ("linear", (2, 16, 100), (33,)),
    ("trilinear", (1, 8, 12, 14, 16), (20, 7, 30)),
    ("nearest", (1, 8, 12, 14, 16), (5, 28, 9))])
def test_interpolate_on_card_matches_cpu(cuda, dtype, tol, mode, shape,
                                         size):
    import paddle_tpu_torch.nn.functional as PF

    fmt = "NC" + "DHW"[-len(size):]
    fn = lambda x: PF.interpolate(x, size=list(size), mode=mode,  # noqa
                                  data_format=fmt)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(5))
    _card_vs_cpu(fn, fn, [x], dtype, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("n,padding", [(1, 1), (2, 1), (2, [1, 0, 2, 1]),
                                       (3, 1)])
def test_conv_transpose_groups_output_padding_on_card(cuda, dtype, tol, n,
                                                      padding):
    """conv{n}d_transpose with stride 2, groups 4, output_padding 1 and
    dilation 2 (asymmetric padding crops a side at a time)."""
    import paddle_tpu_torch.nn.functional as PF

    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(7)
    spatial = (9, 8, 7)[:n]
    x = torch.randn((2, 16) + spatial, generator=g)
    w = torch.randn((16, 6) + (3,) * n, generator=g) * 0.2
    b = torch.randn(24, generator=g)
    fn = getattr(PF, f"conv{n}d_transpose")
    call = lambda x, w, b: fn(x, w, b, stride=2, padding=padding,  # noqa
                              output_padding=1, groups=4, dilation=2)
    _card_vs_cpu(call, call, [x, w, b], dtype, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("cls", ["LSTM", "GRU", "SimpleRNN"])
@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("lengths", [False, True])
def test_recurrent_backward_after_an_eval_call_on_card(cuda, cls, mode,
                                                       lengths):
    """cuDNN refuses an RNN backward after an eval-mode call unless the
    layer calls it in training form whenever autograd records: an eval
    call under no_grad, then a call in ``mode`` whose loss is
    differentiated (with and without ``sequence_length``, the packed
    form); the gradients of the input and every parameter equal the
    CPU's within 1e-4 of their largest."""
    import copy

    from paddle_tpu_torch import nn

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = getattr(nn, cls)(48, 64, 2, direction="bidirect", device="cpu")
    card = copy.deepcopy(cpu).to("cuda")
    g = torch.Generator().manual_seed(21)
    x = torch.randn(6, 19, 48, generator=g)
    cot = torch.randn(6, 19, 128, generator=g)
    seq = torch.tensor([19, 4, 11, 19, 1, 7]) if lengths else None
    grads = []
    for m, dev in ((cpu, "cpu"), (card, "cuda")):
        m.eval()
        with torch.no_grad():
            m(x.to(dev), sequence_length=seq)
        m.train() if mode == "train" else m.eval()
        xi = x.to(dev).requires_grad_()
        out = m(xi, sequence_length=seq)[0]
        loss = (out * cot.to(dev)).sum()
        grads.append(torch.autograd.grad(loss, [xi] + list(m.parameters())))
    for a, b in zip(grads[0], grads[1]):
        assert b.device.type == "cuda"
        err = (b.cpu() - a).abs().max() / a.abs().max().clamp_min(1e-6)
        assert err.item() <= 1e-4, err.item()


@pytest.mark.cuda
@pytest.mark.parametrize("cls", ["LSTM", "GRU", "SimpleRNN"])
@pytest.mark.parametrize("time_major", [False, True])
def test_sequence_length_on_card_matches_cpu(cuda, cls, time_major):
    """The packed call with unsorted lengths (initial states permuted to
    match): outputs, final states and gradients card vs CPU (1e-4)."""
    import copy

    from paddle_tpu_torch import nn

    torch.backends.cudnn.allow_tf32 = False
    cpu = getattr(nn, cls)(32, 48, 2, direction="bidirect",
                           time_major=time_major, device="cpu")
    card = copy.deepcopy(cpu).to("cuda")
    g = torch.Generator().manual_seed(23)
    x = torch.randn((23, 5, 32) if time_major else (5, 23, 32), generator=g)
    h0 = torch.randn(4, 5, 48, generator=g)
    seq = torch.tensor([9, 23, 2, 17, 23])

    def run(m):
        def fn(x, h):
            init = (h, h * 0.5) if cls == "LSTM" else h
            out, final = m(x, init, sequence_length=seq)
            return [out] + (list(final) if isinstance(final, tuple)
                            else [final])
        return fn

    _card_vs_cpu(run(card), run(cpu), [x, h0], torch.float32, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("reduction", ["mean", "none"])
def test_ctc_loss_on_card_matches_cpu(cuda, reduction):
    """T 120, batch 6, 80 classes, one infeasible row (its loss 1e30 and
    its gradient zero on the card; the other rows compared): the card's
    CTC (atomics in its backward) within 1e-3 of the CPU's (the log-domain
    recursion's error is about eps x |log-likelihood|, ~6e-5 here;
    chip_smoke.EXTRAS_LATTICE_TOL)."""
    import paddle_tpu_torch.nn.functional as PF

    g = torch.Generator().manual_seed(25)
    x = torch.randn(120, 6, 80, generator=g)
    labels = torch.randint(1, 80, (6, 30), generator=g)
    il = torch.tensor([120, 90, 20, 120, 61, 100])
    ll = torch.tensor([30, 12, 25, 1, 30, 0])
    keep = torch.tensor([0, 1, 3, 4, 5])
    cut = (lambda v: v) if reduction == "mean" else (lambda v: v[keep.to(
        v.device)])
    fn = lambda x: cut(PF.ctc_loss(  # noqa: E731
        x, labels.to(x.device), il.to(x.device), ll.to(x.device),
        reduction=reduction))
    xc = x.cuda().requires_grad_()
    out = PF.ctc_loss(xc, labels.cuda(), il.cuda(), ll.cuda(),
                      reduction="none")
    assert out[2].item() == np.float32(1e30)
    out.sum().backward()
    assert not xc.grad[:, 2].any()
    _card_vs_cpu(fn, fn, [x], torch.float32, 1e-3)


@pytest.mark.cuda
def test_rnnt_loss_on_card_matches_cpu(cuda):
    import paddle_tpu_torch.nn.functional as PF

    g = torch.Generator().manual_seed(27)
    x = torch.randn(3, 40, 13, 64, generator=g)
    labels = torch.randint(1, 64, (3, 12), generator=g)
    tl, ul = torch.tensor([40, 31, 7]), torch.tensor([12, 5, 12])
    fn = lambda x: PF.rnnt_loss(  # noqa: E731
        x, labels.to(x.device), tl.to(x.device), ul.to(x.device),
        fastemit_lambda=0.01, reduction="none")
    _card_vs_cpu(fn, fn, [x], torch.float32, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("padding_mode", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("align_corners", [True, False])
def test_grid_sample_on_card_matches_cpu(cuda, mode, padding_mode,
                                         align_corners):
    import paddle_tpu_torch.nn.functional as PF

    g = torch.Generator().manual_seed(29)
    x = torch.randn(4, 8, 17, 23, generator=g)
    grid = torch.rand(4, 11, 13, 2, generator=g) * 2.6 - 1.3
    fn = lambda x, gr: PF.grid_sample(  # noqa: E731
        x, gr, mode, padding_mode, align_corners)
    if mode == "bilinear":
        _card_vs_cpu(fn, fn, [x, grid], torch.float32, 1e-4)
    else:   # nearest: no gradient reaches the grid
        near = lambda x: fn(x, grid.to(x.device))  # noqa: E731
        _card_vs_cpu(near, near, [x], torch.float32, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 512, 384), (40, 24, 56)])
@pytest.mark.parametrize("out", ["float16", "bfloat16", "float32"])
def test_fp8_gemm_on_card_matches_cpu(cuda, shape, out):
    """fp8_fp8_half_gemm_fused: ``torch._scaled_mm`` at widths of 16s, the
    fp32 product of the cast values otherwise, against the CPU's plain
    version (the same fp8 values, fp32 sums in another order), within
    the tolerances below of the largest output; values beyond +-464 NaN
    on both."""
    from paddle_tpu_torch import linalg

    m, k, n = shape
    g = torch.Generator().manual_seed(31)
    a = torch.randn(m, k, generator=g) * 4
    b = torch.randn(n, k, generator=g) * 4
    bias = torch.randn(n, generator=g)
    a[0, 0] = 500.0
    call = lambda a, b, bias: linalg.fp8_fp8_half_gemm_fused(  # noqa
        a, b, bias, transpose_y=True, scale=0.25, output_dtype=out,
        activation_type="gelu")
    ref = call(a, b, bias).float()
    got = call(a.cuda(), b.cuda(), bias.cuda())
    assert got.device.type == "cuda"
    assert torch.isnan(got[0]).all() and torch.isnan(ref[0]).all()
    # Hopper's fp8 MMA accumulates with ~14 bits of mantissa (2.9e-4 seen
    # in fp32); a half output then rounds to one ulp (fp16 9.8e-4, bf16
    # 7.8e-3 of the value)
    tol = {"float32": 1e-3, "float16": 2e-3, "bfloat16": 1e-2}[out]
    err = (got[1:].float().cpu() - ref[1:]).abs().max() \
        / ref[1:].abs().max()
    assert err.item() <= tol, err.item()


@pytest.mark.cuda
@pytest.mark.parametrize("name", [
    "inv", "det", "slogdet", "solve", "cholesky", "cholesky_solve",
    "triangular_solve", "matrix_exp", "matrix_power", "pinv", "lstsq",
    "eigvalsh", "svdvals", "qr", "svd", "eigh", "lu", "householder_product",
    "cholesky_inverse", "norm_nuc", "cond", "matrix_rank", "cov",
    "corrcoef", "multi_dot", "cross", "eig"])
def test_linalg_on_card_matches_cpu(cuda, name):
    """Each function card vs CPU on [16, 96, 96] batches (fp32, 1e-4 of
    the largest output and gradient); the sign- or phase-free forms of
    qr, svd, eigh and eig (reconstructions, values); the eigen and
    singular value cases on matrices whose values are 1..96."""
    from paddle_tpu_torch import linalg as LA

    g = torch.Generator().manual_seed(33)
    a = torch.randn(16, 96, 96, generator=g)
    well = a * 0.3 / 96 ** 0.5 + torch.eye(96)
    spd = well @ well.mT
    # eigen / singular values 1..96: the vectors (and the gradients built
    # from them) well conditioned
    q1 = torch.linalg.qr(torch.randn(16, 96, 96, generator=g))[0]
    q2 = torch.linalg.qr(torch.randn(16, 96, 96, generator=g))[0]
    vals = torch.arange(1, 97, dtype=torch.float32)
    sym, sep = (q1 * vals) @ q1.mT, (q1 * vals) @ q2.mT
    chol = torch.linalg.cholesky(spd)
    rhs = torch.randn(16, 96, 8, generator=g)

    def sorted_eig(w):
        w = w[..., torch.argsort(w.imag, stable=True)]
        w = w[..., torch.argsort(w.real, stable=True)]
        return torch.stack([w.real, w.imag])

    geqrf = torch.geqrf(torch.randn(16, 96, 32, generator=g))
    cases = {
        "inv": (LA.inv, [well]), "det": (LA.det, [well]),
        "slogdet": (LA.slogdet, [well]), "solve": (LA.solve, [well, rhs]),
        "cholesky": (LA.cholesky, [spd]),
        "cholesky_solve": (LA.cholesky_solve, [rhs, chol]),
        "triangular_solve": (lambda t, b: LA.triangular_solve(
            t, b, upper=False, transpose=True), [chol, rhs]),
        "matrix_exp": (LA.matrix_exp, [a[:, :16, :16] * 0.2]),
        "matrix_power": (lambda x: LA.matrix_power(x, 3), [well]),
        "pinv": (LA.pinv, [a[:, :, :48]]),
        "lstsq": (lambda x, y: LA.lstsq(x, y)[0], [a[0, :, :40], rhs[0]]),
        "eigvalsh": (LA.eigvalsh, [sym]), "svdvals": (LA.svdvals, [sep]),
        "qr": (lambda x: (lambda q, r: (q @ r, r.abs()))(*LA.qr(x)), [a]),
        "svd": (lambda x: (lambda u, s, v: (u * s[..., None, :] @ v.mT, s))(
            *LA.svd(x)), [sep]),
        "eigh": (lambda x: (lambda w, v: (w, v * w[..., None, :] @ v.mT))(
            *LA.eigh(x)), [sym]),
        "lu": (lambda x: LA.lu(x)[0], [well]),
        "householder_product": (LA.householder_product, list(geqrf)),
        "cholesky_inverse": (LA.cholesky_inverse, [chol]),
        "norm_nuc": (lambda x: LA.norm(x, "nuc", [1, 2]), [a]),
        "cond": (LA.cond, [well]),
        "matrix_rank": (LA.matrix_rank, [a[:, :, :8] @ a[:, :8, :]]),
        "cov": (LA.cov, [a[0]]), "corrcoef": (LA.corrcoef, [a[0]]),
        "multi_dot": (lambda x, y, z: LA.multi_dot([x, y, z]),
                      [a[0], a[1], a[2]]),
        "cross": (LA.cross, [a[:, :3], a[:, 3:6]]),
        "eig": (lambda x: sorted_eig(LA.eig(x)[0]), [a[0]]),
    }
    fn, inputs = cases[name]
    if name in ("matrix_rank", "lu", "eig", "lstsq", "cond"):
        got, ref = fn(*[x.cuda() for x in inputs]), fn(*inputs)
        got = got if isinstance(got, (tuple, list)) else [got]
        ref = ref if isinstance(ref, (tuple, list)) else [ref]
        for x, y in zip(got, ref):
            assert x.device.type == "cuda"
            err = (x.float().cpu() - y.float()).abs().max() \
                / y.float().abs().max().clamp_min(1.0)
            assert err.item() <= 1e-4, err.item()
        return
    _card_vs_cpu(fn, fn, inputs, torch.float32, 1e-4)


@pytest.mark.cuda
def test_stats_dump_of_a_bert_layer_step_syncs_once(cuda, tmp_path):
    """amp.debugging.dump_tensor_stats keeps each record's statistics on
    the card and reads them once when the scope closes: one host sync for
    a BERT-width encoder layer's forward and backward (JAX's recorder
    reads 4 host scalars an output)."""
    import warnings

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import device as pt_device
    from paddle_tpu_torch import nn

    prev = pt_device._PLACE
    pt.set_device("gpu")
    try:
        pt.seed(0)
        layer = nn.TransformerEncoderLayer(768, 12, 3072, dropout=0.0,
                                           activation="gelu")
        x = pt.randn([8, 128, 768])
        x.stop_gradient = False

        def step():
            layer(x).sum().backward()

        step()
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with pt.amp.debugging.dump_tensor_stats(
                        str(tmp_path / "d.jsonl")) as rec:
                    step()
                    pending = len(rec._pending)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs = [w for w in seen if "synchroniz" in str(w.message).lower()]
        assert pending >= 10 and len(rec.records) == pending
        assert len(syncs) <= 1, [str(w.message) for w in syncs]
    finally:
        pt_device._PLACE = prev


@pytest.mark.cuda
def test_profiler_device_trace_counts_the_flash_kernels(cuda, tmp_path):
    """The profiler's device trace (Kineto) names K1-lse, K2 and K3 as
    often as their wrappers' counters say, over two recorded training
    steps of a small Llama after a warm-up (READY) step."""
    import re

    from paddle_tpu_torch import profiler as P

    cfg = LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=256,
                      dtype="bfloat16")
    model = LlamaForCausalLM(cfg, device=cuda, seed=0)
    eng = Engine(model, lr=1e-4)
    ids = torch.randint(0, 256, (2, 128), device=cuda)
    eng.step(ids, ids)
    prof = P.Profiler(targets=[P.ProfilerTarget.CPU, P.ProfilerTarget.GPU],
                      scheduler=P.make_scheduler(ready=1, record=2),
                      on_trace_ready=P.export_chrome_tracing(str(tmp_path)))
    prof.start()
    eng.step(ids, ids)          # READY: Kineto's warm-up, not recorded
    prof.step()
    n0 = (flash_attention_forward.launches,
          flash_attention_backward.launches_dq,
          flash_attention_backward.launches_dkv)
    for _ in range(2):
        eng.step(ids, ids)
        prof.step()
    prof.stop()
    counts = (flash_attention_forward.launches - n0[0],
              flash_attention_backward.launches_dq - n0[1],
              flash_attention_backward.launches_dkv - n0[2])
    res = P.load_profiler_result(str(tmp_path / "device_trace.json"))
    got = tuple(sum(d["calls"] for k, d in res.summary.items() if n in k)
                for n in ("flash_fwd_tc_kernel", "dq_tc_kernel",
                          "dkv_tc_kernel"))
    assert counts == (4, 4, 4) and got == counts


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(), dict(center=False),
                                dict(win_length=320, normalized=True)])
def test_stft_istft_on_card_match_cpu(cuda, kw):
    """signal.stft / istft card vs CPU (fp32, 1e-4 of the largest), and
    the round trip. istft is compared where the window envelope (the
    overlap-added squared window it divides by) is at least 1e-3 of its
    largest: without centring the first and last samples divide by
    envelopes down to ~1e-9 (a Hann window's edges), which turn the FFTs'
    last-place differences into ~5e-3 (seen on an H100)."""
    from paddle_tpu_torch import signal

    g = torch.Generator().manual_seed(49)
    x = torch.randn(4, 2, 16000, generator=g)
    w = torch.hann_window(kw.get("win_length", 400), periodic=True)
    spec = signal.stft(x, 400, 160, window=w, **kw)
    spec_c = signal.stft(x.cuda(), 400, 160, window=w.cuda(), **kw)
    assert spec_c.device.type == "cuda"
    err = (torch.view_as_real(spec_c).cpu() - torch.view_as_real(spec)
           ).abs().max() / torch.view_as_real(spec).abs().max()
    assert err.item() <= 1e-4
    back = signal.istft(spec, 400, 160, window=w, length=16000, **kw)
    back_c = signal.istft(spec_c, 400, 160, window=w.cuda(), length=16000,
                          **kw)
    lo = (400 - w.shape[0]) // 2
    w_p = torch.nn.functional.pad(w, (lo, 400 - w.shape[0] - lo))
    env = signal.overlap_add((w_p * w_p)[:, None].expand(
        400, spec.shape[-1]).contiguous(), 160)
    if kw.get("center", True):
        env = env[200:env.shape[0] - 200]
    live = env[:16000] >= 1e-3 * env.max()
    assert live.float().mean().item() > 0.9
    assert ((back_c.cpu() - back).abs() * live).max().item() <= 1e-4
    if kw.get("center", True):
        assert (back_c.cpu() - x).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_top_p_sampling_on_card_same_seed_same_draw(cuda):
    import paddle_tpu_torch as pt

    g = torch.Generator(device=cuda).manual_seed(46)
    logits = torch.randn(64, 32000, device=cuda, generator=g) * 4
    a = pt.top_p_sampling(logits, 0.7, seed=11)
    b = pt.top_p_sampling(logits, 0.7, seed=11)
    c = pt.top_p_sampling(logits, 0.7, seed=12)
    assert a[1].device.type == "cuda" and torch.equal(a[1], b[1])
    assert torch.equal(a[0], b[0]) and not torch.equal(a[1], c[1])
    probs = torch.softmax(logits, -1)
    sp, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    keep = (torch.cumsum(sp, -1) - sp) <= 0.7
    rank = (order == a[1]).float().argmax(-1)
    assert bool(keep.gather(1, rank[:, None]).all())


@pytest.mark.cuda
def test_nanquantile_on_card_with_bf16_nans(cuda):
    """A NaN cast from bf16 carries its sign bit, which torch's CUDA sort
    puts first (its CPU sort last): paddle.nanquantile sorts NaNs as
    +inf and agrees with the CPU on bf16 data."""
    import paddle_tpu_torch as pt

    g = torch.Generator().manual_seed(46)
    x = torch.randn(64, 1024, generator=g)
    x.view(-1)[::7] = float("nan")
    x = x.bfloat16()
    assert bool(torch.signbit(x[torch.isnan(x)]).all())
    for q, kw in ((0.3, dict(axis=1, keepdim=True)),
                  ([0.1, 0.5, 0.9], dict(axis=0, interpolation="midpoint"))):
        ref = pt.nanquantile(x, q, **kw).float()
        got = pt.nanquantile(x.cuda(), q, **kw).float().cpu()
        assert torch.equal(torch.isnan(ref), torch.isnan(got))
        assert (got - ref).nan_to_num().abs().max().item() <= 1e-2


# ---- jit and static on the card: K1's primal forward as a custom op, a
# compiled encoder step, a jit.load in a fresh process, an Executor run ----

SMALL_BERT = dict(vocab=64, hidden=128, heads=2, ffn=256, layers=2,
                  max_pos=64, labels=2)


@pytest.fixture
def card_place(cuda):
    import paddle_tpu_torch as pt

    prev = pt.device._PLACE
    pt.set_device(cuda)
    yield cuda
    pt.device._PLACE = prev


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [False, True])
def test_primal_flash_op_matches_plain_and_the_eager_launch(cuda, dtype,
                                                            causal):
    """``paddle_tpu_torch::flash_fwd`` against the plain version (2e-2 in
    bf16, 1e-4 in fp32) and byte-equal to K1 launched directly; the op
    counts its launch, the direct launch does not."""
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(2, 128, 4, 64, generator=gen, device=cuda,
                           dtype=dtype) for _ in range(3))
    scale = 64 ** -0.5
    n0 = flash_attention.launches
    out = torch.ops.paddle_tpu_torch.flash_fwd(q, k, v, causal, scale)
    direct, _ = fa._launch_forward(q, k, v, causal, scale, with_lse=False)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    assert torch.equal(out, direct)
    ref = flash_attention_reference(q.float(), k.float(), v.float(), causal,
                                    scale)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert float((out.float() - ref).abs().max()) <= tol


@pytest.mark.cuda
def test_to_static_encoder_step_on_card_runs_the_flash_kernels(card_place):
    """A compiled (Inductor) O1 bf16 step of a 2-layer encoder: one graph,
    K1-lse, K2 and K3 once a layer, loss within 2e-2 of the eager step's
    on the same weights."""
    import chip_smoke
    import paddle_tpu_torch as pt

    pt.seed(7)
    eager = chip_smoke.dygraph_encoder(pt, SMALL_BERT, card_place)
    model = chip_smoke.dygraph_encoder(pt, SMALL_BERT, card_place)
    model.set_state_dict(eager.state_dict())
    pt.jit.to_static(model)
    rng = np.random.default_rng(7)
    ids = pt.to_tensor(rng.integers(0, 64, (4, 32)), place=card_place)
    labels = pt.to_tensor(rng.integers(0, 2, (4,)), place=card_place)
    losses = []
    for m in (eager, model):
        opt = pt.optimizer.AdamW(1e-4, parameters=m.parameters())
        scaler = pt.amp.GradScaler(init_loss_scaling=1024)
        n0 = (flash_attention_forward.launches,
              flash_attention_backward.launches_dq,
              flash_attention_backward.launches_dkv)
        losses.append(float(chip_smoke.dygraph_step(
            pt, m, opt, scaler, ids, labels, "O1", "bfloat16")))
        assert (flash_attention_forward.launches,
                flash_attention_backward.launches_dq,
                flash_attention_backward.launches_dkv) == tuple(
                    x + 2 for x in n0)
    assert model.forward.traces == 1
    assert abs(losses[1] - losses[0]) <= 2e-2 * abs(losses[0])


@pytest.mark.cuda
def test_jit_load_is_the_first_k1_launch_of_a_fresh_process(card_place,
                                                            tmp_path):
    """A bf16 encoder saved here and run by a process that imports only
    ``paddle_tpu_torch.inference``: K1's primal op launches there once a
    layer, and the logits equal this process's eager ones within 2 bf16
    ulps of each row's largest."""
    import subprocess
    import sys

    import chip_smoke
    import paddle_tpu_torch as pt

    pt.seed(7)
    model = chip_smoke.dygraph_encoder(pt, SMALL_BERT, card_place)
    model.eval()
    model.to(torch.bfloat16)
    ids = np.random.default_rng(7).integers(0, 64, (4, 32))
    path = str(tmp_path / "enc")
    pt.jit.save(model, path, input_spec=[pt.static.InputSpec([4, 32],
                                                             "int64")])
    with torch.no_grad():
        ref = model(pt.to_tensor(ids, place=card_place)).float().cpu()
    np.save(tmp_path / "ids.npy", ids)
    code = ("import sys\n"
            "import numpy as np\n"
            "import paddle_tpu_torch.inference as inf\n"
            f"ids = np.load({str(tmp_path / 'ids.npy')!r})\n"
            f"(o,) = inf.create_predictor(inf.Config({path!r})).run([ids])\n"
            f"np.save({str(tmp_path / 'out.npy')!r}, o)\n"
            "fa = sys.modules['paddle_tpu_torch.ops.flash_attention']\n"
            "print(fa.flash_attention.launches)\n")
    root = str(__import__("pathlib").Path(__file__).resolve().parents[1])
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600,
                         env=dict(__import__("os").environ,
                                  PYTHONPATH=root))
    assert res.returncode == 0, res.stderr[-3000:]
    assert int(res.stdout.split()[-1]) == SMALL_BERT["layers"]
    got = torch.from_numpy(np.load(tmp_path / "out.npy"))
    err, ok = chip_smoke._bf16_ulp_err(np, ref.numpy(), got.numpy())
    assert ok, err


@pytest.mark.cuda
def test_executor_trains_an_encoder_program_on_card(card_place):
    """A static program of the 2-layer encoder (fp32, TF32 off): the first
    loss within 1e-4 of the eager fp32 step's, K1-lse, K2 and K3 once a
    layer a run, one cached signature."""
    import chip_smoke
    import paddle_tpu_torch as pt

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        pt.seed(7)
        ref = chip_smoke.dygraph_encoder(pt, SMALL_BERT, card_place)
        model = chip_smoke.dygraph_encoder(pt, SMALL_BERT, card_place)
        model.set_state_dict(ref.state_dict())
        rng = np.random.default_rng(7)
        ids = rng.integers(0, 64, (4, 32))
        labels = rng.integers(0, 2, (4,))
        want = float(pt.nn.functional.cross_entropy(
            ref(pt.to_tensor(ids, place=card_place)),
            pt.to_tensor(labels, place=card_place)))
        pt.enable_static()
        try:
            main = pt.static.Program()
            with pt.static.program_guard(main):
                x = pt.static.data("ids", [4, 32], "int64")
                y = pt.static.data("labels", [4], "int64")
                loss = pt.nn.functional.cross_entropy(model(x), y)
                pt.optimizer.AdamW(1e-4, parameters=model.parameters()
                                   ).minimize(loss)
            exe = pt.static.Executor()
            got = []
            for _ in range(2):
                n0 = (flash_attention_forward.launches,
                      flash_attention_backward.launches_dq,
                      flash_attention_backward.launches_dkv)
                got.append(float(exe.run(main, feed={"ids": ids,
                                                     "labels": labels},
                                         fetch_list=[loss])[0]))
                assert (flash_attention_forward.launches,
                        flash_attention_backward.launches_dq,
                        flash_attention_backward.launches_dkv) == tuple(
                            x + 2 for x in n0)
        finally:
            pt.disable_static()
        assert len(exe.cache_signatures()) == 1
        assert abs(got[0] - want) <= 1e-4 * abs(want)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


# ---- quantization, the fused family and ASP on the card --------------------

@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 8, 8), (5, 12, 3), (16, 768, 2),
                                   (17, 20, 33), (64, 768, 3072)])
def test_int8_matmul_pads_and_is_exact_on_card(cuda, m, k, n):
    """``torch._int_mm`` on the card takes M > 16 and K, N multiples of 8;
    smaller or ragged operands are padded with zeros: the int32 result
    equals the CPU's exactly, and each call counts one launch."""
    from paddle_tpu_torch.quantization import int8_matmul, quantized_linear

    g = torch.Generator().manual_seed(m * 1000 + k + n)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    quantized_linear.launches = 0
    got = int8_matmul(a.to(cuda), b.to(cuda))
    assert quantized_linear.launches == 1
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    assert torch.equal(got.cpu(), a.int() @ b.int())


@pytest.mark.cuda
def test_converted_linear_on_card_matches_cpu(card_place):
    import copy

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import quantization as Q

    pt.seed(3)
    lin = pt.nn.Linear(64, 10)
    lin_cpu = copy.deepcopy(lin).to("cpu")
    x = torch.randn(2, 9, 64, device=card_place)
    w_scale = lin.weight.detach().abs().amax(0)
    conv = Q.ConvertedLinear(lin, w_scale, x.abs().max())
    cpu = Q.ConvertedLinear(lin_cpu, w_scale.cpu(), x.abs().max().cpu())
    Q.quantized_linear.launches = 0
    got = conv(x)
    assert Q.quantized_linear.launches == 1
    torch.testing.assert_close(got.cpu(), cpu(x.cpu()), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.cuda
def test_fused_multi_transformer_runs_k1_in_prefill_and_decode(cuda):
    """2 layers: one K1 a layer in the prefill and one a layer in each
    cached decode step (a 1-row query over the longer end-aligned causal
    key), against the CPU run within bf16 tolerance."""
    import paddle_tpu_torch.incubate.nn.functional as IF

    g = torch.Generator().manual_seed(0)
    L, b, s, nh, hd, ffn, steps = 2, 2, 64, 4, 64, 512, 3
    d = nh * hd

    def w(*shape, scale=0.05):
        return torch.randn(shape, generator=g) * scale

    ws = dict(ln_scales=[1 + w(d) for _ in range(L)],
              ln_biases=[w(d) for _ in range(L)],
              qkv_weights=[w(3 * d, d) for _ in range(L)],
              qkv_biases=[w(3 * d) for _ in range(L)],
              linear_weights=[w(d, d) for _ in range(L)],
              linear_biases=[w(d) for _ in range(L)],
              ffn_ln_scales=[1 + w(d) for _ in range(L)],
              ffn_ln_biases=[w(d) for _ in range(L)],
              ffn1_weights=[w(d, ffn) for _ in range(L)],
              ffn1_biases=[w(ffn) for _ in range(L)],
              ffn2_weights=[w(ffn, d) for _ in range(L)],
              ffn2_biases=[w(d) for _ in range(L)])
    x = torch.randn(b, s, d, generator=g)
    xs = [torch.randn(b, 1, d, generator=g) for _ in range(steps)]

    def run(dev, dtype):
        kw = {k: [t.to(dev, dtype) for t in v] for k, v in ws.items()}
        caches = [torch.zeros(2, b, nh, s + steps, hd, device=dev,
                              dtype=dtype) for _ in range(L)]
        outs = [IF.fused_multi_transformer(x.to(dev, dtype), cache_kvs=caches,
                                           num_heads=nh, **kw)]
        for i, xi in enumerate(xs):
            outs.append(IF.fused_multi_transformer(
                xi.to(dev, dtype), cache_kvs=caches, time_step=s + i,
                num_heads=nh, **kw))
        return [o.float().cpu() for o in outs]

    flash_attention.launches = 0
    got = run(cuda, torch.bfloat16)
    assert flash_attention.launches == L * (1 + steps)
    ref = run("cpu", torch.float32)
    for a, r in zip(got, ref):
        assert float((a - r).abs().max()) <= 3e-2 * float(r.abs().max())


@pytest.mark.cuda
def test_asp_keeps_two_four_after_a_step_on_card(card_place):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.incubate import asp

    pt.seed(1)
    net = pt.nn.Sequential(pt.nn.Linear(64, 128), pt.nn.ReLU(),
                           pt.nn.Linear(128, 16))
    masks = asp.prune_model(net, 2, 4, "mask_1d")
    opt = asp.decorate(pt.optimizer.AdamW(1e-2,
                                          parameters=net.parameters()))
    x = torch.randn(32, 64, device=card_place)
    (net(x) ** 2).mean().backward()
    opt.step()
    for name, p in net.named_parameters():
        if name in masks:
            assert asp.check_sparsity(p.detach().t(), "1d"), name
            assert asp.calculate_density(p) == 0.5, name


# ---- distributed training on the card ---------------------------------

def _dist_cfg():
    """A small Llama whose heads the flash kernels take (head_dim 64); the
    same config as tests/torch_dist_worker.py's card suite."""
    return LlamaConfig.tiny(hidden_size=256, intermediate_size=512,
                            num_key_value_heads=4)

def _dist_world(suite, tmp_path, inputs=None):
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from torch_dist_harness import launch

    if inputs is not None:
        np.savez(tmp_path / f"{suite}_in.npz", **inputs)
    return launch(suite, tmp_path, nprocs=2, timeout=300).wait()


@pytest.mark.cuda
def test_gloo_collectives_on_cuda_tensors(cuda, tmp_path):
    """Two ranks sharing the card over gloo (the chip machine has one card
    and NCCL refuses two ranks on one device): all_reduce and broadcast,
    which dp needs, and all_gather_into_tensor and reduce_scatter_tensor,
    which tp and fsdp need, all run on CUDA tensors. (DTensor's
    Shard -> Replicate goes through the functional all-gather instead,
    which gloo ends with SIGSEGV on CUDA tensors in torch 2.11, so
    chip_smoke.py phase 56 (b) runs dp only; PERF.md section 7.)"""
    res = _dist_world("cuda_gloo", tmp_path)
    x = [np.arange(8, dtype=np.float32) + r for r in range(2)]
    want = [{"all_reduce": x[0] + x[1], "broadcast": x[1],
             "all_gather_into_tensor": np.concatenate(x),
             "reduce_scatter_tensor": (x[0] + x[1])[4 * r:4 * r + 4]}
            for r in range(2)]
    for r in range(2):
        for name, value in want[r].items():
            status, got = res[r][name]
            assert status == "ok", (name, got)
            np.testing.assert_array_equal(got, value)


@pytest.mark.cuda
def test_one_rank_mesh_on_card_matches_mesh_none(card_place):
    """A one-rank NCCL mesh {dp, fsdp, tp: 1} trains as mesh=None (fp32):
    the same losses, and K1-lse, K2 and K3 launched as often."""
    import os

    import torch.distributed as dist

    from paddle_tpu_torch.distributed import destroy_process_group, \
        init_parallel_env
    from paddle_tpu_torch.distributed.auto_parallel import make_mesh
    from paddle_tpu_torch.distributed.parallel import free_port

    os.environ.update(PADDLE_TRAINER_ID="0", PADDLE_TRAINERS_NUM="1",
                      MASTER_PORT=str(free_port()))
    init_parallel_env()
    try:
        assert dist.get_backend() == "nccl"
        rng = np.random.default_rng(4)
        batches = [rng.integers(0, 256, (2, 64)) for _ in range(3)]
        out = {}
        for arm in ("none", "mesh"):
            model = LlamaForCausalLM(_dist_cfg(), seed=3)
            mesh = make_mesh({"dp": 1, "fsdp": 1, "tp": 1}) \
                if arm == "mesh" else None
            eng = Engine(model, mesh, lr=1e-3)
            flash_attention_forward.launches = 0
            flash_attention_backward.launches_dq = 0
            flash_attention_backward.launches_dkv = 0
            losses = [float(eng.step(b, b)) for b in batches]
            out[arm] = (losses, (flash_attention_forward.launches,
                                 flash_attention_backward.launches_dq,
                                 flash_attention_backward.launches_dkv))
        np.testing.assert_allclose(out["mesh"][0], out["none"][0],
                                   rtol=1e-5)
        assert out["mesh"][1] == out["none"][1] == (6, 6, 6)
    finally:
        destroy_process_group()


@pytest.mark.cuda
def test_dp2_sharing_the_card_matches_mesh_none(card_place, tmp_path):
    """dp=2 as two processes sharing the card over gloo (fp32, small)
    against one process's mesh=None steps over the same global batch:
    losses within 2e-4, parameters within 2 * lr * steps."""
    rng = np.random.default_rng(6)
    batches = [rng.integers(0, 256, (4, 64)) for _ in range(3)]
    res = _dist_world("cuda_dp", tmp_path,
                      {f"ids{i}": b for i, b in enumerate(batches)})
    eng = Engine(LlamaForCausalLM(_dist_cfg(), seed=3), lr=1e-3)
    losses = [float(eng.step(b, b)) for b in batches]
    ref = eng.state_dict()["model"]
    for r in range(2):
        np.testing.assert_allclose(res[r]["losses"], losses, rtol=2e-4)
        assert res[r]["launches"] == [6, 6, 6]
    for name, p in ref.items():
        err = np.abs(res[0]["model"][name] - p.float().cpu().numpy()).max()
        assert err <= 2 * 1e-3 * 3, (name, err)


@pytest.mark.cuda
def test_ppermute_on_cuda_tensors_over_gloo(cuda, tmp_path):
    """ppermute over two gloo ranks sharing the card: gloo's own send/recv
    fail on CUDA tensors (they write the device pointer through the host:
    "writev ... Bad address"), so the exchange stages through host copies;
    the swap and its gradient are exact, the result on the card, one send
    and one receive each way."""
    res = _dist_world("cuda_ppermute", tmp_path)
    for r in range(2):
        np.testing.assert_array_equal(
            res[r]["y"], np.arange(8, dtype=np.float32) + (1 - r))
        np.testing.assert_array_equal(res[r]["grad"],
                                      np.full(8, 2.0 - r, np.float32))
        assert res[r]["device"].startswith("cuda")
        assert res[r]["p2p"] == (2, 2)


@pytest.mark.cuda
def test_ring_attention_two_ranks_on_card_match_plain(card_place, tmp_path):
    """Ring attention over {"sep": 2}, two ranks sharing the card over
    gloo (fp32, zigzag, causal, GQA 8/2 heads of 64): each rank's output
    and q, k, v gradients equal the plain attention's on the whole
    sequence, cut at the rank's shard (1e-4 x max(1, max |plain|)); each
    rank launches K1-lse, K2 with l-bar and K3 once for each of its
    2n + 1 = 5 stripe pairs, and no dense K2."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from torch_dist_worker import _ring_card_inputs

    res = _dist_world("cuda_ring", tmp_path)
    q, k, v, cot = _ring_card_inputs()
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    ref = flash_attention_reference(q, k, v, causal=True)
    (ref * cot).sum().backward()
    want = [ref.detach()] + [t.grad for t in (q, k, v)]
    for r in range(2):
        got = [res[r]["out"]] + res[r]["grads"]
        for g, w in zip(got, want):
            w = w.chunk(2, 1)[r].numpy()
            err = np.abs(g - w).max() / max(1.0, np.abs(w).max())
            assert err <= 1e-4, (r, err)
        assert res[r]["launches"] == (5, 0, 5, 5)


@pytest.mark.cuda
def test_sep2_fp32_parameters_within_the_lr_bound(cuda):
    """chip_smoke.py's phase 56 (b) sep=2 run (ring attention, zigzag, two
    ranks sharing the card over gloo, DIST_DP_LAYERS layers of
    TRAIN_CONFIG at full width, DIST_STEPS steps) in fp32, against the
    same mesh=None steps in fp32: losses within 1e-4, every parameter
    within 2 * lr * steps plus DIST_STEPS fp32 ulps, each parameter's
    update within DIST_UPDATE_RTOL of mesh=None's. Without bf16's rounding
    the two runs differ by at most Adam's lr a step and element, which is
    what phase 56 (b)'s wider bf16 bound for sep=2 (DIST_SEP_ULPS) rests
    on."""
    import chip_smoke
    from paddle_tpu_torch import ops

    losses, _, ranks = chip_smoke.dist_gloo_run(
        torch, np, ops, (("sep2", {"sep": 2}, {}),), dtype="float32")
    for r in ranks:
        rel = ((r["sep2"]["losses"] - losses).abs() / losses.abs()).max()
        assert float(rel) <= 1e-4, float(rel)
    pe = ranks[0]["sep2"]["params"]
    print(f"sep2 fp32: params worst abs {pe['worst']} ({pe['ratio']:.3f}x "
          f"of the bound), {pe['beyond']} of {pe['total_n']} elements "
          f"beyond 2 lr steps + |w| / 256; updates worst rel {pe['upd']}")
    assert not pe["far"] and not pe["stale"], (pe["far"], pe["stale"])
    assert ranks[0]["sep2"]["counts"]["k2_glse"] == (
        5 * chip_smoke.DIST_DP_LAYERS * chip_smoke.DIST_STEPS)


@pytest.mark.cuda
def test_pipeline_call_two_ranks_on_card_matches_plain(card_place,
                                                       tmp_path):
    """pipeline_call over {"pp": 2} (GPipe, 2 microbatches), two ranks
    sharing the card over gloo, a block with the flash kernels (fp32):
    the loss and the gradients of the stacked weights (each rank's rows)
    and of the input (stage 0's) equal the plain blocks run in sequence on
    the CPU (1e-4 relative); each rank launches K1-lse, K2 and K3 for its
    2 layers x 2 microbatches."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from torch_dist_worker import _pipe_card_inputs, pipe_card_block

    res = _dist_world("cuda_pipeline", tmp_path)
    ws, x = (t.requires_grad_() for t in _pipe_card_inputs())
    h = x
    for i in range(ws.shape[0]):
        h = pipe_card_block([ws[i]], h)
    loss = (h ** 2).mean()
    loss.backward()
    half = ws.shape[0] // 2
    for r in range(2):
        np.testing.assert_allclose(res[r]["loss"], loss.item(), rtol=1e-4)
        gw = ws.grad.numpy()
        rows = slice(r * half, (r + 1) * half)
        np.testing.assert_allclose(res[r]["gw"][rows], gw[rows], rtol=1e-4,
                                   atol=1e-4 * np.abs(gw).max())
        gx = x.grad.numpy() if r == 0 else np.zeros_like(x.grad.numpy())
        np.testing.assert_allclose(res[r]["gx"], gx, rtol=1e-4,
                                   atol=1e-4 * np.abs(x.grad.numpy()).max())
        assert res[r]["launches"] == (4, 4, 4)


def _parent_adamw(eng, grads):
    """The unguarded AdamW as it was before the guard came (in place:
    ``mm.mul_(b1).add_(...)``, ``p.copy_(...)``), on ``eng``'s tensors."""
    b1, b2, eps, wd = eng.beta1, eng.beta2, eng.epsilon, eng.weight_decay
    stepf = eng.step_count.float()
    bc1, bc2 = 1.0 - b1 ** stepf, 1.0 - b2 ** stepf
    grads = eng._clip_grads(grads)
    with torch.no_grad():
        for p, mm, vv, g, decay in zip(eng.params, eng.m, eng.v, grads,
                                       eng._decay_mask):
            gf = g.float()
            mm.mul_(b1).add_((1.0 - b1) * gf)
            vv.mul_(b2).add_((1.0 - b2) * gf * gf)
            update = (mm / bc1) / (torch.sqrt(vv / bc2) + eps)
            pf = p.float()
            if decay:
                update = update + wd * pf
            p.copy_(pf - eng.lr * update)


@pytest.mark.cuda
def test_guarded_skip_on_card_is_bit_identical(card_place):
    """bf16 on the card: a nan_grad step and a loss_spike step (after the
    warm-up) leave every parameter and moment bit-identical, the counter
    advancing; the healthy guarded steps launch K1-lse, K2 and K3 once a
    layer each and give the unguarded engine's numbers bitwise."""
    from paddle_tpu_torch.distributed import GuardPolicy
    from paddle_tpu_torch.distributed.resilience import FaultPlan, FaultSpec

    cfg = LlamaConfig.tiny(hidden_size=256, intermediate_size=512,
                           num_key_value_heads=4, dtype="bfloat16")
    rng = np.random.default_rng(8)
    batches = [rng.integers(0, 256, (2, 64)) for _ in range(6)]
    plain = Engine(LlamaForCausalLM(cfg, seed=3), lr=1e-3)
    eng = Engine(LlamaForCausalLM(cfg, seed=3), lr=1e-3,
                 guard=GuardPolicy(warmup_steps=2))
    flash_attention_forward.launches = 0
    for b in batches[:4]:
        assert torch.equal(eng.step(b, b), plain.step(b, b))
        assert int(eng.last_health) == 0
    assert flash_attention_forward.launches == 2 * 4 * cfg.num_hidden_layers
    for a, b in zip(eng.params + eng.m + eng.v,
                    plain.params + plain.m + plain.v):
        assert torch.equal(a, b)
    with FaultPlan(specs=[FaultSpec("numeric.step", "nan_grad", at=0),
                          FaultSpec("numeric.step", "loss_spike", at=1)]):
        for b, bit in zip(batches[4:], (1, 8)):
            before = [t.detach().clone() for t in eng.params + eng.m + eng.v]
            n = int(eng.step_count)
            eng.step(b, b)
            assert int(eng.last_health) & bit
            assert int(eng.step_count) == n + 1
            assert all(torch.equal(t, s) for t, s in zip(
                eng.params + eng.m + eng.v, before))


@pytest.mark.cuda
def test_unguarded_step_on_card_is_the_parents_arithmetic(card_place):
    """guard=None: three steps give bitwise the numbers of the in-place
    AdamW the engine ran before the guard came (``_parent_adamw``)."""
    cfg = LlamaConfig.tiny(hidden_size=256, intermediate_size=512,
                           num_key_value_heads=4, dtype="bfloat16")
    rng = np.random.default_rng(9)
    batches = [torch.from_numpy(rng.integers(0, 256, (2, 64))).cuda()
               for _ in range(3)]
    eng = Engine(LlamaForCausalLM(cfg, seed=5), lr=1e-3)
    ref = Engine(LlamaForCausalLM(cfg, seed=5), lr=1e-3)
    for b in batches:
        loss = eng.step(b, b)
        with torch.no_grad():
            ref.step_count += 1
        ref_loss = ref.model.loss_fn(b, b)
        grads = torch.autograd.grad(ref_loss, ref.params, allow_unused=True,
                                    materialize_grads=True)
        _parent_adamw(ref, grads)
        assert torch.equal(loss, ref_loss.detach())
    for a, b in zip(eng.params + eng.m + eng.v, ref.params + ref.m + ref.v):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_accuracy_ties_rank_by_index_on_card(cuda):
    """Tied predictions: the card's top-k equals the CPU's, call after
    call (an unstable CUDA sort moved a tied label across k between two
    evaluations of one model)."""
    from paddle_tpu_torch.metric import Accuracy

    g = torch.Generator().manual_seed(38)
    pred = torch.randint(0, 3, (4096, 10), generator=g).float()
    label = torch.randint(0, 10, (4096,), generator=g)
    acc = Accuracy(topk=(1, 5))
    ref = acc.compute(pred, label)
    for _ in range(3):
        assert torch.equal(acc.compute(pred.to(cuda), label).cpu(), ref)
