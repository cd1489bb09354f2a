// FlashAttention backward for Hopper (sm_90a), CUDA C++: two kernels.
//
// Replaces the Pallas TPU kernels `_fa_bwd_dq_kernel` (K2,
// paddle_tpu/ops/flash_attention.py:337) and `_fa_bwd_dkv_kernel` (K3,
// :420), driven by `_pallas_backward` (:497).
//
// What they compute, from the forward's saved output O and logsumexp lse
// (fp32, of the SCALED logits, [b, hq, s_q]) and the output gradient dO:
//   s   = (q . k) * scale, end-aligned causal mask q + (s_kv - s_q) >= k
//         with the finite NEG_INF = -1e30;
//   P   = exp(s - lse), and P = 0 for a row whose lse <= NEG_INF / 2 (a row
//         that saw no key: without the guard it would get P = 1);
//   d   = rowsum(dO * O) in fp32, from the STORED output O (q's dtype);
//   dP  = dO . V^T;  dS = P * (dP - d) * scale;
//   dQ  = dS . K                                   (K2)
//   dK  = dS^T . Q,  dV = P^T . dO, each summed over the `group` q heads of
//         its kv head in fp32 before one cast to k's dtype (K3).
//
// What bounds them on the H100: at the training shape ([2, 4096, 16 q /
// 4 kv heads, 128], causal) K2 does 6 * head_dim and K3 8 * head_dim
// operations per visible (q, k) pair and head over a few MB of inputs:
// both are bounded by the tensor cores (bf16), far above the line where
// HBM would limit them.
//
// What the design does about it (simple and right first):
//  - No carry across blocks, no atomics: the result is deterministic.
//    K2 has one block per (64-row q tile, q head, batch); it first writes
//    d for its rows to an fp32 scratch [b, hq, s_q] (the wrapper allocates
//    it) and then loops over the kv tiles up to the last causal one,
//    accumulating dQ in fp32. K3 has one block per (64-row k tile, kv
//    head, batch); it loops over the group's q heads and, for each, over
//    the q tiles from the first causal one, reading d from K2, and
//    accumulates dK and dV in fp32 until one final write. K3 is launched
//    after K2 on the same stream.
//  - bf16 runs on the tensor cores (WMMA 16x16x16, fp32 accumulation). Each
//    of the 4 warps owns 16 rows of the tile (q rows in K2, k rows in K3),
//    so after the tiles are staged it works alone: its strip of S (S^T in
//    K3) and dP, the elementwise P/dS in fp32 (rounded to bf16 for the
//    products), and its strip of the accumulators, held in registers for
//    the whole loop. Tiles are staged with 16-byte loads.
//  - fp32 runs on FMAs (256 threads, 4 x 4 score tiles and 4-row
//    accumulator strips per thread) so its 1e-4 tolerance holds.
//  - Causal skips: K2 never visits kv tiles wholly in the future, K3 never
//    visits q tiles wholly in the past. Ragged tails are masked in-kernel.
//  - q, k, v, O and dO are read through their [b, s, h, d] strides.
// Loads are not overlapped with math (no cp.async/TMA pipeline) and the
// products use WMMA rather than wgmma; both are later work.
#include <stdint.h>

#include <mma.h>

#include "common.cuh"

namespace {

constexpr int BT = 64;    // rows per tile (q and k)
constexpr int NTC = 128;  // threads per block, bf16 (4 warps x 16 rows)
constexpr int NTF = 256;  // threads per block, fp32 (16 x 16 groups)

// Strides of one [b, s, h, d] operand (elements).
struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ bool visible(int qr, int kc, int s_q, int s_kv,
                                        int offset, int causal) {
  return qr < s_q && kc < s_kv && !(causal && qr + offset < kc);
}

// P from the saved lse; 0 where masked or where the row saw no key.
__device__ __forceinline__ float prob(float s, float lse, bool vis) {
  return (vis && lse > 0.5f * pt::kNegInf) ? expf(s - lse) : 0.f;
}

// First q tile (of BT rows) that a k tile starting at k0 can see: the
// tiles before it are wholly in its causal past.
__device__ __forceinline__ int first_q_tile(int k0, int offset, int causal) {
  if (!causal) return 0;
  const int x = k0 - offset;
  return x <= 0 ? 0 : x / BT;
}

// Last kv tile that a q tile starting at q0 can see (-1: none).
__device__ __forceinline__ int last_kv_tile(int q0, int s_kv, int offset,
                                            int causal) {
  int last = (s_kv + BT - 1) / BT - 1;
  if (causal) {
    const int lk = q0 + BT - 1 + offset;
    last = lk < 0 ? -1 : min(last, lk / BT);
  }
  return last;
}

// ---- fp32: FMAs -------------------------------------------------------------
template <int D>
struct F32Layout {
  static constexpr int LD = D + 1;   // padded fp32 rows
  static constexpr int LP = BT + 1;
  static constexpr size_t kBytes =
      (4 * BT * LD + 2 * BT * LP + 2 * BT) * sizeof(float);
};

template <int D>
__device__ __forceinline__ void load_f32(float* dst, const float* src,
                                         long long stride, int r0, int n) {
  constexpr int LD = F32Layout<D>::LD;
  for (int i = threadIdx.x; i < BT * D; i += NTF) {
    const int r = i / D, c = i % D;
    dst[r * LD + c] = (r0 + r < n) ? src[(r0 + r) * stride + c] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(NTF)
dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ o,
              const float* __restrict__ dout, const float* __restrict__ lse,
              float* __restrict__ dq, float* __restrict__ delta, int s_q,
              int s_kv, int hq, int group, Strides sq, Strides sk, Strides sv,
              Strides so, Strides sd, float scale, int causal) {
  using L = F32Layout<D>;
  constexpr int LD = L::LD, LP = L::LP, DPT = D / 16;
  extern __shared__ float fsm[];
  float* qs = fsm;
  float* dos = qs + BT * LD;
  float* ks = dos + BT * LD;
  float* vs = ks + BT * LD;
  float* dss = vs + BT * LD;          // [BT][LP] dS of the tile
  float* lse_s = dss + 2 * BT * LP;   // [BT]
  float* del_s = lse_s + BT;          // [BT]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group, offset = s_kv - s_q;
  const long long bh = static_cast<long long>(b) * hq + h;

  load_f32<D>(qs, q + b * sq.b + h * sq.h, sq.s, q0, s_q);
  load_f32<D>(dos, dout + b * sd.b + h * sd.h, sd.s, q0, s_q);
  __syncthreads();
  {  // d = rowsum(dO * O): warp w owns rows 8w .. 8w + 7
    const int warp = tid / 32, lane = tid % 32;
    const float* ob = o + b * so.b + h * so.h;
    for (int r = warp * 8; r < warp * 8 + 8; ++r) {
      const int qr = q0 + r;
      float acc = 0.f;
      if (qr < s_q)
        for (int c = lane; c < D; c += 32)
          acc = fmaf(dos[r * LD + c], ob[qr * so.s + c], acc);
#pragma unroll
      for (int w = 16; w > 0; w >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, w);
      if (lane == 0) {
        del_s[r] = acc;
        lse_s[r] = qr < s_q ? lse[bh * s_q + qr] : pt::kNegInf;
        if (qr < s_q) delta[bh * s_q + qr] = acc;
      }
    }
  }

  float acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[i][d] = 0.f;

  const float* kb = k + b * sk.b + hk * sk.h;
  const float* vb = v + b * sv.b + hk * sv.h;
  const int last = last_kv_tile(q0, s_kv, offset, causal);
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();  // previous tile's reads of ks/dss are done
    load_f32<D>(ks, kb, sk.s, k0, s_kv);
    load_f32<D>(vs, vb, sv.s, k0, s_kv);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = qs[(ty * 4 + i) * LD + c];
        dov[i] = dos[(ty * 4 + i) * LD + c];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = ks[(tx + 16 * j) * LD + c];
        vv[j] = vs[(tx + 16 * j) * LD + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const bool vis = visible(q0 + row, k0 + col, s_q, s_kv, offset, causal);
        const float p = prob(s[i][j] * scale, lse_s[row], vis);
        dss[row * LP + col] = p * (dp[i][j] - del_s[row]) * scale;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BT; ++c) {
      float kv[DPT];
#pragma unroll
      for (int d = 0; d < DPT; ++d) kv[d] = ks[c * LD + tx + 16 * d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = dss[(ty * 4 + i) * LP + c];
#pragma unroll
        for (int d = 0; d < DPT; ++d) acc[i][d] = fmaf(ds, kv[d], acc[i][d]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty * 4 + i;
    if (qr >= s_q) continue;
    float* out = dq + ((static_cast<long long>(b) * s_q + qr) * hq + h) * D;
#pragma unroll
    for (int d = 0; d < DPT; ++d) out[tx + 16 * d] = acc[i][d];
  }
}

template <int D>
__global__ void __launch_bounds__(NTF)
dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dk, float* __restrict__ dv, int s_q,
               int s_kv, int hq, int hkv, int group, Strides sq, Strides sk,
               Strides sv, Strides sd, float scale, int causal) {
  using L = F32Layout<D>;
  constexpr int LD = L::LD, LP = L::LP, DPT = D / 16;
  extern __shared__ float fsm[];
  float* ks = fsm;
  float* vs = ks + BT * LD;
  float* qs = vs + BT * LD;
  float* dos = qs + BT * LD;
  float* pts = dos + BT * LD;        // [BT k][LP] P^T of the tile
  float* dst = pts + BT * LP;        // [BT k][LP] dS^T of the tile
  float* lse_s = dst + BT * LP;
  float* del_s = lse_s + BT;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * BT, hk = blockIdx.y, b = blockIdx.z;
  const int offset = s_kv - s_q;

  load_f32<D>(ks, k + b * sk.b + hk * sk.h, sk.s, k0, s_kv);
  load_f32<D>(vs, v + b * sv.b + hk * sv.h, sv.s, k0, s_kv);

  float ak[4][DPT], av[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int d = 0; d < DPT; ++d) ak[i][d] = av[i][d] = 0.f;

  const int nq = (s_q + BT - 1) / BT;
  const int first = first_q_tile(k0, offset, causal);
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const long long bh = static_cast<long long>(b) * hq + h;
    for (int qt = first; qt < nq; ++qt) {
      const int q0 = qt * BT;
      __syncthreads();  // previous tile's reads of qs/dos/pts/dst are done
      load_f32<D>(qs, q + b * sq.b + h * sq.h, sq.s, q0, s_q);
      load_f32<D>(dos, dout + b * sd.b + h * sd.h, sd.s, q0, s_q);
      for (int r = tid; r < BT; r += NTF) {
        const int qr = q0 + r;
        lse_s[r] = qr < s_q ? lse[bh * s_q + qr] : pt::kNegInf;
        del_s[r] = qr < s_q ? delta[bh * s_q + qr] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];  // rows: k; columns: q
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < D; ++c) {
        float kv[4], vv[4], qv[4], dov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = ks[(ty * 4 + i) * LD + c];
          vv[i] = vs[(ty * 4 + i) * LD + c];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = qs[(tx + 16 * j) * LD + c];
          dov[j] = dos[(tx + 16 * j) * LD + c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tx + 16 * j;
          const bool vis = visible(q0 + col, k0 + row, s_q, s_kv, offset,
                                   causal);
          const float p = prob(s[i][j] * scale, lse_s[col], vis);
          pts[row * LP + col] = p;
          dst[row * LP + col] = p * (dp[i][j] - del_s[col]) * scale;
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < BT; ++c) {
        float qv[DPT], dov[DPT];
#pragma unroll
        for (int d = 0; d < DPT; ++d) {
          qv[d] = qs[c * LD + tx + 16 * d];
          dov[d] = dos[c * LD + tx + 16 * d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = pts[(ty * 4 + i) * LP + c];
          const float ds = dst[(ty * 4 + i) * LP + c];
#pragma unroll
          for (int d = 0; d < DPT; ++d) {
            av[i][d] = fmaf(p, dov[d], av[i][d]);
            ak[i][d] = fmaf(ds, qv[d], ak[i][d]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = k0 + ty * 4 + i;
    if (kr >= s_kv) continue;
    const long long off = ((static_cast<long long>(b) * s_kv + kr) * hkv + hk) * D;
#pragma unroll
    for (int d = 0; d < DPT; ++d) {
      dk[off + tx + 16 * d] = ak[i][d];
      dv[off + tx + 16 * d] = av[i][d];
    }
  }
}

// ---- bf16: tensor cores (WMMA) ----------------------------------------------
namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Row strides of the shared tiles, padded so every 16-row fragment starts
// 32-byte aligned (WMMA's requirement) and rows fall on other banks.
template <int D>
struct TcLayout {
  static constexpr int LDH = D + 8;    // bf16 Q/K/V/dO rows
  static constexpr int LDP = BT + 8;   // bf16 P/dS rows
  static constexpr int LDS = BT + 4;   // fp32 S/dP rows
  static constexpr int LDO = D + 4;    // fp32 staging rows of the output
  // 4 bf16 tiles, 2 fp32 score tiles (also the output staging), 2 bf16
  // P/dS tiles, lse and d
  static constexpr size_t kBytes = 4 * BT * LDH * sizeof(bf16) +
                                   2 * BT * LDS * sizeof(float) +
                                   2 * BT * LDP * sizeof(bf16) +
                                   2 * BT * sizeof(float);
  static_assert(BT * LDO <= 2 * BT * LDS, "output staging fits S and dP");
};

template <int D>
__device__ __forceinline__ void load_bf16(bf16* dst, const bf16* src,
                                          long long stride, int r0, int n) {
  constexpr int LDH = TcLayout<D>::LDH;
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < BT * VPR; i += NTC) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * LDH + c) = val;
  }
}

// C strip (16 x BT, fp32, ld LDS) = A strip (16 x D, row-major) . B^T where
// B is BT x D row-major in shared memory (read as col-major B^T).
template <int D>
__device__ __forceinline__ void strip_abt(float* c, const bf16* a,
                                          const bf16* bm) {
  constexpr int LDH = TcLayout<D>::LDH, LDS = TcLayout<D>::LDS;
  FragC acc[BT / 16];
#pragma unroll
  for (int j = 0; j < BT / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk * 16, LDH);
#pragma unroll
    for (int j = 0; j < BT / 16; ++j) {
      FragBT fb;
      wmma::load_matrix_sync(fb, bm + j * 16 * LDH + kk * 16, LDH);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < BT / 16; ++j)
    wmma::store_matrix_sync(c + j * 16, acc[j], LDS, wmma::mem_row_major);
}

// Write a warp's 16 x D fp32 accumulator strip as bf16 rows of a
// [b, s, h, D] contiguous output, through the warp's staging rows.
template <int D>
__device__ __forceinline__ void store_strip(FragC (&acc)[D / 16],
                                            float* stage, bf16* out, int r0g,
                                            int n, long long row_stride,
                                            int lane) {
  constexpr int LDO = TcLayout<D>::LDO;
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    wmma::store_matrix_sync(stage + j * 16, acc[j], LDO, wmma::mem_row_major);
  __syncwarp();
  for (int r = 0; r < 16; ++r) {
    if (r0g + r >= n) break;
    bf16* row = out + (r0g + r) * row_stride;
    for (int c = lane; c < D; c += 32)
      row[c] = __float2bfloat16(stage[r * LDO + c]);
  }
  __syncwarp();
}

template <int D>
__global__ void __launch_bounds__(NTC)
dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ o,
               const bf16* __restrict__ dout, const float* __restrict__ lse,
               bf16* __restrict__ dq, float* __restrict__ delta, int s_q,
               int s_kv, int hq, int group, Strides sq, Strides sk, Strides sv,
               Strides so, Strides sd, float scale, int causal) {
  using L = TcLayout<D>;
  constexpr int LDH = L::LDH, LDP = L::LDP, LDS = L::LDS, LDO = L::LDO;
  constexpr int NJ = D / 16;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);   // [BT][LDH]
  bf16* dos = qs + BT * LDH;
  bf16* ks = dos + BT * LDH;
  bf16* vs = ks + BT * LDH;
  float* ss = reinterpret_cast<float*>(vs + BT * LDH);  // [BT][LDS] S
  float* dps = ss + BT * LDS;                           // [BT][LDS] dP
  bf16* dss = reinterpret_cast<bf16*>(dps + BT * LDS);  // [BT][LDP] dS
  float* lse_s = reinterpret_cast<float*>(dss + 2 * BT * LDP);
  float* del_s = lse_s + BT;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group, offset = s_kv - s_q;
  const int r0 = warp * 16;
  const long long bh = static_cast<long long>(b) * hq + h;

  load_bf16<D>(qs, q + b * sq.b + h * sq.h, sq.s, q0, s_q);
  load_bf16<D>(dos, dout + b * sd.b + h * sd.h, sd.s, q0, s_q);
  __syncthreads();
  {  // d = rowsum(dO * O) of the warp's rows, from the stored O
    const bf16* ob = o + b * so.b + h * so.h;
    for (int r = r0; r < r0 + 16; ++r) {
      const int qr = q0 + r;
      float acc = 0.f;
      if (qr < s_q)
        for (int c = lane; c < D; c += 32)
          acc = fmaf(__bfloat162float(dos[r * LDH + c]),
                     __bfloat162float(ob[qr * so.s + c]), acc);
#pragma unroll
      for (int w = 16; w > 0; w >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, w);
      if (lane == 0) {
        del_s[r] = acc;
        lse_s[r] = qr < s_q ? lse[bh * s_q + qr] : pt::kNegInf;
        if (qr < s_q) delta[bh * s_q + qr] = acc;
      }
    }
  }
  __syncwarp();

  FragC acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) wmma::fill_fragment(acc[j], 0.f);

  const bf16* kb = k + b * sk.b + hk * sk.h;
  const bf16* vb = v + b * sv.b + hk * sv.h;
  const int last = last_kv_tile(q0, s_kv, offset, causal);
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_bf16<D>(ks, kb, sk.s, k0, s_kv);
    load_bf16<D>(vs, vb, sv.s, k0, s_kv);
    __syncthreads();

    strip_abt<D>(ss + r0 * LDS, qs + r0 * LDH, ks);    // S  = Q K^T
    strip_abt<D>(dps + r0 * LDS, dos + r0 * LDH, vs);  // dP = dO V^T
    __syncwarp();
    for (int r = r0; r < r0 + 16; ++r) {
      const int qr = q0 + r;
      const float l = lse_s[r], dl = del_s[r];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = lane + 32 * e;
        const bool vis = visible(qr, k0 + col, s_q, s_kv, offset, causal);
        const float p = prob(ss[r * LDS + col] * scale, l, vis);
        dss[r * LDP + col] =
            __float2bfloat16(p * (dps[r * LDS + col] - dl) * scale);
      }
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {  // dQ += dS K
      FragA fa;
      wmma::load_matrix_sync(fa, dss + r0 * LDP + kk * 16, LDP);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        FragB fb;
        wmma::load_matrix_sync(fb, ks + kk * 16 * LDH + j * 16, LDH);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
  }
  __syncthreads();  // the staging rows overlay every warp's S/dP
  store_strip<D>(acc, ss + r0 * LDO,
                 dq + (static_cast<long long>(b) * s_q * hq + h) * D,
                 q0 + r0, s_q, static_cast<long long>(hq) * D, lane);
}

template <int D>
__global__ void __launch_bounds__(NTC)
dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dk, bf16* __restrict__ dv, int s_q,
                int s_kv, int hq, int hkv, int group, Strides sq, Strides sk,
                Strides sv, Strides sd, float scale, int causal) {
  using L = TcLayout<D>;
  constexpr int LDH = L::LDH, LDP = L::LDP, LDS = L::LDS, LDO = L::LDO;
  constexpr int NJ = D / 16;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* ks = reinterpret_cast<bf16*>(tc_smem);   // [BT][LDH]
  bf16* vs = ks + BT * LDH;
  bf16* qs = vs + BT * LDH;
  bf16* dos = qs + BT * LDH;
  float* sts = reinterpret_cast<float*>(dos + BT * LDH);  // [BT k][LDS] S^T
  float* dpts = sts + BT * LDS;                           // dP^T
  bf16* pts = reinterpret_cast<bf16*>(dpts + BT * LDS);   // [BT k][LDP] P^T
  bf16* dsts = pts + BT * LDP;                             // dS^T
  float* lse_s = reinterpret_cast<float*>(dsts + BT * LDP);
  float* del_s = lse_s + BT;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k0 = blockIdx.x * BT, hk = blockIdx.y, b = blockIdx.z;
  const int offset = s_kv - s_q;
  const int r0 = warp * 16;  // this warp's k rows

  load_bf16<D>(ks, k + b * sk.b + hk * sk.h, sk.s, k0, s_kv);
  load_bf16<D>(vs, v + b * sv.b + hk * sv.h, sv.s, k0, s_kv);

  FragC ak[NJ], av[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    wmma::fill_fragment(ak[j], 0.f);
    wmma::fill_fragment(av[j], 0.f);
  }

  const int nq = (s_q + BT - 1) / BT;
  const int first = first_q_tile(k0, offset, causal);
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const long long bh = static_cast<long long>(b) * hq + h;
    for (int qt = first; qt < nq; ++qt) {
      const int q0 = qt * BT;
      __syncthreads();  // every warp is done with the previous Q/dO tile
      load_bf16<D>(qs, q + b * sq.b + h * sq.h, sq.s, q0, s_q);
      load_bf16<D>(dos, dout + b * sd.b + h * sd.h, sd.s, q0, s_q);
      for (int r = tid; r < BT; r += NTC) {
        const int qr = q0 + r;
        lse_s[r] = qr < s_q ? lse[bh * s_q + qr] : pt::kNegInf;
        del_s[r] = qr < s_q ? delta[bh * s_q + qr] : 0.f;
      }
      __syncthreads();

      strip_abt<D>(sts + r0 * LDS, ks + r0 * LDH, qs);     // S^T  = K Q^T
      strip_abt<D>(dpts + r0 * LDS, vs + r0 * LDH, dos);   // dP^T = V dO^T
      __syncwarp();
      for (int r = r0; r < r0 + 16; ++r) {
        const int kc = k0 + r;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = lane + 32 * e;
          const bool vis = visible(q0 + col, kc, s_q, s_kv, offset, causal);
          const float p = prob(sts[r * LDS + col] * scale, lse_s[col], vis);
          pts[r * LDP + col] = __float2bfloat16(p);
          dsts[r * LDP + col] = __float2bfloat16(
              p * (dpts[r * LDS + col] - del_s[col]) * scale);
        }
      }
      __syncwarp();
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) {  // dV += P^T dO, dK += dS^T Q
        FragA fp, fd;
        wmma::load_matrix_sync(fp, pts + r0 * LDP + kk * 16, LDP);
        wmma::load_matrix_sync(fd, dsts + r0 * LDP + kk * 16, LDP);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          FragB fo, fq;
          wmma::load_matrix_sync(fo, dos + kk * 16 * LDH + j * 16, LDH);
          wmma::mma_sync(av[j], fp, fo, av[j]);
          wmma::load_matrix_sync(fq, qs + kk * 16 * LDH + j * 16, LDH);
          wmma::mma_sync(ak[j], fd, fq, ak[j]);
        }
      }
    }
  }
  __syncthreads();  // the staging rows overlay every warp's S^T/dP^T
  const long long base = (static_cast<long long>(b) * s_kv * hkv + hk) * D;
  const long long rs = static_cast<long long>(hkv) * D;
  store_strip<D>(ak, sts + r0 * LDO, dk + base, k0 + r0, s_kv, rs, lane);
  store_strip<D>(av, sts + r0 * LDO, dv + base, k0 + r0, s_kv, rs, lane);
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

template <int D>
int launch_dq(int dtype, const void* q, const void* k, const void* v,
              const void* o, const void* dout, const float* lse, void* dq,
              float* delta, int b, int s_q, int s_kv, int hq, int hkv,
              const Strides* st, float scale, int causal, cudaStream_t s) {
  dim3 grid((s_q + BT - 1) / BT, hq, b);
  const int group = hq / hkv;
  if (dtype == 0) {
    const size_t smem = F32Layout<D>::kBytes;
    int err = set_smem(dq_f32_kernel<D>, smem);
    if (err) return err;
    dq_f32_kernel<D><<<grid, NTF, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(o),
        static_cast<const float*>(dout), lse, static_cast<float*>(dq), delta,
        s_q, s_kv, hq, group, st[0], st[1], st[2], st[3], st[4], scale,
        causal);
  } else {
    const size_t smem = TcLayout<D>::kBytes;
    int err = set_smem(dq_bf16_kernel<D>, smem);
    if (err) return err;
    dq_bf16_kernel<D><<<grid, NTC, smem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(o),
        static_cast<const bf16*>(dout), lse, static_cast<bf16*>(dq), delta,
        s_q, s_kv, hq, group, st[0], st[1], st[2], st[3], st[4], scale,
        causal);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(int dtype, const void* q, const void* k, const void* v,
               const void* dout, const float* lse, const float* delta,
               void* dk, void* dv, int b, int s_q, int s_kv, int hq, int hkv,
               const Strides* st, float scale, int causal, cudaStream_t s) {
  dim3 grid((s_kv + BT - 1) / BT, hkv, b);
  const int group = hq / hkv;
  if (dtype == 0) {
    const size_t smem = F32Layout<D>::kBytes;
    int err = set_smem(dkv_f32_kernel<D>, smem);
    if (err) return err;
    dkv_f32_kernel<D><<<grid, NTF, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dk), static_cast<float*>(dv), s_q, s_kv,
        hq, hkv, group, st[0], st[1], st[2], st[4], scale, causal);
  } else {
    const size_t smem = TcLayout<D>::kBytes;
    int err = set_smem(dkv_bf16_kernel<D>, smem);
    if (err) return err;
    dkv_bf16_kernel<D><<<grid, NTC, smem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
        delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), s_q, s_kv,
        hq, hkv, group, st[0], st[1], st[2], st[4], scale, causal);
  }
  return static_cast<int>(cudaGetLastError());
}

void unpack(const long long* flat, Strides* st) {
  for (int i = 0; i < 5; ++i) st[i] = Strides{flat[3 * i], flat[3 * i + 1],
                                               flat[3 * i + 2]};
}

}  // namespace

// K2. q/o/dout [b, s_q, hq, d] and k/v [b, s_kv, hkv, d] read through the
// element strides in `strides` (15 values: batch, seq, head of q, k, v, o,
// dout in that order; head_dim contiguous); lse [b, hq, s_q] fp32; writes
// dq [b, s_q, hq, d] contiguous and delta [b, hq, s_q] fp32 (scratch for
// K3). dtype: 0 = float32, 1 = bfloat16 (16-byte aligned pointers, strides
// multiples of 8). Returns the launch's cudaError_t.
extern "C" int paddle_flash_bwd_dq(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* dq, void* delta, int dtype, int b,
                                   int s_q, int s_kv, int hq, int hkv, int d,
                                   const long long* strides, float scale,
                                   int causal, void* stream) {
  Strides st[5];
  unpack(strides, st);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (d == 64)
    return launch_dq<64>(dtype, q, k, v, o, dout, l, dq, dl, b, s_q, s_kv,
                         hq, hkv, st, scale, causal, s);
  if (d == 128)
    return launch_dq<128>(dtype, q, k, v, o, dout, l, dq, dl, b, s_q, s_kv,
                          hq, hkv, st, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K3. Same operands and stride layout as K2 (the o strides are unused);
// delta is K2's output; writes dk and dv [b, s_kv, hkv, d] contiguous.
extern "C" int paddle_flash_bwd_dkv(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dk, void* dv, int dtype, int b,
                                    int s_q, int s_kv, int hq, int hkv, int d,
                                    const long long* strides, float scale,
                                    int causal, void* stream) {
  Strides st[5];
  unpack(strides, st);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (d == 64)
    return launch_dkv<64>(dtype, q, k, v, dout, l, dl, dk, dv, b, s_q, s_kv,
                          hq, hkv, st, scale, causal, s);
  if (d == 128)
    return launch_dkv<128>(dtype, q, k, v, dout, l, dl, dk, dv, b, s_q, s_kv,
                           hq, hkv, st, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
