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
// What bounds them on the H100: K2 does 6 * head_dim and K3 8 * head_dim
// operations per visible (q, k) pair and head (three and four products)
// over a few MB of inputs, so at the training shape ([2, 4096, 16 q / 4 kv
// heads, 128], causal) both are bounded by the bf16 tensor cores, far above
// the line where HBM would limit them. At BERT fine-tuning's [32, 128,
// 12 / 12, 64], non-causal, both are bounded by HBM (0.0114 ms each). fp16
// has bf16's size and tensor-core rate: the same bounds.
//
// fp16 (AMP's `auto_cast(dtype="float16")`; the TPU kernels compute in
// whatever float dtype they are given): the bf16 kernels instantiated on
// __half (element type T of the tensor maps, the .f16 wgmma forms, the P
// and dS packing, the dO . O prologue and the stores). dS is rounded to T
// before dQ = dS K and dK = dS^T Q. Under a loss scale (GradScaler's 2^15)
// a dS past 65504 rounds to inf in fp16 where bf16 would hold it: dQ and
// dK then carry inf (or NaN, inf times a zero), never a finite wrong
// value, and the scaler's finiteness check sees it and skips the step.
//
// What the bf16 (and fp16) design does about it (TMA + wgmma; helpers in
// hopper.cuh):
//  - 384 threads a block: a producer warpgroup and two consumer warpgroups
//    of 64 rows each. One producer thread loads the block's resident tiles
//    once and streams the other operands' 64-row tiles through a ring of
//    NST stages in shared memory, by TMA, behind full/empty mbarriers; the
//    consumers only compute. Every barrier wait is bounded and traps.
//    setmaxnreg moves registers from the producer to the consumers (K2: 24
//    and 240, K3: 40 and 232; the splits timed fastest on the card): K3 at
//    head_dim 128 holds dK, dV, S^T and dP^T (192 fp32) at once, above the
//    168 a thread of a 384-thread block is launched with.
//  - Each operand arrives through one 4-D tensor map over [b, s, h, d] built
//    from the tensor's strides, as 128-byte-swizzled panels of 64 head_dim
//    columns (head_dim 128 is two panels). A box past a sequence's end reads
//    zeros, never another batch's or head's rows.
//  - All products run on wgmma with fp32 accumulators in registers. The S
//    and dP accumulators become P and dS in registers and, rounded to bf16,
//    the register A operand of the next product: P and dS never touch shared
//    or device memory.
//  - K2: one block per (128 q rows, q head); Q and dO resident, K/V tiles of
//    64 rows streamed. S = Q K^T and dP = dO V^T (both operands K-major),
//    then dQ += dS K with K read MN-major from the same tile. d is computed
//    in the prologue from the stored O and written for K3.
//  - K3: one block per (128 k rows, kv head); K and V resident, Q and dO
//    tiles of 64 rows streamed for each q head of the group from the first
//    causal tile, with lse and d staged beside them by the producer warp.
//    S^T = K Q^T and dP^T = V dO^T are computed directly, so P^T and dS^T
//    come out in the layout the register A operand needs (no transpose goes
//    through shared memory); then dV += P^T dO and dK += dS^T Q (MN-major B).
//  - The heaviest causal tiles launch first (K2: the last q tiles; K3: the
//    first k tiles) over a flattened grid. The mask is applied only on tiles
//    that cross the causal diagonal and on K2's ragged last kv tile (a
//    zero-filled K row gives s = 0, so P would be exp(-lse), not 0); a tile
//    wholly in a warpgroup's causal future is skipped. A row with lse <=
//    NEG_INF / 2 gets lse = +inf, so P = exp2(s scale log2(e) - lse log2(e))
//    is 0 there with no test per element.
//  - No atomics and no carry across blocks: each output element is summed
//    by one warpgroup in a fixed order, so results are identical run to run.
//    K3 is launched after K2 on the same stream.
// Modes, template parameters of all four kernels: MODE, the masks of
// flash_mask.cuh (segment ids or per-kv-column row bounds, `with_seg` /
// `with_rowmask` of the TPU kernels), masks every tile it computes (the
// causal skips stay); K2 reads a kv tile's ids or bounds while its products
// run, K3 keeps its k rows' ids or bounds in registers and reads a streamed
// q tile's ids the same way. GLSE (K2 only, `with_glse`): the cotangent
// g_lse of the forward's lse output, from `flash_attention_with_lse` :757,
// enters the prologue only, d = rowsum(dO * O) - g_lse, which K3 then
// reads; the lse guard above keeps rows that saw no key at P = 0 whatever
// d carries. MODE none without GLSE is the code above.
// fp32 runs on FMAs (256 threads, 64-row tiles, 4 x 4 score tiles and 4-row
// accumulator strips per thread) so its 1e-4 tolerance holds; it carries the
// card-vs-CPU parity checks. K2 has one block per (64-row q tile, q head,
// batch) and K3 one per (64-row k tile, kv head, batch), with the same
// causal skips; q, k, v, O and dO are read through their [b, s, h, d]
// strides on both paths.
#include <stdint.h>

#include "common.cuh"
#include "flash_mask.cuh"
#include "hopper.cuh"

namespace {

constexpr int BT = 64;    // rows per tile, fp32 (q and k)
constexpr int NTF = 256;  // threads per block, fp32 (16 x 16 groups)

// Strides of one [b, s, h, d] operand (elements).
struct Strides {
  long long b, s, h;
};

template <int MODE>
__device__ __forceinline__ bool visible(int qr, int kc, int s_q, int s_kv,
                                        int offset, int causal,
                                        const fmask::View& mv) {
  return qr < s_q && kc < s_kv && !(causal && qr + offset < kc) &&
         !fmask::hidden<MODE>(mv, qr, kc);
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

template <int D, int MODE, bool GLSE>
__global__ void __launch_bounds__(NTF)
dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ o,
              const float* __restrict__ dout, const float* __restrict__ lse,
              float* __restrict__ dq, float* __restrict__ delta, int s_q,
              int s_kv, int hq, int group, Strides sq, Strides sk, Strides sv,
              Strides so, Strides sd, float scale, int causal,
              fmask::Args ma, const float* __restrict__ glse) {
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
  const fmask::View mv = fmask::view<MODE>(ma, b, hk, s_q, s_kv);

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
        if constexpr (GLSE) {  // the lse cotangent: delta -= g_lse
          if (qr < s_q) acc -= glse[bh * s_q + qr];
        }
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
        const bool vis = visible<MODE>(q0 + row, k0 + col, s_q, s_kv, offset,
                                       causal, mv);
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

template <int D, int MODE>
__global__ void __launch_bounds__(NTF)
dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dk, float* __restrict__ dv, int s_q,
               int s_kv, int hq, int hkv, int group, Strides sq, Strides sk,
               Strides sv, Strides sd, float scale, int causal,
               fmask::Args ma) {
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
  const fmask::View mv = fmask::view<MODE>(ma, b, hk, s_q, s_kv);

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
          const bool vis = visible<MODE>(q0 + col, k0 + row, s_q, s_kv,
                                         offset, causal, mv);
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

// ---- bf16 and fp16: TMA + wgmma ---------------------------------------------
using namespace hopper;

constexpr int RB = 128;      // rows a block owns: q rows (K2), k rows (K3)
constexpr int SB = 64;       // rows a streamed tile: kv rows (K2), q rows (K3)
constexpr int NST = 2;       // stages of the ring
constexpr int NTC = 384;     // the producer warpgroup + two consumer ones
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory: two resident operands of RB rows, NST stages of two
// streamed operands of SB rows (each operand D / 64 panels of 128-byte
// rows), a vector area (K2: d of the block's rows; K3: lse and d of each
// stage's q rows), the mbarriers, and slack to align the panels to 1024.
template <int D>
struct TcLayout {
  static constexpr int RES_PANEL = RB * 128;
  static constexpr int RES = (D / 64) * RES_PANEL;
  static constexpr int TILE_PANEL = SB * 128;
  static constexpr int TILE = (D / 64) * TILE_PANEL;
  static constexpr int STAGE = 2 * TILE;
  static constexpr int VEC = NST * 2 * SB * 4;
  static constexpr int BARS = 2 * NST + 1;  // full, empty, resident
  static constexpr int kBytes = 2 * RES + NST * STAGE + VEC + BARS * 8 + 1024;
  static_assert(RB * 4 <= VEC, "K2's row vector fits");
};

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// lse as the exponent base-2 offset; +inf for a row that saw no key (or
// lies past the sequence), so that exp2(x - it) = 0 there.
__device__ __forceinline__ float lse_log2(float lv) {
  return lv > 0.5f * pt::kNegInf ? lv * kLog2e : inf_f();
}

// Number of SB-row kv tiles that q rows up to q_last can see.
__device__ __forceinline__ int kv_tiles(int q_last, int s_kv, int offset,
                                        int causal) {
  int n = (s_kv + SB - 1) / SB;
  if (causal) {
    const int lk = q_last + offset;
    n = lk < 0 ? 0 : min(n, lk / SB + 1);
  }
  return n;
}

// d (+)= A B over the head_dim D for a 64 x 64 tile: A = 64 rows of a
// resident operand (warpgroup cw's rows), B = a streamed SB-row tile, both
// K-major, elements T.
template <typename T, int D>
__device__ __forceinline__ void product_res_tile(float (&d)[32],
                                                 const unsigned char* res,
                                                 const unsigned char* tile,
                                                 int cw) {
  using L = TcLayout<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64<T>(
        d, kmajor_desc(res + (kk / 4) * L::RES_PANEL + cw * 64 * 128, kk % 4),
        kmajor_desc(tile + (kk / 4) * L::TILE_PANEL, kk % 4), 1);
}

// The register A operand (elements T) of a 64 x SB accumulator, by 16-deep
// step.
template <typename T>
__device__ __forceinline__ void pack_tile(const float (&x)[32],
                                          uint32_t (&a)[SB / 16][4]) {
#pragma unroll
  for (int j = 0; j < SB / 16; ++j) pack_a<T>(x, j, a[j]);
}

// d += A B over SB rows: A from registers (pack_tile), B = a streamed
// SB x D tile read MN-major.
template <typename T, int D>
__device__ __forceinline__ void product_reg_tile(float (&d)[D / 2],
                                                 const uint32_t (&a)[SB / 16][4],
                                                 const unsigned char* tile) {
#pragma unroll
  for (int j = 0; j < SB / 16; ++j) {
    const uint64_t db = mnmajor_desc(tile, j, TcLayout<D>::TILE_PANEL);
    if constexpr (D == 64)
      wgmma_rs_n64<T>(d, a[j], db);
    else
      wgmma_rs_n128<T>(d, a[j], db);
  }
}

// K2. Grid: one block per (RB-row q tile, q head, batch), flattened with the
// last q tiles first. Tensor maps: mq, mdo box {64, 1, RB, 1}; mk, mv box
// {64, 1, SB, 1}. MODE: the mask beyond the causal one (flash_mask.cuh; a
// masked mode masks every tile); GLSE: subtract the lse cotangent glse
// [b, hq, s_q] from delta. T: the element type (bf16 or fp16).
template <typename T, int D, int MODE, bool GLSE>
__global__ void __launch_bounds__(NTC, 1)
dq_tc_kernel(const __grid_constant__ CUtensorMap mq,
             const __grid_constant__ CUtensorMap mk,
             const __grid_constant__ CUtensorMap mv,
             const __grid_constant__ CUtensorMap mdo,
             const T* __restrict__ o, const T* __restrict__ dout,
             const float* __restrict__ lse, T* __restrict__ dq,
             float* __restrict__ delta, int batch, int s_q, int s_kv, int hq,
             int group, Strides so, Strides sd, float scale, int causal,
             fmask::Args ma, const float* __restrict__ glse) {
  using L = TcLayout<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* qs = align_1024(smem_raw);  // resident Q
  unsigned char* dos = qs + L::RES;          // resident dO
  unsigned char* ring = dos + L::RES;        // stages of (K, V)
  float* dls = reinterpret_cast<float*>(ring + NST * L::STAGE);  // d [RB]
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + NST * L::STAGE + L::VEC);
  uint64_t* empty = full + NST;
  uint64_t* res = empty + NST;

  const int per = hq * batch;
  const int qt = (s_q + RB - 1) / RB - 1 - static_cast<int>(blockIdx.x) / per;
  const int h = blockIdx.x % per % hq, b = blockIdx.x % per / hq;
  const int hk = h / group, offset = s_kv - s_q, q0 = qt * RB;
  const int nk = kv_tiles(q0 + RB - 1, s_kv, offset, causal);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < NST; ++s) {
      bar_init(&full[s], 1);   // the producer's arrive + the tile bytes
      bar_init(&empty[s], 2);  // one arrive per consumer warpgroup
    }
    bar_init(res, 1);
    bar_init_fence();
  }
  __syncthreads();

  if (tid < 128) {  // producer: one thread issues the loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      bar_expect_tx(res, 2 * L::RES);
      for (int j = 0; j < D / 64; ++j) {
        tma_4d(qs + j * L::RES_PANEL, &mq, 64 * j, h, q0, b, res);
        tma_4d(dos + j * L::RES_PANEL, &mdo, 64 * j, h, q0, b, res);
      }
      for (int it = 0; it < nk; ++it) {
        const int s = it % NST;
        bar_wait(&empty[s], ((it / NST) & 1) ^ 1);
        unsigned char* ks = ring + s * L::STAGE;
        bar_expect_tx(&full[s], L::STAGE);
        for (int j = 0; j < D / 64; ++j) {
          tma_4d(ks + j * L::TILE_PANEL, &mk, 64 * j, hk, it * SB, b,
                 &full[s]);
          tma_4d(ks + L::TILE + j * L::TILE_PANEL, &mv, 64 * j, hk, it * SB,
                 b, &full[s]);
        }
      }
    }
    return;
  }

  // consumers: warpgroup 1 + cw owns q rows r0 .. r0 + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = tid / 128 - 1, t = tid % 128, w = t / 32, l = t % 32;
  const int r0 = q0 + 64 * cw;
  const long long bh = static_cast<long long>(b) * hq + h;
  {  // d = rowsum(dO * O) from the stored O, two threads a row
    const int rr = t >> 1, row = r0 + rr, c0 = (t & 1) * (D / 2);
    float acc = 0.f;
    if (row < s_q) {
      const T* orow = o + b * so.b + h * so.h + row * so.s + c0;
      const T* drow = dout + b * sd.b + h * sd.h + row * sd.s + c0;
#pragma unroll
      for (int c = 0; c < D / 2; c += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(drow + c);
        const uint32_t* o2 = reinterpret_cast<const uint32_t*>(&ov);
        const uint32_t* d2 = reinterpret_cast<const uint32_t*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = Elem<T>::unpack(o2[e]);
          const float2 df = Elem<T>::unpack(d2[e]);
          acc = fmaf(df.x, of.x, acc);
          acc = fmaf(df.y, of.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((t & 1) == 0) {
      if constexpr (GLSE) {  // the lse cotangent: delta -= g_lse
        if (row < s_q) acc -= glse[bh * s_q + row];
      }
      dls[64 * cw + rr] = acc;
      if (row < s_q) delta[bh * s_q + row] = acc;
    }
  }
  named_bar_sync(1 + cw, 128);

  // this thread's two accumulator rows (hopper.cuh's layout)
  int rows[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int rr = 16 * w + l / 4 + 8 * e;
    rows[e] = r0 + rr;
    lse2[e] = lse_log2(rows[e] < s_q ? lse[bh * s_q + rows[e]] : pt::kNegInf);
    dl[e] = dls[64 * cw + rr];
  }
  const fmask::View mview = fmask::view<MODE>(ma, b, hk, s_q, s_kv);
  const int ids[2] = {fmask::row_id<MODE>(mview, rows[0], s_q),
                      fmask::row_id<MODE>(mview, rows[1], s_q)};
  const float sc2 = scale * kLog2e;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  bar_wait(res, 0);
  for (int it = 0; it < nk; ++it) {
    const int s = it % NST, k0 = it * SB;
    bar_wait(&full[s], (it / NST) & 1);
    if (!(causal && r0 + 63 + offset < k0)) {  // not wholly in the future
      const unsigned char* ks = ring + s * L::STAGE;
      const unsigned char* vs = ks + L::TILE;
      float sv[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sv[i] = dp[i] = 0.f;
      fence_regs(sv);
      fence_regs(dp);
      wgmma_fence();
      product_res_tile<T, D>(sv, qs, ks, cw);   // S  = Q K^T
      product_res_tile<T, D>(dp, dos, vs, cw);  // dP = dO V^T
      wgmma_commit();
      fmask::KvCols<MODE> cols;  // the tile's ids, read while S, dP run
      cols.load(mview, k0, s_kv, l);
      wgmma_wait0();
      fence_regs(sv);
      fence_regs(dp);
      if constexpr (MODE == fmask::kNone) {
        const bool mask =
            (causal && r0 + offset < k0 + SB - 1) || k0 + SB > s_kv;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int e = (i >> 1) & 1;
          float p = exp2f(fmaf(sv[i], sc2, -lse2[e]));
          if (mask) {
            const int kc = k0 + 8 * (i >> 2) + 2 * (l % 4) + (i & 1);
            if (kc >= s_kv || (causal && rows[e] + offset < kc)) p = 0.f;
          }
          sv[i] = p * (dp[i] - dl[e]) * scale;  // dS
        }
      } else {  // a masked mode masks every tile
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int e = (i >> 1) & 1;
          const int kc = k0 + 8 * (i >> 2) + 2 * (l % 4) + (i & 1);
          float p = exp2f(fmaf(sv[i], sc2, -lse2[e]));
          if (kc >= s_kv || (causal && rows[e] + offset < kc) ||
              cols.hidden(i, ids[e], rows[e]))
            p = 0.f;
          sv[i] = p * (dp[i] - dl[e]) * scale;  // dS
        }
      }
      uint32_t a[SB / 16][4];
      pack_tile<T>(sv, a);
      fence_regs(acc);
      wgmma_fence();
      product_reg_tile<T, D>(acc, a, ks);  // dQ += dS K
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
    }
    if (t == 0) bar_arrive(&empty[s]);  // this stage may be refilled
  }
  store_rows<D, T>(acc, dq + (static_cast<long long>(b) * s_q * hq + h) * D,
                   rows, s_q, static_cast<long long>(hq) * D, l);
}

// K3. Grid: one block per (RB-row k tile, kv head, batch), flattened with
// the first k tiles first. Tensor maps: mk, mv box {64, 1, RB, 1}; mq, mdo
// box {64, 1, SB, 1}. MODE as K2's: the block's kv ids or row bounds stay
// in registers; a streamed q tile's ids are read while its S^T runs. T as
// K2's.
template <typename T, int D, int MODE>
__global__ void __launch_bounds__(NTC, 1)
dkv_tc_kernel(const __grid_constant__ CUtensorMap mq,
              const __grid_constant__ CUtensorMap mk,
              const __grid_constant__ CUtensorMap mv,
              const __grid_constant__ CUtensorMap mdo,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dk, T* __restrict__ dv, int batch,
              int s_q, int s_kv, int hq, int hkv, int group, float scale,
              int causal, fmask::Args ma) {
  using L = TcLayout<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ks = align_1024(smem_raw);  // resident K
  unsigned char* vs = ks + L::RES;           // resident V
  unsigned char* ring = vs + L::RES;         // stages of (Q, dO)
  float* lzs = reinterpret_cast<float*>(ring + NST * L::STAGE);  // [NST][SB]
  float* dzs = lzs + NST * SB;                                     // [NST][SB]
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + NST * L::STAGE + L::VEC);
  uint64_t* empty = full + NST;
  uint64_t* res = empty + NST;

  const int per = hkv * batch;
  const int kt = blockIdx.x / per;
  const int hk = blockIdx.x % per % hkv, b = blockIdx.x % per / hkv;
  const int offset = s_kv - s_q, k0 = kt * RB;
  const int nq = (s_q + SB - 1) / SB;
  const int first = (causal && k0 > offset) ? (k0 - offset) / SB : 0;
  const int per_head = max(nq - first, 0), total = group * per_head;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < NST; ++s) {
      bar_init(&full[s], 32);  // the producer warp's lanes + the tile bytes
      bar_init(&empty[s], 2);  // one arrive per consumer warpgroup
    }
    bar_init(res, 1);
    bar_init_fence();
  }
  __syncthreads();

  if (tid < 128) {  // producer: warp 0 stages lse and d, lane 0 the tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid >= 32) return;
    const int lane = tid;
    if (lane == 0) {
      bar_expect_tx(res, 2 * L::RES);
      for (int j = 0; j < D / 64; ++j) {
        tma_4d(ks + j * L::RES_PANEL, &mk, 64 * j, hk, k0, b, res);
        tma_4d(vs + j * L::RES_PANEL, &mv, 64 * j, hk, k0, b, res);
      }
    }
    for (int it = 0; it < total; ++it) {
      const int s = it % NST, h = hk * group + it / per_head;
      const int q0 = (first + it % per_head) * SB;
      const long long bh = static_cast<long long>(b) * hq + h;
      bar_wait(&empty[s], ((it / NST) & 1) ^ 1);
      for (int c = lane; c < SB; c += 32) {
        const int qr = q0 + c;
        lzs[s * SB + c] = lse_log2(qr < s_q ? lse[bh * s_q + qr] : pt::kNegInf);
        dzs[s * SB + c] = qr < s_q ? delta[bh * s_q + qr] : 0.f;
      }
      if (lane == 0) {  // after its own row writes: its arrive releases them
        unsigned char* qs = ring + s * L::STAGE;
        bar_expect_tx(&full[s], L::STAGE);
        for (int j = 0; j < D / 64; ++j) {
          tma_4d(qs + j * L::TILE_PANEL, &mq, 64 * j, h, q0, b, &full[s]);
          tma_4d(qs + L::TILE + j * L::TILE_PANEL, &mdo, 64 * j, h, q0, b,
                 &full[s]);
        }
      } else {
        bar_arrive(&full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup 1 + cw owns k rows kr0 .. kr0 + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = tid / 128 - 1, t = tid % 128, w = t / 32, l = t % 32;
  const int kr0 = k0 + 64 * cw;
  const int krow[2] = {kr0 + 16 * w + l / 4, kr0 + 16 * w + l / 4 + 8};
  const fmask::View mview = fmask::view<MODE>(ma, b, hk, s_q, s_kv);
  // this thread's two k rows: their kv ids (kSeg) or row bounds (kRow)
  int kid[2] = {0, 0}, kst[2] = {0, 0}, ken[2] = {0, 0};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int kr = min(krow[e], s_kv - 1);
    if constexpr (MODE == fmask::kSeg) kid[e] = __ldg(mview.kv_seg + kr);
    if constexpr (MODE == fmask::kRow) {
      kst[e] = __ldg(mview.start + kr);
      ken[e] = __ldg(mview.end + kr);
    }
  }
  const float sc2 = scale * kLog2e;
  float ak[D / 2], av[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) ak[i] = av[i] = 0.f;

  bar_wait(res, 0);
  for (int it = 0; it < total; ++it) {
    const int s = it % NST, q0 = (first + it % per_head) * SB;
    bar_wait(&full[s], (it / NST) & 1);
    if (!(causal && q0 + SB - 1 + offset < kr0)) {  // not wholly in the past
      const unsigned char* qs = ring + s * L::STAGE;
      const unsigned char* dos = qs + L::TILE;
      const float* lz = lzs + s * SB;
      const float* dz = dzs + s * SB;
      float sv[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sv[i] = 0.f;
      fence_regs(sv);
      wgmma_fence();
      product_res_tile<T, D>(sv, ks, qs, cw);  // S^T = K Q^T
      wgmma_commit();
      int qid[16];  // kSeg: the q tile's ids, read while S^T runs
      if constexpr (MODE == fmask::kSeg)
        fmask::load_cols(qid, mview.q_seg, q0, s_q, l);
      wgmma_wait0();
      fence_regs(sv);
      const bool mask = causal && q0 + offset < kr0 + 63;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * (i >> 2) + 2 * (l % 4) + (i & 1);
        const int e = (i >> 1) & 1;
        float p = exp2f(fmaf(sv[i], sc2, -lz[col]));
        if constexpr (MODE == fmask::kNone) {
          if (mask && q0 + col + offset < krow[e]) p = 0.f;
        } else {
          bool drop = causal && q0 + col + offset < krow[e];
          if constexpr (MODE == fmask::kSeg)
            drop = drop || qid[fmask::col_slot(i)] != kid[e];
          if constexpr (MODE == fmask::kRow)
            drop = drop || (q0 + col >= kst[e] && q0 + col < ken[e]);
          if (drop) p = 0.f;
        }
        sv[i] = p;  // P^T
      }
      uint32_t a[SB / 16][4];
      pack_tile<T>(sv, a);
      float dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) dp[i] = 0.f;
      fence_regs(av);
      fence_regs(dp);
      wgmma_fence();
      product_reg_tile<T, D>(av, a, dos);       // dV += P^T dO
      product_res_tile<T, D>(dp, vs, dos, cw);  // dP^T = V dO^T
      wgmma_commit();
      wgmma_wait0();
      fence_regs(av);
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * (i >> 2) + 2 * (l % 4) + (i & 1);
        sv[i] = sv[i] * (dp[i] - dz[col]) * scale;  // dS^T
      }
      pack_tile<T>(sv, a);
      fence_regs(ak);
      wgmma_fence();
      product_reg_tile<T, D>(ak, a, qs);  // dK += dS^T Q
      wgmma_commit();
      wgmma_wait0();
      fence_regs(ak);
    }
    if (t == 0) bar_arrive(&empty[s]);  // this stage may be refilled
  }
  const long long base = static_cast<long long>(b) * s_kv * hkv + hk;
  const long long rs = static_cast<long long>(hkv) * D;
  store_rows<D, T>(ak, dk + base * D, krow, s_kv, rs, l);
  store_rows<D, T>(av, dv + base * D, krow, s_kv, rs, l);
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

// K2 on the tensor cores, elements T.
template <typename T, int D, int MODE, bool GLSE>
int launch_dq_tc(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, void* dq, float* delta,
                 int b, int s_q, int s_kv, int hq, int hkv, const Strides* st,
                 float scale, int causal, const fmask::Args& ma,
                 const float* glse, cudaStream_t s) {
  CUtensorMap mq, mk, mv, mdo;
  int err;
  if ((err = map_bshd<T>(&mq, q, b, s_q, hq, D, st[0].b, st[0].s, st[0].h,
                         RB))) return err;
  if ((err = map_bshd<T>(&mk, k, b, s_kv, hkv, D, st[1].b, st[1].s, st[1].h,
                         SB))) return err;
  if ((err = map_bshd<T>(&mv, v, b, s_kv, hkv, D, st[2].b, st[2].s, st[2].h,
                         SB))) return err;
  if ((err = map_bshd<T>(&mdo, dout, b, s_q, hq, D, st[4].b, st[4].s,
                         st[4].h, RB))) return err;
  const size_t smem = TcLayout<D>::kBytes;
  if ((err = set_smem(dq_tc_kernel<T, D, MODE, GLSE>, smem))) return err;
  const int blocks = (s_q + RB - 1) / RB * hq * b;
  dq_tc_kernel<T, D, MODE, GLSE><<<blocks, NTC, smem, s>>>(
      mq, mk, mv, mdo, static_cast<const T*>(o), static_cast<const T*>(dout),
      lse, static_cast<T*>(dq), delta, b, s_q, s_kv, hq, hq / hkv, st[3],
      st[4], scale, causal, ma, glse);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int MODE, bool GLSE>
int launch_dq(int dtype, const void* q, const void* k, const void* v,
              const void* o, const void* dout, const float* lse, void* dq,
              float* delta, int b, int s_q, int s_kv, int hq, int hkv,
              const Strides* st, float scale, int causal,
              const fmask::Args& ma, const float* glse, cudaStream_t s) {
  const int group = hq / hkv;
  if (dtype == 0) {
    dim3 grid((s_q + BT - 1) / BT, hq, b);
    const size_t smem = F32Layout<D>::kBytes;
    int err = set_smem(dq_f32_kernel<D, MODE, GLSE>, smem);
    if (err) return err;
    dq_f32_kernel<D, MODE, GLSE><<<grid, NTF, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(o),
        static_cast<const float*>(dout), lse, static_cast<float*>(dq), delta,
        s_q, s_kv, hq, group, st[0], st[1], st[2], st[3], st[4], scale,
        causal, ma, glse);
  } else if (dtype == 1) {
    return launch_dq_tc<__nv_bfloat16, D, MODE, GLSE>(q, k, v, o, dout, lse, dq, delta, b, s_q, s_kv, hq, hkv, st, scale, causal, ma, glse, s);
  } else if (dtype == 2) {
    return launch_dq_tc<__half, D, MODE, GLSE>(q, k, v, o, dout, lse, dq, delta, b, s_q, s_kv, hq, hkv, st, scale, causal, ma, glse, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K3 on the tensor cores, elements T.
template <typename T, int D, int MODE>
int launch_dkv_tc(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dk, void* dv, int b, int s_q, int s_kv, int hq,
                  int hkv, const Strides* st, float scale, int causal,
                  const fmask::Args& ma, cudaStream_t s) {
  CUtensorMap mq, mk, mv, mdo;
  int err;
  if ((err = map_bshd<T>(&mq, q, b, s_q, hq, D, st[0].b, st[0].s, st[0].h,
                         SB))) return err;
  if ((err = map_bshd<T>(&mk, k, b, s_kv, hkv, D, st[1].b, st[1].s, st[1].h,
                         RB))) return err;
  if ((err = map_bshd<T>(&mv, v, b, s_kv, hkv, D, st[2].b, st[2].s, st[2].h,
                         RB))) return err;
  if ((err = map_bshd<T>(&mdo, dout, b, s_q, hq, D, st[4].b, st[4].s,
                         st[4].h, SB))) return err;
  const size_t smem = TcLayout<D>::kBytes;
  if ((err = set_smem(dkv_tc_kernel<T, D, MODE>, smem))) return err;
  const int blocks = (s_kv + RB - 1) / RB * hkv * b;
  dkv_tc_kernel<T, D, MODE><<<blocks, NTC, smem, s>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      b, s_q, s_kv, hq, hkv, hq / hkv, scale, causal, ma);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int MODE>
int launch_dkv(int dtype, const void* q, const void* k, const void* v,
               const void* dout, const float* lse, const float* delta,
               void* dk, void* dv, int b, int s_q, int s_kv, int hq, int hkv,
               const Strides* st, float scale, int causal,
               const fmask::Args& ma, cudaStream_t s) {
  const int group = hq / hkv;
  if (dtype == 0) {
    dim3 grid((s_kv + BT - 1) / BT, hkv, b);
    const size_t smem = F32Layout<D>::kBytes;
    int err = set_smem(dkv_f32_kernel<D, MODE>, smem);
    if (err) return err;
    dkv_f32_kernel<D, MODE><<<grid, NTF, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dk), static_cast<float*>(dv), s_q, s_kv,
        hq, hkv, group, st[0], st[1], st[2], st[4], scale, causal, ma);
  } else if (dtype == 1) {
    return launch_dkv_tc<__nv_bfloat16, D, MODE>(q, k, v, dout, lse, delta, dk, dv, b, s_q, s_kv, hq, hkv, st, scale, causal, ma, s);
  } else if (dtype == 2) {
    return launch_dkv_tc<__half, D, MODE>(q, k, v, dout, lse, delta, dk, dv, b, s_q, s_kv, hq, hkv, st, scale, causal, ma, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

void unpack(const long long* flat, Strides* st) {
  for (int i = 0; i < 5; ++i) st[i] = Strides{flat[3 * i], flat[3 * i + 1],
                                               flat[3 * i + 2]};
}

// The mask mode of a launch's operands (-1: an invalid combination).
int mask_mode(const fmask::Args& ma) {
  const bool seg = ma.q_seg != nullptr, row = ma.start != nullptr;
  if (seg && row) return -1;
  if (seg) return ma.kv_seg != nullptr ? fmask::kSeg : -1;
  if (row) return (ma.end != nullptr && ma.hm >= 1) ? fmask::kRow : -1;
  return fmask::kNone;
}

template <int D>
int dq_mode(int mode, int dtype, const void* q, const void* k, const void* v,
            const void* o, const void* dout, const float* lse, void* dq,
            float* delta, int b, int s_q, int s_kv, int hq, int hkv,
            const Strides* st, float scale, int causal,
            const fmask::Args& ma, const float* glse, cudaStream_t s) {
  if (mode == fmask::kNone && glse == nullptr)
    return launch_dq<D, fmask::kNone, false>(dtype, q, k, v, o, dout, lse, dq, delta, b, s_q, s_kv, hq, hkv, st, scale, causal, ma, glse, s);
  if (mode == fmask::kNone)
    return launch_dq<D, fmask::kNone, true>(dtype, q, k, v, o, dout, lse, dq, delta, b, s_q, s_kv, hq, hkv, st, scale, causal, ma, glse, s);
  if (glse != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (mode == fmask::kSeg)
    return launch_dq<D, fmask::kSeg, false>(dtype, q, k, v, o, dout, lse, dq, delta, b, s_q, s_kv, hq, hkv, st, scale, causal, ma, glse, s);
  return launch_dq<D, fmask::kRow, false>(dtype, q, k, v, o, dout, lse, dq, delta, b, s_q, s_kv, hq, hkv, st, scale, causal, ma, glse, s);
}

template <int D>
int dkv_mode(int mode, int dtype, const void* q, const void* k,
             const void* v, const void* dout, const float* lse,
             const float* delta, void* dk, void* dv, int b, int s_q,
             int s_kv, int hq, int hkv, const Strides* st, float scale,
             int causal, const fmask::Args& ma, cudaStream_t s) {
  if (mode == fmask::kSeg)
    return launch_dkv<D, fmask::kSeg>(dtype, q, k, v, dout, lse, delta, dk, dv, b, s_q, s_kv, hq, hkv, st, scale, causal, ma, s);
  if (mode == fmask::kRow)
    return launch_dkv<D, fmask::kRow>(dtype, q, k, v, dout, lse, delta, dk, dv, b, s_q, s_kv, hq, hkv, st, scale, causal, ma, s);
  return launch_dkv<D, fmask::kNone>(dtype, q, k, v, dout, lse, delta, dk, dv, b, s_q, s_kv, hq, hkv, st, scale, causal, ma, s);
}

}  // namespace

// K2. q/o/dout [b, s_q, hq, d] and k/v [b, s_kv, hkv, d] read through the
// element strides in `strides` (15 values: batch, seq, head of q, k, v, o,
// dout in that order; head_dim contiguous); lse [b, hq, s_q] fp32; writes
// dq [b, s_q, hq, d] contiguous and delta [b, hq, s_q] fp32 (scratch for
// K3). g_lse [b, hq, s_q] fp32, the cotangent of the forward's lse output,
// or null: delta = rowsum(dout o) - g_lse. Masks as paddle_flash_fwd's
// (flash_mask.cuh): q_seg/kv_seg, or start/end with hm, or all null; g_lse
// only without a mask. dtype: 0 = float32, 1 = bfloat16, 2 = float16 (1
// and 2: 16-byte aligned pointers, strides multiples of 8). Returns the
// launch's cudaError_t (bf16, fp16: cudaErrorNotSupported without the
// driver's tensor-map encoder, cudaErrorInvalidValue if it refuses an
// operand's strides).
extern "C" int paddle_flash_bwd_dq(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* dq, void* delta, const void* g_lse,
                                   const void* q_seg, const void* kv_seg,
                                   const void* start, const void* end, int hm,
                                   int dtype, int b,
                                   int s_q, int s_kv, int hq, int hkv, int d,
                                   const long long* strides, float scale,
                                   int causal, void* stream) {
  Strides st[5];
  unpack(strides, st);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const float* gl = static_cast<const float*>(g_lse);
  const fmask::Args ma{static_cast<const int*>(q_seg),
                       static_cast<const int*>(kv_seg),
                       static_cast<const int*>(start),
                       static_cast<const int*>(end), hm};
  const int mode = mask_mode(ma);
  if (mode < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (d == 64)
    return dq_mode<64>(mode, dtype, q, k, v, o, dout, l, dq, dl, b, s_q,
                       s_kv, hq, hkv, st, scale, causal, ma, gl, s);
  if (d == 128)
    return dq_mode<128>(mode, dtype, q, k, v, o, dout, l, dq, dl, b, s_q,
                        s_kv, hq, hkv, st, scale, causal, ma, gl, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K3. Same operands and stride layout as K2 (the o strides are unused);
// delta is K2's output (g_lse already in it); writes dk and dv [b, s_kv,
// hkv, d] contiguous. Masks as K2's.
extern "C" int paddle_flash_bwd_dkv(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dk, void* dv, const void* q_seg,
                                    const void* kv_seg, const void* start,
                                    const void* end, int hm, int dtype, int b,
                                    int s_q, int s_kv, int hq, int hkv, int d,
                                    const long long* strides, float scale,
                                    int causal, void* stream) {
  Strides st[5];
  unpack(strides, st);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const fmask::Args ma{static_cast<const int*>(q_seg),
                       static_cast<const int*>(kv_seg),
                       static_cast<const int*>(start),
                       static_cast<const int*>(end), hm};
  const int mode = mask_mode(ma);
  if (mode < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (d == 64)
    return dkv_mode<64>(mode, dtype, q, k, v, dout, l, dl, dk, dv, b, s_q,
                        s_kv, hq, hkv, st, scale, causal, ma, s);
  if (d == 128)
    return dkv_mode<128>(mode, dtype, q, k, v, dout, l, dl, dk, dv, b, s_q,
                         s_kv, hq, hkv, st, scale, causal, ma, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
