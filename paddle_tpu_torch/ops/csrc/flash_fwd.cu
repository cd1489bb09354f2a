// FlashAttention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel `_fa_fwd_kernel`
// (paddle_tpu/ops/flash_attention.py:117, driven by `_pallas_forward` :221):
// the primal path (no logsumexp output, serving) and the training path,
// which also writes the logsumexp of every q row (:203-212).
//
// What it computes: out[b, i, h, :] = softmax_j(scale * q[b,i,h,:].k[b,j,h/g,:])
// . v[b,j,h/g,:] with an END-aligned causal mask (q row i sees k columns
// j <= i + s_kv - s_q), GQA mapping q head h -> kv head h / group, an fp32
// online softmax, the finite mask value -1e30 for causally masked scores and
// zeros for a row that attends nothing (l == 0), as the TPU kernel does.
// When `lse` is not null it also writes lse[b, h, i] = m + log(l) of the
// SCALED logits in fp32, NEG_INF (-1e30) for a row with l == 0 (the TPU
// kernel's [b, h, 8, s] lane axis is a tiling artefact and is dropped).
//
// What bounds it on the H100: at the serving prefill shape (s = 512,
// head_dim 128) attention does about 4 * head_dim operations per (q, k) pair
// for a few bytes per row: in bf16 it sits near the line where the tensor
// cores and HBM take equal time, and in fp32 (no tensor-core path kept
// exact) it is bounded by arithmetic.
//
// What the design does about it:
//  - One block per (q tile of 64 rows, q head, batch); the kv loop runs
//    inside the block, so nothing carries across blocks (the TPU grid's
//    sequential kv axis becomes this loop).
//  - bf16 runs on the tensor cores (WMMA 16x16x16, fp32 accumulation). Each
//    of the 4 warps owns 16 q rows: it computes its strip of S = Q K^T,
//    the online softmax of its rows (scores and statistics in fp32, P
//    rounded to bf16 for the product) and its strip of O += P V, with O
//    kept in shared memory between kv tiles. Tiles are staged with 16-byte
//    loads.
//  - fp32 runs on FMAs, so it stays exact to fp32 rounding: Q, K and V
//    tiles are staged as fp32 with a padded row (head_dim + 1 words), and
//    each thread holds an 8 x 4 tile of scores and an 8 x (head_dim / 16)
//    tile of the output in registers.
//  - kv tiles wholly in the causal future are never loaded; ragged tails
//    (s not a multiple of 64) are masked in the kernel, so any length runs.
//  - The public [b, s, h, d] layout is read through its strides: no
//    transpose copy.
// Loads are not overlapped with math (no cp.async/TMA pipeline) and the
// products use WMMA rather than wgmma; both are later work.
#include <stdint.h>

#include <mma.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;   // q rows per block
constexpr int BK = 64;   // kv columns per tile
constexpr int NT = 128;  // threads per block: 8 row groups x 16 col groups
constexpr int RPT = BQ / 8;   // q rows per thread
constexpr int CPT = BK / 16;  // score columns per thread

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int s_q,
                 int s_kv, int hq, int group, long long q_sb, long long q_ss,
                 long long q_sh, long long k_sb, long long k_ss,
                 long long k_sh, long long v_sb, long long v_ss,
                 long long v_sh, float scale, int causal,
                 float* __restrict__ lse) {
  constexpr int LD = D + 1;     // padded shared row
  constexpr int LP = BK + 1;
  constexpr int DPT = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;             // [BQ][LD], pre-scaled
  float* kvs = qs + BQ * LD;    // [BK][LD], K then V of the current tile
  float* ps = kvs + BK * LD;    // [BQ][LP], probabilities of the tile

  const int tid = threadIdx.x;
  const int tx = tid % 16;      // column group
  const int ty = tid / 16;      // row group
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int offset = s_kv - s_q;  // end-aligned causal offset

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    qs[r * LD + c] =
        (q0 + r < s_q) ? pt::to_f(qb[(q0 + r) * q_ss + c]) * scale : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = pt::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[i][d] = 0.f;
  }

  int last = (s_kv + BK - 1) / BK - 1;
  if (causal) {
    // last kv tile this q tile attends to; tiles past it are all future
    const int lk = q0 + BQ - 1 + offset;
    last = lk < 0 ? -1 : min(last, lk / BK);
  }

  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // previous tile's P.V reads of kvs/ps are done
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D;
      kvs[r * LD + c] = (k0 + r < s_kv) ? pt::to_f(kb[(k0 + r) * k_ss + c])
                                        : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = qs[(ty * RPT + i) * LD + c];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = kvs[(tx + 16 * j) * LD + c];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qr = q0 + ty * RPT + i;
      float mx = pt::kNegInf;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kc = k0 + tx + 16 * j;
        if (kc >= s_kv) {
          s[i][j] = -INFINITY;  // past the end: weight exactly 0
        } else if (causal && qr + offset < kc) {
          s[i][j] = pt::kNegInf;
        }
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row are 16 consecutive lanes of one warp
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = __expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = __expf(s[i][j] - m_new);
        ps[(ty * RPT + i) * LP + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int d = 0; d < DPT; ++d) acc[i][d] *= alpha;
    }
    __syncthreads();  // K reads done, P written

    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D;
      kvs[r * LD + c] = (k0 + r < s_kv) ? pt::to_f(vb[(k0 + r) * v_ss + c])
                                        : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RPT], vv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = ps[(ty * RPT + i) * LP + c];
#pragma unroll
      for (int d = 0; d < DPT; ++d) vv[d] = kvs[c * LD + tx + 16 * d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int d = 0; d < DPT; ++d) acc[i][d] = fmaf(pv[i], vv[d], acc[i][d]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qr = q0 + ty * RPT + i;
    if (qr >= s_q) continue;
    const float inv = 1.f / (l[i] > 0.f ? l[i] : 1.f);
    T* ob = out + ((static_cast<long long>(b) * s_q + qr) * hq + h) * D;
#pragma unroll
    for (int d = 0; d < DPT; ++d) ob[tx + 16 * d] = pt::from_f<T>(acc[i][d] * inv);
    if (lse != nullptr && tx == 0)
      lse[(static_cast<long long>(b) * hq + h) * s_q + qr] =
          l[i] > 0.f ? m[i] + logf(l[i]) : pt::kNegInf;
  }
}

// ---- bf16: tensor cores (WMMA) -------------------------------------------
namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

// Row strides of the shared tiles, padded so that every 16-row fragment
// starts 32-byte aligned (WMMA's requirement) and rows fall on other banks.
template <int D>
struct TcLayout {
  static constexpr int LDH = D + 8;    // bf16 Q/K/V rows
  static constexpr int LDP = BK + 8;   // bf16 P rows
  static constexpr int LDS = BK + 4;   // fp32 S rows
  static constexpr int LDO = D + 4;    // fp32 O rows
  static constexpr size_t kBytes =
      (BQ * LDH + 2 * BK * LDH + BQ * LDP) * sizeof(bf16) +
      (BQ * LDS + BQ * LDO) * sizeof(float);
};

template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int r0, int n) {
  constexpr int LDH = TcLayout<D>::LDH;
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < BK * VPR; i += NT) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * LDH + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out,
                      int s_q, int s_kv, int hq, int group, long long q_sb,
                      long long q_ss, long long q_sh, long long k_sb,
                      long long k_ss, long long k_sh, long long v_sb,
                      long long v_ss, long long v_sh, float scale,
                      int causal, float* __restrict__ lse) {
  using Lay = TcLayout<D>;
  constexpr int LDH = Lay::LDH, LDP = Lay::LDP, LDS = Lay::LDS,
                LDO = Lay::LDO;
  constexpr int NJ = D / 16;   // 16-column output fragments per warp
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);   // [BQ][LDH]
  bf16* ks = qs + BQ * LDH;                      // [BK][LDH]
  bf16* vs = ks + BK * LDH;                      // [BK][LDH]
  bf16* ps = vs + BK * LDH;                      // [BQ][LDP]
  float* ss = reinterpret_cast<float*>(ps + BQ * LDP);  // [BQ][LDS]
  float* os = ss + BQ * LDS;                     // [BQ][LDO]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const int offset = s_kv - s_q;
  const int r0 = warp * 16;   // this warp's rows within the tile

  load_tile<D>(qs, q + b * q_sb + h * q_sh, q_ss, q0, s_q);
  for (int i = tid; i < BQ * LDO; i += NT) os[i] = 0.f;
  float m[16], l[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m[r] = pt::kNegInf;
    l[r] = 0.f;
  }

  int last = (s_kv + BK - 1) / BK - 1;
  if (causal) {
    const int lk = q0 + BQ - 1 + offset;
    last = lk < 0 ? -1 : min(last, lk / BK);
  }
  const bf16* kb = k + b * k_sb + hk * k_sh;
  const bf16* vb = v + b * v_sb + hk * v_sh;

  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(ks, kb, k_ss, k0, s_kv);
    load_tile<D>(vs, vb, v_ss, k0, s_kv);
    __syncthreads();

    {  // S strip = Q strip . K^T
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc[BK / 16];
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) wmma::fill_fragment(sacc[j], 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, qs + r0 * LDH + kk * 16, LDH);
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
          wmma::load_matrix_sync(bt, ks + j * 16 * LDH + kk * 16, LDH);
          wmma::mma_sync(sacc[j], a, bt, sacc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        wmma::store_matrix_sync(ss + r0 * LDS + j * 16, sacc[j], LDS,
                                wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax of the warp's 16 rows; lane owns columns lane, lane+32
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = r0 + r, qr = q0 + row;
      float sv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kc = k0 + lane + 32 * e;
        float x = ss[row * LDS + lane + 32 * e] * scale;
        if (kc >= s_kv) {
          x = -INFINITY;  // past the end: weight exactly 0
        } else if (causal && qr + offset < kc) {
          x = pt::kNegInf;
        }
        sv[e] = x;
      }
      float mx = fmaxf(pt::kNegInf, fmaxf(sv[0], sv[1]));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = __expf(m[r] - m_new);
      const float p0 = __expf(sv[0] - m_new), p1 = __expf(sv[1] - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
      ps[row * LDP + lane] = __float2bfloat16(p0);
      ps[row * LDP + lane + 32] = __float2bfloat16(p1);
#pragma unroll
      for (int c = lane; c < D; c += 32) os[row * LDO + c] *= alpha;
    }
    __syncwarp();

    {  // O strip += P strip . V
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        wmma::load_matrix_sync(oacc[j], os + r0 * LDO + j * 16, LDO,
                               wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, ps + r0 * LDP + kk * 16, LDP);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
          wmma::load_matrix_sync(vf, vs + kk * 16 * LDH + j * 16, LDH);
          wmma::mma_sync(oacc[j], a, vf, oacc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        wmma::store_matrix_sync(os + r0 * LDO + j * 16, oacc[j], LDO,
                                wmma::mem_row_major);
    }
    __syncwarp();
  }
  __syncwarp();

#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = r0 + r, qr = q0 + row;
    if (qr >= s_q) continue;
    const float inv = 1.f / (l[r] > 0.f ? l[r] : 1.f);
    bf16* ob = out + ((static_cast<long long>(b) * s_q + qr) * hq + h) * D;
    for (int c = lane; c < D; c += 32)
      ob[c] = __float2bfloat16(os[row * LDO + c] * inv);
    if (lse != nullptr && lane == 0)
      lse[(static_cast<long long>(b) * hq + h) * s_q + qr] =
          l[r] > 0.f ? m[r] + logf(l[r]) : pt::kNegInf;
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                float* lse, int b, int s_q, int s_kv, int hq, int hkv,
                const long long* st, float scale, int causal,
                cudaStream_t stream) {
  const size_t smem = TcLayout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((s_q + BQ - 1) / BQ, hq, b);
  flash_fwd_bf16_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), s_q, s_kv, hq,
      hq / hkv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], scale, causal, lse);
  return static_cast<int>(cudaGetLastError());
}

// ---- fp32: FMAs ------------------------------------------------------------
template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int b, int s_q, int s_kv, int hq, int hkv, const long long* st,
           float scale, int causal, cudaStream_t stream) {
  const size_t smem = (BQ * (D + 1) + BK * (D + 1) + BQ * (BK + 1)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((s_q + BQ - 1) / BQ, hq, b);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), s_q, s_kv, hq,
      hq / hkv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], scale, causal, lse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [b, s_q, hq, d], k/v [b, s_kv, hkv, d] with the given element strides
// (batch, seq, head; head_dim contiguous); out [b, s_q, hq, d] contiguous;
// lse [b, hq, s_q] fp32 contiguous, or null to skip it (the primal path).
// dtype: 0 = float32, 1 = bfloat16 (then the pointers are 16-byte aligned
// and the strides multiples of 8). Returns the launch's cudaError_t.
extern "C" int paddle_flash_fwd(const void* q, const void* k, const void* v,
                                void* out, void* lse_ptr, int dtype, int b,
                                int s_q,
                                int s_kv, int hq, int hkv, int d,
                                long long q_sb, long long q_ss, long long q_sh,
                                long long k_sb, long long k_ss, long long k_sh,
                                long long v_sb, long long v_ss, long long v_sh,
                                float scale, int causal, void* stream) {
  const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_ptr);
  if (dtype == 0 && d == 64)
    return launch<float, 64>(q, k, v, out, lse, b, s_q, s_kv, hq, hkv, st, scale, causal, s);
  if (dtype == 0 && d == 128)
    return launch<float, 128>(q, k, v, out, lse, b, s_q, s_kv, hq, hkv, st, scale, causal, s);
  if (dtype == 1 && d == 64)
    return launch_bf16<64>(q, k, v, out, lse, b, s_q, s_kv, hq, hkv, st, scale, causal, s);
  if (dtype == 1 && d == 128)
    return launch_bf16<128>(q, k, v, out, lse, b, s_q, s_kv, hq, hkv, st, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
