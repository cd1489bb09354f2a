// Paged-KV decode attention for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel `_paged_decode_kernel`
// (paddle_tpu/ops/paged_attention.py:174, driven by `paged_decode_attention`
// :271).
//
// What it computes: one query token per row over a paged KV pool
// [num_pages, kv_heads, page, head_dim]. Row b reads its pages through its
// block table (negative ids clamp to page 0, as the TPU kernel and the
// reference do), attends its first context_lens[b] tokens with an fp32
// online softmax, and writes zeros when its length is 0 (parked serving
// slots stay inert).
//
// What bounds it on the H100: one token per row does 4 * head_dim operations
// per cached token for 4 * head_dim bytes of bf16 K/V, about one operation
// per byte, so it is bounded by memory bandwidth: the least time is the
// bytes of the K/V pages the rows' lengths need over 3.35 TB/s.
//
// What the design does about it:
//  - Split-K. A row's context is cut into chunks of 64 tokens and every
//    (kv head, row, chunk) is its own block, so a batch of 8 rows at 640
//    tokens runs ~1,300 blocks on the 132 SMs instead of 128 serial walks
//    (the TPU kernel's sequential chunk axis cannot carry across blocks on
//    a GPU). Each block writes its chunk's unnormalised output with the
//    chunk's max and sum; a second kernel merges the chunks of each
//    (row, q head) with the usual log-sum-exp rescaling.
//  - Chunks past a row's length exit at once: no page past it is read.
//  - All `group` q heads of a kv head are computed in one block, so each
//    K/V page is read from device memory once, not once per q head.
//  - K and V rows are read as 16-byte vectors; a page's tokens for one kv
//    head are contiguous (page * head_dim elements), so loads coalesce.
//  - Every row takes the kernel, whatever its length (the TPU dispatcher's
//    short-context fallback to the gather reference does not exist here).
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int CH = 64;   // tokens per chunk (one block)
constexpr int NT = 128;  // threads per block of the chunk kernel
constexpr int NW = NT / 32;

__device__ __forceinline__ void unpack(const uint4& u, float* dst, float) {
  const float* f = reinterpret_cast<const float*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) dst[i] = f[i];
}

__device__ __forceinline__ void unpack(const uint4& u, float* dst,
                                       __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// One (kv head, row, chunk): scores, chunk-local softmax and P.V for the
// group's q heads. part[((b * hq + qh) * nsplit + chunk) * (D + 2) + :]
// holds the unnormalised output, then the chunk's max and sum.
template <typename T, int D>
__global__ void __launch_bounds__(NT)
paged_decode_chunk(const T* __restrict__ q, const T* __restrict__ kc,
                   const T* __restrict__ vc, const int* __restrict__ tables,
                   const int* __restrict__ lens, float* __restrict__ part,
                   int hkv, int group, int page, int maxp, int nsplit,
                   float scale) {
  constexpr int LD = D + 1;              // padded shared row
  constexpr int VEC = 16 / sizeof(T);    // elements per 16-byte load
  constexpr int VPR = D / VEC;           // 16-byte loads per token row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* rows = reinterpret_cast<long long*>(smem_raw);  // [CH]
  float* ks = reinterpret_cast<float*>(rows + CH);           // [CH][LD]
  float* vs = ks + CH * LD;                                  // [CH][LD]
  float* qs = vs + CH * LD;                                  // [group][D]
  float* ps = qs + group * D;                                // [group][CH]

  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int L = min(lens[b], maxp * page);
  const int c0 = sp * CH;
  if (c0 >= L) return;
  const int n = min(CH, L - c0);
  const int hq = hkv * group;
  const long long qbase = (static_cast<long long>(b) * hq + h * group) * D;

  for (int i = tid; i < group * D; i += NT)
    qs[i] = pt::to_f(q[qbase + i]) * scale;
  if (tid < CH) {
    long long off = 0;
    if (tid < n) {
      const int tok = c0 + tid;
      const int pid = max(tables[static_cast<long long>(b) * maxp + tok / page], 0);
      off = ((static_cast<long long>(pid) * hkv + h) * page + tok % page) * D;
    }
    rows[tid] = off;
  }
  __syncthreads();
  for (int i = tid; i < CH * VPR; i += NT) {
    const int t = i / VPR, c = (i % VPR) * VEC;
    float* kd = ks + t * LD + c;
    float* vd = vs + t * LD + c;
    if (t < n) {
      const uint4 kraw = *reinterpret_cast<const uint4*>(kc + rows[t] + c);
      const uint4 vraw = *reinterpret_cast<const uint4*>(vc + rows[t] + c);
      unpack(kraw, kd, T());
      unpack(vraw, vd, T());
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) kd[e] = vd[e] = 0.f;
    }
  }
  __syncthreads();

  for (int i = tid; i < group * CH; i += NT) {
    const int g = i / CH, t = i % CH;
    float s = -INFINITY;  // past the row's length: weight exactly 0
    if (t < n) {
      s = 0.f;
      const float* qg = qs + g * D;
      const float* kt = ks + t * LD;
#pragma unroll 16
      for (int c = 0; c < D; ++c) s = fmaf(qg[c], kt[c], s);
    }
    ps[g * CH + t] = s;
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  for (int g = warp; g < group; g += NW) {
    float* pg = ps + g * CH;
    float mx = pt::kNegInf;
    for (int t = lane; t < CH; t += 32) mx = fmaxf(mx, pg[t]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int t = lane; t < CH; t += 32) {
      const float p = __expf(pg[t] - mx);
      pg[t] = p;
      sum += p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      float* dst = part + ((static_cast<long long>(b) * hq + h * group + g)
                           * nsplit + sp) * (D + 2);
      dst[D] = mx;
      dst[D + 1] = sum;
    }
  }
  __syncthreads();

  for (int i = tid; i < group * D; i += NT) {
    const int g = i / D, c = i % D;
    const float* pg = ps + g * CH;
    float a = 0.f;
    for (int t = 0; t < n; ++t) a = fmaf(pg[t], vs[t * LD + c], a);
    part[((static_cast<long long>(b) * hq + h * group + g) * nsplit + sp)
         * (D + 2) + c] = a;
  }
}

// Merge the chunks of one (q head, row): out = sum_c e^(m_c - M) acc_c /
// sum_c e^(m_c - M) l_c. One thread per output element.
template <typename T, int D>
__global__ void __launch_bounds__(D)
paged_decode_merge(const float* __restrict__ part, const int* __restrict__ lens,
                   T* __restrict__ out, int hq, int page, int maxp,
                   int nsplit) {
  const int h = blockIdx.x, b = blockIdx.y, c = threadIdx.x;
  const long long row = static_cast<long long>(b) * hq + h;
  const int L = min(lens[b], maxp * page);
  if (L <= 0) {
    out[row * D + c] = pt::from_f<T>(0.f);
    return;
  }
  const int ns = (L + CH - 1) / CH;
  const float* p = part + row * nsplit * (D + 2);
  float m = pt::kNegInf;
  for (int s = 0; s < ns; ++s) m = fmaxf(m, p[s * (D + 2) + D]);
  float l = 0.f, a = 0.f;
  for (int s = 0; s < ns; ++s) {
    const float w = __expf(p[s * (D + 2) + D] - m);
    l = fmaf(w, p[s * (D + 2) + D + 1], l);
    a = fmaf(w, p[s * (D + 2) + c], a);
  }
  out[row * D + c] = pt::from_f<T>(a / l);
}

template <typename T, int D>
int launch(const void* q, const void* kc, const void* vc, const int* tables,
           const int* lens, float* part, void* out, int b, int hkv,
           int group, int page, int maxp, float scale, cudaStream_t stream) {
  const int nsplit = (maxp * page + CH - 1) / CH;
  const size_t smem = CH * sizeof(long long) +
      (2 * CH * (D + 1) + group * D + group * CH) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_chunk<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_decode_chunk<T, D><<<dim3(hkv, b, nsplit), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), tables, lens, part, hkv, group, page, maxp,
      nsplit, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_decode_merge<T, D><<<dim3(hkv * group, b), D, 0, stream>>>(
      part, lens, static_cast<T*>(out), hkv * group, page, maxp, nsplit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Number of 64-token chunks a row of `maxp` pages of `page` tokens splits
// into: the wrapper sizes the fp32 scratch `part` as
// [b, hq, chunks, head_dim + 2].
extern "C" int paddle_paged_decode_chunks(int page, int maxp) {
  return (maxp * page + CH - 1) / CH;
}

// q [b, hq, d] and out [b, hq, d] contiguous; pools [P, hkv, page, d]
// contiguous and 16-byte aligned; tables [b, maxp] int32; lens [b] int32;
// part: fp32 scratch (see above). All on the device. dtype: 0 = float32,
// 1 = bfloat16. Returns the first failing launch's cudaError_t, else 0.
extern "C" int paddle_paged_decode(const void* q, const void* kc,
                                   const void* vc, const void* tables,
                                   const void* lens, void* part, void* out,
                                   int dtype, int b, int hq, int hkv, int d,
                                   int page, int maxp, float scale,
                                   void* stream) {
  const int group = hq / hkv;
  const int* t = static_cast<const int*>(tables);
  const int* l = static_cast<const int*>(lens);
  float* p = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 64)
    return launch<float, 64>(q, kc, vc, t, l, p, out, b, hkv, group, page, maxp, scale, s);
  if (dtype == 0 && d == 128)
    return launch<float, 128>(q, kc, vc, t, l, p, out, b, hkv, group, page, maxp, scale, s);
  if (dtype == 1 && d == 64)
    return launch<__nv_bfloat16, 64>(q, kc, vc, t, l, p, out, b, hkv, group, page, maxp, scale, s);
  if (dtype == 1 && d == 128)
    return launch<__nv_bfloat16, 128>(q, kc, vc, t, l, p, out, b, hkv, group, page, maxp, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
