// Padded grouped matmul for Hopper (sm_90a), CUDA C++: the MoE expert FFN's
// forward (K5), its dx (K5 over the transposed weights) and its dw (K6).
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/grouped_matmul.py:
//  - K5 `_pgmm_kernel` (:38, called at :76 by `_pgmm_raw` :62):
//      out[r, :] = x[r, :] @ w[tile_gids[r / tile_m]]   (fp32 accumulator,
//    output in x's dtype). `trans_w` reads w [E, n, k] as its transpose:
//    the backward's dx = dout @ w^T (:192) with no transposed copy.
//  - K6 `_pgmm_dw_kernel` (:93, called at :150 by `_pgmm_dw_call` :138):
//      dw[e] = sum over the rows r of expert e's tiles of x[r]^T dout[r],
//    fp32 [E, k, n]. An expert that owns no tile gets zeros, written here
//    (the TPU kernel never visits such a block and the JAX package masks
//    it afterwards, `_mask_unvisited_experts` :128).
// Rows come sorted by expert and padded so that each tile_m-row tile
// belongs to one expert (padded_group_layout); tile_gids is monotone.
//
// What bounds it on the H100: at the Mixtral-class training shape (P =
// 36864 padded rows, k x n = 1024 x 2816 or 2816 x 1024, 8 experts) every
// call does 2 P k n = 2.1e11 FLOP against ~0.35 GB of traffic: about 600
// operations a byte, twice the bf16 ridge (295), so the tensor cores bound
// it (0.215 ms at 989 TFLOP/s).
//
// What the design does about it (bf16):
//  - wgmma (m64n256k16, fp32 accumulators in registers) fed by TMA: one
//    block owns a 128 x 256 output tile; warpgroup 0 is the producer (one
//    thread issues the tile loads), warpgroups 1 and 2 each multiply 64
//    rows. Four 48 KB stages of 64-deep operand tiles in shared memory,
//    with full/empty mbarriers between producer and consumers, keep loads
//    in flight while the tensor cores run. setmaxnreg moves registers from
//    the producer to the consumers (128 accumulators a thread).
//  - Tiles land in the 128-byte swizzle that TMA writes and wgmma reads.
//    The products take their operands in either major-ness through
//    wgmma's transpose bits, so no operand is transposed in memory: K5
//    reads x K-major and w [k][n] MN-major; the dx mode reads w [n][k]
//    K-major; K6 reads both x and dout MN-major (their rows are the
//    reduction). For MN-major operands the descriptor's leading offset is
//    the stride between 64-wide panels, the stride offset that between
//    8-row groups.
//  - K5: the block reads its expert from tile_gids[row0 / tile_m] in device
//    memory (the TPU's scalar prefetch); 128 divides tile_m, so a tile
//    never straddles two experts. The weights are a 3-D tensor map [E, .,
//    .], so a box never reads into the next expert.
//  - K6: one block per (expert, 128-row k tile, 256-column n tile) finds
//    its expert's contiguous run of tiles by a binary search of tile_gids
//    and loops over those rows. Each output element is summed by one block
//    in a fixed order: no atomics, identical results run to run. An empty
//    run leaves the accumulators at zero and the epilogue writes them.
//  - Edges of k and n that a tile does not divide: TMA fills out-of-range
//    box elements with zeros and the epilogue masks its stores; k and n
//    must be multiples of 8 (TMA's 16-byte strides), the wrapper checks.
//  - A barrier wait that never completes traps (a launch error) instead of
//    hanging the card.
//  - The mbarrier, TMA, tensor-map, descriptor and wgmma helpers live in
//    hopper.cuh, shared with the flash backward kernels (flash_bwd.cu).
// fp32 runs on FMAs (128 x 128 tiles, an 8 x 8 register tile a thread),
// exact to fp32 rounding; it serves the fp32 parity checks.
// Later work: a persistent schedule over tiles (the epilogue does not yet
// overlap the next tile's loads) and clusters that share operand loads.
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

// ---- bf16: TMA + wgmma -----------------------------------------------------
constexpr int TBM = 128;   // output rows a block (K6: rows of dw[e])
constexpr int TBN = 256;   // output columns a block
constexpr int TBK = 64;    // reduction depth a stage (128 bytes of bf16)
constexpr int TST = 4;     // stages
constexpr int TNT = 384;   // producer warpgroup + two consumer warpgroups
constexpr int A_BYTES = TBM * TBK * 2, B_BYTES = TBN * TBK * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int PANEL = 64 * TBK * 2;  // one 64-wide MN-major panel, 8 KB
// stages, the mbarriers, and slack to align the tiles to 1024 bytes
constexpr int TC_SMEM = TST * STAGE_BYTES + 2 * TST * 8 + 1024;

// [t_lo, t_hi): the tiles that the monotone gids give expert e
__device__ __forceinline__ void expert_tiles(const int* __restrict__ gids,
                                             int ntiles, int e, int* t_lo,
                                             int* t_hi) {
  int lo = 0, hi = ntiles;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (gids[mid] < e) lo = mid + 1; else hi = mid;
  }
  *t_lo = lo;
  hi = ntiles;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (gids[mid] <= e) lo = mid + 1; else hi = mid;
  }
  *t_hi = lo;
}

// The three products, by MODE:
//   0  K5:          out[r][j]   = sum_c x[r][c] w[g][c][j]
//   1  K5, trans_w: out[r][j]   = sum_c x[r][c] w[g][j][c]
//   2  K6:          dw[e][i][j] = sum_r x[r][i] dout[r][j] over e's rows
// Tensor maps (innermost dimension first, 128-byte swizzle):
//   0: ma = x {k, p} box {64, 128}; mb = w {n, k, E} box {64, 64, 1}, four
//      boxes (MN-major panels)
//   1: ma = x {k, p} box {64, 128}; mb = w {k, n, E} box {64, 256, 1}
//   2: ma = x {k, p} box {64, 64}, two boxes; mb = dout {n, p} box {64, 64},
//      four boxes (all MN-major panels, rows = the reduction)
// out: bf16 [p, n] (modes 0, 1) or fp32 [E, k, n] (mode 2).
template <int MODE>
__global__ void __launch_bounds__(TNT, 1)
pgmm_tc_kernel(const __grid_constant__ CUtensorMap ma,
               const __grid_constant__ CUtensorMap mb,
               const int* __restrict__ gids, void* __restrict__ out, int p,
               int k, int n, int tile_m) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + TST * STAGE_BYTES);
  uint64_t* empty = full + TST;
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  const int n0 = blockIdx.x * TBN, m0 = blockIdx.y * TBM;
  int nsteps, row_lo = 0, g = 0;
  if constexpr (MODE == 2) {
    int t_lo, t_hi;
    expert_tiles(gids, p / tile_m, blockIdx.z, &t_lo, &t_hi);
    row_lo = t_lo * tile_m;
    nsteps = (t_hi - t_lo) * (tile_m / TBK);
  } else {
    g = gids[m0 / tile_m];
    nsteps = (k + TBK - 1) / TBK;
  }
  if (tid == 0) {
    for (int s = 0; s < TST; ++s) {
      bar_init(&full[s], 1);   // the producer's arrive + the tile bytes
      bar_init(&empty[s], 2);  // one arrive per consumer warpgroup
    }
    bar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (t == 0) {
      for (int it = 0; it < nsteps; ++it) {
        const int s = it % TST;
        bar_wait(&empty[s], ((it / TST) & 1) ^ 1);
        unsigned char* as = smem + s * STAGE_BYTES;
        unsigned char* bs = as + A_BYTES;
        bar_expect_tx(&full[s], STAGE_BYTES);
        const int s0 = it * TBK;
        if constexpr (MODE == 2) {
          tma_2d(as, &ma, m0, row_lo + s0, &full[s]);
          tma_2d(as + PANEL, &ma, m0 + 64, row_lo + s0, &full[s]);
#pragma unroll
          for (int j = 0; j < TBN / 64; ++j)
            tma_2d(bs + j * PANEL, &mb, n0 + 64 * j, row_lo + s0, &full[s]);
        } else {
          tma_2d(as, &ma, s0, m0, &full[s]);
          if constexpr (MODE == 1) {
            tma_3d(bs, &mb, s0, n0, g, &full[s]);
          } else {
#pragma unroll
            for (int j = 0; j < TBN / 64; ++j)
              tma_3d(bs + j * PANEL, &mb, n0 + 64 * j, s0, g, &full[s]);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup 1 owns rows 0-63 of the tile, warpgroup 2 64-127
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1;
  float acc[TBN / 2];
#pragma unroll
  for (int i = 0; i < TBN / 2; ++i) acc[i] = 0.f;
  for (int it = 0; it < nsteps; ++it) {
    const int s = it % TST;
    bar_wait(&full[s], (it / TST) & 1);
    const unsigned char* as = smem + s * STAGE_BYTES;
    const unsigned char* bs = as + A_BYTES;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TBK / 16; ++kk) {
      if constexpr (MODE == 2) {
        wgmma_ss_n256<1, 1>(acc, mnmajor_desc(as + cw * PANEL, kk, PANEL),
                            mnmajor_desc(bs, kk, PANEL));
      } else if constexpr (MODE == 1) {
        wgmma_ss_n256<0, 0>(acc, kmajor_desc(as + cw * 64 * 128, kk),
                            kmajor_desc(bs, kk));
      } else {
        wgmma_ss_n256<0, 1>(acc, kmajor_desc(as + cw * 64 * 128, kk),
                            mnmajor_desc(bs, kk, PANEL));
      }
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    if (t == 0) bar_arrive(&empty[s]);  // this stage may be refilled
  }

  // epilogue: accumulator 4b + q of a thread holds row 16 * warp + lane / 4
  // + 8 (q / 2), column 8 b + 2 (lane % 4) + q % 2 of its 64 x 256 tile
  const int warp = t / 32, lane = t % 32;
  const long long mrows = MODE == 2 ? k : p;
  const long long obase =
      MODE == 2 ? static_cast<long long>(blockIdx.z) * k * n : 0;
#pragma unroll
  for (int b = 0; b < TBN / 8; ++b)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = m0 + cw * 64 + 16 * warp + lane / 4 + 8 * h;
      const int col = n0 + 8 * b + 2 * (lane % 4);
      if (row < mrows && col < n) {  // n is even: both columns or neither
        const float v0 = acc[4 * b + 2 * h], v1 = acc[4 * b + 2 * h + 1];
        const long long o = obase + row * n + col;
        if constexpr (MODE == 2)
          *reinterpret_cast<float2*>(static_cast<float*>(out) + o) =
              make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) + o) =
              __floats2bfloat162_rn(v0, v1);
      }
    }
}

template <int MODE>
int launch_tc(const void* x, const void* y, const int* gids, void* out,
              int p, int k, int n, int e, int tile_m, cudaStream_t s) {
  using u64 = cuuint64_t;
  CUtensorMap ma, mb;
  const u64 x_dims[2] = {static_cast<u64>(k), static_cast<u64>(p)};
  const u64 x_strides[1] = {static_cast<u64>(k) * 2};
  int err;
  if constexpr (MODE == 2) {
    const cuuint32_t panel[2] = {64, 64};
    const u64 d_dims[2] = {static_cast<u64>(n), static_cast<u64>(p)};
    const u64 d_strides[1] = {static_cast<u64>(n) * 2};
    if ((err = make_map(&ma, x, 2, x_dims, x_strides, panel))) return err;
    if ((err = make_map(&mb, y, 2, d_dims, d_strides, panel))) return err;
  } else {
    const cuuint32_t x_box[2] = {64, TBM};
    if ((err = make_map(&ma, x, 2, x_dims, x_strides, x_box))) return err;
    if constexpr (MODE == 1) {  // w [E][n][k], k innermost
      const u64 dims[3] = {static_cast<u64>(k), static_cast<u64>(n),
                           static_cast<u64>(e)};
      const u64 strides[2] = {static_cast<u64>(k) * 2,
                              static_cast<u64>(k) * n * 2};
      const cuuint32_t box[3] = {64, TBN, 1};
      if ((err = make_map(&mb, y, 3, dims, strides, box))) return err;
    } else {                    // w [E][k][n], n innermost
      const u64 dims[3] = {static_cast<u64>(n), static_cast<u64>(k),
                           static_cast<u64>(e)};
      const u64 strides[2] = {static_cast<u64>(n) * 2,
                              static_cast<u64>(k) * n * 2};
      const cuuint32_t box[3] = {64, 64, 1};
      if ((err = make_map(&mb, y, 3, dims, strides, box))) return err;
    }
  }
  const cudaError_t ce = cudaFuncSetAttribute(
      pgmm_tc_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      TC_SMEM);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  const dim3 grid((n + TBN - 1) / TBN,
                  MODE == 2 ? (k + TBM - 1) / TBM : p / TBM,
                  MODE == 2 ? e : 1);
  pgmm_tc_kernel<MODE><<<grid, TNT, TC_SMEM, s>>>(ma, mb, gids, out, p, k, n,
                                                  tile_m);
  return static_cast<int>(cudaGetLastError());
}

// ---- fp32: FMAs ------------------------------------------------------------
constexpr int BM = 128;  // output rows per block (K6: k rows)
constexpr int BN = 128;  // output columns per block
constexpr int NT = 256;  // 16 x 16 threads, an 8 x 8 register tile each
constexpr int FK = 8;    // reduction depth per shared stage

// acc[i][j] += sum_c as[c][ty*8+i] * bs[c][tx+16j] over the FK staged steps
__device__ __forceinline__ void fma_tile(const float (*as)[BM],
                                         const float (*bs)[BN],
                                         float (&acc)[8][8], int ty, int tx) {
#pragma unroll
  for (int c = 0; c < FK; ++c) {
    float a[8], b[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = as[c][ty * 8 + i];
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = bs[c][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ void store_f32(const float (&acc)[8][8],
                                          float* out, long long row0, int col0,
                                          long long m, int n, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long row = row0 + ty * 8 + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col < n) out[row * n + col] = acc[i][j];
    }
  }
}

template <bool TRANS>
__global__ void __launch_bounds__(NT)
pgmm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const int* __restrict__ gids, float* __restrict__ out, int p,
                int k, int n, int tile_m) {
  __shared__ float as[FK][BM];  // as[c][r] = x[r0 + r][k0 + c]
  __shared__ float bs[FK][BN];  // bs[c][j] = B[k0 + c][n0 + j]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * BN;
  const long long r0 = static_cast<long long>(blockIdx.y) * BM;
  const float* xb = x + r0 * k;
  const float* wb = w + static_cast<long long>(gids[r0 / tile_m]) * k * n;
  float acc[8][8] = {};
  for (int k0 = 0; k0 < k; k0 += FK) {
    for (int i = tid; i < FK * BM; i += NT) {
      const int r = i % BM, c = i / BM;
      as[c][r] = k0 + c < k ? xb[r * k + k0 + c] : 0.f;
    }
    for (int i = tid; i < FK * BN; i += NT) {
      const int c = i / BN, j = i % BN;
      const int kk = k0 + c, nn = n0 + j;
      float v = 0.f;
      if (kk < k && nn < n)
        v = TRANS ? wb[static_cast<long long>(nn) * k + kk]
                  : wb[static_cast<long long>(kk) * n + nn];
      bs[c][j] = v;
    }
    __syncthreads();
    fma_tile(as, bs, acc, ty, tx);
    __syncthreads();
  }
  store_f32(acc, out, r0, n0, p, n, ty, tx);
}

__global__ void __launch_bounds__(NT)
pgmm_dw_f32_kernel(const float* __restrict__ x, const float* __restrict__ dout,
                   const int* __restrict__ gids, float* __restrict__ dw,
                   int p, int k, int n, int tile_m) {
  __shared__ float xs[FK][BM];  // xs[c][i] = x[r + c][k0 + i]
  __shared__ float ds[FK][BN];  // ds[c][j] = dout[r + c][n0 + j]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * BN, k0 = blockIdx.y * BM, e = blockIdx.z;
  int t_lo, t_hi;
  expert_tiles(gids, p / tile_m, e, &t_lo, &t_hi);
  const long long row_hi = static_cast<long long>(t_hi) * tile_m;
  float acc[8][8] = {};
  for (long long r = static_cast<long long>(t_lo) * tile_m; r < row_hi;
       r += FK) {
    for (int i = tid; i < FK * BM; i += NT) {
      const int c = i / BM, j = i % BM;
      xs[c][j] = k0 + j < k ? x[(r + c) * k + k0 + j] : 0.f;
      ds[c][j] = n0 + j < n ? dout[(r + c) * n + n0 + j] : 0.f;
    }
    __syncthreads();
    fma_tile(xs, ds, acc, ty, tx);
    __syncthreads();
  }
  store_f32(acc, dw + static_cast<long long>(e) * k * n, k0, n0, k, n, ty,
            tx);
}

}  // namespace

// x [p, k], w [e, k, n] (trans_w = 0) or [e, n, k] (trans_w = 1), tile_gids
// [p / tile_m] int32, out [p, n]; all contiguous. dtype: 0 = float32, 1 =
// bfloat16 (then k and n are multiples of 8 and the pointers 16-byte
// aligned). tile_m is a multiple of 128. Returns the launch's cudaError_t
// (or cudaErrorNotSupported without the driver's tensor-map encoder).
extern "C" int paddle_pgmm(const void* x, const void* w, const void* tile_gids,
                           void* out, int dtype, int p, int k, int n, int e,
                           int tile_m, int trans_w, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* g = static_cast<const int*>(tile_gids);
  if (dtype == 1)
    return trans_w ? launch_tc<1>(x, w, g, out, p, k, n, e, tile_m, s)
                   : launch_tc<0>(x, w, g, out, p, k, n, e, tile_m, s);
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + BN - 1) / BN, p / BM);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* of = static_cast<float*>(out);
  if (trans_w)
    pgmm_f32_kernel<true><<<grid, NT, 0, s>>>(xf, wf, g, of, p, k, n, tile_m);
  else
    pgmm_f32_kernel<false><<<grid, NT, 0, s>>>(xf, wf, g, of, p, k, n, tile_m);
  return static_cast<int>(cudaGetLastError());
}

// x [p, k], dout [p, n], tile_gids [p / tile_m] int32 monotone, dw [e, k, n]
// fp32; all contiguous. dtype as for paddle_pgmm.
extern "C" int paddle_pgmm_dw(const void* x, const void* dout,
                              const void* tile_gids, void* dw, int dtype,
                              int p, int k, int n, int e, int tile_m,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* g = static_cast<const int*>(tile_gids);
  if (dtype == 1)
    return launch_tc<2>(x, dout, g, dw, p, k, n, e, tile_m, s);
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + BN - 1) / BN, (k + BM - 1) / BM, e);
  pgmm_dw_f32_kernel<<<grid, NT, 0, s>>>(static_cast<const float*>(x),
                                         static_cast<const float*>(dout), g,
                                         static_cast<float*>(dw), p, k, n,
                                         tile_m);
  return static_cast<int>(cudaGetLastError());
}
