// FlashAttention forward for Hopper (sm_90a), CUDA C++: K1.
//
// Replaces the Pallas TPU kernel `_fa_fwd_kernel`
// (paddle_tpu/ops/flash_attention.py:117, driven by `_pallas_forward` :221):
// the primal path (no logsumexp output, serving) and the training path,
// which also writes the logsumexp of every q row (:203-212). One kernel
// does both; a null lse pointer picks the primal path.
//
// What it computes: out[b, i, h, :] = softmax_j(scale * q[b,i,h,:].k[b,j,h/g,:])
// . v[b,j,h/g,:] with an END-aligned causal mask (q row i sees k columns
// j <= i + s_kv - s_q), GQA mapping q head h -> kv head h / group, an fp32
// online softmax, the finite mask value -1e30 for causally masked scores and
// zeros for a row that attends nothing (l == 0), as the TPU kernel does.
// When `lse` is not null it also writes lse[b, h, i] = m + log(l) of the
// SCALED logits in fp32 (natural log: K2/K3 read it back), NEG_INF (-1e30)
// for a row with l == 0 or one that saw no key (the TPU kernel's [b, h, 8, s]
// lane axis is a tiling artefact and is dropped).
//
// What bounds it on the H100: 4 * head_dim operations per visible (q, k)
// pair and head against each input read once and the output written once.
// At the main-path shapes (989 TFLOP/s bf16, 3.35 TB/s):
//   serving prefill [8, 512, 16, 128] causal        0.0200 ms (bytes)
//   dense training  [2, 4096, 16 q / 4 kv, 128]     0.1390 ms (operations)
//   MoE training    [8, 2048, 16 q / 4 kv, 64]      0.0695 ms (operations)
//   GQA prefill     [2, 1024, 16 q / 4 kv, 128]     0.0087 ms (operations)
// so training is bounded by the tensor cores and short prefills by HBM.
//
// What the bf16 design does about it (TMA + wgmma; helpers in hopper.cuh):
//  - One block per (64 NCW q rows, q head, batch) over a flattened grid
//    that launches the heaviest causal tiles (the last q rows) first:
//    128 (NCW + 1) threads, a producer warpgroup, one thread of which
//    issues every load, and NCW consumer warpgroups of 64 q rows each (NCW
//    = 2 at head_dim 128, 3 at head_dim 64, where each kv tile then feeds
//    more rows against the same exp work); setmaxnreg gives the consumers
//    the registers (24 for the producer, 240 / 160 for a consumer).
//  - Q is loaded once by TMA; K and V tiles of 64 kv rows stream through a
//    ring of NST stages (4 at head_dim 128, 6 at 64) behind full/empty
//    mbarriers. Each operand has one 4-D tensor map over [b, s, h, d]
//    built from its strides, as 128-byte-swizzled panels of 64 head_dim
//    columns (head_dim 128 is two panels); a box past a sequence's end
//    reads zeros. Every barrier wait is bounded and traps.
//  - S = Q K^T on wgmma (K K-major) into fp32 registers; the online softmax
//    runs on them: row maxima over the 4 threads of a quad by shuffles, the
//    scale folded into the exp2 argument (no bf16 pre-scaling of Q), per-
//    thread partial row sums reduced once at the end, O rescaled by alpha in
//    registers. P, rounded to bf16, becomes the register A operand of
//    O += P V, with V read MN-major from the same TMA tile. S, P and O never
//    touch shared or device memory.
//  - Tile it's S is issued together with tile it - 1's P V, so the softmax
//    of tile it runs while P V is still on the tensor cores, and the
//    warpgroups interleave on the tensor cores as they come (turns enforced
//    by named barriers, "ping-pong", were slower on the card, as were 128-row
//    kv tiles).
//  - A warpgroup skips a kv tile wholly in its causal future but still
//    releases the stage; the mask is applied only on tiles that cross the
//    diagonal and on the ragged last kv tile (a zero-filled K row would give
//    a score of 0, not a masked one): causally masked scores get NEG_INF,
//    columns past s_kv weight 0. Rows past s_q are not stored.
//  - No atomics and no carry across blocks: results are identical run to
//    run, and the primal and lse paths give the same out bit for bit.
// fp32 runs on FMAs (128 threads, 64-row tiles, Q, K and V staged as fp32
// with a padded row, an 8 x 4 score tile and an 8 x (head_dim / 16) output
// tile per thread in registers), so it stays exact to fp32 rounding and
// carries the card-vs-CPU parity checks; its grid is (q tile, head, batch).
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

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

// ---- bf16: TMA + wgmma ------------------------------------------------------
using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

constexpr int BN = 64;  // kv rows a streamed tile

// Stages of the ring (NST) and consumer warpgroups (NCW) by head_dim, as
// timed fastest on the card (PERF.md). At head_dim 128 a third warpgroup
// spills: 512 threads cap ptxas at 128 registers a thread.
template <int D>
struct TcTile;
template <>
struct TcTile<64> {
  static constexpr int NST = 6, NCW = 3;
};
template <>
struct TcTile<128> {
  static constexpr int NST = 4, NCW = 2;
};

// Shared memory: resident Q (D / 64 panels of RB 128-byte rows), NST stages
// of a K and a V tile (D / 64 panels of BN rows each), the mbarriers, and
// slack to align the panels to 1024 bytes. NCW consumer warpgroups of 64 q
// rows each own the block's RB = 64 NCW q rows; a producer warpgroup issues
// the loads.
template <int D, int NST, int NCW>
struct TcLayout {
  static constexpr int RB = 64 * NCW;
  static constexpr int THREADS = 128 * (NCW + 1);
  // a consumer thread's registers: the SM's 65536 less the producer
  // warpgroup's 24 a thread, shared by the consumer warpgroups
  static constexpr int CONSUMER_REGS = (65536 / 128 - 24) / NCW / 8 * 8;
  static constexpr int Q_PANEL = RB * 128;
  static constexpr int QBYTES = (D / 64) * Q_PANEL;
  static constexpr int TILE_PANEL = BN * 128;
  static constexpr int TILE = (D / 64) * TILE_PANEL;
  static constexpr int STAGE = 2 * TILE;
  static constexpr int BARS = 2 * NST + 1;  // full, empty, Q
  static constexpr int kBytes = QBYTES + NST * STAGE + BARS * 8 + 1024;
  static_assert(NST >= 2, "a tile's P V overlaps the next tile's load");
  static_assert(kBytes <= 232448, "fits a block's shared memory");
};

// Number of BN-row kv tiles that q rows up to q_last can see.
__device__ __forceinline__ int kv_tiles(int q_last, int s_kv, int offset,
                                        int causal) {
  int n = (s_kv + BN - 1) / BN;
  if (causal) {
    const int lk = q_last + offset;
    n = lk < 0 ? 0 : min(n, lk / BN + 1);
  }
  return n;
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S = Q K^T for a warpgroup's 64 q rows against a BN-row K tile, issued
// (not waited for): Q rows of warpgroup cw of a block of RB, both operands
// K-major.
template <int D, int RB>
__device__ __forceinline__ void issue_qk(float (&s)[BN / 2],
                                         const unsigned char* qs,
                                         const unsigned char* ks, int cw) {
  constexpr int QP = RB * 128, KP = BN * 128;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(s, kmajor_desc(qs + (kk / 4) * QP + cw * 64 * 128, kk % 4),
                 kmajor_desc(ks + (kk / 4) * KP, kk % 4), kk > 0);
}

// O += P V over a BN-row V tile read MN-major, P the register A operand.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[BN / 16][4],
                                         const unsigned char* vs) {
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) {
    const uint64_t db = mnmajor_desc(vs, j, BN * 128);
    if constexpr (D == 64)
      wgmma_rs_n64(o, a[j], db);
    else
      wgmma_rs_n128(o, a[j], db);
  }
}

// The online softmax of one 64 x BN tile of raw scores s (q . k, fp32) in
// hopper.cuh's accumulator layout: updates each of the thread's two rows'
// maximum m (raw units, the quad's) and partial sum l (this thread's
// columns), turns s into P = exp(scale (s - m)) and returns in alpha the
// factor that row's O must be rescaled by. MASK: the tile crosses the
// causal diagonal or the end of the sequence.
template <bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             float sc2, int k0, int s_kv,
                                             const int (&rows)[2], int offset,
                                             int causal, int lane) {
  if constexpr (MASK) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int kc = k0 + 8 * (i >> 2) + 2 * (lane % 4) + (i & 1);
      if (kc >= s_kv)
        s[i] = -INFINITY;  // past the end: weight exactly 0
      else if (causal && rows[(i >> 1) & 1] + offset < kc)
        s[i] = pt::kNegInf;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int e = (i >> 1) & 1;
    mx[e] = fmaxf(mx[e], s[i]);
  }
  float mb[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
    mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
    // unfused products, so that equal maxima give alpha = 1 exactly
    mb[e] = __fmul_rn(mx[e], sc2);
    alpha[e] = fast_exp2(__fmul_rn(m[e], sc2) - mb[e]);
    m[e] = mx[e];
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int e = (i >> 1) & 1;
    float p = fast_exp2(fmaf(s[i], sc2, -mb[e]));
    // a row that has seen only masked scores so far: uniform weights over
    // them, exp(NEG_INF - NEG_INF), as the TPU kernel gives
    if (MASK && s[i] == pt::kNegInf && mx[e] == pt::kNegInf) p = 1.f;
    s[i] = p;
    sum[e] += p;
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) l[e] = l[e] * alpha[e] + sum[e];
}

// Grid: one block per (RB-row q tile, q head, batch), flattened with the
// last q tiles first. Tensor maps: mq box {64, 1, RB, 1}; mk, mv box
// {64, 1, BN, 1}. lse may be null (the primal path).
template <int D, int NST, int NCW>
__global__ void __launch_bounds__(128 * (NCW + 1), 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap mq,
                    const __grid_constant__ CUtensorMap mk,
                    const __grid_constant__ CUtensorMap mv,
                    bf16* __restrict__ out, float* __restrict__ lse,
                    int batch, int s_q, int s_kv, int hq, int group,
                    float scale, int causal) {
  using L = TcLayout<D, NST, NCW>;
  constexpr int RB = L::RB;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* qs = align_1024(smem_raw);  // resident Q
  unsigned char* ring = qs + L::QBYTES;      // stages of (K, V)
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + NST * L::STAGE);
  uint64_t* empty = full + NST;
  uint64_t* res = empty + NST;

  const int per = hq * batch;
  const int qt = (s_q + RB - 1) / RB - 1 - static_cast<int>(blockIdx.x) / per;
  const int h = blockIdx.x % per % hq, b = blockIdx.x % per / hq;
  const int hk = h / group, offset = s_kv - s_q, q0 = qt * RB;
  const int nk = kv_tiles(min(q0 + RB, s_q) - 1, s_kv, offset, causal);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < NST; ++s) {
      bar_init(&full[s], 1);   // the producer's arrive + the tile bytes
      bar_init(&empty[s], NCW);  // one arrive per consumer warpgroup
    }
    bar_init(res, 1);
    bar_init_fence();
  }
  __syncthreads();

  if (tid < 128) {  // producer: one thread issues the loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      bar_expect_tx(res, L::QBYTES);
      for (int j = 0; j < D / 64; ++j)
        tma_4d(qs + j * L::Q_PANEL, &mq, 64 * j, h, q0, b, res);
      for (int it = 0; it < nk; ++it) {
        const int s = it % NST;
        bar_wait(&empty[s], ((it / NST) & 1) ^ 1);
        unsigned char* ks = ring + s * L::STAGE;
        bar_expect_tx(&full[s], L::STAGE);
        for (int j = 0; j < D / 64; ++j) {
          tma_4d(ks + j * L::TILE_PANEL, &mk, 64 * j, hk, it * BN, b,
                 &full[s]);
          tma_4d(ks + L::TILE + j * L::TILE_PANEL, &mv, 64 * j, hk, it * BN,
                 b, &full[s]);
        }
      }
    }
    return;
  }

  // consumers: warpgroup 1 + cw owns q rows r0 .. r0 + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      L::CONSUMER_REGS));
  // the warpgroup index broadcast from lane 0, so that the compiler knows
  // it (and every branch on it) to be uniform across a warp
  const int cw = __shfl_sync(0xffffffffu, tid / 128, 0) - 1;
  const int t = tid % 128, w = t / 32, l = t % 32;
  const int r0 = q0 + 64 * cw;
  const int rows[2] = {r0 + 16 * w + l / 4, r0 + 16 * w + l / 4 + 8};
  // the tiles this warpgroup's real rows see (the others: skipped)
  const int nkw =
      r0 < s_q ? kv_tiles(min(r0 + 63, s_q - 1), s_kv, offset, causal) : 0;
  const float sc2 = scale * kLog2e;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {pt::kNegInf, pt::kNegInf}, lsum[2] = {0.f, 0.f};
  uint32_t a[BN / 16][4];  // P of the previous tile, bf16

  // does kv tile `it` cross this warpgroup's diagonal or the sequence end?
  auto masked = [&](int it) {
    const int k0 = it * BN;
    return (causal && r0 + offset < k0 + BN - 1) || k0 + BN > s_kv;
  };
  auto softmax = [&](float (&sv)[BN / 2], int it, float (&alpha)[2]) {
    if (masked(it))
      softmax_tile<true>(sv, m, lsum, alpha, sc2, it * BN, s_kv, rows,
                         offset, causal, l);
    else
      softmax_tile<false>(sv, m, lsum, alpha, sc2, it * BN, s_kv, rows,
                          offset, causal, l);
  };

  bar_wait(res, 0);
  if (nkw > 0) {
    {  // tile 0: S only (O is still 0)
      bar_wait(&full[0], 0);
      float sv[BN / 2];
      fence_regs(sv);
      wgmma_fence();
      issue_qk<D, RB>(sv, qs, ring, cw);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sv);
      float alpha[2];
      softmax(sv, 0, alpha);
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) pack_a(sv, j, a[j]);
    }
    for (int it = 1; it < nkw; ++it) {
      // S of tile it runs beside O += P V of tile it - 1
      const int s = it % NST, sp = (it - 1) % NST;
      bar_wait(&full[s], (it / NST) & 1);
      float sv[BN / 2];
      fence_regs(sv);
      fence_regs(o);
      wgmma_fence();
      issue_qk<D, RB>(sv, qs, ring + s * L::STAGE, cw);
      wgmma_commit();
      issue_pv<D>(o, a, ring + sp * L::STAGE + L::TILE);
      wgmma_commit();
      wgmma_wait1();  // S is done
      fence_regs(sv);
      float alpha[2];
      softmax(sv, it, alpha);
      wgmma_wait0();  // P V is done
      fence_regs(o);
      if (t == 0) bar_arrive(&empty[sp]);  // stage of tile it - 1 is free
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) pack_a(sv, j, a[j]);
    }
    {  // the last tile's P V
      const int sp = (nkw - 1) % NST;
      fence_regs(o);
      wgmma_fence();
      issue_pv<D>(o, a, ring + sp * L::STAGE + L::TILE);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(o);
      if (t == 0) bar_arrive(&empty[sp]);
    }
  }
  for (int it = nkw; it < nk; ++it) {  // tiles only later warpgroups see
    const int s = it % NST;
    bar_wait(&full[s], (it / NST) & 1);
    if (t == 0) bar_arrive(&empty[s]);
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    lsum[e] += __shfl_xor_sync(0xffffffffu, lsum[e], 1);
    lsum[e] += __shfl_xor_sync(0xffffffffu, lsum[e], 2);
  }
  const float inv[2] = {1.f / (lsum[0] > 0.f ? lsum[0] : 1.f),
                        1.f / (lsum[1] > 0.f ? lsum[1] : 1.f)};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] *= inv[(i >> 1) & 1];
  store_rows<D>(o, out + (static_cast<long long>(b) * s_q * hq + h) * D, rows,
                s_q, static_cast<long long>(hq) * D, l);
  if (lse != nullptr && l % 4 == 0) {
    const long long bh = static_cast<long long>(b) * hq + h;
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (rows[e] < s_q)
        lse[bh * s_q + rows[e]] = (lsum[e] > 0.f && m[e] != pt::kNegInf)
                                      ? m[e] * scale + logf(lsum[e])
                                      : pt::kNegInf;
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                float* lse, int b, int s_q, int s_kv, int hq, int hkv,
                const long long* st, float scale, int causal,
                cudaStream_t stream) {
  constexpr int NST = TcTile<D>::NST, NCW = TcTile<D>::NCW;
  using L = TcLayout<D, NST, NCW>;
  constexpr int RB = L::RB;
  CUtensorMap mq, mk, mv;
  int err;
  if ((err = map_bshd(&mq, q, b, s_q, hq, D, st[0], st[1], st[2], RB)))
    return err;
  if (s_kv == 0) {
    // no key: no tile is loaded, but a map needs extents > 0; map q's
    // memory, which is never read through these maps
    if ((err = map_bshd(&mk, q, b, s_q, hq, D, st[0], st[1], st[2], BN)))
      return err;
    mv = mk;
  } else {
    if ((err = map_bshd(&mk, k, b, s_kv, hkv, D, st[3], st[4], st[5], BN)))
      return err;
    if ((err = map_bshd(&mv, v, b, s_kv, hkv, D, st[6], st[7], st[8], BN)))
      return err;
  }
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<D, NST, NCW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (s_q + RB - 1) / RB * hq * b;
  flash_fwd_tc_kernel<D, NST, NCW>
      <<<blocks, L::THREADS, L::kBytes, stream>>>(
      mq, mk, mv, static_cast<bf16*>(out), lse, b, s_q, s_kv, hq, hq / hkv,
      scale, causal);
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
// and the strides multiples of 8). Returns the launch's cudaError_t (bf16:
// cudaErrorNotSupported without the driver's tensor-map encoder,
// cudaErrorInvalidValue if it refuses an operand's strides).
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
