// Paged-KV decode attention for Hopper (sm_90a), CUDA C++: K4.
//
// Replaces the Pallas TPU kernel `_paged_decode_kernel`
// (paddle_tpu/ops/paged_attention.py:174, driven by `paged_decode_attention`
// :271).
//
// What it computes: one query token per row over a paged KV pool
// [num_pages, kv_heads, page, head_dim]. Row b reads its first
// context_lens[b] tokens through its block table (negative ids clamp to page
// 0, as the TPU kernel and the reference do; pages past the row's length are
// never read), attends them with an fp32 softmax scaled by `scale`, and
// writes zeros when its length is 0 (parked serving slots stay inert).
//
// What bounds it on the H100: one token per row does 4 * head_dim operations
// per cached token and q head for 4 * head_dim bytes of bf16 K/V per kv head,
// 1 to 8 operations a byte at groups 1 to 8, so it is bounded by memory: the
// least time is the K/V bytes the rows' lengths need over 3.35 TB/s (0.0041
// ms for 8 rows of 0-640 tokens, 16 kv heads of 128, bf16).
//
// What the design does about it:
//  - One launch. A cluster of CL blocks serves one (row, kv head): its
//    blocks split the row's own length, read on the device, into
//    page-aligned ranges. CL (<= 8) is the largest size at which every
//    cluster of the grid is resident at once (a second wave of blocks
//    would pay the whole latency chain again), asked of the card once per
//    instantiation. The grid depends on the shapes only, so a CUDA graph
//    replays the kernel while lengths and tables change.
//  - The split merged on chip. Each block merges its warps' partials
//    (max, sum, unnormalised output) and sends them in slices through
//    distributed shared memory: block o of the cluster receives every
//    block's share of output elements [o slice, (o + 1) slice) and every
//    block's maxima and sums. After one cluster barrier each block merges
//    its slice, senders in rank order, and writes it to `out`. Sends are
//    stores, so no block waits on another's reads, and no block reads
//    another's memory after the barrier, so none waits for the others to
//    leave (the barrier's first half, arrived at when a block starts,
//    guarantees that every block is running before the first send). No
//    scratch in device memory, no second kernel, no atomics: results are
//    identical run to run.
//  - A ring of pages by bulk copy. One kv head's slice of a page is
//    contiguous (page * head_dim elements, 4 KB at bf16 / 128 / page 16), so
//    each page's K and V tokens are one `cp.async.bulk` each into an
//    NST-stage ring of CT-token stages behind full/empty mbarriers (bounded
//    waits that trap). A producer warp reads the stage's table entries, one
//    lane a page, and starts the copies; NW consumer warps compute. K and
//    V stay in their own dtype in shared memory. Stage size and depth are
//    constants per (dtype, head_dim, group block), the fastest on the card.
//  - Arithmetic spread over the warp. A lane holds one 16-byte piece of
//    head_dim, so a token row takes LPT lanes and a warp TPW tokens a pass;
//    the group's q rows sit in fp32 registers, scaled by scale * log2(e) so
//    that the softmax runs on exp2. Shuffles over a token's lanes give the
//    scores; each token slot of a warp keeps its own online softmax (max,
//    sum, output piece) in registers, rescaled once per stage; slots, then
//    warps (shared memory), then blocks (cluster) merge at the end.
//  - FMAs, not tensor cores: the kernel moves 1 to 8 operations a byte.
//  - Groups above 8 take ceil(group / 8) clusters per (row, kv head), each
//    with 8 q heads in registers; each reads the kv head's pages.
//
// int8 pools (the block format of `QuantizedKVPool`: int8 pages and one
// fp32 absmax scale per (page, kv head)). The TPU package never gave its
// Pallas kernel the dequant (it routes int8 pools to the dense-gather
// reference); here the same kernel takes them, with the pool type KT apart
// from q's type T:
//  - the ring holds the int8 page rows as they are, bulk-copied like the
//    float pages (page * head_dim bytes a page and kv head, 2 KB at page
//    16 / head_dim 128), so the K/V bytes read are half of bf16's;
//  - a lane still holds VEC = 16 / sizeof(T) elements of head_dim, which
//    for int8 is a VEC-byte piece of the row, so the register layout is
//    that of the float kernel;
//  - the producer lane that copies a page also loads its two fp32 scales
//    (ordinary loads: a 4-byte bulk copy is not allowed) and leaves
//    scale / 127 beside the stage in shared memory; every producer lane
//    then arrives on the stage's full barrier too (33 arrivals with the
//    one that sets the bytes), which releases those stores to the
//    consumers. (Consumers loading the scales themselves, table entry
//    then scale, doubled the kernel's time at the `main` shape: a chain
//    of two dependent loads each stage.)
//  - the consumers fold scale_k / 127 into each key's score and
//    scale_v / 127 into each token's weight on V; the softmax sum takes
//    the weights unscaled. Everything else (cluster split, DSMEM merge,
//    zero-length rows, bitwise determinism) is the float kernel's.
#include <stdint.h>

#include <type_traits>

#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_CL = 8;          // the portable cluster size limit
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, typename KT, int D, int G>
struct Tile {
  // consumer warps, passes a consumer warp takes a stage and ring stages:
  // the fastest on the card (PERF.md section 6)
  static constexpr int NW = G <= 2 ? 8 : 4;
  static constexpr int U = 4;
  static constexpr int NST = 3;
  static constexpr int NT = 32 * (NW + 1);    // and one producer warp
  static constexpr int VEC = 16 / sizeof(T);  // elements of a 16-byte q piece
  static constexpr int LPT = D / VEC;         // lanes a token row takes
  static constexpr int TPW = 32 / LPT;        // tokens a warp pass takes
  static constexpr int CT = U * NW * TPW;     // tokens a stage holds
  static constexpr int ROW = D * sizeof(KT);  // bytes of one token row
  static constexpr int STAGE = 2 * CT * ROW;  // K rows, then V rows
  static constexpr int PARTIALS = NW * G * (D + 2) * 4;
  static_assert(LPT <= 32 && 32 % LPT == 0, "a warp holds whole rows");
  // shared memory (byte offsets): the ring, which the warps' partials
  // reuse once every stage is consumed; the barriers; the slices other
  // blocks of the cluster send ([MAX_CL] senders x their share of the
  // G x D outputs, then their maxima and sums); the weights of the warps
  // and of the senders, 1 / sum, and the block's maxima and sums.
  static constexpr int RING =
      NST * STAGE > PARTIALS ? NST * STAGE : PARTIALS;
  static constexpr int BARS = RING;
  static constexpr int XACC = BARS + 2 * NST * 8;
  static constexpr int XM = XACC + (G * D + MAX_CL) * 4;
  static constexpr int XL = XM + MAX_CL * G * 4;
  static constexpr int WW = XL + MAX_CL * G * 4;   // [NW][G]
  static constexpr int WR = WW + NW * G * 4;       // [MAX_CL][G]
  static constexpr int BM = WR + MAX_CL * G * 4;   // max [G], sum [G], 1/sum [G]
  // int8 pools: each stage's dequant steps of K and V, one a page the
  // stage touches (at most CT + 1)
  static constexpr int SEGS = CT + 1;
  static constexpr int STEPS = BM + 3 * G * 4;     // [NST][2][SEGS]
  static constexpr int kBytes =
      STEPS + (sizeof(KT) == 1 ? NST * 2 * SEGS * 4 : 0);
  static_assert(kBytes <= 232448, "fits a block's shared memory");
};

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// exp2 weights of partials against their maximum: a partial that saw no
// token has max -inf and weight 0, also when every partial is empty.
__device__ __forceinline__ float ref_max(float m) {
  return m == -INFINITY ? 0.f : m;
}

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

// VEC pool elements of a row from shared memory, as floats: a 16-byte
// piece of a float pool, a VEC-byte piece of an int8 pool.
template <int N>
struct Word;
template <>
struct Word<4> { using type = uint32_t; };
template <>
struct Word<8> { using type = uint2; };

__device__ __forceinline__ uint32_t word(uint32_t w, int) { return w; }
__device__ __forceinline__ uint32_t word(const uint2& w, int j) {
  return j == 0 ? w.x : w.y;
}

// Four int8 values to floats with full-rate instructions (int-to-float
// conversion runs at a quarter of the FMA rate): the byte, offset by 128 to
// unsigned, becomes the low mantissa byte of 2^23, and one subtraction of
// 2^23 + 128 leaves its value, exactly.
__device__ __forceinline__ void int8x4_to_float(uint32_t w, float* dst) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    dst[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) -
             8388736.f;
}

template <typename KT, int VEC>
__device__ __forceinline__ void load_piece(const KT* p, bool valid,
                                           float* dst) {
  if constexpr (std::is_same_v<KT, int8_t>) {
    typename Word<VEC>::type raw{};
    if (valid) raw = *reinterpret_cast<const typename Word<VEC>::type*>(p);
#pragma unroll
    for (int j = 0; j < VEC / 4; ++j) int8x4_to_float(word(raw, j), dst + 4 * j);
  } else {
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (valid) raw = *reinterpret_cast<const uint4*>(p);
    unpack(raw, dst, KT());
  }
}

// Grid (CL, hkv * nhb, b), clusters of (CL, 1, 1): one cluster per (row,
// kv head, block of G q heads). KT is the pool's element type: T, or int8_t
// with the [P, hkv] scales ksc / vsc (unused for float pools).
template <typename T, typename KT, int D, int G>
__global__ void __launch_bounds__(Tile<T, KT, D, G>::NT)
paged_decode_kernel(const T* __restrict__ q, const KT* __restrict__ kc,
                    const KT* __restrict__ vc, const float* __restrict__ ksc,
                    const float* __restrict__ vsc,
                    const int* __restrict__ tables,
                    const int* __restrict__ lens, T* __restrict__ out,
                    int hkv, int group, int nhb, int page, int maxp,
                    float qscale) {
  using C = Tile<T, KT, D, G>;
  constexpr bool kQuant = std::is_same_v<KT, int8_t>;
  constexpr int NW = C::NW, NT = C::NT, U = C::U, VEC = C::VEC,
                LPT = C::LPT, TPW = C::TPW, CT = C::CT, NST = C::NST;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BARS);
  uint64_t* empty = full + NST;
  float* xacc = reinterpret_cast<float*>(smem + C::XACC);  // [cl][slice]
  float* xm = reinterpret_cast<float*>(smem + C::XM);      // [MAX_CL][G]
  float* xl = reinterpret_cast<float*>(smem + C::XL);      // [MAX_CL][G]
  float* ww = reinterpret_cast<float*>(smem + C::WW);      // [NW][G]
  float* wr = reinterpret_cast<float*>(smem + C::WR);      // [MAX_CL][G]
  float* bm = reinterpret_cast<float*>(smem + C::BM);      // [G]
  float* bl = bm + G;                                      // [G]
  float* inv_l = bl + G;                                   // [G]
  float* stage_steps = reinterpret_cast<float*>(smem + C::STEPS);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cl = static_cast<int>(cluster.num_blocks());
  // this block has started: others may write its shared memory once every
  // block has arrived here (the wait comes before the first such write)
  hopper::cluster_arrive_relaxed();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.y / nhb, hb = blockIdx.y % nhb, b = blockIdx.z;
  const int gc = min(G, group - hb * G);  // q heads of this block
  const long long qrow = static_cast<long long>(b) * hkv * group + h * group + hb * G;

  // this block's page-aligned share of the row's tokens
  const int len = min(max(lens[b], 0), maxp * page);
  const int npg = (len + page - 1) / page;
  const int per = (npg + cl - 1) / cl;
  const int t_begin = min(len, rank * per * page);
  const int ntok = min(len, (rank + 1) * per * page) - t_begin;
  const int nstage = (ntok + CT - 1) / CT;

  if (tid == 0) {
    for (int s = 0; s < NST; ++s) {
      // the producer's arrive + the bytes (int8: and one arrive of every
      // producer lane, releasing its dequant steps)
      hopper::bar_init(&full[s], kQuant ? 33 : 1);
      hopper::bar_init(&empty[s], NW);  // one arrive per consumer warp
    }
    hopper::bar_init_fence();
  }
  __syncthreads();

  float m[G], l[G], acc[G][VEC];
  const int piece = lane % LPT, slot = lane / LPT;
  if (warp == NW) {
    // producer: stage i holds tokens [a, e) of the row, one bulk copy of K
    // and one of V for each page they touch, a lane a page
    const int* trow = tables + static_cast<long long>(b) * maxp;
    for (int i = 0; i < nstage; ++i) {
      const int s = i % NST;
      const int a = t_begin + i * CT, e = min(t_begin + ntok, a + CT);
      if (lane == 0) {
        hopper::bar_wait(&empty[s], ((i / NST) & 1) ^ 1);
        hopper::bar_expect_tx(&full[s], (e - a) * 2 * C::ROW);
      }
      __syncwarp();
      KT* kd = reinterpret_cast<KT*>(smem + s * C::STAGE);
      KT* vd = kd + CT * D;
      float* steps = stage_steps + s * 2 * C::SEGS;
      const int p0 = a / page, nseg = (e - 1) / page - p0 + 1;
      for (int j = lane; j < nseg; j += 32) {
        const int pg = p0 + j;
        const int s0 = max(a, pg * page), s1 = min(e, (pg + 1) * page);
        const long long blk = static_cast<long long>(max(trow[pg], 0)) * hkv + h;
        const long long src = blk * page + (s0 - pg * page);
        hopper::bulk_copy(kd + (s0 - a) * D, kc + src * D,
                          (s1 - s0) * C::ROW, &full[s]);
        hopper::bulk_copy(vd + (s0 - a) * D, vc + src * D,
                          (s1 - s0) * C::ROW, &full[s]);
        if (kQuant) {
          steps[j] = ksc[blk] / 127.f;
          steps[C::SEGS + j] = vsc[blk] / 127.f;
        }
      }
      if (kQuant) hopper::bar_arrive(&full[s]);  // releases its steps
    }
  } else {
    float qf[G][VEC];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      m[g] = -INFINITY;
      l[g] = 0.f;
#pragma unroll
      for (int c = 0; c < VEC; ++c) acc[g][c] = qf[g][c] = 0.f;
      if (g < gc) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            q + (qrow + g) * D + piece * VEC);
        unpack(raw, qf[g], T());
#pragma unroll
        for (int c = 0; c < VEC; ++c) qf[g][c] *= qscale;
      }
    }
    for (int i = 0; i < nstage; ++i) {
      const int s = i % NST;
      const int n = min(CT, ntok - i * CT);
      const KT* ks = reinterpret_cast<const KT*>(smem + s * C::STAGE);
      const KT* vs = ks + CT * D;
      hopper::bar_wait(&full[s], (i / NST) & 1);
      // int8: the dequant steps of the pages of this warp's token slots,
      // as the producer left them beside the stage
      float kstep[U], vstep[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        kstep[u] = vstep[u] = 1.f;
        const int t = (u * NW + warp) * TPW + slot;
        if (kQuant && t < n) {
          const int a = t_begin + i * CT;
          const float* steps = stage_steps + s * 2 * C::SEGS;
          const int j = (a + t) / page - a / page;
          kstep[u] = steps[j];
          vstep[u] = steps[C::SEGS + j];
        }
      }
      // scores of this warp's U passes (token slot `slot` of each)
      float sc[U][G];
      bool valid[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = (u * NW + warp) * TPW + slot;
        valid[u] = t < n;
        float kf[VEC];
        load_piece<KT, VEC>(ks + t * D + piece * VEC, valid[u], kf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float d = 0.f;
#pragma unroll
          for (int c = 0; c < VEC; ++c) d = fmaf(qf[g][c], kf[c], d);
          sc[u][g] = d;
        }
      }
#pragma unroll
      for (int o = 1; o < LPT; o <<= 1)
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int g = 0; g < G; ++g)
            sc[u][g] += __shfl_xor_sync(0xffffffffu, sc[u][g], o);
      if (kQuant) {
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int g = 0; g < G; ++g) sc[u][g] *= kstep[u];
      }
      // online softmax of the slot, rescaled once for the U passes
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float mx = m[g];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (!valid[u]) sc[u][g] = -INFINITY;
          mx = fmaxf(mx, sc[u][g]);
        }
        const float mr = ref_max(mx);
        const float alpha = fast_exp2(m[g] - mr);
        m[g] = mx;
        float sum = l[g] * alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          sc[u][g] = fast_exp2(sc[u][g] - mr);
          sum += sc[u][g];
        }
        l[g] = sum;
#pragma unroll
        for (int c = 0; c < VEC; ++c) acc[g][c] *= alpha;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!valid[u]) continue;
        const int t = (u * NW + warp) * TPW + slot;
        float vf[VEC];
        load_piece<KT, VEC>(vs + t * D + piece * VEC, true, vf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float w = kQuant ? sc[u][g] * vstep[u] : sc[u][g];
#pragma unroll
          for (int c = 0; c < VEC; ++c) acc[g][c] = fmaf(w, vf[c], acc[g][c]);
        }
      }
      __syncwarp();
      if (lane == 0) hopper::bar_arrive(&empty[s]);
    }
    // merge the warp's token slots (lanes LPT apart)
#pragma unroll
    for (int o = LPT; o < 32; o <<= 1)
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
        const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
        const float mx = fmaxf(m[g], mo), mr = ref_max(mx);
        const float wa = fast_exp2(m[g] - mr), wb = fast_exp2(mo - mr);
        l[g] = l[g] * wa + lo * wb;
#pragma unroll
        for (int c = 0; c < VEC; ++c) {
          const float ao = __shfl_xor_sync(0xffffffffu, acc[g][c], o);
          acc[g][c] = acc[g][c] * wa + ao * wb;
        }
        m[g] = mx;
      }
  }

  // the warps' partials, in the ring (every stage is consumed)
  float* wacc = reinterpret_cast<float*>(smem);  // [NW][G][D]
  float* wm = wacc + NW * G * D;                 // [NW][G]
  float* wl = wm + NW * G;                       // [NW][G]
  __syncthreads();
  if (warp < NW && slot == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float4* dst = reinterpret_cast<float4*>(
          wacc + (warp * G + g) * D + piece * VEC);
#pragma unroll
      for (int c = 0; c < VEC; c += 4)
        dst[c / 4] = make_float4(acc[g][c], acc[g][c + 1], acc[g][c + 2],
                                 acc[g][c + 3]);
      if (piece == 0) {
        wm[warp * G + g] = m[g];
        wl[warp * G + g] = l[g];
      }
    }
  }
  __syncthreads();
  // the block's maximum and sum, and the warps' weights, warps in order
  if (tid < G) {
    const int g = tid;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, wm[w * G + g]);
    const float mr = ref_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float wt = fast_exp2(wm[w * G + g] - mr);
      ww[w * G + g] = wt;
      sum = fmaf(wt, wl[w * G + g], sum);
    }
    bm[g] = mx;
    bl[g] = sum;
  }
  __syncthreads();
  // the block's partial, sent in slices: block o of the cluster merges
  // output elements [o slice, (o + 1) slice) and receives each block's
  // share of them, and every block's maxima and sums
  const int slice = (G * D + cl - 1) / cl;
  hopper::cluster_wait();  // every block of the cluster has started
  for (int e = tid; e < G * D; e += NT) {
    const int g = e / D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w)
      a = fmaf(ww[w * G + g], wacc[(w * G + g) * D + e % D], a);
    const int o = e / slice;
    cluster.map_shared_rank(xacc, o)[rank * slice + e - o * slice] = a;
  }
  if (tid < G * cl) {
    const int o = tid / G, g = tid % G;
    cluster.map_shared_rank(xm, o)[rank * G + g] = bm[g];
    cluster.map_shared_rank(xl, o)[rank * G + g] = bl[g];
  }
  hopper::cluster_arrive();  // releases the sends
  hopper::cluster_wait();    // every block's sends have landed here
  // the cluster's merge of this block's slice, blocks in rank order; no
  // block reads another's shared memory, so none waits for the others to
  // leave
  if (tid < G) {
    const int g = tid;
    float mx = -INFINITY;
    for (int r = 0; r < cl; ++r) mx = fmaxf(mx, xm[r * G + g]);
    const float mr = ref_max(mx);
    float sum = 0.f;
    for (int r = 0; r < cl; ++r) {
      const float wt = fast_exp2(xm[r * G + g] - mr);
      wr[r * G + g] = wt;
      sum = fmaf(wt, xl[r * G + g], sum);
    }
    inv_l[g] = sum > 0.f ? 1.f / sum : 0.f;  // a row of length 0: zeros
  }
  __syncthreads();
  const int e_end = min(gc * D, (rank + 1) * slice);
  for (int e = rank * slice + tid; e < e_end; e += NT) {
    const int g = e / D, i = e - rank * slice;
    float a = 0.f;
    for (int r = 0; r < cl; ++r) a = fmaf(wr[r * G + g], xacc[r * slice + i], a);
    out[qrow * D + e] = pt::from_f<T>(a * inv_l[g]);
  }
}

template <typename T, typename KT, int D, int G>
int launch(const void* q, const void* kc, const void* vc, const float* ksc,
           const float* vsc, const int* tables, const int* lens, void* out,
           int b, int hkv, int group, int page, int maxp, float scale,
           cudaStream_t stream) {
  constexpr int smem = Tile<T, KT, D, G>::kBytes;
  auto kernel = paged_decode_kernel<T, KT, D, G>;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(Tile<T, KT, D, G>::NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  // once per instantiation: the shared-memory size, then how many clusters
  // of 1, 2, 4 and 8 blocks the card holds at once
  static int resident[4] = {-1, -1, -1, -1};
  if (resident[0] < 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    for (int i = 0; i < 4 && err == cudaSuccess; ++i) {
      attrs[0].val.clusterDim.x = 1 << i;
      cfg.gridDim = dim3(1 << i, 1, 1);
      err = cudaOccupancyMaxActiveClusters(&resident[i], kernel, &cfg);
    }
    if (err != cudaSuccess) {
      resident[0] = -1;
      return static_cast<int>(err);
    }
    if (resident[0] < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  }
  // the cluster size: the largest (<= 8, <= the table's pages) at which
  // every cluster of the grid is resident at once
  const int nhb = (group + G - 1) / G;
  const int clusters = b * hkv * nhb;
  int lg = 0;
  while (lg < 3 && (2 << lg) <= maxp && clusters <= resident[lg + 1]) ++lg;
  const int cl = 1 << lg;
  attrs[0].val.clusterDim.x = cl;
  cfg.gridDim = dim3(cl, hkv * nhb, b);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q), static_cast<const KT*>(kc),
      static_cast<const KT*>(vc), ksc, vsc, tables, lens,
      static_cast<T*>(out), hkv, group, nhb, page, maxp, scale * kLog2e);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename KT, int D>
int launch_group(const void* q, const void* kc, const void* vc,
                 const float* ksc, const float* vsc, const int* tables,
                 const int* lens, void* out, int b, int hkv, int group,
                 int page, int maxp, float scale, cudaStream_t s) {
  if (group <= 1)
    return launch<T, KT, D, 1>(q, kc, vc, ksc, vsc, tables, lens, out, b, hkv, group, page, maxp, scale, s);
  if (group <= 2)
    return launch<T, KT, D, 2>(q, kc, vc, ksc, vsc, tables, lens, out, b, hkv, group, page, maxp, scale, s);
  if (group <= 4)
    return launch<T, KT, D, 4>(q, kc, vc, ksc, vsc, tables, lens, out, b, hkv, group, page, maxp, scale, s);
  return launch<T, KT, D, 8>(q, kc, vc, ksc, vsc, tables, lens, out, b, hkv, group, page, maxp, scale, s);
}

// q's type T and head_dim, then the pool type: T itself (int8 = false) or
// int8 pages with scales.
template <typename T>
int launch_dim(const void* q, const void* kc, const void* vc,
               const float* ksc, const float* vsc, const int* tables,
               const int* lens, void* out, bool int8, int b, int hkv,
               int group, int d, int page, int maxp, float scale,
               cudaStream_t s) {
  if (d == 64 && int8)
    return launch_group<T, int8_t, 64>(q, kc, vc, ksc, vsc, tables, lens, out, b, hkv, group, page, maxp, scale, s);
  if (d == 128 && int8)
    return launch_group<T, int8_t, 128>(q, kc, vc, ksc, vsc, tables, lens, out, b, hkv, group, page, maxp, scale, s);
  if (d == 64)
    return launch_group<T, T, 64>(q, kc, vc, ksc, vsc, tables, lens, out, b, hkv, group, page, maxp, scale, s);
  if (d == 128)
    return launch_group<T, T, 128>(q, kc, vc, ksc, vsc, tables, lens, out, b, hkv, group, page, maxp, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch(const void* q, const void* kc, const void* vc, const void* ksc,
             const void* vsc, const void* tables, const void* lens, void* out,
             bool int8, int dtype, int b, int hq, int hkv, int d, int page,
             int maxp, float scale, void* stream) {
  const int group = hq / hkv;
  const int* t = static_cast<const int*>(tables);
  const int* l = static_cast<const int*>(lens);
  const float* ks = static_cast<const float*>(ksc);
  const float* vs = static_cast<const float*>(vsc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dim<float>(q, kc, vc, ks, vs, t, l, out, int8, b, hkv, group, d, page, maxp, scale, s);
  if (dtype == 1)
    return launch_dim<__nv_bfloat16>(q, kc, vc, ks, vs, t, l, out, int8, b, hkv, group, d, page, maxp, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q [b, hq, d] and out [b, hq, d] contiguous, 16-byte aligned; pools [P,
// hkv, page, d] contiguous and 16-byte aligned; tables [b, maxp] int32;
// lens [b] int32. All on the device. dtype (of q, out and the pools):
// 0 = float32, 1 = bfloat16. One kernel launch; returns its cudaError_t
// (cudaErrorLaunchOutOfResources if no cluster of the chosen size fits the
// card), else 0.
extern "C" int paddle_paged_decode(const void* q, const void* kc,
                                   const void* vc, const void* tables,
                                   const void* lens, void* out, int dtype,
                                   int b, int hq, int hkv, int d, int page,
                                   int maxp, float scale, void* stream) {
  return dispatch(q, kc, vc, nullptr, nullptr, tables, lens, out, false,
                  dtype, b, hq, hkv, d, page, maxp, scale, stream);
}

// The same on int8 pools: kc / vc [P, hkv, page, d] int8, ksc / vsc [P, hkv]
// float32 absmax scales (a stored value x_q stands for x_q * scale / 127),
// all contiguous; dtype is q's and out's.
extern "C" int paddle_paged_decode_int8(const void* q, const void* kc,
                                        const void* vc, const void* ksc,
                                        const void* vsc, const void* tables,
                                        const void* lens, void* out,
                                        int dtype, int b, int hq, int hkv,
                                        int d, int page, int maxp,
                                        float scale, void* stream) {
  return dispatch(q, kc, vc, ksc, vsc, tables, lens, out, true, dtype, b, hq,
                  hkv, d, page, maxp, scale, stream);
}
