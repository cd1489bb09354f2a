// Hopper (sm_90a) building blocks of the port's TMA + wgmma kernels
// (grouped_matmul.cu: K5/K6; flash_fwd.cu: K1; flash_bwd.cu: K2/K3) and of
// the paged decode (paged_decode.cu: K4): mbarriers whose waits are
// bounded, split cluster barriers, TMA tile loads and plain bulk copies,
// cuTensorMapEncodeTiled, shared-memory matrix descriptors for the
// 128-byte swizzle, the wgmma instructions, and the [b, s, h, d] tensor
// maps and row stores of the flash kernels.
//
// Layout facts the kernels rely on (128-byte swizzle, bf16):
//  - TMA writes a box whose inner dimension is 64 elements (128 bytes) as
//    rows of 128 bytes, 8-row groups 1024 bytes apart: a "panel". A wider
//    operand is several panels side by side.
//  - K-major operand (the reduction runs along the 128-byte row): the
//    descriptor's stride offset is 1024 (8-row groups), its leading offset
//    unused; a 16-deep step advances 32 bytes in the row (kmajor_desc).
//  - MN-major operand (the reduction runs down the rows): the leading
//    offset is the stride between 64-wide panels, the stride offset that
//    between 8-row groups; a 16-deep step advances 16 rows, 2048 bytes
//    (mnmajor_desc). This assignment was found on the card.
//  - wgmma's fp32 accumulator d[4 b + q] of thread t of a warpgroup holds
//    row 16 (t / 32) + (t % 32) / 4 + 8 (q / 2), column 8 b + 2 (t % 4) +
//    q % 2 of the 64-row tile. Columns 16 j .. 16 j + 15 of it, rounded to
//    bf16 in pairs (d[8 j], d[8 j + 1]), ..., (d[8 j + 6], d[8 j + 7]), are
//    exactly the register A operand of a product whose 16-deep step j runs
//    over those columns (pack_a).
// fp16 has bf16's 2-byte layout, so all of the above holds for it too: the
// 16-bit element type T (bf16 or fp16, `Elem<T>`) is a template parameter
// of the wgmma forms (.bf16 / .f16 operands, fp32 accumulators), of the
// register packing (pack_a), of the tensor maps and of the row stores.
#pragma once

#include <stdint.h>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace hopper {

// The 16-bit element types of the tensor-core kernels: the tensor-map
// type, pairs of fp32 rounded to two elements (round to nearest even; an
// fp16 value past 65504 becomes inf), and two elements widened to fp32.
template <typename T>
struct Elem;
template <>
struct Elem<__nv_bfloat16> {
  static constexpr bool kHalf = false;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  __device__ static __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  __device__ static __forceinline__ float2 unpack(uint32_t x) {
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
  }
};
template <>
struct Elem<__half> {
  static constexpr bool kHalf = true;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  __device__ static __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  __device__ static __forceinline__ float2 unpack(uint32_t x) {
    return __half22float2(*reinterpret_cast<__half2*>(&x));
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(count));
}
// Makes the initialised barriers visible; a __syncthreads must follow.
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void bar_expect_tx(uint64_t* b, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(b)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b))
               : "memory");
}
// Wait for the phase of parity `parity` to complete; bounded, so that a
// phase that never completes traps instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint64_t* b, int parity) {
  for (long long spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred P;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P;\n}\n"
        : "=r"(done) : "r"(smem_u32(b)), "r"(parity) : "memory");
    if (done) return;
    if (spins > (1ll << 22)) __trap();
  }
}
// Split cluster barrier: every thread of every block of the cluster
// arrives, then waits. `cluster_arrive` releases this thread's earlier
// writes (distributed shared memory included) to the threads that
// `cluster_wait` (acquire) after the barrier; `cluster_arrive_relaxed`
// orders nothing (it only marks that this block has started).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// Barrier `id` (1-15; 0 is __syncthreads) over `count` threads.
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Copy `bytes` contiguous bytes from device memory to this block's shared
// memory (1-D bulk copy, no tensor map); completion counts `bytes` on
// `bar`. Both addresses and `bytes` must be multiples of 16.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void tma_4d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, int c2, int c3,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar)) : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t smem_desc(const void* p, int lbo,
                                              int sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// K-major operand in one 64-deep panel: 16-deep step kk (0-3).
__device__ __forceinline__ uint64_t kmajor_desc(const unsigned char* p,
                                                int kk) {
  return smem_desc(p + kk * 32, 16, 1024);
}
// MN-major operand: 16-deep step kk, panels `panel` bytes apart.
__device__ __forceinline__ uint64_t mnmajor_desc(const unsigned char* p,
                                                 int kk, int panel) {
  return smem_desc(p + kk * 2048, panel, 1024);
}

// Pins registers in order around the asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Wait until at most the last committed group is still running.
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Register A operand (elements T) of 16-deep step j from the accumulator
// columns 16 j .. 16 j + 15 (see the header comment).
template <typename T = __nv_bfloat16, int N>
__device__ __forceinline__ void pack_a(const float (&d)[N], int j,
                                       uint32_t (&a)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
    a[r] = Elem<T>::pack(d[8 * j + 2 * r], d[8 * j + 2 * r + 1]);
}

// d (+)= A B for a 64 x 64 tile over one 16-deep step, A and B both
// K-major in shared memory; acc = 0 overwrites d.
#define PT_WGMMA_SS_N64(TY)                                                                                      \
  asm volatile(                                                                                                  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                                               \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                                               \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "                                             \
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "                                             \
      "%26, %27, %28, %29, %30, %31"                                                                             \
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                                                         \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),          \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),    \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])   \
      : "l"(da), "l"(db), "r"(acc))
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int acc) {
  if constexpr (Elem<T>::kHalf)
    PT_WGMMA_SS_N64("f16");
  else
    PT_WGMMA_SS_N64("bf16");
}

// d += A B for a 64 x 64 tile over one 16-deep step: A from registers, B
// MN-major in shared memory.
#define PT_WGMMA_RS_N64(TY)                                                                                      \
  asm volatile(                                                                                                  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                                               \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                                               \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "                                             \
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "                                             \
      "%26, %27, %28, %29, %30, %31"                                                                             \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                                                           \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),          \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),    \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])   \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  if constexpr (Elem<T>::kHalf)
    PT_WGMMA_RS_N64("f16");
  else
    PT_WGMMA_RS_N64("bf16");
}

// The same for a 64 x 128 tile.
#define PT_WGMMA_RS_N128(TY)                                                                                     \
  asm volatile(                                                                                                  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                                               \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"                                              \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "                                             \
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "                                             \
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "                                             \
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "                                             \
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "                                             \
      "%62, %63"                                                                                                 \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                                                           \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),          \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),    \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),  \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),  \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),  \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),  \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])   \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  if constexpr (Elem<T>::kHalf)
    PT_WGMMA_RS_N128("f16");
  else
    PT_WGMMA_RS_N128("bf16");
}

// d += A B for a 64 x 256 tile over one 16-deep step, both operands in
// shared memory; TA / TB = 1 reads that operand MN-major.
#define PT_WGMMA_SS_N256(TY)                                                                                             \
  asm volatile(                                                                                                          \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"                                                                      \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {"                                                      \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                           \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "                                 \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "                                 \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "                                 \
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "                                 \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "                                 \
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "                     \
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"                   \
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"                                                                         \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                  \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),            \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),          \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),          \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),          \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),          \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),          \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),          \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),          \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),          \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),          \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),          \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),      \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),  \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),  \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])   \
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB))
template <int TA, int TB, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t da,
                                              uint64_t db) {
  if constexpr (Elem<T>::kHalf)
    PT_WGMMA_SS_N256("f16");
  else
    PT_WGMMA_SS_N256("bf16");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// link against libcuda); null if the driver does not offer it.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map of 2-byte elements of `type` (bf16 unless given) of `rank`
// (<= 5) dimensions (innermost first; strides in bytes of dimensions 1..),
// 128-byte swizzle, out-of-range elements read as 0. Returns 0,
// cudaErrorNotSupported without the driver's encoder, or
// cudaErrorInvalidValue if the driver refuses the map.
inline int make_map(CUtensorMap* m, const void* base, int rank,
                    const cuuint64_t* dims, const cuuint64_t* strides,
                    const cuuint32_t* box,
                    CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  auto encode = [&] {
    return fn(m, type, rank,
              const_cast<void*>(base), dims, strides, box, unit,
              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  };
  CUresult r = encode();
  if (r != CUDA_SUCCESS) {
    // The encoder is a driver call and needs the device's context current
    // on this host thread. A thread that has made no runtime call needing
    // one (the autograd engine's worker thread, when a flash backward is
    // its first launch) has none yet: cudaSetDevice makes it current.
    int dev;
    if (cudaGetDevice(&dev) == cudaSuccess && cudaSetDevice(dev) == cudaSuccess)
      r = encode();
  }
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// ---- flash attention's [b, s, h, d] operands (flash_fwd.cu, flash_bwd.cu)

// A tensor map over one [b, s, h, d] operand of element type T (bf16 or
// fp16) read through its element strides (batch, seq, head; d contiguous);
// a box is 64 head_dim columns of `rows` sequence rows of one (batch,
// head).
template <typename T = __nv_bfloat16>
inline int map_bshd(CUtensorMap* m, const void* base, int b, int s, int h,
                    int d, long long sb, long long ss, long long sh,
                    int rows) {
  using u64 = cuuint64_t;
  const u64 dims[4] = {static_cast<u64>(d), static_cast<u64>(h),
                       static_cast<u64>(s), static_cast<u64>(b)};
  const u64 strides[3] = {static_cast<u64>(sh) * 2, static_cast<u64>(ss) * 2,
                          static_cast<u64>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  return make_map(m, base, 4, dims, strides, box, Elem<T>::kMap);
}

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// Store a warpgroup's 64 x D fp32 accumulator as rows of T (bf16 or fp16;
// fp16 rounds a value past 65504 to inf) of a contiguous [b, s, h, D]
// output (row stride rs elements); rows[e] are this thread's two rows,
// those >= n are not stored.
template <int D, typename T = __nv_bfloat16>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2], T* out,
                                           const int (&rows)[2], int n,
                                           long long rs, int lane) {
#pragma unroll
  for (int bb = 0; bb < D / 8; ++bb)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (rows[e] < n)
        *reinterpret_cast<uint32_t*>(out + rows[e] * rs + 8 * bb +
                                     2 * (lane % 4)) =
            Elem<T>::pack(acc[4 * bb + 2 * e], acc[4 * bb + 2 * e + 1]);
}

}  // namespace hopper
