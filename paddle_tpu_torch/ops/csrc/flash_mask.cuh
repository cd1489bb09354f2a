// Score masks of the flash kernels (flash_fwd.cu: K1; flash_bwd.cu: K2, K3)
// beyond the causal one, chosen at compile time by a MODE parameter:
//
//  kNone  no further mask (the dense paths; this instantiation is the code
//         the kernels had before masks existed);
//  kSeg   segment ids, q_seg [b, s_q] and kv_seg [b, s_kv]: a score is
//         masked where q_seg[row] != kv_seg[col] (packed variable-length
//         batches; `with_seg` of the TPU kernels,
//         paddle_tpu/ops/flash_attention.py:117, :337, :420);
//  kRow   per-kv-column row bounds, start/end [b, hm, s_kv]: a score is
//         masked where start[col] <= row < end[col], row being the q row's
//         index, bounds row (kv head % hm) (flashmask's LT encodings;
//         `with_rowmask` of the same kernels).
//
// Masked scores take the finite NEG_INF of the causal mask, on top of it.
// The ids and bounds are int32, contiguous, read from global memory through
// the read-only path: a wgmma kernel loads the 16 columns of a 64-wide tile
// that a thread holds (hopper.cuh's accumulator layout) into registers
// while the tile's products run.
#pragma once

#include "common.cuh"

namespace fmask {

constexpr int kNone = 0, kSeg = 1, kRow = 2;

// The mask operands of one launch; null pointers where the mode does not
// use them.
struct Args {
  const int* q_seg;
  const int* kv_seg;
  const int* start;
  const int* end;
  int hm;
};

// The mask of one (batch, kv head): pointers moved to its rows.
struct View {
  const int* q_seg;   // [s_q]
  const int* kv_seg;  // [s_kv]
  const int* start;   // [s_kv]
  const int* end;     // [s_kv]
};

template <int MODE>
__device__ __forceinline__ View view(const Args& a, int b, int hk, int s_q,
                                     int s_kv) {
  View v{nullptr, nullptr, nullptr, nullptr};
  if constexpr (MODE == kSeg) {
    v.q_seg = a.q_seg + static_cast<long long>(b) * s_q;
    v.kv_seg = a.kv_seg + static_cast<long long>(b) * s_kv;
  } else if constexpr (MODE == kRow) {
    const long long off =
        (static_cast<long long>(b) * a.hm + hk % a.hm) * s_kv;
    v.start = a.start + off;
    v.end = a.end + off;
  }
  return v;
}

// Is the score of q row r (< s_q) and kv column c (< s_kv) masked?
template <int MODE>
__device__ __forceinline__ bool hidden(const View& v, int r, int c) {
  if constexpr (MODE == kSeg)
    return __ldg(v.q_seg + r) != __ldg(v.kv_seg + c);
  else if constexpr (MODE == kRow)
    return r >= __ldg(v.start + c) && r < __ldg(v.end + c);
  else
    return false;
}

// Index of accumulator element i's column among the 16 columns of a 64-wide
// tile that a thread holds: column 8 (i / 4) + 2 (lane % 4) + i % 2.
__device__ __forceinline__ constexpr int col_slot(int i) {
  return 2 * (i >> 2) + (i & 1);
}

// ids[col_slot(i)] = src[c0 + column of i], clamped to the last of the n
// entries (columns past the end are masked by their caller).
__device__ __forceinline__ void load_cols(int (&ids)[16], const int* src,
                                          int c0, int n, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u)
      ids[2 * j + u] = __ldg(src + min(c0 + 8 * j + 2 * (lane % 4) + u,
                                       n - 1));
}

// The per-column operands of one kv tile (K1, K2: columns are kv rows):
// kSeg the kv ids, kRow the bounds; nothing in kNone.
template <int MODE>
struct KvCols {
  __device__ __forceinline__ void load(const View&, int, int, int) {}
  __device__ __forceinline__ bool hidden(int, int, int) const {
    return false;
  }
};
template <>
struct KvCols<kSeg> {
  int id[16];
  __device__ __forceinline__ void load(const View& v, int k0, int s_kv,
                                       int lane) {
    load_cols(id, v.kv_seg, k0, s_kv, lane);
  }
  // row_id: the q row's segment id; row: its index
  __device__ __forceinline__ bool hidden(int i, int row_id, int) const {
    return row_id != id[col_slot(i)];
  }
};
template <>
struct KvCols<kRow> {
  int st[16], en[16];
  __device__ __forceinline__ void load(const View& v, int k0, int s_kv,
                                       int lane) {
    load_cols(st, v.start, k0, s_kv, lane);
    load_cols(en, v.end, k0, s_kv, lane);
  }
  __device__ __forceinline__ bool hidden(int i, int, int row) const {
    return row >= st[col_slot(i)] && row < en[col_slot(i)];
  }
};

// The segment id of q row r (kSeg; 0 otherwise), r clamped into [0, s_q).
template <int MODE>
__device__ __forceinline__ int row_id(const View& v, int r, int s_q) {
  if constexpr (MODE == kSeg)
    return __ldg(v.q_seg + min(r, s_q - 1));
  else
    return 0;
}

}  // namespace fmask
