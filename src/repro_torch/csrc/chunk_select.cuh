// The vectorised chunk-row select: the "vec4" variant of chunk_argmax
// (csrc/scalecom_kernels.cu; replaces src/repro/kernels/chunk_topk.py:
// _argmax_kernel) and chunk_topm (csrc/chunk_topm_gather.cu; replaces
// _topm_kernel), the one kernel template at M = 1 and at M = topm.
//
// Both selects stream a (rows, chunk) fp32 view once and write a few bytes
// per row, so they are bound by device-memory bytes: rows*chunk*4 read and
// rows*M*8 written (a row of 64 floats is 256 bytes read for 8 * M bytes
// written). At the tok_embed shapes (8 workers, 2,368,000 rows of 64) that
// is 0.187 ms at M = 1 and 0.192 ms at M = 2 on an H100 (3.35 TB/s).
//
// What held the one-warp-per-row design (the scalar variant) back was
// latency, not bandwidth: 4-byte loads left at most 256 bytes in flight per
// warp, and a dependent 5-round shuffle merge sat between one row's loads
// and the next. This design attacks both:
//
//  * Bytes in flight. L lanes share a row (L = 4 at chunk 64), so a warp
//    owns 32 / L rows at once. Each lane issues all its 16-byte loads of a
//    batch (kBatch float4 = 64 bytes) before it compares anything: 2 KB per
//    warp, and with 40+ warps resident some 80-100 KB per SM, well past the
//    ~25 KB that Little's law asks for at 3.35 TB/s and ~700 ns.
//    Neighbouring lanes of a row read neighbouring 16 bytes, so each load
//    instruction touches whole 32-byte sectors.
//  * A short merge. Each lane keeps its best M (rank, offset, value) in
//    registers (M <= kVecMaxTopm, a template), then the row's L lanes merge
//    their lists with log2(L) xor-shuffle rounds (2 at chunk 64), not 5. The
//    row is read once for any M: no second pass, no L1 re-read.
//
// On an H100 (700 W, chip_smoke.py) the kernel reaches ~89 % of the byte
// bound at M = 1. At M > 1 the per-element insert (M compares, 3M selects)
// sets the pace, which is why the in-lane list compares 32-bit ranks, not
// 64-bit keys.
//
// The order is beats() of common.cuh: NaN above every number, all NaNs
// equal, ties to the lower offset. Inside a lane it is a 32-bit rank of |x|
// compared strictly in scan order (LaneList); across lanes, one unsigned
// 64-bit key of (rank, offset) (TopList). It is a strict total order on
// distinct offsets, so the top-M set does not depend on the order in which
// lanes scan or merge, and any merge tree gives the reference's picks. Values
// are carried beside the keys, so the value returned is x at that offset bit
// for bit (-0, NaN payloads).
//
// Needs chunk % 4 == 0 and a 16-byte-aligned base (every row then starts
// 16-byte aligned); repro_torch/kernels/chunk_topk.py:select_variant sends
// other tensors, and top-m above kVecMaxTopm, to the scalar kernels.

#pragma once

#include "common.cuh"

// Internal linkage: each source that includes this header instantiates its
// own kernels (chunk_argmax M = 1, chunk_topm M = 1..kVecMaxTopm).
namespace scalecom {
namespace {

constexpr int kVecMaxTopm = 8;      // register lists up to this many picks
constexpr int kSelectThreads = kDefaultThreads;  // 8 warps per block
constexpr int kBatch = 4;            // float4 loads a lane issues before comparing

// |v| ranked for the scan of one lane: 1 + its bit pattern, with every NaN
// clamped to one value above +inf (NaN ranks above every number, all NaNs
// tie). 0 is an empty slot, below every element.
__device__ __forceinline__ uint32_t lane_rank(float v) {
  return min(__float_as_uint(v) & 0x7fffffffu, 0x7f800001u) + 1u;
}

// The best M elements one lane has seen, best first, as (rank, offset,
// value). A lane scans its offsets in increasing order, so a strictly
// greater rank is the whole of beats() here: an equal rank came later and
// has the higher offset. 32-bit compares keep the per-element insert short
// (it is what bounds the kernel's issue rate at M > 1). Only static indices
// touch the arrays, so they stay in registers.
template <int M>
struct LaneList {
  uint32_t rank[M];
  int32_t off[M];
  float val[M];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int j = 0; j < M; ++j) {
      rank[j] = 0;
      off[j] = -1;
      val[j] = 0.0f;
    }
  }

  // Insert: the entries it beats shift down one place, the last drops.
  __device__ __forceinline__ void push(uint32_t r, int32_t c, float v) {
    bool above[M];
#pragma unroll
    for (int j = 0; j < M; ++j) above[j] = r > rank[j];
#pragma unroll
    for (int j = M - 1; j > 0; --j) {
      rank[j] = above[j - 1] ? rank[j - 1] : (above[j] ? r : rank[j]);
      off[j] = above[j - 1] ? off[j - 1] : (above[j] ? c : off[j]);
      val[j] = above[j - 1] ? val[j - 1] : (above[j] ? v : val[j]);
    }
    rank[0] = above[0] ? r : rank[0];
    off[0] = above[0] ? c : off[0];
    val[0] = above[0] ? v : val[0];
  }

  __device__ __forceinline__ void push4(float4 v, int32_t c) {
    push(lane_rank(v.x), c, v.x);
    push(lane_rank(v.y), c + 1, v.y);
    push(lane_rank(v.z), c + 2, v.z);
    push(lane_rank(v.w), c + 3, v.w);
  }
};

// Across lanes the offsets interleave, so the merge compares (rank, offset)
// as one unsigned 64-bit key whose order is beats(): rank in the high word,
// ~offset in the low word (the lower offset ranks higher among equal ranks).
// An empty slot (rank 0, offset -1) is key 0, below every element.
template <int M>
struct TopList {
  uint64_t key[M];
  float val[M];

  __device__ __forceinline__ explicit TopList(const LaneList<M>& l) {
#pragma unroll
    for (int j = 0; j < M; ++j) {
      key[j] = (static_cast<uint64_t>(l.rank[j]) << 32) | static_cast<uint32_t>(~l.off[j]);
      val[j] = l.val[j];
    }
  }

  __device__ __forceinline__ int32_t offset(int j) const {
    return static_cast<int32_t>(~static_cast<uint32_t>(key[j]));
  }

  __device__ __forceinline__ void push(uint64_t k, float v) {
    bool above[M];
#pragma unroll
    for (int j = 0; j < M; ++j) above[j] = k > key[j];
#pragma unroll
    for (int j = M - 1; j > 0; --j) {
      key[j] = above[j - 1] ? key[j - 1] : (above[j] ? k : key[j]);
      val[j] = above[j - 1] ? val[j - 1] : (above[j] ? v : val[j]);
    }
    key[0] = above[0] ? k : key[0];
    val[0] = above[0] ? v : val[0];
  }
};

// Merge the lists of the L lanes that share a row (L a power of two, the
// lanes aligned on L): after log2(L) xor rounds each of them holds the top M
// of the whole row. The lists of two partners hold disjoint offsets.
template <int L, int M>
__device__ __forceinline__ void merge_row_lanes(TopList<M>& t) {
#pragma unroll
  for (int off = 1; off < L; off <<= 1) {
    uint64_t ok[M];
    float ov[M];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      ok[j] = __shfl_xor_sync(kFullMask, t.key[j], off);
      ov[j] = __shfl_xor_sync(kFullMask, t.val[j], off);
    }
#pragma unroll
    for (int j = 0; j < M; ++j) t.push(ok[j], ov[j]);
  }
}

// Per row of x (rows, 4 * vecs), the top M offsets by beats() into idx
// (rows, M) int32 and the values there into val (rows, M). Warps walk groups
// of 32 / L rows grid-stride; row offsets are int64 (a worker-stacked tensor
// can pass 2^31 elements). kThreads is the block size it is launched with.
template <int L, int M, int kThreads>
__global__ void __launch_bounds__(kThreads)
chunk_select_vec4_kernel(const float4* __restrict__ x, int32_t* __restrict__ idx,
                         float* __restrict__ val, int64_t rows, int vecs) {
  constexpr int kRowsPerWarp = kWarp / L;
  const int lane = threadIdx.x % kWarp;
  const int sub = lane % L;  // this lane's place in its row
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * blockDim.x / kWarp;
  for (int64_t r0 = warp * kRowsPerWarp; r0 < rows; r0 += warps * kRowsPerWarp) {
    const int64_t r = r0 + lane / L;
    const bool live = r < rows;
    const float4* row = x + (live ? r : 0) * vecs;
    LaneList<M> mine;
    mine.clear();
    for (int q0 = sub; q0 < vecs; q0 += kBatch * L) {
      float4 v[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {  // every load before any compare
        const int q = q0 + b * L;
        v[b] = (live && q < vecs) ? __ldg(row + q) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int q = q0 + b * L;
        if (live && q < vecs) mine.push4(v[b], 4 * q);
      }
    }
    TopList<M> best(mine);
    merge_row_lanes<L, M>(best);
    if (live && sub == 0) {
#pragma unroll
      for (int j = 0; j < M; ++j) {
        idx[r * M + j] = best.offset(j);
        val[r * M + j] = best.val[j];
      }
    }
  }
}

// Lanes per row: about kBatch float4 loads per lane, a power of two <= 32.
inline int select_lanes(int64_t vecs) {
  int lanes = 1;
  while (lanes < kWarp && lanes * 2 * kBatch <= vecs) lanes <<= 1;
  return lanes;
}

template <int L, int M, int kThreads>
cudaError_t launch_select_vec4(const float* x, int32_t* idx, float* val,
                               int64_t rows, int64_t chunk, cudaStream_t stream) {
  constexpr int64_t kBlockRows = (kThreads / kWarp) * (kWarp / L);
  int64_t blocks = (rows + kBlockRows - 1) / kBlockRows;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  chunk_select_vec4_kernel<L, M, kThreads><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(x), idx, val, rows, static_cast<int>(chunk / 4));
  return cudaGetLastError();
}

// kThreads: kSelectThreads, or a TunedThreads size at M = 1 (chunk_argmax).
template <int M, int kThreads = kSelectThreads>
cudaError_t select_vec4_lanes(const float* x, int32_t* idx, float* val,
                              int64_t rows, int64_t chunk, cudaStream_t stream) {
  switch (select_lanes(chunk / 4)) {
    case 1: return launch_select_vec4<1, M, kThreads>(x, idx, val, rows, chunk, stream);
    case 2: return launch_select_vec4<2, M, kThreads>(x, idx, val, rows, chunk, stream);
    case 4: return launch_select_vec4<4, M, kThreads>(x, idx, val, rows, chunk, stream);
    case 8: return launch_select_vec4<8, M, kThreads>(x, idx, val, rows, chunk, stream);
    case 16: return launch_select_vec4<16, M, kThreads>(x, idx, val, rows, chunk, stream);
    default: return launch_select_vec4<32, M, kThreads>(x, idx, val, rows, chunk, stream);
  }
}

}  // namespace
}  // namespace scalecom
