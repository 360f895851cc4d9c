// Shared device helpers of the port's kernels (included by every csrc/*.cu).
//
// The first design of the chunk-row kernels: one warp owns one chunk row at
// a time and its 32 lanes stride over the row, so neighbouring lanes touch
// neighbouring addresses; rows are walked grid-stride with int64 offsets.
// ef_update and the scalar variants of the two selects, of chunk_scatter and
// of fused_reduce use it. The fast "vec4" variants of the selects and of
// fused_reduce (several lanes per row, 16-byte loads, a short merge) share
// the helpers in chunk_select.cuh; the vec4 variants of the scatter and of
// fused_reduce size their grid to the card (card_blocks below).

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>
#include <utility>

namespace scalecom {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;           // warps per block: 256 threads
constexpr int64_t kMaxBlocks = 1 << 20;    // grid-stride beyond this
constexpr unsigned kFullMask = 0xffffffffu;

// The block sizes a tuned launch may take (the vec4 select at top-1,
// ef_update, the vec4 fused reduce's clt_k route at top-1), the counterpart of
// the reference autotuner's tile heights: repro_torch/kernels/build.py:
// CANDIDATE_THREADS. A launch given 0 takes kDefaultThreads. Rows are
// independent in all three kernels and each row is handled by a fixed set of
// lanes, so every size gives the same bits; only the time changes. Each size
// is its own template instantiation with its own __launch_bounds__, so the
// default one compiles as it did when the size was a constant.
using TunedThreads = std::integer_sequence<int, 64, 128, 256, 512, 1024>;
constexpr int kDefaultThreads = 256;
static_assert(kDefaultThreads == kRowsPerBlock * kWarp, "ef_update's default is one warp a row");

// launch(std::integral_constant<int, T>{}) for the T of TunedThreads equal
// to `threads` (0: kDefaultThreads); cudaErrorInvalidValue for any other.
template <typename Launch, int... T>
cudaError_t with_threads_in(int threads, Launch&& launch, std::integer_sequence<int, T...>) {
  if (threads == 0) threads = kDefaultThreads;
  cudaError_t rc = cudaErrorInvalidValue;
  (void)((threads == T && ((rc = launch(std::integral_constant<int, T>{})), true)) || ...);
  return rc;
}

template <typename Launch>
cudaError_t with_threads(int threads, Launch&& launch) {
  return with_threads_in(threads, launch, TunedThreads{});
}

inline int64_t blocks_for(int64_t rows) {
  const int64_t b = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  return b < kMaxBlocks ? b : kMaxBlocks;
}

// Blocks of `threads` threads that fill the current card once: the blocks of
// `kernel` one SM holds at a time (the occupancy calculator, at the kernel's
// registers and `smem` bytes of dynamic shared memory) times the SMs.
// Launchers cache it per kernel in a static.
template <typename Kernel>
int64_t card_blocks(Kernel kernel, int threads, size_t smem = 0) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  const int64_t b = static_cast<int64_t>(sms) * per_sm;
  return b > 0 ? b : 1;
}

// Does magnitude a at lane ia beat magnitude b at lane ib? NaN ranks above
// every number and ties go to the lower lane: the order torch.argmax and
// jnp.argmax use. It is a strict total order on (magnitude, lane) pairs.
__device__ __forceinline__ bool beats(float a, int ia, float b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return na && (!nb || ia < ib);
  return a > b || (a == b && ia < ib);
}

struct Pick {
  float key;
  int lane;
};

// One pass of the top-m select over a chunk row, by the whole warp: the best
// (key(c), c) under beats() among the lanes that rank after `prev`.
//
// The reference takes m masked-argmax passes, setting each picked lane to -1
// (below every magnitude) before the next pass. Because beats() is a strict
// total order, pass j's pick is simply the best lane that ranks after pass
// j-1's pick, so no mask is kept: a row of any width needs no shared memory.
// key(c) must be |x| at lane c (>= 0 or NaN). Every lane returns the pick:
// the xor-butterfly merge leaves the maximum of the order in all 32 lanes.
template <typename KeyFn>
__device__ __forceinline__ Pick warp_pick(KeyFn key, int chunk, bool first,
                                          Pick prev) {
  const int lane = threadIdx.x;
  float best = -1.0f;  // below every magnitude: an empty lane never wins
  int best_i = INT_MAX;
  for (int c = lane; c < chunk; c += kWarp) {
    const float a = key(c);
    if (!first && !beats(prev.key, prev.lane, a, c)) continue;  // picked before
    if (beats(a, c, best, best_i)) {
      best = a;
      best_i = c;
    }
  }
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(kFullMask, best, off);
    const int oi = __shfl_xor_sync(kFullMask, best_i, off);
    if (beats(ob, oi, best, best_i)) {
      best = ob;
      best_i = oi;
    }
  }
  return Pick{best, best_i};
}

}  // namespace scalecom
