// The one-row variant of the fused reduce (csrc/fused_reduce.cu), for one rank
// of a process group: select and Eq. 5 update in one launch, no ĝ.
//
// Over one worker's residue m and gradient g viewed as (rows, chunk), per
// chunk row r:
//
//   select  top-M of |m + g| (kKey false: clt_k's leader), or of |key| (kKey
//           true: true_topk's leader, key the oracle's worker mean)
//   update  vals[r, j] = (m + g)[idx[j]], m' = m + beta * (g - own), own the
//           selected ef entries
//
// and stores idx, vals and m'. On a process group the values go through an
// all-reduce between this launch and the scatter that makes ĝ, so the fused
// reduce's worker mean and ĝ store have no place here (the fused reduce
// replaces src/repro/kernels/fused_reduce.py:_fused_kernel; this is its
// variant). The order of operations is ef_update's and the order of the
// select is the selects' (beats() in common.cuh), each op rounded on its own,
// so the outputs equal chunk_argmax / chunk_topm followed by ef_update bit
// for bit, and repro_torch/kernels/fused_reduce.py:fused_select_update_plain.
//
// The design is the vec4 fused kernel's (fused_reduce_vec4.cuh) at one
// worker: L lanes share a row (L = 4 at chunk 64), each lane owns chunk / L
// floats as float4s and issues all its 16-byte loads of a batch before any
// compare, the lanes' LaneLists merge in log2(L) shuffle rounds, and m' is
// stored with __stcs. Where a lane's share of the row is one batch (chunk <=
// 16 * L, as at chunk 64) its m and g float4s stay in registers from the
// select to the update, so the row is read once; wider rows read them again
// (from L1/L2). With a key, the select reads the key and, in that one-batch
// case, m and g beside it.
//
// Bound: device-memory bytes. Reads m and g (2 * rows * chunk * 4 bytes; the
// key adds rows * chunk * 4), writes m' (rows * chunk * 4), idx and vals
// (rows * M * 8): at the tok_embed one-row shapes (296,000 rows of 64, top-1)
// 229.7 MB, 0.0686 ms at the H100's 3.35 TB/s, against a few fp32 operations
// per element.
//
// Internal linkage, as chunk_select.cuh: fused_select_update.cu instantiates
// the m + g kernels and holds the entry, fused_select_update_key.cu the keyed
// ones, so nvcc builds the two sets in parallel.

#pragma once

#include "chunk_select.cuh"
#include "common.cuh"
#include "fused_reduce_vec4.cuh"

namespace scalecom {

// The keyed launch (fused_select_update_key.cu): M = topm, `threads` a
// TunedThreads size at M = 1 (0: the default), else 0.
cudaError_t select_update_keyed(const float* m, const float* g, const float* key, int32_t* idx,
                                float* vals, float* m_out, int64_t rows, int64_t chunk,
                                int64_t topm, float beta, int threads, cudaStream_t st);

namespace {

// Per row of the (rows, 4 * vecs) m and g (and key): select M offsets, update
// (see above). Lane `sub` of a row owns the float4s b * kSpan + k * L + sub
// (batch b, slot k < kBatch). kThreads is the block size it is launched with.
template <int L, int M, bool kKey, int kThreads>
__global__ void __launch_bounds__(kThreads)
select_update_kernel(const float4* __restrict__ m, const float4* __restrict__ g,
                     const float4* __restrict__ key, int32_t* __restrict__ idx,
                     float* __restrict__ vals, float4* __restrict__ m_out, int64_t rows,
                     int vecs, float beta) {
  constexpr int kRowsPerWarp = kWarp / L;
  constexpr int kSpan = kBatch * L;  // float4s of a row one batch of its L lanes covers
  const int lane = threadIdx.x % kWarp;
  const int sub = lane % L;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * blockDim.x / kWarp;
  const int batches = (vecs + kSpan - 1) / kSpan;
  for (int64_t r0 = warp * kRowsPerWarp; r0 < rows; r0 += warps * kRowsPerWarp) {
    const int64_t r = r0 + lane / L;
    const bool live = r < rows;
    const int64_t row = (live ? r : 0) * vecs;
    auto owns = [&](int b, int k) { return live && b * kSpan + k * L + sub < vecs; };
    auto load = [&](Quads& d, int b) {
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const bool ok = owns(b, k);
        const int64_t at = row + b * kSpan + k * L + sub;
        d.m[k] = ok ? __ldg(m + at) : make_float4(0.f, 0.f, 0.f, 0.f);
        d.g[k] = ok ? __ldg(g + at) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    };

    // -- select; a one-batch row keeps its m and g for the update
    LaneList<M> mine;
    mine.clear();
    Quads keep;
    for (int b = 0; b < batches; ++b) {
      Quads d;
      float4 kv[kBatch];
      if (!kKey || batches == 1) load(d, b);
      if constexpr (kKey) {
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {  // every load before any compare
          kv[k] = owns(b, k) ? __ldg(key + row + b * kSpan + k * L + sub)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (owns(b, k)) {
          mine.push4(kKey ? kv[k] : add4(d.m[k], d.g[k]), 4 * (b * kSpan + k * L + sub));
        }
      }
      if (batches == 1) keep = d;
    }
    TopList<M> best(mine);
    merge_row_lanes<L, M>(best);
    int32_t pick[M];
#pragma unroll
    for (int j = 0; j < M; ++j) pick[j] = best.offset(j);
    if (live && sub == 0) {
#pragma unroll
      for (int j = 0; j < M; ++j) idx[r * M + j] = pick[j];
    }

    // -- update; the lane that owns pick j writes its value
    float v[M];
#pragma unroll
    for (int j = 0; j < M; ++j) v[j] = 0.0f;
    for (int b = 0; b < batches; ++b) {
      Quads d;
      if (batches == 1) {
        d = keep;
      } else {
        load(d, b);
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (!owns(b, k)) continue;
        const int q = b * kSpan + k * L + sub;
        const float4 mv = d.m[k], gv = d.g[k];
        float4 o;
        o.x = update_at<M>(mv.x, gv.x, 4 * q, pick, v, beta);
        o.y = update_at<M>(mv.y, gv.y, 4 * q + 1, pick, v, beta);
        o.z = update_at<M>(mv.z, gv.z, 4 * q + 2, pick, v, beta);
        o.w = update_at<M>(mv.w, gv.w, 4 * q + 3, pick, v, beta);
        __stcs(m_out + row + q, o);
      }
    }
#pragma unroll
    for (int j = 0; j < M; ++j) {
      if (live && (pick[j] >> 2) % L == sub) vals[r * M + j] = v[j];
    }
  }
}

// One instance over a grid of at most one card's fill, grid-stride beyond it.
template <int L, int M, bool kKey, int kThreads>
cudaError_t launch_select_update(const float* m, const float* g, const float* key, int32_t* idx,
                                 float* vals, float* m_out, int64_t rows, int64_t chunk,
                                 float beta, cudaStream_t stream) {
  const auto kernel = select_update_kernel<L, M, kKey, kThreads>;
  static int64_t fill = 0;
  if (!fill) fill = card_blocks(kernel, kThreads);
  constexpr int64_t kBlockRows = (kThreads / kWarp) * (kWarp / L);
  int64_t blocks = (rows + kBlockRows - 1) / kBlockRows;
  if (blocks > fill) blocks = fill;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(m), reinterpret_cast<const float4*>(g),
      reinterpret_cast<const float4*>(key), idx, vals, reinterpret_cast<float4*>(m_out), rows,
      static_cast<int>(chunk / 4), beta);
  return cudaGetLastError();
}

template <int M, bool kKey, int kThreads = kDefaultThreads>
cudaError_t select_update_lanes(const float* m, const float* g, const float* key, int32_t* idx,
                                float* vals, float* m_out, int64_t rows, int64_t chunk,
                                float beta, cudaStream_t st) {
#define SCALECOM_SELECT_UPDATE(L) \
  launch_select_update<L, M, kKey, kThreads>(m, g, key, idx, vals, m_out, rows, chunk, beta, st)
  switch (select_lanes(chunk / 4)) {
    case 1: return SCALECOM_SELECT_UPDATE(1);
    case 2: return SCALECOM_SELECT_UPDATE(2);
    case 4: return SCALECOM_SELECT_UPDATE(4);
    case 8: return SCALECOM_SELECT_UPDATE(8);
    case 16: return SCALECOM_SELECT_UPDATE(16);
    default: return SCALECOM_SELECT_UPDATE(32);
  }
#undef SCALECOM_SELECT_UPDATE
}

// M = topm <= kVecMaxTopm; at M = 1 in blocks of `threads` (a TunedThreads
// size, 0 the default), else only threads == 0 (kDefaultThreads).
template <bool kKey>
cudaError_t select_update_topm(const float* m, const float* g, const float* key, int32_t* idx,
                               float* vals, float* m_out, int64_t rows, int64_t chunk,
                               int64_t topm, float beta, int threads, cudaStream_t st) {
  if (topm == 1) {
    return with_threads(threads, [&](auto t) {
      return select_update_lanes<1, kKey, decltype(t)::value>(m, g, key, idx, vals, m_out, rows,
                                                              chunk, beta, st);
    });
  }
  if (threads != 0) return cudaErrorInvalidValue;
#define SCALECOM_SELECT_UPDATE_TOPM(M) \
  case M:                              \
    return select_update_lanes<M, kKey>(m, g, key, idx, vals, m_out, rows, chunk, beta, st)
  static_assert(kVecMaxTopm == 8, "one case per register-list length");
  switch (topm) {
    SCALECOM_SELECT_UPDATE_TOPM(2);
    SCALECOM_SELECT_UPDATE_TOPM(3);
    SCALECOM_SELECT_UPDATE_TOPM(4);
    SCALECOM_SELECT_UPDATE_TOPM(5);
    SCALECOM_SELECT_UPDATE_TOPM(6);
    SCALECOM_SELECT_UPDATE_TOPM(7);
    SCALECOM_SELECT_UPDATE_TOPM(8);
    default: return cudaErrorInvalidValue;
  }
#undef SCALECOM_SELECT_UPDATE_TOPM
}

}  // namespace
}  // namespace scalecom
