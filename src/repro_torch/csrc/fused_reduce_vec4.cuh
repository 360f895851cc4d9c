// The vec4 variant of the fused reduce (csrc/fused_reduce.cu describes it):
// the kernel template over (lanes per row L, picks M, true_topk, staged) and
// its launchers. Internal linkage, as chunk_select.cuh: fused_reduce.cu
// instantiates the clt_k kernels, fused_reduce_true_topk.cu the true_topk
// ones, so nvcc builds the two sets in parallel.

#pragma once

#include <cuda_pipeline.h>

#include "chunk_select.cuh"
#include "common.cuh"

namespace scalecom {

// true_topk's vec4 launch (fused_reduce_true_topk.cu), at M = topm.
cudaError_t fused_vec4_true_topk(const float* m, const float* g, int32_t* idx, float* vals,
                                 float* m_out, float* ghat, int64_t rows, int64_t workers,
                                 int64_t chunk, int64_t topm, float beta, cudaStream_t st);

namespace {

constexpr int kCltK = 0;  // mode: the index in repro_torch.kernels.fused_reduce.MODES
constexpr int kFusedThreads = 256;      // 8 warps per block
constexpr int kStagedThreads = 128;     // a staged true_topk block: 4 warps, 32 rows at chunk 64
constexpr int kStageBytes = 200 << 10;  // the most shared memory a staged block takes

// One (worker, batch) step of a lane: kBatch float4s of m and of g.
struct Quads {
  float4 m[kBatch];
  float4 g[kBatch];
};

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float4 div4(float4 a, float d) {
  return make_float4(__fdiv_rn(a.x, d), __fdiv_rn(a.y, d), __fdiv_rn(a.z, d), __fdiv_rn(a.w, d));
}

// Eq. 5 at offset c, in ef_update_kernel's order of operations; v[j] takes
// ef where c is pick j.
template <int M>
__device__ __forceinline__ float update_at(float mv, float gv, int c, const int32_t (&pick)[M],
                                           float (&v)[M], float beta) {
  const float ef = __fadd_rn(mv, gv);
  float own = (c == pick[0]) ? ef : 0.0f;
  v[0] = (c == pick[0]) ? ef : v[0];
#pragma unroll
  for (int j = 1; j < M; ++j) {  // top-m: the offsets are distinct
    const bool hit = c == pick[j];
    own = __fadd_rn(own, hit ? ef : 0.0f);
    v[j] = hit ? ef : v[j];
  }
  return __fadd_rn(mv, __fmul_rn(beta, __fsub_rn(gv, own)));
}

// ĝ at offset c: the mean of pick j where c is pick j, else 0.
template <int M>
__device__ __forceinline__ float ghat_at(int c, const int32_t (&pick)[M], const float (&mean)[M]) {
  float x = 0.0f;
#pragma unroll
  for (int j = 0; j < M; ++j) x = (c == pick[j]) ? mean[j] : x;
  return x;
}

// Per row of the (workers, rows, 4 * vecs) m and g: select M offsets, update
// every worker, write ĝ (see fused_reduce.cu). kTrue: the true_topk select,
// else clt_k on the leader's row. kStaged (true_topk only): every (worker,
// batch) step of the row is copied to shared memory first, and the select
// and the update read that copy; else they load from device memory (L2).
// Lane `sub` of a row owns the float4s b * kSpan + k * L + sub of it (batch
// b, slot k < kBatch).
template <int L, int M, bool kTrue, bool kStaged>
__global__ void __launch_bounds__(kFusedThreads, 1)
fused_reduce_vec4_kernel(const float4* __restrict__ m, const float4* __restrict__ g,
                         int32_t* __restrict__ idx, float* __restrict__ vals,
                         float4* __restrict__ m_out, float4* __restrict__ ghat,
                         int64_t rows, int workers, int vecs, int leader, float beta) {
  constexpr int kRowsPerWarp = kWarp / L;
  constexpr int kSpan = kBatch * L;  // float4s of a row one batch of its L lanes covers
  const int lane = threadIdx.x % kWarp;
  const int sub = lane % L;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * blockDim.x / kWarp;
  const int64_t plane = rows * vecs;  // float4s of one worker's slab
  const int batches = (vecs + kSpan - 1) / kSpan;
  const int steps = workers * batches;
  const float count = static_cast<float>(workers);
  extern __shared__ float4 stage[];  // a staged block's copy of its rows
  for (int64_t r0 = warp * kRowsPerWarp; r0 < rows; r0 += warps * kRowsPerWarp) {
    const int64_t r = r0 + lane / L;
    const bool live = r < rows;
    const int64_t row = (live ? r : 0) * vecs;
    auto owns = [&](int b, int k) { return live && b * kSpan + k * L + sub < vecs; };
    auto load = [&](Quads& d, int w, int b) {
      const int64_t at = w * plane + row + b * kSpan + sub;
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const bool ok = owns(b, k);
        d.m[k] = ok ? __ldg(m + at + k * L) : make_float4(0.f, 0.f, 0.f, 0.f);
        d.g[k] = ok ? __ldg(g + at + k * L) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    };

    // a staged block's copy of the row: slot (step, k, m or g) of this thread;
    // the threads of a slot are adjacent, so copies and reads are free of
    // bank conflicts
    auto slot = [&](int st, int k, int t) {
      return stage + ((st * kBatch + k) * 2 + t) * static_cast<int>(blockDim.x) + threadIdx.x;
    };
    auto read = [&](Quads& d, int st, int b) {
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const bool ok = owns(b, k);
        d.m[k] = ok ? *slot(st, k, 0) : make_float4(0.f, 0.f, 0.f, 0.f);
        d.g[k] = ok ? *slot(st, k, 1) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    };

    // -- select
    LaneList<M> mine;
    mine.clear();
    if constexpr (kStaged) {
      // every (worker, batch) step of the row in flight at once, into shared
      // memory; then, batch by batch, s = sum_w ef_w in worker order and |s / G|
      for (int st = 0; st < steps; ++st) {
        const int w = st / batches, b = st % batches;
        const int64_t at = w * plane + row + b * kSpan + sub;
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          if (!owns(b, k)) continue;
          __pipeline_memcpy_async(slot(st, k, 0), m + at + k * L, sizeof(float4));
          __pipeline_memcpy_async(slot(st, k, 1), g + at + k * L, sizeof(float4));
        }
      }
      __pipeline_commit();
      __pipeline_wait_prior(0);  // each thread reads back only its own slots
      for (int b = 0; b < batches; ++b) {
        float4 s[kBatch];
        for (int w = 0; w < workers; ++w) {
          Quads d;
          read(d, w * batches + b, b);
#pragma unroll
          for (int k = 0; k < kBatch; ++k) {
            const float4 ef = add4(d.m[k], d.g[k]);
            s[k] = w == 0 ? ef : add4(s[k], ef);
          }
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          if (owns(b, k)) mine.push4(div4(s[k], count), 4 * (b * kSpan + k * L + sub));
        }
      }
    } else if constexpr (!kTrue) {
      for (int b = 0; b < batches; ++b) {
        Quads d;
        load(d, leader, b);  // every load before any compare
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          if (owns(b, k)) mine.push4(add4(d.m[k], d.g[k]), 4 * (b * kSpan + k * L + sub));
        }
      }
    } else {
      // batch by batch, the workers in order: s = sum_w ef_w, then |s / G|
      float4 s[kBatch];
      Quads cur, nxt;
      load(cur, 0, 0);
      for (int st = 0; st < steps; ++st) {
        const int b = st / workers, w = st % workers;
        if (st + 1 < steps) load(nxt, (st + 1) % workers, (st + 1) / workers);
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const float4 ef = add4(cur.m[k], cur.g[k]);
          s[k] = w == 0 ? ef : add4(s[k], ef);
        }
        if (w == workers - 1) {
#pragma unroll
          for (int k = 0; k < kBatch; ++k) {
            if (owns(b, k)) mine.push4(div4(s[k], count), 4 * (b * kSpan + k * L + sub));
          }
        }
        cur = nxt;
      }
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

    // -- update, worker by worker in order; vals and the worker sums of the picks
    float v[M], sum[M];
#pragma unroll
    for (int j = 0; j < M; ++j) v[j] = sum[j] = 0.0f;
    Quads cur, nxt;
    if constexpr (!kStaged) load(cur, 0, 0);
    for (int st = 0; st < steps; ++st) {
      const int w = st / batches, b = st % batches;
      if constexpr (kStaged) {
        read(cur, st, b);
      } else if (st + 1 < steps) {
        load(nxt, (st + 1) / batches, (st + 1) % batches);
      }
      const int64_t at = w * plane + row;
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (!owns(b, k)) continue;
        const int q = b * kSpan + k * L + sub;
        const float4 mv = cur.m[k], gv = cur.g[k];
        float4 o;
        o.x = update_at<M>(mv.x, gv.x, 4 * q, pick, v, beta);
        o.y = update_at<M>(mv.y, gv.y, 4 * q + 1, pick, v, beta);
        o.z = update_at<M>(mv.z, gv.z, 4 * q + 2, pick, v, beta);
        o.w = update_at<M>(mv.w, gv.w, 4 * q + 3, pick, v, beta);
        __stcs(m_out + at + q, o);
      }
      if (b == batches - 1) {  // worker w done: its values at the picks this lane owns
#pragma unroll
        for (int j = 0; j < M; ++j) {
          if (live && (pick[j] >> 2) % L == sub) vals[(w * rows + r) * M + j] = v[j];
          sum[j] = w == 0 ? v[j] : __fadd_rn(sum[j], v[j]);
        }
      }
      if constexpr (!kStaged) cur = nxt;
    }

    // -- ĝ: zeros with the worker mean at each pick
    float mean[M];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      mean[j] = __fdiv_rn(sum[j], count);
      // chunk_scatter sums top-m entries onto zeros, which turns -0 into +0
      if (M > 1) mean[j] = __fadd_rn(mean[j], 0.0f);
    }
    for (int b = 0; b < batches; ++b) {
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (!owns(b, k)) continue;
        const int q = b * kSpan + k * L + sub;
        ghat[row + q] =
            make_float4(ghat_at<M>(4 * q, pick, mean), ghat_at<M>(4 * q + 1, pick, mean),
                        ghat_at<M>(4 * q + 2, pick, mean), ghat_at<M>(4 * q + 3, pick, mean));
      }
    }
  }
}

// One vec4 instance over a grid that fills the card once (at most `cap`
// blocks), with `smem` bytes of dynamic shared memory per block.
template <int L, int M, bool kTrue, bool kStaged>
cudaError_t launch_vec4(const float* m, const float* g, int32_t* idx, float* vals, float* m_out,
                        float* ghat, int64_t rows, int64_t workers, int64_t chunk, int leader,
                        float beta, int threads, size_t smem, int64_t cap, cudaStream_t stream) {
  const auto kernel = fused_reduce_vec4_kernel<L, M, kTrue, kStaged>;
  static int64_t fill = 0;  // cached for the last smem size
  static size_t fill_smem = 0;
  if (!fill && kStaged) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kStageBytes);
  }
  if (!fill || smem != fill_smem) {
    fill = card_blocks(kernel, threads, smem);
    fill_smem = smem;
  }
  const int64_t block_rows = threads / kWarp * (kWarp / L);
  int64_t blocks = (rows + block_rows - 1) / block_rows;
  if (blocks > fill) blocks = fill;
  if (blocks > cap) blocks = cap;
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      reinterpret_cast<const float4*>(m), reinterpret_cast<const float4*>(g), idx, vals,
      reinterpret_cast<float4*>(m_out), reinterpret_cast<float4*>(ghat), rows,
      static_cast<int>(workers), static_cast<int>(chunk / 4), leader, beta);
  return cudaGetLastError();
}

// clt_k: one grid that fills the card. true_topk: staged in shared memory
// where a block's rows fit in kStageBytes (G <= 12 at chunk <= 512), else
// the L2 re-read, with the rows in flight within half the L2 (and at least
// one block per SM).
template <int L, int M, bool kTrue>
cudaError_t launch_fused_vec4(const float* m, const float* g, int32_t* idx, float* vals,
                              float* m_out, float* ghat, int64_t rows, int64_t workers,
                              int64_t chunk, int leader, float beta, cudaStream_t stream) {
  if constexpr (!kTrue) {
    return launch_vec4<L, M, false, false>(m, g, idx, vals, m_out, ghat, rows, workers, chunk,
                                           leader, beta, kFusedThreads, 0, INT64_MAX, stream);
  } else {
    constexpr int64_t kSpan = kBatch * L;
    const int64_t steps = workers * ((chunk / 4 + kSpan - 1) / kSpan);
    const int64_t stage =
        steps * kBatch * 2 * static_cast<int64_t>(sizeof(float4)) * kStagedThreads;
    if (stage <= kStageBytes) {
      return launch_vec4<L, M, true, true>(m, g, idx, vals, m_out, ghat, rows, workers, chunk,
                                           leader, beta, kStagedThreads, stage, INT64_MAX,
                                           stream);
    }
    static int l2 = 0, sms = 0;
    if (!l2) {
      int dev = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    constexpr int64_t kBlockRows = (kFusedThreads / kWarp) * (kWarp / L);
    int64_t cap = l2 / 2 / (kBlockRows * workers * chunk * 8);
    if (cap < sms) cap = sms;
    return launch_vec4<L, M, true, false>(m, g, idx, vals, m_out, ghat, rows, workers, chunk,
                                          leader, beta, kFusedThreads, 0, cap, stream);
  }
}

template <int M, bool kTrue>
cudaError_t fused_vec4_lanes(const float* m, const float* g, int32_t* idx, float* vals,
                             float* m_out, float* ghat, int64_t rows, int64_t workers,
                             int64_t chunk, int leader, float beta, cudaStream_t st) {
#define SCALECOM_FUSED_VEC4(L)                                                             \
  launch_fused_vec4<L, M, kTrue>(m, g, idx, vals, m_out, ghat, rows, workers, chunk, leader, \
                                 beta, st)
  switch (select_lanes(chunk / 4)) {
    case 1: return SCALECOM_FUSED_VEC4(1);
    case 2: return SCALECOM_FUSED_VEC4(2);
    case 4: return SCALECOM_FUSED_VEC4(4);
    case 8: return SCALECOM_FUSED_VEC4(8);
    case 16: return SCALECOM_FUSED_VEC4(16);
    default: return SCALECOM_FUSED_VEC4(32);
  }
#undef SCALECOM_FUSED_VEC4
}

template <bool kTrue>
cudaError_t fused_vec4_topm(const float* m, const float* g, int32_t* idx, float* vals,
                            float* m_out, float* ghat, int64_t rows, int64_t workers,
                            int64_t chunk, int64_t topm, int leader, float beta,
                            cudaStream_t st) {
#define SCALECOM_FUSED_TOPM(M)                                                             \
  case M:                                                                                  \
    return fused_vec4_lanes<M, kTrue>(m, g, idx, vals, m_out, ghat, rows, workers, chunk,  \
                                      leader, beta, st)
  static_assert(kVecMaxTopm == 8, "one case per register-list length");
  switch (topm) {
    SCALECOM_FUSED_TOPM(1);
    SCALECOM_FUSED_TOPM(2);
    SCALECOM_FUSED_TOPM(3);
    SCALECOM_FUSED_TOPM(4);
    SCALECOM_FUSED_TOPM(5);
    SCALECOM_FUSED_TOPM(6);
    SCALECOM_FUSED_TOPM(7);
    SCALECOM_FUSED_TOPM(8);
    default: return cudaErrorInvalidValue;
  }
#undef SCALECOM_FUSED_TOPM
}

}  // namespace
}  // namespace scalecom
