// Hand-written Hopper (sm_90a) kernels for the ScaleCom reduce's inner loop.
//
// Per compressed tensor and step the unfused reduce makes three launches
// (repro_torch/core/scalecom.py:_execute):
//
//   chunk_argmax   per chunk row, arg-max of |x| and the signed value there
//   ef_update      Eq. 5 residue update + the values each worker contributes
//   chunk_scatter  densify the worker-mean values into the reduced gradient
//                  (the vec4 variant below; the scalar one for other shapes)
//
// All three work on a (rows, chunk) row-major view whose trailing axis is
// already padded to a chunk multiple (the Python wrappers in
// repro_torch/kernels/ do the padding, reshaping and index broadcasting).
// Each is bound by device-memory bytes, not by arithmetic (a few flops per
// element against 4-12 bytes moved); every input is read once and every
// output written once. Rows are walked grid-stride with int64 offsets: a
// worker-stacked tensor can pass 2^31 elements.
//
// ef_update keeps the first design (csrc/common.cuh): one warp owns one
// chunk row at a time and its 32 lanes stride over the row, so every
// warp-wide 4-byte load is one 128-byte transaction.
//
// chunk_argmax has two variants, picked in Python from shape and alignment
// (repro_torch/kernels/chunk_topk.py:select_variant): "vec4"
// (csrc/chunk_select.cuh, 16-byte loads, a few lanes per row, a
// log2(lanes)-round merge) when chunk % 4 == 0 and the base is 16-byte
// aligned, as on the main path; otherwise "scalar", the one-warp-per-row
// kernel below.
//
// chunk_scatter has two variants, picked in Python from the chunk width and
// top-m alone (chunk_topk.py:scatter_variant; its output is always a fresh,
// aligned tensor): "vec4" (whole rows as 16-byte stores, each row's (idx,
// vals) loaded once, several rows' loads issued before any store, a grid
// sized to the card) for chunk % 4 == 0 and top-m <= 8, as on the main path;
// otherwise "scalar", the one-warp-per-row kernel below.
//
// Every entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include "chunk_select.cuh"
#include "common.cuh"

namespace scalecom {
namespace {

// Replaces src/repro/kernels/chunk_topk.py:_argmax_kernel (the topm == 1
// body of row_select). Bound: reads rows*chunk*4 bytes, writes rows*8 bytes
// (0.187 ms at the tok_embed shapes, 2,368,000 rows of 64, on an H100).
// This is the scalar variant, for any chunk width and any 4-byte-aligned
// base: one warp per row, 4-byte loads; each lane keeps its own best
// (|x|, lane, x) over the lanes it visits in increasing order, then a 5-round
// shuffle reduction merges the 32 candidates. It holds only 256 bytes in
// flight per warp; the vec4 variant (chunk_select.cuh) is the fast one.
__global__ void chunk_argmax_kernel(const float* __restrict__ x,
                                    int32_t* __restrict__ idx,
                                    float* __restrict__ val, int64_t rows,
                                    int chunk) {
  const int lane = threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kRowsPerBlock;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.y;
       r < rows; r += stride) {
    const float* row = x + r * chunk;
    float best = -1.0f;  // below every magnitude: an empty lane never wins
    int best_i = INT_MAX;
    float best_v = 0.0f;
    for (int c = lane; c < chunk; c += kWarp) {
      const float v = row[c];
      const float a = fabsf(v);
      if (beats(a, c, best, best_i)) {
        best = a;
        best_i = c;
        best_v = v;
      }
    }
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      const float ob = __shfl_down_sync(0xffffffffu, best, off);
      const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
      const float ov = __shfl_down_sync(0xffffffffu, best_v, off);
      if (beats(ob, oi, best, best_i)) {
        best = ob;
        best_i = oi;
        best_v = ov;
      }
    }
    if (lane == 0) {
      idx[r] = best_i;
      val[r] = best_v;
    }
  }
}

// Replaces src/repro/kernels/ef_update.py:_ef_update_kernel. Paper Eq. 5:
//   ef = m + g;  vals[j] = ef[idx[j]];  m' = m + beta * (g - onehot(ef at idx))
// Bound: reads m and g (rows*chunk*4 bytes each) and the index set, writes
// m' (rows*chunk*4 bytes) and vals (rows*topm*4 bytes). Worker row r reads
// index row r % idx_rows, so one shared (R,) index set serves all G workers
// without being materialized G times. beta is a runtime float. The update
// rounds each operation separately (no FMA contraction), so m' is bitwise
// equal to the plain PyTorch version on the card.
__global__ void ef_update_kernel(const float* __restrict__ m,
                                 const float* __restrict__ g,
                                 const int32_t* __restrict__ idx,
                                 float* __restrict__ m_out,
                                 float* __restrict__ vals, int64_t rows,
                                 int64_t idx_rows, int chunk, int topm,
                                 float beta) {
  const int lane = threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kRowsPerBlock;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.y;
       r < rows; r += stride) {
    const int32_t* ir = idx + (r % idx_rows) * topm;
    float* vr = vals + r * topm;
    const int64_t base = r * chunk;
    const int i0 = ir[0];
    for (int c = lane; c < chunk; c += kWarp) {
      const float mv = m[base + c];
      const float gv = g[base + c];
      const float ef = __fadd_rn(mv, gv);
      float own = (c == i0) ? ef : 0.0f;
      if (c == i0) vr[0] = ef;
      for (int j = 1; j < topm; ++j) {  // top-m: the offsets are distinct
        const bool hit = (c == ir[j]);
        own = __fadd_rn(own, hit ? ef : 0.0f);
        if (hit) vr[j] = ef;
      }
      m_out[base + c] = __fadd_rn(mv, __fmul_rn(beta, __fsub_rn(gv, own)));
    }
  }
}

// Replaces src/repro/kernels/chunk_topk.py:_scatter_kernel. Bound: reads
// rows*topm*8 bytes of (vals, idx), writes rows*chunk*4 bytes (0.0233 ms at
// the tok_embed shapes, 296,000 rows of 64, on an H100). Each lane writes
// vals[j] where it equals idx[j] and 0 elsewhere; top-m entries are summed in
// j order, as the plain version sums them. This is the scalar variant, for
// any chunk width and top-m: one warp per row, 4-byte stores, each row's
// (idx, vals) loaded by every lane before its stores, so a warp has one row's
// 256 bytes of stores per round trip to device memory.
__global__ void chunk_scatter_kernel(const float* __restrict__ vals,
                                     const int32_t* __restrict__ idx,
                                     float* __restrict__ out, int64_t rows,
                                     int chunk, int topm) {
  const int lane = threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kRowsPerBlock;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.y;
       r < rows; r += stride) {
    const int32_t* ir = idx + r * topm;
    const float* vr = vals + r * topm;
    const int i0 = ir[0];
    const float v0 = vr[0];
    float* orow = out + r * chunk;
    for (int c = lane; c < chunk; c += kWarp) {
      float o = (c == i0) ? v0 : 0.0f;
      for (int j = 1; j < topm; ++j) {
        o = __fadd_rn(o, (c == ir[j]) ? vr[j] : 0.0f);
      }
      orow[c] = o;
    }
  }
}

// The offset c of a row holds the sum over j of [c == idx[j]] * vals[j], in
// j order: at top-1 the value's bits are copied (-0 and NaN payloads
// included); above, each term is added with __fadd_rn to a sum that starts
// at the first term, so -0 turns to +0 as in the plain version.
template <int M>
__device__ __forceinline__ float scatter_lane(int c, const int32_t (&i)[M],
                                              const float (&v)[M]) {
  float o = (c == i[0]) ? v[0] : 0.0f;
#pragma unroll
  for (int j = 1; j < M; ++j) o = __fadd_rn(o, (c == i[j]) ? v[j] : 0.0f);
  return o;
}

constexpr int kScatterThreads = 256;  // 8 warps per block
constexpr int kScatterBatch = 4;      // row groups a warp loads before it stores

// The vec4 variant of chunk_scatter (same function and bound as above), for
// chunk % 4 == 0 and top-m = M <= 8. What held the scalar kernel back was
// latency: every warp waited one device-memory round trip for one row's
// (idx, vals) and then stored 256 bytes as 64 4-byte stores per lane pair.
// Here L lanes share a row (L = 8 at chunk 64: each lane writes two 16-byte
// quads of its row), and a warp loads the (idx, vals) of kScatterBatch row
// groups, 32 / L rows each, before it stores any: 4 KB of stores per warp per
// round trip at chunk 64, from a grid sized to the card and walked
// grid-stride with int64 offsets. The L lanes of a row load the same few
// bytes, which the memory system serves as one request. The stores are
// streaming (__stcs, evict-first): on an H100 they beat plain stores both at
// the tok_embed shapes (75.8 MB, past the 50 MB L2) and over the 17 smaller
// and larger tensors of one step.
template <int L, int M>
__global__ void __launch_bounds__(kScatterThreads)
chunk_scatter_vec4_kernel(const float* __restrict__ vals, const int32_t* __restrict__ idx,
                          float4* __restrict__ out, int64_t rows, int vecs) {
  constexpr int kRowsPerWarp = kWarp / L;
  const int lane = threadIdx.x % kWarp;
  const int sub = lane % L;  // this lane's place in its row
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * blockDim.x / kWarp;
  const int64_t groups = (rows + kRowsPerWarp - 1) / kRowsPerWarp;
  for (int64_t g0 = warp; g0 < groups; g0 += warps * kScatterBatch) {
    int32_t i[kScatterBatch][M];
    float v[kScatterBatch][M];
#pragma unroll
    for (int b = 0; b < kScatterBatch; ++b) {  // every load before any store
      const int64_t r = (g0 + b * warps) * kRowsPerWarp + lane / L;
      const bool live = r < rows;
#pragma unroll
      for (int j = 0; j < M; ++j) {
        i[b][j] = live ? __ldg(idx + r * M + j) : -1;
        v[b][j] = live ? __ldg(vals + r * M + j) : 0.0f;
      }
    }
#pragma unroll
    for (int b = 0; b < kScatterBatch; ++b) {
      const int64_t r = (g0 + b * warps) * kRowsPerWarp + lane / L;
      if (r >= rows) continue;
      float4* orow = out + r * vecs;
      for (int q = sub; q < vecs; q += L) {
        const int c = 4 * q;
        __stcs(orow + q,
               make_float4(scatter_lane<M>(c, i[b], v[b]), scatter_lane<M>(c + 1, i[b], v[b]),
                           scatter_lane<M>(c + 2, i[b], v[b]), scatter_lane<M>(c + 3, i[b], v[b])));
      }
    }
  }
}

template <int L, int M>
cudaError_t launch_scatter_vec4(const float* vals, const int32_t* idx, float* out,
                                int64_t rows, int64_t chunk, cudaStream_t stream) {
  static const int64_t full = card_blocks(chunk_scatter_vec4_kernel<L, M>, kScatterThreads);
  constexpr int64_t kBlockRows = (kScatterThreads / kWarp) * (kWarp / L);
  int64_t blocks = (rows + kBlockRows - 1) / kBlockRows;
  if (blocks > full) blocks = full;
  chunk_scatter_vec4_kernel<L, M><<<static_cast<unsigned>(blocks), kScatterThreads, 0, stream>>>(
      vals, idx, reinterpret_cast<float4*>(out), rows, static_cast<int>(chunk / 4));
  return cudaGetLastError();
}

// Lanes per row: a power of two <= 32 with at least two 16-byte stores each
// where the row has them (8 at chunk 64; 16 lanes of one store each measured
// slower on an H100).
template <int M>
cudaError_t scatter_vec4_lanes(const float* vals, const int32_t* idx, float* out,
                               int64_t rows, int64_t chunk, cudaStream_t stream) {
  int lanes = 1;
  while (lanes < kWarp && lanes * 4 <= chunk / 4) lanes <<= 1;
  switch (lanes) {
    case 1: return launch_scatter_vec4<1, M>(vals, idx, out, rows, chunk, stream);
    case 2: return launch_scatter_vec4<2, M>(vals, idx, out, rows, chunk, stream);
    case 4: return launch_scatter_vec4<4, M>(vals, idx, out, rows, chunk, stream);
    case 8: return launch_scatter_vec4<8, M>(vals, idx, out, rows, chunk, stream);
    case 16: return launch_scatter_vec4<16, M>(vals, idx, out, rows, chunk, stream);
    default: return launch_scatter_vec4<32, M>(vals, idx, out, rows, chunk, stream);
  }
}

}  // namespace
}  // namespace scalecom

extern "C" {

int scalecom_chunk_argmax(const float* x, int32_t* idx, float* val,
                          int64_t rows, int64_t chunk, void* stream) {
  using namespace scalecom;
  const dim3 block(kWarp, kRowsPerBlock);
  const dim3 grid(static_cast<unsigned>(blocks_for(rows)));
  chunk_argmax_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      x, idx, val, rows, static_cast<int>(chunk));
  return static_cast<int>(cudaGetLastError());
}

// The vec4 variant: the same function through csrc/chunk_select.cuh at M = 1
// (idx and val are (rows,), the layout of (rows, 1)). Needs chunk % 4 == 0
// and a 16-byte-aligned x.
int scalecom_chunk_argmax_vec4(const float* x, int32_t* idx, float* val,
                               int64_t rows, int64_t chunk, void* stream) {
  using namespace scalecom;
  return static_cast<int>(select_vec4_lanes<1>(x, idx, val, rows, chunk,
                                               static_cast<cudaStream_t>(stream)));
}

int scalecom_ef_update(const float* m, const float* g, const int32_t* idx,
                       float* m_out, float* vals, int64_t rows,
                       int64_t idx_rows, int64_t chunk, int64_t topm,
                       float beta, void* stream) {
  using namespace scalecom;
  const dim3 block(kWarp, kRowsPerBlock);
  const dim3 grid(static_cast<unsigned>(blocks_for(rows)));
  ef_update_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      m, g, idx, m_out, vals, rows, idx_rows, static_cast<int>(chunk),
      static_cast<int>(topm), beta);
  return static_cast<int>(cudaGetLastError());
}

int scalecom_chunk_scatter(const float* vals, const int32_t* idx, float* out,
                           int64_t rows, int64_t chunk, int64_t topm,
                           void* stream) {
  using namespace scalecom;
  const dim3 block(kWarp, kRowsPerBlock);
  const dim3 grid(static_cast<unsigned>(blocks_for(rows)));
  chunk_scatter_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      vals, idx, out, rows, static_cast<int>(chunk), static_cast<int>(topm));
  return static_cast<int>(cudaGetLastError());
}

// The vec4 variant at M = topm <= kVecMaxTopm (chunk_select.cuh, the same
// limit as the selects'). Needs chunk % 4 == 0 and a 16-byte-aligned out;
// returns cudaErrorInvalidValue for a top-m it was not built for.
int scalecom_chunk_scatter_vec4(const float* vals, const int32_t* idx, float* out,
                                int64_t rows, int64_t chunk, int64_t topm, void* stream) {
  using namespace scalecom;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  static_assert(kVecMaxTopm == 8, "one case per register-list length");
  switch (topm) {
    case 1: return static_cast<int>(scatter_vec4_lanes<1>(vals, idx, out, rows, chunk, st));
    case 2: return static_cast<int>(scatter_vec4_lanes<2>(vals, idx, out, rows, chunk, st));
    case 3: return static_cast<int>(scatter_vec4_lanes<3>(vals, idx, out, rows, chunk, st));
    case 4: return static_cast<int>(scatter_vec4_lanes<4>(vals, idx, out, rows, chunk, st));
    case 5: return static_cast<int>(scatter_vec4_lanes<5>(vals, idx, out, rows, chunk, st));
    case 6: return static_cast<int>(scatter_vec4_lanes<6>(vals, idx, out, rows, chunk, st));
    case 7: return static_cast<int>(scatter_vec4_lanes<7>(vals, idx, out, rows, chunk, st));
    case 8: return static_cast<int>(scatter_vec4_lanes<8>(vals, idx, out, rows, chunk, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
