// Hand-written Hopper (sm_90a) kernels: the per-chunk top-m select and the
// gather of values at per-chunk offsets (each offset loaded once for all the
// workers that share it).
//
// Both work on a (rows, chunk) row-major view whose trailing axis is already
// padded to a chunk multiple (repro_torch/backends/cuda_backend.py pads,
// reshapes and lays out the index sets). Each launches on the caller's
// stream, allocates nothing, and returns cudaGetLastError().
//
// chunk_topm has two variants, picked in Python from shape, alignment and
// top-m (repro_torch/kernels/chunk_topk.py:select_variant): "vec4"
// (csrc/chunk_select.cuh: 16-byte loads, a few lanes per row, each lane's
// best M in registers, one read of the row, a log2(lanes)-round merge) for
// chunk % 4 == 0, a 16-byte-aligned base and top-m <= 8, as on the rate
// rules' top-2 path; otherwise "scalar", the pass design below.

#include "chunk_select.cuh"
#include "common.cuh"

namespace scalecom {
namespace {

// Replaces src/repro/kernels/chunk_topk.py:_topm_kernel (the topm > 1 body
// of row_select): per row, the top-m lanes by |x| in descending order, ties
// to the lower lane and NaN above every number (the order of jax.lax.top_k
// and of m masked-argmax passes), with the signed values there.
//
// Bound: reads rows*chunk*4 bytes, writes rows*topm*8 bytes (0.192 ms at
// the tok_embed shapes, top-2, on an H100). This is the scalar variant, for
// any chunk width, any 4-byte-aligned base and any top-m: one warp per row;
// pass j is warp_pick() over the lanes ranking after pass j-1's pick, so no
// mask and no shared memory are needed. Pass 0 streams the row from device
// memory with 4-byte loads (256 bytes in flight per warp); passes 1..m-1
// re-read it from L1. Each pass ends in a 5-step shuffle merge.
__global__ void chunk_topm_kernel(const float* __restrict__ x,
                                  int32_t* __restrict__ idx,
                                  float* __restrict__ val, int64_t rows,
                                  int chunk, int topm) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kRowsPerBlock;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.y;
       r < rows; r += stride) {
    const float* row = x + r * chunk;
    int32_t* ir = idx + r * topm;
    float* vr = val + r * topm;
    Pick prev{0.0f, 0};
    for (int j = 0; j < topm; ++j) {
      prev = warp_pick([row](int c) { return fabsf(row[c]); }, chunk, j == 0, prev);
      if (threadIdx.x == 0) {
        ir[j] = prev.lane;
        vr[j] = row[prev.lane];
      }
    }
  }
}

// Replaces src/repro/kernels/chunk_topk.py:_gather_kernel: out[r, j] =
// x[r, idx[r % idx_rows, j]]. Row r reads index row r % idx_rows, so one
// shared (R,) set serves all G stacked workers (rows = G * R) without being
// broadcast in memory. As jnp.take_along_axis in that kernel, an offset in
// [-chunk, 0) counts from the row's end and one outside [-chunk, chunk)
// yields NaN (the canonical quiet NaN) instead of a read outside its row.
//
// Bound: one 32-byte sector of x per distinct (row, offset sector), plus the
// index set and the output (0.0258 ms at the tok_embed shapes with a shared
// top-1 set on an H100).
//
// A thread owns one entry (i, j) of the (idx_rows, m) set: it loads the
// offset once, finds the entry's row with one divide by m (none at m = 1,
// 32-bit where it fits) for all its copies, and then reads and writes the
// entry's copies, x[(q * idx_rows + i) * chunk + c] for the G = rows /
// idx_rows workers that share the set. Neighbouring
// threads own neighbouring entries, so the index reads and, per copy, the
// output writes are coalesced. x is read with a streaming hint (__ldcs): no
// sector of it is read twice.
constexpr int kGatherThreads = 256;

__global__ void __launch_bounds__(kGatherThreads)
chunk_gather_kernel(const float* __restrict__ x, const int32_t* __restrict__ idx,
                    float* __restrict__ out, int64_t idx_rows, int64_t copies,
                    int chunk, int topm) {
  const int64_t n = idx_rows * topm;             // entries of the index set
  const int64_t copy_stride = idx_rows * chunk;  // x elements from one copy to the next
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < n;
       e += stride) {
    int c = __ldg(idx + e);
    if (c < 0) c += chunk;
    const bool inside = c >= 0 && c < chunk;
    const int64_t i = (topm == 1) ? e
                      : (e <= UINT32_MAX ? static_cast<int64_t>(static_cast<uint32_t>(e) /
                                                                static_cast<uint32_t>(topm))
                                         : e / topm);
    const float* src = x + i * chunk + c;
    for (int64_t q = 0; q < copies; ++q) {
      out[q * n + e] = inside ? __ldcs(src + q * copy_stride) : __int_as_float(0x7fc00000);
    }
  }
}

}  // namespace
}  // namespace scalecom

extern "C" {

int scalecom_chunk_topm(const float* x, int32_t* idx, float* val, int64_t rows,
                        int64_t chunk, int64_t topm, void* stream) {
  using namespace scalecom;
  const dim3 block(kWarp, kRowsPerBlock);
  const dim3 grid(static_cast<unsigned>(blocks_for(rows)));
  chunk_topm_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      x, idx, val, rows, static_cast<int>(chunk), static_cast<int>(topm));
  return static_cast<int>(cudaGetLastError());
}

// The vec4 variant (csrc/chunk_select.cuh) at M = topm <= kVecMaxTopm. Needs
// chunk % 4 == 0 and a 16-byte-aligned x; returns cudaErrorInvalidValue for
// a top-m it was not built for.
int scalecom_chunk_topm_vec4(const float* x, int32_t* idx, float* val,
                             int64_t rows, int64_t chunk, int64_t topm,
                             void* stream) {
  using namespace scalecom;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  static_assert(kVecMaxTopm == 8, "one case per register-list length");
  switch (topm) {
    case 1: return static_cast<int>(select_vec4_lanes<1>(x, idx, val, rows, chunk, st));
    case 2: return static_cast<int>(select_vec4_lanes<2>(x, idx, val, rows, chunk, st));
    case 3: return static_cast<int>(select_vec4_lanes<3>(x, idx, val, rows, chunk, st));
    case 4: return static_cast<int>(select_vec4_lanes<4>(x, idx, val, rows, chunk, st));
    case 5: return static_cast<int>(select_vec4_lanes<5>(x, idx, val, rows, chunk, st));
    case 6: return static_cast<int>(select_vec4_lanes<6>(x, idx, val, rows, chunk, st));
    case 7: return static_cast<int>(select_vec4_lanes<7>(x, idx, val, rows, chunk, st));
    case 8: return static_cast<int>(select_vec4_lanes<8>(x, idx, val, rows, chunk, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int scalecom_chunk_gather(const float* x, const int32_t* idx, float* out,
                          int64_t rows, int64_t idx_rows, int64_t chunk,
                          int64_t topm, void* stream) {
  using namespace scalecom;
  const int64_t n = idx_rows * topm;
  int64_t blocks = (n + kGatherThreads - 1) / kGatherThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  chunk_gather_kernel<<<static_cast<unsigned>(blocks), kGatherThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      x, idx, out, idx_rows, rows / idx_rows, static_cast<int>(chunk), static_cast<int>(topm));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
