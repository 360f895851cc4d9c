// Hand-written Hopper (sm_90a) kernels: the single-launch fused reduce of one
// compressed tensor (select -> Eq. 5 residue update -> ĝ scatter), in two
// variants.
//
// Replaces src/repro/kernels/fused_reduce.py:_fused_kernel. Inputs are the
// worker-stacked residue m and gradient g viewed as (G, rows, chunk), the
// trailing axis already padded to a chunk multiple (the Python wrapper pads
// and reshapes). Per chunk row r:
//
//   select  clt_k:     top-m of |m + g| on the leader's row alone
//           true_topk: top-m of |mean_w (m_w + g_w)|, summed in worker order
//                      and then divided by G
//   update  for every worker w in order: vals[w, r, j] = (m_w + g_w)[idx[j]],
//           m'_w = m_w + beta * (g_w - own), own = the selected ef entries
//   scatter ĝ[r] = zeros with mean_w vals[w, r, j] at idx[j] (summed in
//           worker order, divided by G)
//
// The TPU kernel picks the clt_k leader's candidates through a (G, chunk)
// one-hot mask operand, which exists only for TPU tiling; here the leader is
// an integer and only its row is read for the select. Every operation is
// rounded on its own (__fadd_rn / __fmul_rn / __fsub_rn / __fdiv_rn, no FMA
// contraction), so idx, vals and m' equal the unfused kernels' bit for bit
// from the same state, and both variants equal fused_reduce_plain bit for
// bit.
//
// Bound: device-memory bytes. Reads m and g once (2 * G * rows * chunk * 4
// bytes), writes m' (G * rows * chunk * 4), vals (G * rows * topm * 4), idx
// (rows * topm * 4) and ĝ (rows * chunk * 4): 0.569 ms at the tok_embed
// shapes (8 workers, 296,000 rows of 64) on an H100 (3.35 TB/s), against a
// few fp32 operations per element.
//
// The "scalar" variant (fused_reduce_kernel, the first design, for any chunk
// width, base and top-m) is one warp per chunk row with 4-byte loads. What
// held it near half the bound was latency, as in the first selects: two
// 4-byte loads per lane and worker leave ~512 bytes in flight per warp; the
// worker loop loads, computes and stores one worker at a time; each pick is
// a 5-round (float, int) shuffle merge; at top-m > 1 the select keys go to
// the ĝ row in device memory and are read back in every pass; ĝ's worker
// mean re-reads vals.
//
// The "vec4" variant (fused_reduce_vec4_kernel in fused_reduce_vec4.cuh,
// for chunk % 4 == 0, 16-byte-aligned m and g and top-m <= kVecMaxTopm, as
// on the main path) keeps the selects' layout (csrc/chunk_select.cuh): L
// lanes share a row (L = 4 at chunk 64, so a warp owns 8 rows), each lane
// owns chunk / L floats as float4s, and rows are walked grid-stride over a
// grid sized to the card.
//
//  * Select, clt_k. The leader's row comes in with 16-byte __ldg loads, all
//    issued before any compare; lane_rank(m + g) goes into a LaneList<M> and
//    the row's L lists merge (merge_row_lanes, log2(L) shuffle rounds):
//    every lane then holds the row's M offsets in registers. No keys go to
//    memory and no pass repeats per pick.
//  * Select, true_topk. The key needs every worker's row before any update.
//    Where a block's rows fit in shared memory (kStageBytes: G <= 12 at
//    chunk <= 512) each thread copies all its (worker, batch) float4s there
//    with cp.async, all in flight at once, sums ef over the workers in worker
//    order and later updates from that copy. Otherwise it streams the rows
//    once for the sum (the next worker's loads issued before this one is
//    added) and reads them again from L2 in the update, with at most half
//    the L2 in rows in flight. The staged design is the faster of the two
//    (chip_smoke.py times both, at 12 and 13 workers); the L2 re-read holds
//    two sets of float4 buffers in registers, which keeps it to one block
//    per SM.
//  * Update, worker by worker in order. The next (worker, batch) step's
//    float4 loads are issued before this step's stores; own and m' are
//    computed in ef_update's order of operations and m' is stored with
//    __stcs (nothing re-reads it). The lane that owns pick j writes
//    vals[w, r, j] and keeps pick j's worker sum in a register.
//  * ĝ. Each lane writes its float4s of the row: zeros, and the worker mean
//    __fdiv_rn(s_j, G) at pick j (plus 0.0f at top-m > 1, as the scatter's
//    sum turns -0 into +0). Nothing re-reads vals or keys.
//
// Offsets are int64 throughout (a worker-stacked tensor passes 2^31
// elements). The Python wrapper (repro_torch/kernels/fused_reduce.py:
// fused_variant) picks the variant from the chunk width, both bases and
// top-m.

#include "common.cuh"
#include "fused_reduce_vec4.cuh"

namespace scalecom {
namespace {

__global__ void fused_reduce_kernel(const float* __restrict__ m,
                                    const float* __restrict__ g,
                                    int32_t* __restrict__ idx,
                                    float* __restrict__ vals,
                                    float* __restrict__ m_out,
                                    float* __restrict__ ghat, int64_t rows,
                                    int workers, int chunk, int topm, int mode,
                                    int leader, float beta) {
  const int lane = threadIdx.x;
  const int64_t plane = rows * chunk;  // elements of one worker's slab
  const float count = static_cast<float>(workers);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kRowsPerBlock;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.y;
       r < rows; r += stride) {
    const int64_t base = r * chunk;
    float* grow = ghat + base;
    int32_t* ir = idx + r * topm;

    // -- select: pass 0 computes the keys (kept in the ĝ row when topm > 1)
    const float* ml = m + leader * plane + base;
    const float* gl = g + leader * plane + base;
    const bool keep = topm > 1;
    auto key0 = [&](int c) {
      float k;
      if (mode == kCltK) {
        k = fabsf(__fadd_rn(ml[c], gl[c]));
      } else {
        float s = __fadd_rn(m[base + c], g[base + c]);
        for (int w = 1; w < workers; ++w) {
          const int64_t o = w * plane + base + c;
          s = __fadd_rn(s, __fadd_rn(m[o], g[o]));
        }
        k = fabsf(__fdiv_rn(s, count));
      }
      if (keep) grow[c] = k;
      return k;
    };
    Pick prev = warp_pick(key0, chunk, true, Pick{0.0f, 0});
    if (lane == 0) ir[0] = prev.lane;
    for (int j = 1; j < topm; ++j) {
      prev = warp_pick([grow](int c) { return grow[c]; }, chunk, false, prev);
      if (lane == 0) ir[j] = prev.lane;
    }
    __syncwarp();

    // -- update: Eq. 5 for every worker in order, as ef_update computes it
    const int i0 = ir[0];
    for (int w = 0; w < workers; ++w) {
      const int64_t o = w * plane + base;
      float* vr = vals + (static_cast<int64_t>(w) * rows + r) * topm;
      for (int c = lane; c < chunk; c += kWarp) {
        const float mv = m[o + c];
        const float gv = g[o + c];
        const float ef = __fadd_rn(mv, gv);
        float own = (c == i0) ? ef : 0.0f;
        if (c == i0) vr[0] = ef;
        for (int j = 1; j < topm; ++j) {  // top-m: the offsets are distinct
          const bool hit = (c == ir[j]);
          own = __fadd_rn(own, hit ? ef : 0.0f);
          if (hit) vr[j] = ef;
        }
        m_out[o + c] = __fadd_rn(mv, __fmul_rn(beta, __fsub_rn(gv, own)));
      }
    }

    // -- scatter: ĝ = the worker-mean values at idx, zeros elsewhere
    for (int c = lane; c < chunk; c += kWarp) grow[c] = 0.0f;
    __syncwarp();  // the vals and zeros above come from other lanes
    for (int j = lane; j < topm; j += kWarp) {
      const float* vj = vals + r * topm + j;
      float s = vj[0];
      for (int w = 1; w < workers; ++w) {
        s = __fadd_rn(s, vj[static_cast<int64_t>(w) * rows * topm]);
      }
      const float mean = __fdiv_rn(s, count);
      // chunk_scatter sums top-m entries onto zeros, which turns -0 into +0
      grow[ir[j]] = keep ? __fadd_rn(mean, 0.0f) : mean;
    }
  }
}

}  // namespace
}  // namespace scalecom

extern "C" {

int scalecom_fused_reduce(const float* m, const float* g, int32_t* idx,
                          float* vals, float* m_out, float* ghat, int64_t rows,
                          int64_t workers, int64_t chunk, int64_t topm,
                          int mode, int leader, float beta, void* stream) {
  using namespace scalecom;
  const dim3 block(kWarp, kRowsPerBlock);
  const dim3 grid(static_cast<unsigned>(blocks_for(rows)));
  fused_reduce_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      m, g, idx, vals, m_out, ghat, rows, static_cast<int>(workers),
      static_cast<int>(chunk), static_cast<int>(topm), mode, leader, beta);
  return static_cast<int>(cudaGetLastError());
}

// The vec4 variant at M = topm <= kVecMaxTopm. Needs chunk % 4 == 0 and
// 16-byte-aligned m and g (the outputs are fresh tensors).
int scalecom_fused_reduce_vec4(const float* m, const float* g, int32_t* idx,
                               float* vals, float* m_out, float* ghat,
                               int64_t rows, int64_t workers, int64_t chunk,
                               int64_t topm, int mode, int leader, float beta,
                               void* stream) {
  using namespace scalecom;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t rc =
      mode == kCltK ? fused_vec4_topm<false>(m, g, idx, vals, m_out, ghat, rows, workers, chunk,
                                             topm, leader, beta, st)
                    : fused_vec4_true_topk(m, g, idx, vals, m_out, ghat, rows, workers, chunk,
                                           topm, beta, st);
  return static_cast<int>(rc);
}

}  // extern "C"
