// Hand-written Hopper (sm_90a) kernel: the single-launch fused reduce of one
// compressed tensor (select -> Eq. 5 residue update -> ĝ scatter).
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
// from the same state, and the kernel equals fused_reduce_plain bit for bit.
//
// Bound: device-memory bytes. Reads m and g once (2 * G * rows * chunk * 4
// bytes), writes m' (G * rows * chunk * 4), vals (G * rows * topm * 4), idx
// (rows * topm * 4) and ĝ (rows * chunk * 4). Design: one warp per chunk row
// (rows walked grid-stride, int64 offsets); the workers are streamed, never
// held, so G is not limited. The select's re-reads (the leader's row in the
// update; for true_topk every worker's row, a second time) come from L1/L2,
// where that row was just read. With topm > 1 the select keys live in the ĝ
// row between passes (each lane reads only the lanes it wrote); ĝ is then
// zeroed and written. Vector loads, several rows per warp and TMA are later
// work.

#include "common.cuh"

namespace scalecom {
namespace {

// mode: the index in repro_torch.kernels.fused_reduce.MODES
constexpr int kCltK = 0;  // else true_topk

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

}  // extern "C"
