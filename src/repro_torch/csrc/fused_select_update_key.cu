// The keyed select of fused_select_update (true_topk's leader selects on the
// oracle's worker mean; the template is in fused_select_update.cuh), built
// apart from the m + g instances so that nvcc compiles the two sets in
// parallel.

#include "fused_select_update.cuh"

namespace scalecom {

cudaError_t select_update_keyed(const float* m, const float* g, const float* key, int32_t* idx,
                                float* vals, float* m_out, int64_t rows, int64_t chunk,
                                int64_t topm, float beta, int threads, cudaStream_t st) {
  return select_update_topm<true>(m, g, key, idx, vals, m_out, rows, chunk, topm, beta, threads,
                                  st);
}

}  // namespace scalecom
