// The true_topk kernels of the fused reduce's vec4 variant (the template is
// in fused_reduce_vec4.cuh, the design in fused_reduce.cu), built apart from
// the clt_k ones so that nvcc compiles the two sets in parallel.

#include "fused_reduce_vec4.cuh"

namespace scalecom {

cudaError_t fused_vec4_true_topk(const float* m, const float* g, int32_t* idx, float* vals,
                                 float* m_out, float* ghat, int64_t rows, int64_t workers,
                                 int64_t chunk, int64_t topm, float beta, cudaStream_t st) {
  return fused_vec4_topm<true>(m, g, idx, vals, m_out, ghat, rows, workers, chunk, topm, 0, beta,
                               st);
}

}  // namespace scalecom
