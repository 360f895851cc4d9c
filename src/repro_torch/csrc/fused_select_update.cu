// Hand-written Hopper (sm_90a) kernel: one rank's select and Eq. 5 update in
// one launch, the one-row variant of the fused reduce (the design and the
// bound are in fused_select_update.cuh). This source instantiates the m + g
// select (clt_k) and holds the C entry; fused_select_update_key.cu the keyed
// select (true_topk).

#include "fused_select_update.cuh"

extern "C" {

// m, g (and key, or nullptr for the m + g select) (rows, chunk) fp32,
// 16-byte aligned, chunk % 4 == 0; idx and vals (rows, topm); m_out like m.
// topm <= kVecMaxTopm; at topm 1 `threads` is a TunedThreads block size (0 the
// default), else it must be 0. Any other value returns cudaErrorInvalidValue.
int scalecom_fused_select_update(const float* m, const float* g, const float* key,
                                 int32_t* idx, float* vals, float* m_out, int64_t rows,
                                 int64_t chunk, int64_t topm, float beta, int threads,
                                 void* stream) {
  using namespace scalecom;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (chunk % 4 != 0 || topm < 1 || topm > kVecMaxTopm) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t rc =
      key == nullptr ? select_update_topm<false>(m, g, nullptr, idx, vals, m_out, rows, chunk,
                                                 topm, beta, threads, st)
                     : select_update_keyed(m, g, key, idx, vals, m_out, rows, chunk, topm, beta,
                                           threads, st);
  return static_cast<int>(rc);
}

}  // extern "C"
