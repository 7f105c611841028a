// Native embedding-bag: host-side gather-reduce over an embedding table.
//
// The reference ships a hand-vectorized AVX2 CPU embedding-bag
// (src/ops/embedding_avx2.cc, fbgemm-style) so DLRM strategies can place
// embedding lookups on CPUs next to the data source.  Here the *model*
// embedding runs on the card (ops/embedding.py), so the native bag's
// role moves into the data pipeline: pre-reducing multi-hot categorical
// features on the host before the batch ships to the device, which
// shrinks host-to-device traffic from (B, L) indices and a gather on the
// card to a dense (B, D) row per feature.  Vectorization is left to the compiler
// (-O3 auto-vectorizes the inner dim-D loops; AVX2 intrinsics would pin
// the ISA for no measurable gain at typical D of 16-128).

#include "flexflow_torch_c.h"

#include <cstdint>

extern "C" void ffdl_embedding_bag(const float *table, int64_t num_entries,
                                   int32_t dim, const int64_t *indices,
                                   int64_t batch, int32_t bag_size,
                                   int32_t mode /* 0=sum, 1=mean */,
                                   float *out) {
  for (int64_t b = 0; b < batch; ++b) {
    float *dst = out + b * dim;
    for (int32_t d = 0; d < dim; ++d) dst[d] = 0.0f;
    int32_t valid = 0;
    for (int32_t j = 0; j < bag_size; ++j) {
      int64_t idx = indices[b * bag_size + j];
      if (idx < 0 || idx >= num_entries) continue;  // padding slot
      ++valid;
      const float *src = table + idx * dim;
      for (int32_t d = 0; d < dim; ++d) dst[d] += src[d];
    }
    if (mode == 1 && valid > 1) {
      float inv = 1.0f / static_cast<float>(valid);
      for (int32_t d = 0; d < dim; ++d) dst[d] *= inv;
    }
  }
}
