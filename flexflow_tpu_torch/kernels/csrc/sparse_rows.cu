// Sparse embedding-row updates for Hopper (sm_90a): the optimizer rules of
// the JAX executor's sparse path, applied to the touched rows of (T, V, D)
// f32 tables in an order that is fixed, so a run is deterministic and
// equals the plain version (kernels/sparse_rows.py apply_rows_ref) bit for
// bit.
//
// No TPU kernel is replaced: the JAX package applies these updates in
// XLA's scatter (flexflow_tpu/core/optimizers.py SGDOptimizer and
// AdamOptimizer sparse_update, coalesce_rows). On the CPU XLA applies a
// scatter's updates one after another in index order, and index_add_ does
// the same; on the card index_add_ adds with atomics, so the order of
// duplicate ids changes from run to run and a captured step would not
// equal an eager one. This kernel walks each destination row's updates in
// their order of occurrence instead.
//
// Input, for each table t (blockIdx.y): the ids as int64 sort keys `skey`
// (n), sorted stably, with `order` (n) the sort's permutation into the
// rows of the gradient g (n, D). The wrapper builds the keys from JAX's
// index rules: an id i names row r = i < 0 ? i + V : i (negative ids wrap
// once), and a row outside [0, V) is dropped (scatter mode "drop"); such
// ids get the key 2V. Otherwise the key is 2r (exact rule: a row's updates
// stay in their order of occurrence) or 2r + (i >= 0) (the coalesced
// rules: the segments of equal raw ids, as coalesce_rows sorts them, and
// the segment of r - V before that of r, where both wrap onto row r).
//
// One warp per sorted position p; the warp whose p starts a row group
// (key >> 1 differs from position p - 1's) owns that row, its lanes over
// the D columns, and walks the group sequentially:
//   EXACT     w = (..((w + (-lr) g_0) + (-lr) g_1) ..)   in order
//   MOMENTUM  v' = (..((mu v) + g_0) + g_1 ..)           a segment's ids in
//             w += (-lr) v'                              order (XLA folds
//                                                        mu v into the
//                                                        segment sum)
//   NESTEROV  s = (..(0 + g_0) + g_1 ..); v' = fma(mu, v, s);
//             w += (-lr) fma(mu, v', s)
//   ADAM      s as above; m' = fma(b1, m, (1-b1) s);
//             v' = fma(b2, v, ((1-b2) s) s);
//             w += ((-alpha_t) m') / (sqrt(v') + eps)
// the products, sums and quotients rounded one at a time (__fmul_rn,
// __fadd_rn, __fdiv_rn, __fsqrt_rn: no contraction that XLA's CPU code
// does not make) and the FMAs where XLA's CPU code makes them. Each
// segment of a coalesced rule reads the slots as they were before the
// update (JAX gathers the rows before it scatters) and the last segment
// of a row writes them. lr or alpha_t is read from device memory (the
// executor's staged scalar), so a captured step takes each step's value.
//
// Bound on an H100 SXM at DLRM's shape (26 tables of 1M x 64, batch 8192,
// bag 1): each touched row is read and written once and each gradient row
// read once, about 26 x 8192 x 64 x 4 B x 3 = 164 MB (fewer where ids
// repeat), 0.05 ms at 3.35 TB/s; the arithmetic is a few operations a
// byte. Design: a warp a row gives coalesced 128-byte row accesses; no
// atomics and no shared memory. A heavily repeated id serializes its row
// on one warp, which is the price of the fixed order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // warps (sorted positions) a block

enum Rule { EXACT = 0, MOMENTUM = 1, NESTEROV = 2, ADAM = 3 };

template <int RULE>
__global__ void __launch_bounds__(32 * kWarps)
    sparse_rows_kernel(float* __restrict__ w, float* __restrict__ s0,
                       float* __restrict__ s1, const float* __restrict__ g,
                       const int64_t* __restrict__ skey,
                       const int64_t* __restrict__ order,
                       const float* __restrict__ scalar, int n, int64_t V,
                       int D, float h0, float h1, float h2, float h3,
                       float h4) {
  const int p = blockIdx.x * kWarps + threadIdx.y;
  if (p >= n) return;
  const int t = blockIdx.y;
  const int64_t* key = skey + (int64_t)t * n;
  const int64_t* ord = order + (int64_t)t * n;
  const int64_t k0 = key[p];
  if (k0 == 2 * V) return;  // an id outside the table: dropped
  const int64_t row = k0 >> 1;
  if (p > 0 && (key[p - 1] >> 1) == row) return;  // not the group's start
  int end = p + 1;
  while (end < n && (key[end] >> 1) == row) ++end;
  const int64_t tab = (int64_t)t * V * D;
  float* wr = w + tab + row * D;
  const float* gt = g + (int64_t)t * n * D;
  const float sc = *scalar;
  for (int c = threadIdx.x; c < D; c += 32) {
    float wacc = wr[c];
    if (RULE == EXACT) {
      const float neg = -sc;
      for (int q = p; q < end; ++q)
        wacc = __fadd_rn(wacc, __fmul_rn(neg, gt[ord[q] * D + c]));
      wr[c] = wacc;
      continue;
    }
    const float old0 = s0[tab + row * D + c];
    const float old1 = RULE == ADAM ? s1[tab + row * D + c] : 0.0f;
    float new0 = old0, new1 = old1;
    int q = p;
    while (q < end) {  // each segment: a run of equal keys
      const int64_t kq = key[q];
      float s;
      if (RULE == MOMENTUM) {
        s = __fmul_rn(h0, old0);
      } else {
        s = 0.0f;
      }
      for (; q < end && key[q] == kq; ++q)
        s = __fadd_rn(s, gt[ord[q] * D + c]);
      if (RULE == MOMENTUM) {
        new0 = s;
        wacc = __fadd_rn(wacc, __fmul_rn(-sc, s));
      } else if (RULE == NESTEROV) {
        new0 = __fmaf_rn(h0, old0, s);
        wacc = __fadd_rn(wacc, __fmul_rn(-sc, __fmaf_rn(h0, new0, s)));
      } else {  // ADAM: h0 b1, h1 1 - b1, h2 b2, h3 1 - b2, h4 eps
        new0 = __fmaf_rn(h0, old0, __fmul_rn(h1, s));
        new1 = __fmaf_rn(h2, old1, __fmul_rn(__fmul_rn(h3, s), s));
        wacc = __fadd_rn(wacc, __fdiv_rn(__fmul_rn(-sc, new0),
                                         __fadd_rn(__fsqrt_rn(new1), h4)));
      }
    }
    wr[c] = wacc;
    s0[tab + row * D + c] = new0;
    if (RULE == ADAM) s1[tab + row * D + c] = new1;
  }
}

template <int RULE>
cudaError_t launch(float* w, float* s0, float* s1, const float* g,
                   const int64_t* skey, const int64_t* order,
                   const float* scalar, int T, int n, int64_t V, int D,
                   float h0, float h1, float h2, float h3, float h4,
                   cudaStream_t st) {
  const dim3 block(32, kWarps);
  const dim3 grid((n + kWarps - 1) / kWarps, T);
  sparse_rows_kernel<RULE><<<grid, block, 0, st>>>(
      w, s0, s1, g, skey, order, scalar, n, V, D, h0, h1, h2, h3, h4);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// rule: 0 exact SGD, 1 SGD momentum, 2 SGD nesterov, 3 Adam. w, s0, s1:
// (T, V, D) f32 (s0: v or m, s1: Adam's v; unused ones may be null); g
// (T, n, D) f32; skey, order (T, n) int64; scalar: lr or alpha_t, f32 in
// device memory; h0-h4 the rule's constants (momentum; Adam's b1, 1 - b1,
// b2, 1 - b2, eps).
// Returns the launch's cudaError_t.
int sparse_rows_launch(int rule, void* w, void* s0, void* s1, const void* g,
                       const void* skey, const void* order,
                       const void* scalar, int T, int n, long long V, int D,
                       float h0, float h1, float h2, float h3, float h4,
                       void* stream) {
  if (T <= 0 || n <= 0 || D <= 0) return 0;
  if (T > 65535) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto W = static_cast<float*>(w);
  auto S0 = static_cast<float*>(s0);
  auto S1 = static_cast<float*>(s1);
  auto G = static_cast<const float*>(g);
  auto K = static_cast<const int64_t*>(skey);
  auto O = static_cast<const int64_t*>(order);
  auto sc = static_cast<const float*>(scalar);
  switch (rule) {
    case EXACT:
      return (int)launch<EXACT>(W, S0, S1, G, K, O, sc, T, n, V, D, h0, h1,
                                h2, h3, h4, st);
    case MOMENTUM:
      return (int)launch<MOMENTUM>(W, S0, S1, G, K, O, sc, T, n, V, D, h0,
                                   h1, h2, h3, h4, st);
    case NESTEROV:
      return (int)launch<NESTEROV>(W, S0, S1, G, K, O, sc, T, n, V, D, h0,
                                   h1, h2, h3, h4, st);
    case ADAM:
      return (int)launch<ADAM>(W, S0, S1, G, K, O, sc, T, n, V, D, h0, h1,
                               h2, h3, h4, st);
  }
  return (int)cudaErrorInvalidValue;
}

const char* sparse_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
