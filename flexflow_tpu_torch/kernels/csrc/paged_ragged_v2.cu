// Ragged paged attention for Hopper (sm_90a): one query token per lane,
// attending through its sequence's page-table row.
//
// Replaces: flexflow_tpu/kernels/paged_ragged_v2.py::_ragged_v2_kernel
// (launched by _ragged_v2_pallas), the TPU kernel of the serving mixed
// step (flexflow_tpu/serve/engine.py::_mixed_body, once per layer per
// step). Float32 and bfloat16 pages, and int8 or fp8 (e4m3) pages with
// one f32 scale per (page, slot, head) — the TPU kernel's quantized
// branch, which dequantizes each K/V row in registers before the
// (otherwise unchanged) online softmax.
//
// What it computes, per lane t and head h (the plain version is
// flexflow_tpu_torch/kernels/paged_ragged_v2.py::ragged_attention_ref):
//   o[t,h] = softmax(q[t,h] . K[:n,h] * scale) . V[:n,h],
//   n = lane_lens[t], key j at page page_tables[lane_slots[t], j / ps],
//   slot j % ps. Keys at or past n are masked. lane_lens >= 1.
//   Quantized pages: K[j,h] = code * k_scales[page, slot, h] in f32, the
//   product dequantize_kv computes, so a dequantized key is the plain
//   version's bit for bit.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores): the kernel reads each live K/V page (the pages covering
// [0, n) of every lane's row) and q, and writes o. Attention per lane
// is 4*n*H*D flops over 2*n*H*D*itemsize K/V bytes — about 0.5
// flop/byte in f32 — so with every page read once it is memory-bound:
// the least time is the live K/V bytes over 3.35 TB/s. Quantized pages
// move 1 byte an element plus 4 bytes of scale per (slot, head) row.
//
// What this design does about that bound: one CTA per lane, one warp
// per head, each thread holding EPT = ceil(D/32) elements of q and of
// the f32 accumulator (neighbouring threads on neighbouring addresses,
// so a warp reads one 128-byte row segment per element slot). Any head
// dim from 1 to 512 is taken: EPT 1-8 are instantiated, and 16 for D
// past 256. When D < 32 * EPT (TAIL: D not a multiple of 32, or D
// past 256 and below 512), elements at or past D are masked in the
// load (q and K read as 0, so they add exactly 0 to the dot and its
// warp reduction) and in the store; otherwise the mask is compiled
// out. The pages are the engine's pool and cannot be
// padded.
// The block loads its own page-table row into shared memory (the TPU
// kernel's scalar prefetch) and walks only the pages below ceil(n/ps) —
// the ragged skip: a lane never touches a page past its length. Keys are
// streamed TILE at a time with all K and V loads of a tile issued
// before any is used, so a warp keeps TILE*EPT loads in flight; the
// running max, sum and accumulator stay in registers (online softmax,
// f32) and the scores reduce with warp shuffles.
//
// What it leaves on the table (later work): every lane of a prefill
// chunk re-reads its sequence's pages, so a 512-token chunk reads its
// prefix up to 512 times (through L2) instead of once; grouping a
// chunk's lanes into a query tile with wgmma and TMA page loads is the
// step that approaches the bound. On 1-byte pages a warp reads 32
// bytes per element slot, a quarter of a 128-byte line; packing four
// codes per thread is the step for those.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }
// e4m3 -> f32 is exact (every e4m3 value is an f32 value)
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

// 1-byte page types carry a scale per (page, slot, head)
template <typename KVT>
constexpr bool kQuantized = sizeof(KVT) == 1;

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Args {
  const void* q;
  int64_t q_st, q_sh;
  const void* kp;
  const void* vp;
  const float* ks;  // (P, ps, H) scales of quantized pages, else null
  const float* vs;
  int64_t p_sp, p_ss, p_sh;  // page strides (elements): page, slot, head
  const int* page_tables;
  int64_t pt_s;
  const int* lane_slots;
  const int* lane_lens;
  void* out;
  int64_t o_st, o_sh;
  int T, H, D, ps, pp;
  float scale;
  cudaStream_t stream;
};

// EPT = ceil(D / 32) elements per thread; TILE = keys per tile; TAIL:
// D < 32 * EPT, the elements at or past D masked.
template <typename QT, typename KVT, int EPT, int TILE, bool TAIL>
__global__ void ragged_v2_kernel(const QT* __restrict__ q, int64_t q_st, int64_t q_sh,
                 const KVT* __restrict__ kp, const KVT* __restrict__ vp,
                 const float* __restrict__ ks, const float* __restrict__ vs,
                 int64_t p_sp, int64_t p_ss, int64_t p_sh,
                 const int* __restrict__ page_tables, int64_t pt_s,
                 const int* __restrict__ lane_slots,
                 const int* __restrict__ lane_lens, QT* __restrict__ out,
                 int64_t o_st, int64_t o_sh, int D, int ps, int pp,
                 float scale) {
  extern __shared__ int s_pages[];  // this lane's page-table row
  const int t = blockIdx.x;
  const int h = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const int* row = page_tables + (int64_t)lane_slots[t] * pt_s;
  for (int i = threadIdx.x; i < pp; i += blockDim.x) s_pages[i] = row[i];
  __syncthreads();
  const int n = min(lane_lens[t], ps * pp);
  const int H = blockDim.x >> 5;

  float qr[EPT], acc[EPT];
  bool in[EPT];  // this thread's element e lies below D
  const QT* qh = q + (int64_t)t * q_st + (int64_t)h * q_sh;
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    in[e] = !TAIL || lane + 32 * e < D;
    qr[e] = in[e] ? to_f32(qh[lane + 32 * e]) : 0.f;
    acc[e] = 0.f;
  }
  float m = -INFINITY;  // running max of the scores
  float l = 0.f;        // running sum of exp(score - m)
  const int64_t head_off = (int64_t)h * p_sh + lane;

  for (int j0 = 0; j0 < n; j0 += TILE) {
    float kr[TILE][EPT], vr[TILE][EPT];
    // issue every K and V load of the tile before using any of them
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      const int pos = j0 + j;
      if (pos < n) {
        const int page = s_pages[pos / ps], slot = pos % ps;
        const int64_t base =
            (int64_t)page * p_sp + (int64_t)slot * p_ss + head_off;
#pragma unroll
        for (int e = 0; e < EPT; ++e) {
          kr[j][e] = in[e] ? to_f32(kp[base + 32 * e]) : 0.f;
          vr[j][e] = in[e] ? to_f32(vp[base + 32 * e]) : 0.f;
        }
        if constexpr (kQuantized<KVT>) {
          // scales are contiguous (P, ps, H): one f32 per row, the same
          // address for the whole warp (a broadcast load)
          const int64_t srow = ((int64_t)page * ps + slot) * H + h;
          const float ksc = ks[srow], vsc = vs[srow];
#pragma unroll
          for (int e = 0; e < EPT; ++e) {
            kr[j][e] *= ksc;
            vr[j][e] *= vsc;
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < EPT; ++e) {
          kr[j][e] = 0.f;
          vr[j][e] = 0.f;
        }
      }
    }
    float s[TILE];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < EPT; ++e) d = fmaf(qr[e], kr[j][e], d);
      d = warp_sum(d) * scale;
      s[j] = (j0 + j < n) ? d : -INFINITY;
      tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);  // 0 on the first tile
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      s[j] = expf(s[j] - m_new);  // masked keys: exp(-inf) = 0
      psum += s[j];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      float a = acc[e] * alpha;
#pragma unroll
      for (int j = 0; j < TILE; ++j) a = fmaf(s[j], vr[j][e], a);
      acc[e] = a;
    }
    m = m_new;
  }

  QT* oh = out + (int64_t)t * o_st + (int64_t)h * o_sh;
#pragma unroll
  for (int e = 0; e < EPT; ++e)
    if (in[e]) oh[lane + 32 * e] = from_f32<QT>(acc[e] / l);
}

template <typename QT, typename KVT, int EPT, int TILE>
cudaError_t launch(const Args& a) {
  const size_t smem = (size_t)a.pp * sizeof(int);
  auto kern = a.D != 32 * EPT
                  ? ragged_v2_kernel<QT, KVT, EPT, TILE, true>
                  : ragged_v2_kernel<QT, KVT, EPT, TILE, false>;
  kern<<<dim3(a.T), dim3(32 * a.H), smem, a.stream>>>(
          static_cast<const QT*>(a.q), a.q_st, a.q_sh,
          static_cast<const KVT*>(a.kp), static_cast<const KVT*>(a.vp),
          a.ks, a.vs, a.p_sp, a.p_ss, a.p_sh, a.page_tables, a.pt_s,
          a.lane_slots, a.lane_lens, static_cast<QT*>(a.out), a.o_st, a.o_sh,
          a.D, a.ps, a.pp, a.scale);
  return cudaGetLastError();
}

// TILE * EPT <= 64 keeps the K and V tiles at <= 128 registers a
// thread: tiles 8, 16, 32 where they fit, and 4 only at EPT 16 (D past
// 256), where no tile of 8 does
template <typename QT, typename KVT, int EPT>
cudaError_t by_tile(const Args& a, int tile) {
  switch (tile) {
    case 4:
      if constexpr (EPT > 8) return launch<QT, KVT, EPT, 4>(a);
      break;
    case 8:
      if constexpr (EPT <= 8) return launch<QT, KVT, EPT, 8>(a);
      break;
    case 16:
      if constexpr (EPT <= 4) return launch<QT, KVT, EPT, 16>(a);
      break;
    case 32:
      if constexpr (EPT <= 2) return launch<QT, KVT, EPT, 32>(a);
      break;
  }
  return cudaErrorInvalidValue;
}

// EPT = ceil(D / 32): 1 to 8 for D up to 256, 16 for D up to 512
template <typename QT, typename KVT>
cudaError_t by_head_dim(const Args& a, int tile) {
  switch ((a.D + 31) / 32) {
    case 1: return by_tile<QT, KVT, 1>(a, tile);
    case 2: return by_tile<QT, KVT, 2>(a, tile);
    case 3: return by_tile<QT, KVT, 3>(a, tile);
    case 4: return by_tile<QT, KVT, 4>(a, tile);
    case 5: return by_tile<QT, KVT, 5>(a, tile);
    case 6: return by_tile<QT, KVT, 6>(a, tile);
    case 7: return by_tile<QT, KVT, 7>(a, tile);
    case 8: return by_tile<QT, KVT, 8>(a, tile);
  }
  if (a.D <= 512) return by_tile<QT, KVT, 16>(a, tile);
  return cudaErrorInvalidValue;
}

template <typename QT>
cudaError_t by_kv_dtype(const Args& a, int kv_dtype, int tile) {
  switch (kv_dtype) {
    case 0:
      return by_head_dim<QT, float>(a, tile);
    case 1:
      return by_head_dim<QT, __nv_bfloat16>(a, tile);
    case 2:
      return by_head_dim<QT, int8_t>(a, tile);
    case 3:
      return by_head_dim<QT, __nv_fp8_e4m3>(a, tile);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: q 0 = float32, 1 = bfloat16; pages also 2 = int8 and
// 3 = float8_e4m3fn, which need k_scales/v_scales (contiguous (P, ps, H)
// f32; null otherwise). Pointers are device pointers; strides are in
// elements. Launches on `stream` and returns cudaGetLastError() (0 on
// success); the caller raises on anything else.
extern "C" int paged_ragged_v2_launch(
    int q_dtype, int kv_dtype, const void* q, int64_t q_st, int64_t q_sh,
    const void* k_pages, const void* v_pages, const void* k_scales,
    const void* v_scales, int64_t p_sp, int64_t p_ss, int64_t p_sh,
    const void* page_tables, int64_t pt_s,
    const void* lane_slots, const void* lane_lens, void* out, int64_t o_st,
    int64_t o_sh, int T, int H, int D, int ps, int pp, int tile, float scale,
    void* stream) {
  if (T < 1 || H < 1 || H > 32 || D < 1 || D > 512 || ps < 1 || pp < 1 ||
      (size_t)pp * sizeof(int) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  if ((kv_dtype >= 2) != (k_scales != nullptr && v_scales != nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{q,       q_st,    q_sh,
         k_pages, v_pages, static_cast<const float*>(k_scales),
         static_cast<const float*>(v_scales), p_sp,
         p_ss,    p_sh,    static_cast<const int*>(page_tables),
         pt_s,    static_cast<const int*>(lane_slots),
         static_cast<const int*>(lane_lens),
         out,     o_st,    o_sh,
         T,       H,       D,
         ps,      pp,      scale,
         static_cast<cudaStream_t>(stream)};
  if (q_dtype == 0) return (int)by_kv_dtype<float>(a, kv_dtype, tile);
  if (q_dtype == 1)
    return (int)by_kv_dtype<__nv_bfloat16>(a, kv_dtype, tile);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* paged_ragged_v2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
