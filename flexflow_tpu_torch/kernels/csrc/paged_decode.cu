// Paged attention for Hopper (sm_90a), one query token per row, each row
// attending through one page-table row: the legacy decode step and the
// v1 ragged entry point. One template, two __global__ instantiations,
// two launchers:
//   paged_decode     row b reads table row b, length seq_lens[b];
//   paged_ragged_v1  row t reads table row lane_slots[t], length
//                    lane_lens[t].
//
// Replaces: flexflow_tpu/kernels/flash_attention.py::_paged_decode_kernel
// (launched by _paged_decode_pallas; the legacy decode step
// flexflow_tpu/serve/engine.py::_decode_impl, once per layer per decode
// step) and ::_paged_ragged_kernel (launched by _paged_ragged_pallas;
// the entry point paged_attention_ragged_v1, the equality oracle of
// kernel v2). Both TPU kernels run the shared online-page body
// _paged_online_page over a (rows, pages_per_seq) grid and differ only
// in how a row's length and table row are picked; so do these.
//
// What it computes, per row b and head h (the plain versions are
// flexflow_tpu_torch/kernels/flash_attention.py::paged_decode_ref and
// ::paged_ragged_v1_ref):
//   o[b,h] = softmax(q[b,h] . K[:n,h] * scale) . V[:n,h], n = len[b],
//   key j at page table_row[j / ps], slot j % ps. Keys at or past n are
//   masked; len >= 1 (a zero length NaNs the softmax, as in the plain
//   version). Float32 or bfloat16 q and pages, any head_dim: up to 512
//   a thread holds EPT = ceil(D/32) elements (1-8, or 16 past 256);
//   when D < 32 * EPT (TAIL) those at or past D read as 0
//   (adding exactly 0 to the dot and its warp reduction) and are never
//   stored, otherwise the mask is compiled out. Past 512
//   (paged_decode_wide_kernel) q and the accumulators live in shared
//   memory, (NW + 1) * D f32, which bounds D (the wrapper takes up to
//   2048).
//
// Bound on an H100 SXM (3.35 TB/s): per row 4*n*H*D flops over
// 2*n*H*D*itemsize bytes of live K/V, about 0.5 flop/byte in f32, so
// the least time is the live K/V bytes (the pages below ceil(n/ps) of
// each row) over the memory rate.
//
// What this design does about that bound: the TPU grid walks a row's
// pages in order on one core; here a row has too little work to fill
// 132 SMs alone (the legacy decode step has 8 rows), so the grid is
// (row, head) and the NW warps of a CTA split the row's keys, warp w
// taking tiles w, w + NW, ... of TILE keys. Each warp keeps its own
// running max, sum and accumulator in registers (online softmax, f32,
// threads holding EPT elements on neighbouring addresses); at the end
// the warps' (m, l, acc) combine through shared memory. Pages past a
// row's length are skipped: that is exact, since a fully masked page
// gives m_new = m, p = 0 and alpha = 1 and adds nothing. The block
// loads its own live page-table entries into shared memory (the TPU
// kernel's scalar prefetch).
//
// What it leaves on the table (later work): the legacy decode step
// (8 rows x 8 heads) launches 64 CTAs, so about half the 132 SMs idle;
// splitting long rows over several CTAs, with a second combine pass, is
// the step for long contexts. Each CTA reads its head's D-element slice
// of a (slot, head) row, 32*EPT*itemsize contiguous bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NW = 8;    // warps a CTA: they split one row's keys
// a block's shared memory on an H100 (dynamic, past 48 KB on request)
constexpr size_t kMaxSmem = 232448;

// keys a warp streams per step: 8, or 4 at EPT 16 (D past 256), which
// keeps the K and V tiles at 128 registers a thread
template <int EPT>
__host__ __device__ constexpr int tile_keys() { return EPT > 8 ? 4 : 8; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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
  int64_t q_sb, q_sh;
  const void* kp;
  const void* vp;
  int64_t p_sp, p_ss, p_sh;  // page strides (elements): page, slot, head
  const int* page_tables;
  int64_t pt_s;
  const int* lane_slots;  // RAGGED only: the table row of each row
  const int* lens;
  void* out;
  int64_t o_sb, o_sh;
  int B, H, D, ps, pp;
  float scale;
  cudaStream_t stream;
};

// EPT = ceil(D / 32) elements per thread; TAIL: D < 32 * EPT, the
// elements at or past D masked. RAGGED picks the table row through
// lane_slots (v1); otherwise row b reads table row b (decode).
template <typename QT, typename KVT, int EPT, bool RAGGED, bool TAIL>
__global__ void __launch_bounds__(NW * 32)
    paged_decode_kernel(const QT* __restrict__ q, int64_t q_sb, int64_t q_sh,
                        const KVT* __restrict__ kp,
                        const KVT* __restrict__ vp, int64_t p_sp,
                        int64_t p_ss, int64_t p_sh,
                        const int* __restrict__ page_tables, int64_t pt_s,
                        const int* __restrict__ lane_slots,
                        const int* __restrict__ lens, QT* __restrict__ out,
                        int64_t o_sb, int64_t o_sh, int D, int ps,
                        int pp, float scale) {
  constexpr int DP = 32 * EPT;  // D padded: the accumulators' row
  constexpr int TILE = tile_keys<EPT>();
  // shared: per-warp running max and sum, per-warp accumulators, then
  // this row's live page-table entries
  extern __shared__ float smem[];
  float* s_m = smem;
  float* s_l = smem + NW;
  float* s_acc = smem + 2 * NW;
  int* s_pages = reinterpret_cast<int*>(smem + 2 * NW + NW * DP);

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const int row_idx = RAGGED ? lane_slots[b] : b;
  const int* row = page_tables + (int64_t)row_idx * pt_s;
  const int n = min(lens[b], ps * pp);
  const int live = (n + ps - 1) / ps;  // pages below the length
  for (int i = threadIdx.x; i < live; i += blockDim.x) s_pages[i] = row[i];
  __syncthreads();

  float qr[EPT], acc[EPT];
  bool in[EPT];  // this thread's element e lies below D
  const QT* qh = q + (int64_t)b * q_sb + (int64_t)h * q_sh;
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    in[e] = !TAIL || lane + 32 * e < D;
    qr[e] = in[e] ? to_f32(qh[lane + 32 * e]) : 0.f;
    acc[e] = 0.f;
  }
  float m = -INFINITY;  // running max of this warp's scores
  float l = 0.f;        // running sum of exp(score - m)
  const int64_t head_off = (int64_t)h * p_sh + lane;

  for (int j0 = w * TILE; j0 < n; j0 += NW * TILE) {
    float kr[TILE][EPT], vr[TILE][EPT];
    // issue every K and V load of the tile before using any of them
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      const int pos = j0 + j;
      if (pos < n) {
        const int64_t base = (int64_t)s_pages[pos / ps] * p_sp +
                             (int64_t)(pos % ps) * p_ss + head_off;
#pragma unroll
        for (int e = 0; e < EPT; ++e) {
          kr[j][e] = in[e] ? to_f32(kp[base + 32 * e]) : 0.f;
          vr[j][e] = in[e] ? to_f32(vp[base + 32 * e]) : 0.f;
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
    // j0 < n, so the tile holds a live key and tmax is finite
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);  // 0 on the warp's first tile
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

  // combine the warps: a warp that saw no key has m = -inf, l = 0,
  // acc = 0 and weight exp(-inf - M) = 0
  if (lane == 0) {
    s_m[w] = m;
    s_l[w] = l;
  }
#pragma unroll
  for (int e = 0; e < EPT; ++e) s_acc[w * DP + lane + 32 * e] = acc[e];
  __syncthreads();
  QT* oh = out + (int64_t)b * o_sb + (int64_t)h * o_sh;
  for (int d = threadIdx.x; d < (TAIL ? D : DP); d += blockDim.x) {
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < NW; ++i) mx = fmaxf(mx, s_m[i]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const float c = expf(s_m[i] - mx);
      lsum = fmaf(s_l[i], c, lsum);
      o = fmaf(s_acc[i * DP + d], c, o);
    }
    oh[d] = from_f32<QT>(o / lsum);
  }
}

// Head dims past 512: q and the warps' accumulator rows live in dynamic
// shared memory rather than in EPT registers a thread, and the dot and
// the accumulator update are strided loops over D (lane, lane + 32, ...).
// The same key split, online softmax and combine as paged_decode_kernel.
template <typename QT, typename KVT, bool RAGGED>
__global__ void __launch_bounds__(NW * 32)
    paged_decode_wide_kernel(const QT* __restrict__ q, int64_t q_sb,
                             int64_t q_sh, const KVT* __restrict__ kp,
                             const KVT* __restrict__ vp, int64_t p_sp,
                             int64_t p_ss, int64_t p_sh,
                             const int* __restrict__ page_tables,
                             int64_t pt_s,
                             const int* __restrict__ lane_slots,
                             const int* __restrict__ lens,
                             QT* __restrict__ out, int64_t o_sb,
                             int64_t o_sh, int D, int ps, int pp,
                             float scale) {
  constexpr int TILE = 4;  // keys a warp scores before it updates
  // shared: per-warp running max and sum, q (D f32), the per-warp
  // accumulator rows (NW x D f32), this row's live page-table entries
  extern __shared__ float smem[];
  float* s_m = smem;
  float* s_l = smem + NW;
  float* s_q = smem + 2 * NW;
  float* s_acc = s_q + D;
  int* s_pages = reinterpret_cast<int*>(s_acc + NW * D);

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const int row_idx = RAGGED ? lane_slots[b] : b;
  const int* row = page_tables + (int64_t)row_idx * pt_s;
  const int n = min(lens[b], ps * pp);
  const int live = (n + ps - 1) / ps;  // pages below the length
  for (int i = threadIdx.x; i < live; i += blockDim.x) s_pages[i] = row[i];
  const QT* qh = q + (int64_t)b * q_sb + (int64_t)h * q_sh;
  for (int d = threadIdx.x; d < D; d += blockDim.x) s_q[d] = to_f32(qh[d]);
  float* acc = s_acc + w * D;  // this warp's row
  for (int d = lane; d < D; d += 32) acc[d] = 0.f;
  __syncthreads();

  float m = -INFINITY;  // running max of this warp's scores
  float l = 0.f;        // running sum of exp(score - m)
  const int64_t head_off = (int64_t)h * p_sh;
  for (int j0 = w * TILE; j0 < n; j0 += NW * TILE) {
    int64_t base[TILE];
    float s[TILE];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      const int pos = j0 + j;
      base[j] = pos < n ? (int64_t)s_pages[pos / ps] * p_sp +
                              (int64_t)(pos % ps) * p_ss + head_off
                        : 0;
      float d = 0.f;
      if (pos < n)
        for (int e = lane; e < D; e += 32)
          d = fmaf(s_q[e], to_f32(kp[base[j] + e]), d);
      d = warp_sum(d) * scale;
      s[j] = pos < n ? d : -INFINITY;
      tmax = fmaxf(tmax, s[j]);
    }
    // j0 < n, so the tile holds a live key and tmax is finite
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);  // 0 on the warp's first tile
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      s[j] = expf(s[j] - m_new);  // masked keys: exp(-inf) = 0
      psum += s[j];
    }
    l = l * alpha + psum;
    for (int e = lane; e < D; e += 32) {
      float x = acc[e] * alpha;
#pragma unroll
      for (int j = 0; j < TILE; ++j)
        if (j0 + j < n) x = fmaf(s[j], to_f32(vp[base[j] + e]), x);
      acc[e] = x;
    }
    m = m_new;
  }

  // combine the warps, as paged_decode_kernel
  if (lane == 0) {
    s_m[w] = m;
    s_l[w] = l;
  }
  __syncthreads();
  QT* oh = out + (int64_t)b * o_sb + (int64_t)h * o_sh;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < NW; ++i) mx = fmaxf(mx, s_m[i]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const float c = expf(s_m[i] - mx);
      lsum = fmaf(s_l[i], c, lsum);
      o = fmaf(s_acc[i * D + d], c, o);
    }
    oh[d] = from_f32<QT>(o / lsum);
  }
}

template <typename QT, typename KVT, bool RAGGED>
cudaError_t launch_wide(const Args& a) {
  const size_t smem = (size_t)(2 * NW + (NW + 1) * a.D) * sizeof(float) +
                      (size_t)a.pp * sizeof(int);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = paged_decode_wide_kernel<QT, KVT, RAGGED>;
  if (smem > 48 * 1024) {  // past the default, on request
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(a.B, a.H), dim3(NW * 32), smem, a.stream>>>(
      static_cast<const QT*>(a.q), a.q_sb, a.q_sh,
      static_cast<const KVT*>(a.kp), static_cast<const KVT*>(a.vp), a.p_sp,
      a.p_ss, a.p_sh, a.page_tables, a.pt_s, a.lane_slots, a.lens,
      static_cast<QT*>(a.out), a.o_sb, a.o_sh, a.D, a.ps, a.pp, a.scale);
  return cudaGetLastError();
}

template <typename QT, typename KVT, int EPT, bool RAGGED>
cudaError_t launch(const Args& a) {
  const size_t smem =
      (size_t)(2 * NW + NW * 32 * EPT) * sizeof(float) +
      (size_t)a.pp * sizeof(int);
  auto kern = a.D != 32 * EPT
                  ? paged_decode_kernel<QT, KVT, EPT, RAGGED, true>
                  : paged_decode_kernel<QT, KVT, EPT, RAGGED, false>;
  kern<<<dim3(a.B, a.H), dim3(NW * 32), smem, a.stream>>>(
          static_cast<const QT*>(a.q), a.q_sb, a.q_sh,
          static_cast<const KVT*>(a.kp), static_cast<const KVT*>(a.vp),
          a.p_sp, a.p_ss, a.p_sh, a.page_tables, a.pt_s, a.lane_slots,
          a.lens, static_cast<QT*>(a.out), a.o_sb, a.o_sh, a.D, a.ps, a.pp,
          a.scale);
  return cudaGetLastError();
}

// EPT = ceil(D / 32): 1 to 8 for D up to 256, 16 for D up to 512
template <typename QT, typename KVT, bool RAGGED>
cudaError_t by_head_dim(const Args& a) {
  switch ((a.D + 31) / 32) {
    case 1: return launch<QT, KVT, 1, RAGGED>(a);
    case 2: return launch<QT, KVT, 2, RAGGED>(a);
    case 3: return launch<QT, KVT, 3, RAGGED>(a);
    case 4: return launch<QT, KVT, 4, RAGGED>(a);
    case 5: return launch<QT, KVT, 5, RAGGED>(a);
    case 6: return launch<QT, KVT, 6, RAGGED>(a);
    case 7: return launch<QT, KVT, 7, RAGGED>(a);
    case 8: return launch<QT, KVT, 8, RAGGED>(a);
  }
  if (a.D <= 512) return launch<QT, KVT, 16, RAGGED>(a);
  return launch_wide<QT, KVT, RAGGED>(a);
}

template <bool RAGGED>
int dispatch(int q_dtype, int kv_dtype, const Args& a) {
  if (a.B < 1 || a.H < 1 || a.H > 65535 || a.D < 1 ||
      a.ps < 1 || a.pp < 1 || (size_t)a.pp * sizeof(int) > 32 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaError_t rc = cudaErrorInvalidValue;
  if (q_dtype == 0 && kv_dtype == 0)
    rc = by_head_dim<float, float, RAGGED>(a);
  else if (q_dtype == 0 && kv_dtype == 1)
    rc = by_head_dim<float, __nv_bfloat16, RAGGED>(a);
  else if (q_dtype == 1 && kv_dtype == 0)
    rc = by_head_dim<__nv_bfloat16, float, RAGGED>(a);
  else if (q_dtype == 1 && kv_dtype == 1)
    rc = by_head_dim<__nv_bfloat16, __nv_bfloat16, RAGGED>(a);
  return (int)rc;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Pointers are device pointers;
// strides are in elements; q and out are (B, H, D) with a unit last
// stride, pages (P, ps, H, D) with a unit last stride, page_tables
// (rows, pp) int32 with row stride pt_s. Each launcher runs on `stream`
// and returns cudaGetLastError() (0 on success); the caller raises on
// anything else.
extern "C" int paged_decode_launch(
    int q_dtype, int kv_dtype, const void* q, int64_t q_sb, int64_t q_sh,
    const void* k_pages, const void* v_pages, int64_t p_sp, int64_t p_ss,
    int64_t p_sh, const void* page_table, int64_t pt_s,
    const void* seq_lens, void* out, int64_t o_sb, int64_t o_sh, int B,
    int H, int D, int ps, int pp, float scale, void* stream) {
  Args a{q,       q_sb,    q_sh,
         k_pages, v_pages, p_sp,
         p_ss,    p_sh,    static_cast<const int*>(page_table),
         pt_s,    nullptr, static_cast<const int*>(seq_lens),
         out,     o_sb,    o_sh,
         B,       H,       D,
         ps,      pp,      scale,
         static_cast<cudaStream_t>(stream)};
  return dispatch<false>(q_dtype, kv_dtype, a);
}

extern "C" int paged_ragged_v1_launch(
    int q_dtype, int kv_dtype, const void* q, int64_t q_sb, int64_t q_sh,
    const void* k_pages, const void* v_pages, int64_t p_sp, int64_t p_ss,
    int64_t p_sh, const void* page_tables, int64_t pt_s,
    const void* lane_slots, const void* lane_lens, void* out, int64_t o_sb,
    int64_t o_sh, int T, int H, int D, int ps, int pp, float scale,
    void* stream) {
  Args a{q,       q_sb,    q_sh,
         k_pages, v_pages, p_sp,
         p_ss,    p_sh,    static_cast<const int*>(page_tables),
         pt_s,    static_cast<const int*>(lane_slots),
         static_cast<const int*>(lane_lens),
         out,     o_sb,    o_sh,
         T,       H,       D,
         ps,      pp,      scale,
         static_cast<cudaStream_t>(stream)};
  return dispatch<true>(q_dtype, kv_dtype, a);
}

extern "C" const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
