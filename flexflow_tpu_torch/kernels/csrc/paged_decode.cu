// Paged attention for Hopper (sm_90a), one query token per row, each row
// attending through one page-table row: the legacy decode step and the
// v1 ragged entry point. One template, two launchers:
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
// ::paged_ragged_v1_ref; ::paged_decode_split_ref repeats this file's
// split-and-combine arithmetic in torch):
//   o[b,h] = softmax(q[b,h] . K[:n,h] * scale) . V[:n,h], n = len[b],
//   key j at page table_row[j / ps], slot j % ps. Keys at or past n are
//   masked; len >= 1 (a zero length NaNs the softmax, as in the plain
//   version). Float32 or bfloat16 q and pages, any head count, any
//   head_dim up to 2048. Scores, the online softmax (expf) and the
//   accumulators are f32; V enters as f32 and p unrounded.
//
// Bound on an H100 SXM (3.35 TB/s): per row 4*n*H*D flops over
// 2*n*H*D*itemsize bytes of live K/V, about 0.5 flop/byte in f32, so
// the least time is the live K/V bytes (the pages below ceil(n/ps) of
// each row) over the memory rate. A row has one query and no K/V head
// serves two queries, so the tensor cores would have nothing to reuse:
// the math stays on the CUDA cores.
//
// The design (paged_decode_split_kernel, head_dim up to 512):
//   * Key splits that fill the card. A CTA is a work item (row, head,
//     split of split_keys keys). The wrapper picks the split count from
//     what the host knows (rows, heads, ps * pp and the SM count, never
//     seq_lens, which lives on the device): enough items for about four
//     CTAs an SM, splits of at least 32 keys — 8 splits of 64 keys at
//     the legacy decode step (8 rows x 8 heads, 512 items on 132 SMs),
//     one split where rows x heads fill the card alone (v1's 520 lanes
//     x 8 heads), so the longest row no longer sets the time. A split
//     past its row's length returns after two loads; the grid holds at
//     most a few waves of them. Items run rows from the last, so a
//     prefill chunk's longest lanes (v1) start first.
//   * One launch. Each live split writes its partial (m, l, acc) to a
//     workspace the wrapper allocates; the row's last split to finish,
//     found by an atomic count a (row, head), combines them — the warps'
//     combine of the earlier design — writes o and re-zeroes the count
//     for the next launch (the wrapper zeroes the counts when it
//     allocates them). A row within one split writes o directly.
//   * A short chain of dependent memory trips, since a decode step's
//     attention is latency-bound: the row's length and the split's
//     page-table entries are read together; the last split reads every
//     partial's (m, l) in one round and their accumulators with P
//     threads an element, the loads unrolled so that they are in flight
//     together.
//   * Pages copied asynchronously. K and V rows arrive in a ring of
//     kStages stages of BK keys (8 KB of K and V a stage at D=64) by
//     16-byte cp.async in f32 and bf16 alike, three stages in flight
//     while one is scored. Rows whose head slice does not start 16-byte
//     aligned are staged element by element.
//   * The CTA's 128 threads form NG = 128 / G groups of G threads: a
//     group owns KPG keys of each tile and G threads split a key's row
//     by 16-byte chunks (G the power of two that covers the row's
//     chunks, up to 32; past 32 chunks a thread takes CPT of them), so
//     each thread keeps its slice of q and of the accumulator in
//     registers, reads 16 bytes of K and V from shared memory at a time
//     and reduces the dot with log2(G) shuffles. Each group runs its own
//     online softmax over its keys; at the end the groups combine
//     through shared memory, the same arithmetic as the splits'.
//
// Head dims past 512 (paged_decode_wide_kernel) keep the earlier design:
// a CTA per (row, head), 8 warps splitting the keys, q and the warps'
// accumulators in shared memory. No model of the repository serves at
// such head dims, and a thread's slice of q and acc (up to 64 f32 each)
// would not fit the split kernel's registers.
//
// What it leaves on the table: v1 (kernel 6) reads each lane's own row,
// so a page shared by the 512 lanes of a prefill chunk is read once a
// lane — 2 * sum(lens) * H * D * itemsize, ~546 MB of f32 at the smoke's
// inputs (counted from the lengths; the 16.8 MB pool fits the L2, which
// presumably serves most of them, not measured) against a bound of
// ~16.8 MB of pages — and page sharing is v2's design (kernel 1). At the
// decode step the kernel is a chain of dependent trips (length and
// table, K/V, the partials' fence and count, their reads), each a
// device-memory or L2 latency, not bytes; at long rows a CTA walks its
// tiles one after another with a few CTAs an SM, so latency within the
// tile loop, not the memory rate, sets its pace.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 128;  // a CTA of the split kernel
constexpr int kStages = 4;     // K/V tiles in its ring
// keys a group a tile where a thread takes one chunk of a key; half as
// many where it takes several
constexpr int kKpg = 2;
constexpr int NW = 8;          // warps of the wide kernel
// a block's shared memory on an H100 (dynamic, past 48 KB on request)
constexpr size_t kMaxSmem = 232448;

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

// the f32 values of a 16-byte chunk of page elements (4 f32 or 8 bf16);
// every conversion is exact
template <typename KVT>
__device__ __forceinline__ void cvt_chunk(const uint4& w,
                                          float (&x)[16 / sizeof(KVT)]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
  if constexpr (sizeof(KVT) == 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] = __uint_as_float(u[k]);
  } else {  // bf16: the high half of an f32
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x[2 * k] = __uint_as_float(u[k] << 16);
      x[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
    }
  }
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
  int vec;  // 16-byte copies of the page rows
  // a row's keys in nsplit splits of split_keys; with nsplit > 1 the
  // splits' partial (m, l, acc) meet in ws, (B, H, nsplit, D + 2) f32,
  // and cnt, (B, H) int32, zero between launches, counts the splits of
  // a (row, head) done
  int nsplit, split_keys;
  float* ws;
  int* cnt;
  cudaStream_t stream;
};

// The geometry of a split kernel's CTA for head_dim D (bytes): the K/V
// ring (kStages x K, V x BK rows of U 16-byte chunks), then the split's
// page-table entries. The groups' combine reuses the ring, and so does
// the last split's.
template <typename KVT, int G, int KPG>
struct Geometry {
  static constexpr int E = 16 / sizeof(KVT);  // elements of a chunk
  static constexpr int NG = kThreads / G;     // groups of a CTA
  static constexpr int BK = NG * KPG;         // keys of a tile
  int U, RB;
  __host__ __device__ explicit Geometry(int D)
      : U((D + E - 1) / E), RB(16 * U) {}
  __host__ __device__ size_t ring_bytes() const {
    return (size_t)kStages * 2 * BK * RB;
  }
  // with the split's page-table entries after the ring, or the last
  // split's combine (three floats a split and one a thread) over both
  __host__ __device__ size_t bytes(int split_keys, int ps,
                                   int nsplit) const {
    const size_t walk =
        ring_bytes() + (size_t)(split_keys / ps + 2) * sizeof(int);
    const size_t combine = (size_t)(3 * nsplit + kThreads) * sizeof(float);
    return walk > combine ? walk : combine;
  }
};

// One work item a CTA: split `split` of head h of row b. G threads a
// key, CPT 16-byte chunks a thread, KPG keys a group a tile.
template <typename QT, typename KVT, int G, int CPT, int KPG, bool RAGGED>
__global__ void __launch_bounds__(kThreads, 512 / kThreads)
    paged_decode_split_kernel(const Args a) {
  using Geo = Geometry<KVT, G, KPG>;
  constexpr int E = Geo::E, NG = Geo::NG, BK = Geo::BK;
  constexpr int EL = CPT * E;  // elements of q and acc a thread
  static_assert(32 % G == 0, "a group lies within a warp");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;

  // rows from the last, as kernel 1's plan orders its lanes: a prefill
  // chunk's lanes come in rising length, so the longest start first
  const int item = gridDim.x - 1 - blockIdx.x;
  const int split = item % a.nsplit;
  const int bh = item / a.nsplit;
  const int b = bh / a.H, h = bh % a.H;
  const int cap = a.ps * a.pp;
  const int k_lo = split * a.split_keys;
  const Geo geo(a.D);
  const int U = geo.U, RB = geo.RB, D = a.D;
  const int tid = threadIdx.x, g = tid / G, gl = tid % G;
  unsigned char* ring = smem;
  int* s_pages = reinterpret_cast<int*>(smem + geo.ring_bytes());

  // the table entries of the split's pages, read beside the row's
  // length rather than after it, so that the two loads are in flight
  // together (a split past the length reads them for nothing)
  const int row_idx = RAGGED ? a.lane_slots[b] : b;
  const int pg_lo = k_lo / a.ps;
  const int npg =
      min((min(k_lo + a.split_keys, cap) + a.ps - 1) / a.ps, a.pp) - pg_lo;
  const int* row = a.page_tables + (int64_t)row_idx * a.pt_s + pg_lo;
  const int len = a.lens[b];
  for (int i = tid; i < npg; i += kThreads) s_pages[i] = row[i];
  const int n = min(len, cap);
  // a split past the row's length has nothing to do (split 0 always
  // runs, so a zero length NaNs o as in the plain version)
  if (split > 0 && k_lo >= n) return;
  const int k_hi = min(n, k_lo + a.split_keys);
  const int nsl = max(1, (n + a.split_keys - 1) / a.split_keys);

  // this thread's slice of q: chunks gl + G * i, zeros past D
  float qr[EL], acc[EL];
  const QT* qh =
      static_cast<const QT*>(a.q) + (int64_t)b * a.q_sb + (int64_t)h * a.q_sh;
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = (gl + G * i) * E + e;
      qr[i * E + e] = d < D ? to_f32(qh[d]) : 0.f;
      acc[i * E + e] = 0.f;
    }
  }
  __syncthreads();  // the page entries are in

  const KVT* kp = static_cast<const KVT*>(a.kp);
  const KVT* vp = static_cast<const KVT*>(a.vp);
  const bool ps_pow2 = (a.ps & (a.ps - 1)) == 0;
  const int ps_shift = __ffs(a.ps) - 1;
  const int64_t head_off = (int64_t)h * a.p_sh;
  // a thread stages chunks tid, tid + kThreads, ... of a tile's BK x U,
  // stepping (key, chunk) without dividing
  const int j_first = tid / U, c_first = tid % U;
  const int j_step = kThreads / U, c_step = kThreads % U;
  // key tile kt -> ring stage st: BK rows of K and of V, zeros past
  // the split's last key
  auto load = [&](int st, int kt) {
    unsigned char* sk = ring + (size_t)st * 2 * BK * RB;
    unsigned char* sv = sk + BK * RB;
    const int j0 = k_lo + kt * BK;
    for (int j = j_first, c = c_first; j < BK;) {
      const int pos = j0 + j;
      const bool in = pos < k_hi;
      const int pg = ps_pow2 ? pos >> ps_shift : pos / a.ps;
      const int64_t off =
          in ? (int64_t)s_pages[pg - pg_lo] * a.p_sp +
                   (int64_t)(pos - pg * a.ps) * a.p_ss + head_off +
                   (int64_t)c * E
             : 0;
      const int valid = in ? min(E, D - c * E) : 0;
      tc::stage_row_chunk(sk + j * RB + c * 16, kp + off, valid, a.vec);
      tc::stage_row_chunk(sv + j * RB + c * 16, vp + off, valid, a.vec);
      c += c_step;
      j += j_step;
      if (c >= U) c -= U, ++j;
    }
  };

  float m = -INFINITY;  // running max of this group's scores
  float l = 0.f;        // running sum of exp(score - m)
  const int ntiles = (k_hi - k_lo + BK - 1) / BK;
#pragma unroll
  for (int kt = 0; kt < kStages - 1; ++kt) {
    if (kt < ntiles) load(kt, kt);
    tc::cp_async_commit();
  }
  for (int kt = 0; kt < ntiles; ++kt) {
    tc::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt landed; every thread is done with kt - 1
    const int next = kt + kStages - 1;  // into kt - 1's stage
    if (next < ntiles) load(next % kStages, next);
    tc::cp_async_commit();
    const unsigned char* sk = ring + (size_t)(kt % kStages) * 2 * BK * RB;
    const unsigned char* sv = sk + BK * RB;
    const int j0 = k_lo + kt * BK;

    // scores of the group's keys g + NG * k: the thread's chunks, then
    // the group's shuffles
    float s[KPG];
    float tmax = -INFINITY;
#pragma unroll
    for (int k = 0; k < KPG; ++k) {
      const int j = g + NG * k;
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const int c = gl + G * i;
        if (c < U) {
          float kx[E];
          cvt_chunk<KVT>(
              *reinterpret_cast<const uint4*>(sk + j * RB + c * 16), kx);
#pragma unroll
          for (int e = 0; e < E; ++e) dot = fmaf(qr[i * E + e], kx[e], dot);
        }
      }
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      s[k] = j0 + j < k_hi ? dot * a.scale : -INFINITY;
      tmax = fmaxf(tmax, s[k]);
    }
    // m_new is -inf only while the group has seen no key of the split:
    // then alpha and p are 0
    const float m_new = fmaxf(m, tmax);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = expf(m - m_use);  // 0 on the group's first key
    float psum = 0.f;
#pragma unroll
    for (int k = 0; k < KPG; ++k) {
      s[k] = expf(s[k] - m_use);  // masked keys: exp(-inf) = 0
      psum += s[k];
    }
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = gl + G * i;
      if (c >= U) continue;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i * E + e] *= alpha;
#pragma unroll
      for (int k = 0; k < KPG; ++k) {
        const int j = g + NG * k;
        float vx[E];
        cvt_chunk<KVT>(*reinterpret_cast<const uint4*>(sv + j * RB + c * 16),
                       vx);
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[i * E + e] = fmaf(s[k], vx[e], acc[i * E + e]);
      }
    }
  }

  // combine the groups through shared memory (the ring is free): a group
  // that saw no key has m = -inf, l = 0, acc = 0 and weight 0
  tc::cp_async_wait<0>();
  __syncthreads();
  const int W = U * E;  // an accumulator row
  float* s_m = reinterpret_cast<float*>(smem);
  float* s_c = s_m + NG;  // the groups' weights
  float* s_l = s_c + NG;
  float* s_acc = s_l + NG;
  if (gl == 0) s_m[g] = m, s_l[g] = l;
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int c = gl + G * i;
    if (c < U) {
#pragma unroll
      for (int e = 0; e < E; ++e) s_acc[g * W + c * E + e] = acc[i * E + e];
    }
  }
  __syncthreads();
  float mx = -INFINITY;
  for (int i = 0; i < NG; ++i) mx = fmaxf(mx, s_m[i]);
  if (tid < NG) s_c[tid] = s_m[tid] == -INFINITY ? 0.f : expf(s_m[tid] - mx);
  __syncthreads();
  float lsum = 0.f;
  for (int i = 0; i < NG; ++i) lsum = fmaf(s_l[i], s_c[i], lsum);
  QT* oh = static_cast<QT*>(a.out) + (int64_t)b * a.o_sb + (int64_t)h * a.o_sh;
  if (nsl == 1) {  // the whole row in this CTA
    for (int d = tid; d < D; d += kThreads) {
      float o = 0.f;
      for (int i = 0; i < NG; ++i) o = fmaf(s_acc[i * W + d], s_c[i], o);
      oh[d] = from_f32<QT>(o / lsum);
    }
    return;
  }
  // this split's (m, l, acc) to the workspace; the row's last split to
  // finish combines them
  const int WS = D + 2;
  float* wrow = a.ws + (int64_t)bh * a.nsplit * WS;
  float* mine = wrow + (int64_t)split * WS;
  if (tid == 0) mine[0] = mx, mine[1] = lsum;
  for (int d = tid; d < D; d += kThreads) {
    float o = 0.f;
    for (int i = 0; i < NG; ++i) o = fmaf(s_acc[i * W + d], s_c[i], o);
    mine[2 + d] = o;
  }
  __threadfence();  // the partials are visible before the count
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(a.cnt + bh, 1) == nsl - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // every partial's (m, l) in one round of loads, then their weights;
  // the shared memory is free again
  float* s_pm = reinterpret_cast<float*>(smem);
  float* s_pl = s_pm + a.nsplit;
  float* s_w = s_pl + a.nsplit;
  float* s_po = s_w + a.nsplit;  // kThreads partial sums of o
  for (int sp = tid; sp < nsl; sp += kThreads) {
    s_pm[sp] = __ldcg(wrow + sp * WS);
    s_pl[sp] = __ldcg(wrow + sp * WS + 1);
  }
  __syncthreads();
  float row_m = -INFINITY;
  for (int sp = 0; sp < nsl; ++sp) row_m = fmaxf(row_m, s_pm[sp]);
  for (int sp = tid; sp < nsl; sp += kThreads)
    s_w[sp] = s_pm[sp] == -INFINITY ? 0.f : expf(s_pm[sp] - row_m);
  __syncthreads();
  float row_l = 0.f;
  for (int sp = 0; sp < nsl; ++sp) row_l = fmaf(s_pl[sp], s_w[sp], row_l);
  // o: P threads an element where D < kThreads, each summing every
  // P-th split, its loads unrolled so that they are in flight together
  const int P = D < kThreads ? kThreads / D : 1;
  const int span = D < kThreads ? D : kThreads;
  for (int d0 = 0; d0 < D; d0 += span) {
    const int d = d0 + tid % span, part = tid / span;
    float o = 0.f;
    if (part < P && d < D) {
#pragma unroll 8
      for (int sp = part; sp < nsl; sp += P)
        o = fmaf(__ldcg(wrow + sp * WS + 2 + d), s_w[sp], o);
    }
    if (P > 1) {  // one pass: D < kThreads
      s_po[tid] = o;
      __syncthreads();
      if (part == 0)
        for (int q = 1; q < P; ++q) o += s_po[q * span + tid];
    }
    if (part == 0 && d < D) oh[d] = from_f32<QT>(o / row_l);
  }
  if (tid == 0) a.cnt[bh] = 0;  // zero again for the next launch
}

// Head dims past 512: q and the warps' accumulator rows live in dynamic
// shared memory rather than in EPT registers a thread, and the dot and
// the accumulator update are strided loops over D (lane, lane + 32, ...).
// The earlier design of this file: a CTA per (row, head), its NW warps
// splitting the row's keys, online softmax and the warps' combine.
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
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_m = reinterpret_cast<float*>(smem);
  float* s_l = s_m + NW;
  float* s_q = s_m + 2 * NW;
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

  // combine the warps: a warp that saw no key has m = -inf, l = 0, acc = 0
  // and weight exp(-inf - M) = 0
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

template <typename QT, typename KVT, int G, int CPT, int KPG, bool RAGGED>
cudaError_t launch(const Args& a) {
  const size_t smem =
      Geometry<KVT, G, KPG>(a.D).bytes(a.split_keys, a.ps, a.nsplit);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = paged_decode_split_kernel<QT, KVT, G, CPT, KPG, RAGGED>;
  if (smem > 48 * 1024) {  // past the default, on request
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int64_t items = (int64_t)a.B * a.H * a.nsplit;
  kern<<<(unsigned)items, kThreads, smem, a.stream>>>(a);
  return cudaGetLastError();
}

// The group shape for a row of U = ceil(D / E) 16-byte chunks: G, the
// power of two that covers them, up to 32 threads a key, kKpg keys a
// group a tile; past 32 chunks a thread takes CPT of them and half as
// many keys.
// Past D = 512 the wide kernel.
template <typename QT, typename KVT, bool RAGGED>
cudaError_t by_head_dim(const Args& a) {
  constexpr int E = 16 / sizeof(KVT);
  const int U = (a.D + E - 1) / E;
  if (a.D > 512) return launch_wide<QT, KVT, RAGGED>(a);
  constexpr int K1 = kKpg, K2 = kKpg / 2;
  if (U <= 1) return launch<QT, KVT, 1, 1, K1, RAGGED>(a);
  if (U <= 2) return launch<QT, KVT, 2, 1, K1, RAGGED>(a);
  if (U <= 4) return launch<QT, KVT, 4, 1, K1, RAGGED>(a);
  if (U <= 8) return launch<QT, KVT, 8, 1, K1, RAGGED>(a);
  if (U <= 16) return launch<QT, KVT, 16, 1, K1, RAGGED>(a);
  if (U <= 32) return launch<QT, KVT, 32, 1, K1, RAGGED>(a);
  if (U <= 64) return launch<QT, KVT, 32, 2, K2, RAGGED>(a);
  if constexpr (E == 4) {  // f32 pages: up to 128 chunks at D = 512
    if (U <= 96) return launch<QT, KVT, 32, 3, K2, RAGGED>(a);
    return launch<QT, KVT, 32, 4, K2, RAGGED>(a);
  }
  return cudaErrorInvalidValue;
}

template <bool RAGGED>
int dispatch(int q_dtype, int kv_dtype, Args& a) {
  const int64_t cap = (int64_t)a.ps * a.pp;
  if (a.B < 1 || a.H < 1 || a.D < 1 || a.ps < 1 || a.pp < 1 ||
      (size_t)a.pp * sizeof(int) > 32 * 1024 || a.nsplit < 1 ||
      a.split_keys < 1 || a.split_keys > cap ||
      (int64_t)a.nsplit * a.split_keys < cap ||
      (int64_t)a.B * a.H * a.nsplit >= (1LL << 31) ||
      (a.D > 512 && a.H > 65535) ||
      (a.nsplit > 1 && (a.ws == nullptr || a.cnt == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int64_t item = kv_dtype == 0 ? 4 : 2;
  // 16-byte copies when every head slice of every page row starts
  // 16-byte aligned
  a.vec = (a.D * item) % 16 == 0 && (a.p_sh * item) % 16 == 0 &&
          (a.p_ss * item) % 16 == 0 && (a.p_sp * item) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(a.kp) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(a.vp) % 16 == 0;
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
// (rows, pp) int32 with row stride pt_s. A row's keys are walked in
// `nsplit` splits of `split_keys` (nsplit * split_keys >= ps * pp); with
// nsplit > 1, `ws` is an f32 workspace of B * H * nsplit * (D + 2) and
// `cnt` B * H int32 counts that are zero at the launch and zero again
// after it (head dims past 512 take neither: they run one CTA a row and
// head). Each launcher enqueues one kernel on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for what
// it does not take; the caller raises on anything else.
extern "C" int paged_decode_launch(
    int q_dtype, int kv_dtype, const void* q, int64_t q_sb, int64_t q_sh,
    const void* k_pages, const void* v_pages, int64_t p_sp, int64_t p_ss,
    int64_t p_sh, const void* page_table, int64_t pt_s,
    const void* seq_lens, void* out, int64_t o_sb, int64_t o_sh, int B,
    int H, int D, int ps, int pp, float scale, int nsplit, int split_keys,
    void* ws, void* cnt, void* stream) {
  Args a{q,       q_sb,    q_sh,
         k_pages, v_pages, p_sp,
         p_ss,    p_sh,    static_cast<const int*>(page_table),
         pt_s,    nullptr, static_cast<const int*>(seq_lens),
         out,     o_sb,    o_sh,
         B,       H,       D,
         ps,      pp,      scale,
         0,       nsplit,  split_keys,
         static_cast<float*>(ws), static_cast<int*>(cnt),
         static_cast<cudaStream_t>(stream)};
  return dispatch<false>(q_dtype, kv_dtype, a);
}

extern "C" int paged_ragged_v1_launch(
    int q_dtype, int kv_dtype, const void* q, int64_t q_sb, int64_t q_sh,
    const void* k_pages, const void* v_pages, int64_t p_sp, int64_t p_ss,
    int64_t p_sh, const void* page_tables, int64_t pt_s,
    const void* lane_slots, const void* lane_lens, void* out, int64_t o_sb,
    int64_t o_sh, int T, int H, int D, int ps, int pp, float scale,
    int nsplit, int split_keys, void* ws, void* cnt, void* stream) {
  Args a{q,       q_sb,    q_sh,
         k_pages, v_pages, p_sp,
         p_ss,    p_sh,    static_cast<const int*>(page_tables),
         pt_s,    static_cast<const int*>(lane_slots),
         static_cast<const int*>(lane_lens),
         out,     o_sb,    o_sh,
         T,       H,       D,
         ps,      pp,      scale,
         0,       nsplit,  split_keys,
         static_cast<float*>(ws), static_cast<int*>(cnt),
         static_cast<cudaStream_t>(stream)};
  return dispatch<true>(q_dtype, kv_dtype, a);
}

extern "C" const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
