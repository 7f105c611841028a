// Ragged paged attention for Hopper (sm_90a): one query token per lane,
// attending through its sequence's page-table row, computed a query
// tile at a time so that a page the tile's lanes share is read once.
//
// Replaces: flexflow_tpu/kernels/paged_ragged_v2.py::_ragged_v2_kernel
// (launched by _ragged_v2_pallas), the TPU kernel of the serving mixed
// step (flexflow_tpu/serve/engine.py::_mixed_body, once per layer per
// step). Float32 and bfloat16 pages, and int8 or fp8 (e4m3) pages with
// one f32 scale per (page, slot, head) — the TPU kernel's quantized
// branch, which dequantizes each K/V row before the (otherwise
// unchanged) online softmax.
//
// What it computes, per lane t and head h (the plain version is
// flexflow_tpu_torch/kernels/paged_ragged_v2.py::ragged_attention_ref):
//   o[t,h] = softmax(q[t,h] . K[:n,h] * scale) . V[:n,h],
//   n = lane_lens[t], key j at page page_tables[lane_slots[t], j / ps],
//   slot j % ps. Keys at or past n are masked. lane_lens >= 1.
//   Quantized pages: K[j,h] = code * k_scales[page, slot, h] in f32, the
//   product dequantize_kv computes, so a dequantized key is the plain
//   version's bit for bit. Any head count and any head_dim up to what
//   the shared memory of one CTA holds (the wrapper takes up to 2048).
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores): the kernel must read each live K/V page (the pages covering
// [0, n) of every lane's row) once, and q, and write o. Attention per
// lane is 4*n*H*D flops; a prefill chunk of C lanes over one sequence
// does ~C/2 times the flops of its last lane over the same bytes, so
// with every page read once the mixed step's bound is its operations
// (f32) or its bytes (1- and 2-byte pages).
//
// The design: the lanes of a prefill chunk are contiguous and share one
// table row (serve/engine.py lays the mixed step out so), so the work is
// cut into query tiles — up to TQ consecutive lanes with one lane_slots
// value — each walking its sequence's pages once, for one head, up to
// the tile's longest lane. Lane t leads a tile if t % TQ == 0 or its
// slot differs from lane t-1's; the tile takes the lanes after it up to
// the next slot change or multiple of TQ. So any lane layout is right
// (shuffled slots make tiles of one lane), lanes of distinct slots —
// the decode lanes — run in tiles of their own, and nothing limits the
// head count. Two kernels, and the host reads no device value (the step
// can be captured in a CUDA graph): ragged_v2_plan_kernel (one CTA)
// finds the tiles and writes the work items — (tile, head, key split) —
// the longest lanes first (a chunk's last lanes and the decode lanes
// after it); ragged_v2_tile_kernel, a grid of as many CTAs as the card
// holds at once, walks the items. A grid of a CTA per (lane, head,
// split), most of them finding that their lane leads no tile, had spent
// more time launching those than the tiles took.
//
// In a CTA (128 threads), the tile's queries are staged in shared
// memory as f32 (zeros past D and past the tile's lanes), the page-table
// row too; K and V tiles of BK keys arrive through a ring of kStages
// stages of 16-byte cp.async copies (raw page bytes — 4, 8 or 16
// elements a copy for 4-, 2- and 1-byte pages — plus, for 1-byte pages,
// the keys' f32 scales), three tiles in flight while one is used. Rows
// whose head slice does not start 16-byte aligned (D * itemsize not a
// multiple of 16) are staged element by element instead. Then, per key
// tile:
//   scores  a thread owns one key and TQ/(128/BK) queries: it reads its
//           key's row a 16-byte chunk at a time (an odd number of chunks
//           a row, so 8 threads reading 8 rows hit 8 distinct bank
//           groups), and every q read is a broadcast; f32 FMAs; keys at
//           or past a query's own length score -inf;
//   softmax a warp per query: the tile's max, the rescale alpha, p and
//           the running sum, f32 (expf, as the plain version's exp);
//   p.V     a thread owns 4 elements of 2 queries' accumulator rows,
//           which live in shared memory (so D is bounded by shared
//           memory, not registers); V enters as f32, p unrounded.
// The scores, running max and sum, p and the accumulator are f32, as in
// _online_block; only the order of the sums differs from the plain
// version. 1-byte codes dequantize as they are read (code * scale, then
// the FMA), so the dequantized values are the plain version's.
//
// Tiles: TQ = 8 lanes with BK = 8, 16 or 32 keys (the wrapper maps
// FFConfig.serve_attn_block_kv onto BK), or TQ = 4, BK = 4 for the head
// dims where an 8-lane tile's shared memory does not fit.
//
// Key splits: a CTA walks its keys one tile after another, ~2 us a
// 32-key tile on an H100, so the longest lane (a decode lane, or a
// chunk's last tile, 512 keys at the smoke's shapes) set the kernel's
// time. So a tile's keys are cut into splits of ks (128 keys, more for
// long contexts: at most 8 splits), one work item each, which write
// their partial (m, l, acc) to a workspace; the tile's last split to
// finish (an atomic count per tile, zeroed by the plan) combines them —
// the combine of paged_decode's warps — and writes o. A tile within one
// split writes o itself.
//
// What it leaves on the table (later work): q.K^T and p.V on the tensor
// cores for bf16 pages (mma.sync, exact products, f32 sums); TMA page
// loads; a decode lane's CTA has one query and leaves most of its
// threads idle in the score and p.V phases.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kQueryTile = 8;  // lanes of a tile (QUERY_TILE in Python)
constexpr int kWarps = kThreads / 32;
// K/V tiles in the ring of a kQueryTile-lane tile: a CTA walks its keys
// in a chain of tiles, and the kStages - 1 tiles ahead of the one in use
// cover the latency of pages that come from device memory; the 4-lane
// tiles of the widest heads keep two
constexpr int kStages = 4;
// a block's shared memory on an H100 (dynamic, past 48 KB on request)
constexpr size_t kMaxSmem = 232448;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
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
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The f32 values of elements e..e+3 of a 16-byte chunk of page elements
// held in w; every conversion is exact.
template <typename KVT>
__device__ __forceinline__ void cvt4(const uint32_t (&w)[4], int e,
                                     float (&x)[4]) {
  if constexpr (sizeof(KVT) == 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] = __uint_as_float(w[e + k]);
  } else if constexpr (sizeof(KVT) == 2) {  // bf16: the high half of an f32
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      x[2 * k] = __uint_as_float(w[e / 2 + k] << 16);
      x[2 * k + 1] = __uint_as_float(w[e / 2 + k] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t b = (w[e / 4] >> (8 * k)) & 0xffu;
      if constexpr (std::is_same_v<KVT, int8_t>) {
        x[k] = (float)(int8_t)b;
      } else {  // e4m3 -> f32 is exact (every e4m3 value is an f32 value)
        __nv_fp8_e4m3 f;
        f.__x = (__nv_fp8_storage_t)b;
        x[k] = static_cast<float>(f);
      }
    }
  }
}

// A whole 16-byte chunk (shared memory, 16-byte aligned) as words
__device__ __forceinline__ void load16(const unsigned char* p,
                                       uint32_t (&w)[4]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
}

// The f32 values of the 4 page elements at p (shared memory, aligned to
// their 4 * itemsize bytes)
template <typename KVT>
__device__ __forceinline__ void load4(const unsigned char* p, float (&x)[4]) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if constexpr (sizeof(KVT) == 4) {
    load16(p, w);
  } else if constexpr (sizeof(KVT) == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x, w[1] = v.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
  cvt4<KVT>(w, 0, x);
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
  int vec;  // 16-byte copies of the page rows
  // a tile's keys in splits of split_keys, a work item each; with
  // nsplit > 1 the splits' partial (m, l, acc) meet in ws, (T, H,
  // nsplit, D + 2) f32, and cnt, (T, H) int32 zeroed by the plan, counts
  // the splits of a tile done
  int nsplit, split_keys;
  float* ws;
  int* cnt;
  // the plan (ragged_v2_plan_kernel): the work items, (t0 * H + h) *
  // nsplit + split for every tile t0, head and split the tile needs,
  // the longest lanes first; their count; and each tile's lanes and
  // longest lane, at its first lane
  int* items;
  int* count;
  int* tile_nq;
  int* tile_len;
};

// The geometry of a CTA's shared memory for head_dim D (bytes): the
// query tile and the accumulator (TQ rows of QS f32 each), the K/V ring
// (S stages x K, V x BK rows of RB bytes), p (TQ rows of BK + 1 f32),
// alpha, l and the lengths (TQ each), the scales ring (S x 2 x BK
// f32), then the page-table row (pp ints). Every part is a multiple of
// 16.
template <typename KVT, int TQ, int BK, int S>
struct Geometry {
  static constexpr int E = 16 / sizeof(KVT);  // elements of a chunk
  static constexpr int PS = (TQ * (BK + 1) + 3) / 4 * 4;
  int U, QS, RB;
  __host__ __device__ explicit Geometry(int D)
      : U((D + E - 1) / E), QS(U * E), RB(16 * (U | 1)) {}
  __host__ __device__ size_t bytes(int pp) const {
    return (size_t)(2 * TQ * QS + PS + 3 * TQ + 2 * S * BK) * 4 +
           (size_t)2 * S * BK * RB + (size_t)pp * 4;
  }
};

// One work item: the split `split` of head h of the tile that starts at
// lane t0. Every thread of the CTA takes the same item.
template <typename QT, typename KVT, int TQ, int BK, int S>
__device__ __forceinline__ void tile_item(const Args& a, int item,
                                          unsigned char* smem) {
  using G = Geometry<KVT, TQ, BK, S>;
  constexpr int E = G::E, PS = G::PS;
  constexpr int KG = kThreads / BK;          // key groups of the scores
  constexpr int RQ = (TQ + KG - 1) / KG;     // queries a thread scores
  constexpr int QPW = (TQ + kWarps - 1) / kWarps;  // queries a warp owns
  static_assert(kThreads % BK == 0 && BK <= 32, "a key a lane");
  static_assert(TQ % 2 == 0, "p.V takes queries in pairs");

  const int split = item % a.nsplit, lane_head = item / a.nsplit;
  const int t0 = lane_head / a.H, h = lane_head % a.H, tid = threadIdx.x;
  const int slot = a.lane_slots[t0];
  const int nq = a.tile_nq[t0], maxlen = a.tile_len[t0];
  const int cap = a.ps * a.pp;
  // this item's split of the tile's keys: [k_lo, k_hi)
  const int nsl = max(1, (maxlen + a.split_keys - 1) / a.split_keys);
  const int k_lo = split * a.split_keys;
  const int k_hi = min(maxlen, k_lo + a.split_keys);

  const G geo(a.D);
  const int U = geo.U, QS = geo.QS, RB = geo.RB, D = a.D;
  __syncthreads();  // every thread is done with the previous item
  float* s_q = reinterpret_cast<float*>(smem);
  float* s_acc = s_q + TQ * QS;
  unsigned char* s_kv = reinterpret_cast<unsigned char*>(s_acc + TQ * QS);
  float* s_p = reinterpret_cast<float*>(s_kv + 2 * S * BK * RB);
  float* s_alpha = s_p + PS;
  float* s_l = s_alpha + TQ;
  int* s_len = reinterpret_cast<int*>(s_l + TQ);
  float* s_sc = reinterpret_cast<float*>(s_len + TQ);
  int* s_pages = reinterpret_cast<int*>(s_sc + 2 * S * BK);

  const QT* q = static_cast<const QT*>(a.q);
  const KVT* kp = static_cast<const KVT*>(a.kp);
  const KVT* vp = static_cast<const KVT*>(a.vp);
  // the table entries of the split's pages (the ragged skip: none past
  // the tile's longest lane)
  const int pg_lo = k_lo / a.ps;
  const int live = (k_hi + a.ps - 1) / a.ps - pg_lo;
  const int* row = a.page_tables + (int64_t)slot * a.pt_s + pg_lo;
  for (int i = tid; i < live; i += kThreads) s_pages[i] = row[i];
  if (tid < TQ) s_len[tid] = tid < nq ? min(a.lane_lens[t0 + tid], cap) : 0;
  for (int x = tid; x < TQ * QS; x += kThreads) {
    const int i = x / QS, d = x % QS;
    const int64_t qi = (int64_t)(t0 + i) * a.q_st + (int64_t)h * a.q_sh;
    s_q[x] = i < nq && d < D ? to_f32(q[qi + d]) : 0.f;
    s_acc[x] = 0.f;
  }
  __syncthreads();

  // key tile kt -> ring stage st: BK rows of K and of V (zeros past the
  // tile's longest lane), and for 1-byte pages their scales
  // key position -> (page-table entry, slot), a shift for the usual
  // power-of-two page size
  const bool ps_pow2 = (a.ps & (a.ps - 1)) == 0;
  const int ps_shift = __ffs(a.ps) - 1;
  auto page_of = [&](int pos) {
    return ps_pow2 ? pos >> ps_shift : pos / a.ps;
  };
  // a thread stages chunks tid, tid + kThreads, ... of a tile's BK x U,
  // stepping (key, chunk) without dividing
  const int j_first = tid / U, c_first = tid % U;
  const int j_step = kThreads / U, c_step = kThreads % U;
  auto load = [&](int st, int kt) {
    unsigned char* sk = s_kv + st * 2 * BK * RB;
    unsigned char* sv = sk + BK * RB;
    const int j0 = k_lo + kt * BK;
    for (int j = j_first, c = c_first; j < BK;) {
      const int pos = j0 + j;
      const bool in = pos < k_hi;
      const int pg = page_of(pos);
      const int64_t off =
          in ? (int64_t)s_pages[pg - pg_lo] * a.p_sp +
                   (int64_t)(pos - pg * a.ps) * a.p_ss + (int64_t)h * a.p_sh +
                   (int64_t)c * E
             : 0;
      const int valid = in ? min(E, D - c * E) : 0;
      tc::stage_row_chunk(sk + j * RB + c * 16, kp + off, valid, a.vec);
      tc::stage_row_chunk(sv + j * RB + c * 16, vp + off, valid, a.vec);
      c += c_step;
      j += j_step;
      if (c >= U) c -= U, ++j;
    }
    if constexpr (kQuantized<KVT>) {
      float* sc = s_sc + st * 2 * BK;
      for (int j = tid; j < BK; j += kThreads) {
        const int pos = j0 + j;
        const bool in = pos < k_hi;
        // scales are contiguous (P, ps, H): one f32 a (page, slot, head)
        const int pg = page_of(pos);
        const int64_t srow =
            in ? ((int64_t)s_pages[pg - pg_lo] * a.ps + (pos - pg * a.ps)) *
                         a.H +
                     h
               : 0;
        tc::cp_async4(sc + j, a.ks + srow, in ? 4 : 0);
        tc::cp_async4(sc + BK + j, a.vs + srow, in ? 4 : 0);
      }
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  float m[QPW], l[QPW];  // running max and sum of query warp + kWarps * r
#pragma unroll
  for (int r = 0; r < QPW; ++r) m[r] = -INFINITY, l[r] = 0.f;

  const int ntiles = (k_hi - k_lo + BK - 1) / BK;
#pragma unroll
  for (int kt = 0; kt < S - 1; ++kt) {
    if (kt < ntiles) load(kt, kt);
    tc::cp_async_commit();
  }
  for (int kt = 0; kt < ntiles; ++kt) {
    const int st = kt % S;
    tc::cp_async_wait<S - 2>();
    __syncthreads();  // tile kt landed; every thread is done with kt - 1
    const int next = kt + S - 1;  // into kt - 1's stage
    if (next < ntiles) load(next % S, next);
    tc::cp_async_commit();
    const unsigned char* sk = s_kv + st * 2 * BK * RB;
    const unsigned char* sv = sk + BK * RB;
    const float* ksc = s_sc + st * 2 * BK;
    const float* vsc = ksc + BK;
    const int j0 = k_lo + kt * BK, jn = min(BK, k_hi - j0);

    // scores: thread (key j, group g) takes queries g + KG * r
    {
      const int j = tid % BK, g = tid / BK;
      if (g >= TQ) {
        // no query for this group (4-query tiles)
      } else if (j < jn) {
        float dot[RQ][4] = {};
        const unsigned char* kj = sk + j * RB;
        const float ks = kQuantized<KVT> ? ksc[j] : 1.f;
#pragma unroll 4
        for (int c = 0; c < U; ++c) {
          uint32_t w[4];  // one 16-byte read: 8 rows, 8 bank groups
          load16(kj + c * 16, w);
#pragma unroll
          for (int e4 = 0; e4 < E; e4 += 4) {
            float kx[4];
            cvt4<KVT>(w, e4, kx);
            if constexpr (kQuantized<KVT>) {
#pragma unroll
              for (int e = 0; e < 4; ++e) kx[e] *= ks;
            }
#pragma unroll
            for (int r = 0; r < RQ; ++r) {
              const int i = g + KG * r;
              if (RQ * KG > TQ && i >= TQ) continue;
              const float4 qv =
                  *reinterpret_cast<const float4*>(s_q + i * QS + c * E + e4);
              dot[r][0] = fmaf(qv.x, kx[0], dot[r][0]);
              dot[r][1] = fmaf(qv.y, kx[1], dot[r][1]);
              dot[r][2] = fmaf(qv.z, kx[2], dot[r][2]);
              dot[r][3] = fmaf(qv.w, kx[3], dot[r][3]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < RQ; ++r) {
          const int i = g + KG * r;
          if (i < nq) {
            const float d = (dot[r][0] + dot[r][1]) + (dot[r][2] + dot[r][3]);
            s_p[i * (BK + 1) + j] = j0 + j < s_len[i] ? d * a.scale : -INFINITY;
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < RQ; ++r) {
          const int i = g + KG * r;
          if (i < nq) s_p[i * (BK + 1) + j] = -INFINITY;
        }
      }
    }
    __syncthreads();

    // online softmax: warp w owns queries w + kWarps * r, lane j key j
#pragma unroll
    for (int r = 0; r < QPW; ++r) {
      const int i = warp + kWarps * r;
      if (i >= nq) continue;  // warp-uniform
      float* pi = s_p + i * (BK + 1);
      const float s = lane < BK ? pi[lane] : -INFINITY;
      // m_new is -inf only while a split has shown query i no key (its
      // length lies below the split): then alpha and p are 0
      const float m_new = fmaxf(m[r], warp_max(s));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[r] - m_use);  // 0 on the first tile
      const float p = expf(s - m_use);         // masked keys: 0
      if (lane < BK) pi[lane] = p;
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
      if (lane == 0) s_alpha[i] = alpha;
    }
    __syncthreads();

    // p.V: thread (query pair, 4 elements) over the tile's live keys
    {
      const int n4 = QS / 4, pairs = (nq + 1) / 2;
      for (int x = tid; x < pairs * n4; x += kThreads) {
        const int i = 2 * (x / n4), c4 = x % n4;
        const int i1 = min(i + 1, TQ - 1);  // a row past nq: never stored
        float* a0 = s_acc + i * QS + 4 * c4;
        float* a1 = s_acc + i1 * QS + 4 * c4;
        float4 o0 = *reinterpret_cast<float4*>(a0);
        float4 o1 = *reinterpret_cast<float4*>(a1);
        const float al0 = s_alpha[i], al1 = i + 1 < nq ? s_alpha[i1] : 1.f;
        float x0[4] = {o0.x * al0, o0.y * al0, o0.z * al0, o0.w * al0};
        float x1[4] = {o1.x * al1, o1.y * al1, o1.z * al1, o1.w * al1};
        const float* p0 = s_p + i * (BK + 1);
        const float* p1 = s_p + i1 * (BK + 1);
#pragma unroll 4
        for (int j = 0; j < jn; ++j) {
          float vx[4];
          load4<KVT>(sv + j * RB + 4 * c4 * (int)sizeof(KVT), vx);
          if constexpr (kQuantized<KVT>) {
#pragma unroll
            for (int e = 0; e < 4; ++e) vx[e] *= vsc[j];
          }
          const float q0 = p0[j], q1 = i + 1 < nq ? p1[j] : 0.f;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            x0[e] = fmaf(q0, vx[e], x0[e]);
            x1[e] = fmaf(q1, vx[e], x1[e]);
          }
        }
        *reinterpret_cast<float4*>(a0) =
            make_float4(x0[0], x0[1], x0[2], x0[3]);
        if (i + 1 < nq)
          *reinterpret_cast<float4*>(a1) =
              make_float4(x1[0], x1[1], x1[2], x1[3]);
      }
    }
  }

  // the running max (where alpha was: every thread is past the last
  // p.V first) and sum of each lane
  __syncthreads();
#pragma unroll
  for (int r = 0; r < QPW; ++r) {
    const int i = warp + kWarps * r;
    if (i < nq && lane == 0) s_alpha[i] = m[r], s_l[i] = l[r];
  }
  __syncthreads();
  QT* out = static_cast<QT*>(a.out);
  if (nsl <= 1) {  // the whole walk in this CTA
    for (int x = tid; x < nq * D; x += kThreads) {
      const int i = x / D, d = x % D;
      out[(int64_t)(t0 + i) * a.o_st + (int64_t)h * a.o_sh + d] =
          from_f32<QT>(s_acc[i * QS + d] / s_l[i]);
    }
    return;
  }
  // this split's (m, l, acc) of each lane to the workspace; the tile's
  // last split to finish combines them, as paged_decode's warps combine
  const int W = D + 2;
  for (int x = tid; x < nq * W; x += kThreads) {
    const int i = x / W, d = x % W;
    a.ws[(((int64_t)(t0 + i) * a.H + h) * a.nsplit + split) * W + d] =
        d == 0 ? s_alpha[i] : d == 1 ? s_l[i] : s_acc[i * QS + d - 2];
  }
  __threadfence();  // the partials are visible before the count
  __syncthreads();
  int* s_last = s_len;  // the lengths are no longer read
  if (tid == 0)
    s_last[0] = atomicAdd(a.cnt + (int64_t)t0 * a.H + h, 1) == nsl - 1;
  __syncthreads();
  if (!s_last[0]) return;
  __threadfence();
  for (int x = tid; x < nq * D; x += kThreads) {
    const int i = x / D, d = x % D;
    const float* w = a.ws + ((int64_t)(t0 + i) * a.H + h) * a.nsplit * W;
    float mx = -INFINITY;
    for (int sp = 0; sp < nsl; ++sp) mx = fmaxf(mx, __ldcg(w + sp * W));
    float lsum = 0.f, o = 0.f;
    for (int sp = 0; sp < nsl; ++sp) {
      const float c = expf(__ldcg(w + sp * W) - mx);  // no key: 0
      lsum = fmaf(__ldcg(w + sp * W + 1), c, lsum);
      o = fmaf(__ldcg(w + sp * W + 2 + d), c, o);
    }
    out[(int64_t)(t0 + i) * a.o_st + (int64_t)h * a.o_sh + d] =
        from_f32<QT>(o / lsum);
  }
}

// The grid walks the plan's items, CTA b taking items b, b + gridDim.x,
// ... (the grid is what the card holds at once, so no CTA exists only
// to find that its lane leads no tile).
// (With the launch bounds' minimum of 1 CTA an SM ptxas gives the bf16-q
// instantiations the registers they need, at most 128; without it it
// held them to 64 and spilled. Shared memory caps the CTAs an SM at 3
// either way.)
template <typename QT, typename KVT, int TQ, int BK, int S>
__global__ void __launch_bounds__(kThreads, 1)
    ragged_v2_tile_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int count = *a.count;
  for (int k = blockIdx.x; k < count; k += gridDim.x)
    tile_item<QT, KVT, TQ, BK, S>(a, a.items[k], smem);
}

constexpr int kPlanThreads = 1024;

// exclusive prefix sum over the block (kPlanThreads); returns the total
__device__ __forceinline__ int block_scan(int v, int& excl, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = s_warp[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    s_warp[lane] = w;  // inclusive sums of the warps
  }
  __syncthreads();
  excl = x - v + (warp > 0 ? s_warp[warp - 1] : 0);
  const int total = s_warp[kPlanThreads / 32 - 1];
  __syncthreads();
  return total;
}

// The plan, one CTA: which lanes lead a tile (lane t leads if t % tq ==
// 0 or its slot differs from lane t-1's; the tile takes the lanes after
// it up to the next slot change or multiple of tq), each tile's lanes
// and longest lane, and the work items of the tiles, lanes from the last
// so that the longest lanes of a chunk and the decode lanes go first;
// also zeroes the split counts.
__global__ void __launch_bounds__(kPlanThreads)
    ragged_v2_plan_kernel(const Args a, int tq) {
  __shared__ int s_warp[kPlanThreads / 32];
  const int cap = a.ps * a.pp;
  for (int i = threadIdx.x; i < a.T * a.H; i += kPlanThreads) a.cnt[i] = 0;
  int base = 0;
  for (int c0 = 0; c0 < a.T; c0 += kPlanThreads) {
    const int t = a.T - 1 - (c0 + (int)threadIdx.x);
    int n = 0, nsl = 0;
    if (t >= 0) {
      const int slot = a.lane_slots[t];
      if (t % tq == 0 || a.lane_slots[t - 1] != slot) {
        int maxlen = min(a.lane_lens[t], cap);
        n = 1;
        while (t + n < a.T && (t + n) % tq != 0 &&
               a.lane_slots[t + n] == slot)
          maxlen = max(maxlen, min(a.lane_lens[t + n++], cap));
        a.tile_nq[t] = n;
        a.tile_len[t] = maxlen;
        nsl = max(1, (maxlen + a.split_keys - 1) / a.split_keys);
      }
    }
    int off;
    const int total = block_scan(a.H * nsl, off, s_warp);
    for (int h = 0; h < a.H * (nsl > 0); ++h)
      for (int sp = 0; sp < nsl; ++sp)
        a.items[base + off + h * nsl + sp] = (t * a.H + h) * a.nsplit + sp;
    base += total;
  }
  if (threadIdx.x == 0) *a.count = base;
}

template <typename QT, typename KVT, int TQ, int BK, int S>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = Geometry<KVT, TQ, BK, S>(a.D).bytes(a.pp);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = ragged_v2_tile_kernel<QT, KVT, TQ, BK, S>;
  cudaError_t e;
  if (smem > 48 * 1024 &&  // past the default, on request
      (e = cudaFuncSetAttribute(kern,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem)) != cudaSuccess)
    return e;
  // as many CTAs as the card holds at once, and no more than items
  int dev, sms, per_sm;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, kThreads, smem)) != cudaSuccess)
    return e;
  const int64_t items = (int64_t)a.T * a.H * a.nsplit;
  const int grid = (int)std::min<int64_t>(items, (int64_t)sms * max(per_sm, 1));
  ragged_v2_plan_kernel<<<1, kPlanThreads, 0, stream>>>(a, TQ);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  kern<<<grid, dim3(kThreads), smem, stream>>>(a);
  return cudaGetLastError();
}

// keys per tile: 8, 16, 32 with kQueryTile-lane tiles; 4 with 4-lane
// tiles
template <typename QT, typename KVT>
cudaError_t by_tile(const Args& a, int tile, cudaStream_t stream) {
  switch (tile) {
    case 4: return launch<QT, KVT, 4, 4, 2>(a, stream);
    case 8: return launch<QT, KVT, kQueryTile, 8, kStages>(a, stream);
    case 16: return launch<QT, KVT, kQueryTile, 16, kStages>(a, stream);
    case 32: return launch<QT, KVT, kQueryTile, 32, kStages>(a, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename QT>
cudaError_t by_kv_dtype(const Args& a, int kv_dtype, int tile,
                        cudaStream_t stream) {
  switch (kv_dtype) {
    case 0: return by_tile<QT, float>(a, tile, stream);
    case 1: return by_tile<QT, __nv_bfloat16>(a, tile, stream);
    case 2: return by_tile<QT, int8_t>(a, tile, stream);
    case 3: return by_tile<QT, __nv_fp8_e4m3>(a, tile, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: q 0 = float32, 1 = bfloat16; pages also 2 = int8 and
// 3 = float8_e4m3fn, which need k_scales/v_scales (contiguous (P, ps, H)
// f32; null otherwise). Pointers are device pointers; strides are in
// elements; `tile` is the keys per tile (4, 8, 16 or 32). A tile's keys
// are walked in splits of `ks` (a multiple of 32), at most `nsplit` a
// tile (nsplit * ks >= ps * pp); with nsplit > 1, `ws` is an f32
// workspace of T * H * nsplit * (D + 2); `plan` is an int32 workspace of
// T * H * nsplit + 1 + 2 * T + T * H. Enqueues two kernels, the plan and
// the tiles. Launches on
// `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for what it does not take — a tile whose shared
// memory exceeds the block's; the caller raises on anything but 0.
extern "C" int paged_ragged_v2_launch(
    int q_dtype, int kv_dtype, const void* q, int64_t q_st, int64_t q_sh,
    const void* k_pages, const void* v_pages, const void* k_scales,
    const void* v_scales, int64_t p_sp, int64_t p_ss, int64_t p_sh,
    const void* page_tables, int64_t pt_s,
    const void* lane_slots, const void* lane_lens, void* out, int64_t o_st,
    int64_t o_sh, int T, int H, int D, int ps, int pp, int tile, float scale,
    int nsplit, int ks, void* ws, void* plan, void* stream) {
  if (T < 1 || H < 1 || D < 1 || ps < 1 || pp < 1 || nsplit < 1 ||
      ks < 1 || ks % 32 != 0 || (int64_t)nsplit * ks < (int64_t)ps * pp ||
      (int64_t)T * H * nsplit + 2LL * T + (int64_t)T * H >= (1LL << 31) ||
      (nsplit > 1) != (ws != nullptr) || plan == nullptr)
    return (int)cudaErrorInvalidValue;
  if ((kv_dtype >= 2) != (k_scales != nullptr && v_scales != nullptr))
    return (int)cudaErrorInvalidValue;
  static const int kItem[4] = {4, 2, 1, 1};
  if (kv_dtype < 0 || kv_dtype > 3) return (int)cudaErrorInvalidValue;
  const int64_t item = kItem[kv_dtype];
  // 16-byte copies when every head slice of every page row starts
  // 16-byte aligned
  const bool vec = (D * item) % 16 == 0 && (p_sh * item) % 16 == 0 &&
                   (p_ss * item) % 16 == 0 && (p_sp * item) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k_pages) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v_pages) % 16 == 0;
  Args a{q,       q_st,    q_sh,
         k_pages, v_pages, static_cast<const float*>(k_scales),
         static_cast<const float*>(v_scales), p_sp,
         p_ss,    p_sh,    static_cast<const int*>(page_tables),
         pt_s,    static_cast<const int*>(lane_slots),
         static_cast<const int*>(lane_lens),
         out,     o_st,    o_sh,
         T,       H,       D,
         ps,      pp,      scale,
         vec ? 1 : 0,     nsplit,  ks,
         static_cast<float*>(ws)};
  // the plan workspace: items, count, tile_nq, tile_len, then the counts
  int* p = static_cast<int*>(plan);
  a.items = p;
  a.count = a.items + (int64_t)T * H * nsplit;
  a.tile_nq = a.count + 1;
  a.tile_len = a.tile_nq + T;
  a.cnt = a.tile_len + T;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0) return (int)by_kv_dtype<float>(a, kv_dtype, tile, s);
  if (q_dtype == 1)
    return (int)by_kv_dtype<__nv_bfloat16>(a, kv_dtype, tile, s);
  return (int)cudaErrorInvalidValue;
}

// bytes of shared memory a CTA of the kernel takes for this page type
// (code as above), head_dim, tile and pages_per_seq; 0 for an unknown
// tile or type. The wrapper's tile map is held against it in the tests.
extern "C" long long paged_ragged_v2_smem_bytes(int kv_dtype, int D,
                                                int tile, int pp) {
  auto pick = [&](auto item) -> long long {
    using KVT = decltype(item);
    switch (tile) {
      case 4: return (long long)Geometry<KVT, 4, 4, 2>(D).bytes(pp);
      case 8:
        return (long long)Geometry<KVT, kQueryTile, 8, kStages>(D).bytes(pp);
      case 16:
        return (long long)Geometry<KVT, kQueryTile, 16, kStages>(D).bytes(pp);
      case 32:
        return (long long)Geometry<KVT, kQueryTile, 32, kStages>(D).bytes(pp);
    }
    return 0;
  };
  switch (kv_dtype) {
    case 0: return pick(float{});
    case 1: return pick(__nv_bfloat16{});
    case 2: return pick(int8_t{});
    case 3: return pick(__nv_fp8_e4m3{});
  }
  return 0;
}

extern "C" const char* paged_ragged_v2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
