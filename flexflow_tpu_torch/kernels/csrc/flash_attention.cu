// Flash attention for Hopper (sm_90a): the forward kernel and the two
// backward kernels of the training path's attention op.
//
// Replaces (flexflow_tpu/kernels/flash_attention.py):
//   flash_fwd      <- _flash_fwd_kernel      (:67, launched by _fwd_pallas)
//   flash_bwd_dq   <- _flash_bwd_dq_kernel   (:131, launched by _bwd_pallas)
//   flash_bwd_dkv  <- _flash_bwd_dkv_kernel  (:161, launched by _bwd_pallas)
// the kernels of MultiHeadAttention._attend (ops/attention.py), once per
// layer per forward and once each per layer per backward.
//
// What they compute, on (b, s, h, d) tensors read through strides (the
// plain versions are flash_fwd_ref, flash_bwd_dq_ref and
// flash_bwd_dkv_ref in flexflow_tpu_torch/kernels/flash_attention.py):
//   forward: s = q.k^T * scale (masked where key > query when causal,
//            top-left aligned), o = softmax(s).v, lse = logsumexp(s);
//   dq:      p = exp(s - lse), ds = p * (do.v^T - delta) * scale,
//            dq = ds.k  (delta = rowsum(do * o), computed by the caller);
//   dkv:     dv = p^T.do, dk = ds^T.q.
// Dots read float32 or bfloat16 inputs and accumulate in f32; softmax
// statistics are f32. The roundings of the TPU kernels are kept: p is
// rounded to the input type before p.v and p^T.do, ds before ds.k and
// ds^T.q; o, dq, dk, dv are written in the input type, lse in f32.
//
// Bound on an H100 SXM at the flagship shapes (b=32, h=8, s=512, d=64,
// not causal): forward 4*b*h*s^2*d = 17.2 GFLOP, dq 25.8, dkv 34.4,
// against 16.8 MB per bf16 (b, s, h, d) operand. At 989 TFLOP/s (bf16
// tensor cores) or 67 TFLOP/s (f32) every kernel is bound by
// operations, not bytes (a few hundred flops per byte moved): the least
// time is 17-35 us in bf16 and 0.26-0.51 ms in f32. So what bounds a
// kernel here is the rate of its products: on the CUDA cores every type
// is capped at 67 TFLOP/s; only the tensor cores reach the bf16 bound.
//
// The bf16 forward (flash_fwd_mma_kernel) runs on the tensor cores, in
// the shape of FlashAttention-2: a CTA of 8 warps owns 128 query rows of
// one (batch, head), 16 rows a warp. Its Q rows go once through shared
// memory into mma A fragments that stay in registers for the whole key
// loop. K and V tiles of 64 keys stream through a two-stage ring of
// padded bf16 rows (16-byte cp.async copies, the next tile in flight
// while this one is used) and reach the products through ldmatrix (V
// with .trans). s = q.k^T is a run of mma.sync m16n8k16 (bf16 in, f32
// sums); the online softmax works on the accumulator fragments, a row's
// max and sum reducing over the 4 lanes of a quad; p, rounded to bf16
// in registers, is the A operand of p.v as it stands, because the C
// layout of two n8 tiles is the A layout of one k16 step — p never
// touches shared memory. The scale is applied to the f32 dot, folded
// with log2(e) so that every exponential is one exp2f of one fma:
// p = exp2(s * scale * log2(e) - m), m the running max in log2 units
// (the row max of the raw dots, scaled; lse is converted back). This
// exp2f for expf moves o and lse by rounding only, far inside the bf16
// tolerance of the checks. l sums the unrounded p; o = acc / l is
// rounded to bf16. Tiles wholly above
// the diagonal are never loaded, and a warp skips the products of a tile
// all of whose keys lie past its rows. The wrapper hands it rows that
// start 16-byte aligned (a view that is not is made contiguous).
//
// The f32 forward and both backward kernels run on the CUDA cores: one
// CTA of 256 threads owns a 64-row tile (queries for forward and dq,
// keys for dkv) and loops over the other side's 64-row tiles, so the
// TPU kernel's sequential grid axis becomes a loop inside the block and
// no state crosses blocks. Tiles are staged in shared memory as f32
// (rows padded by one word so neither the row-broadcast nor the column
// reads conflict on banks); each thread holds a 4 x 4 block of the
// score tile and a 4 x d/16 block of the output in registers; row
// reductions are shuffles within 16 lanes. Their dots run as f32 FMAs
// on the CUDA cores, under the f32 peak of 67 TFLOP/s — for f32 inputs
// that is the contract (exact f32, no TF32), for the bf16 backward the
// ceiling it is still under. Causal tiles wholly above the diagonal are
// never loaded: the dq loop stops at the diagonal tile, dkv starts its
// loop there. Tail tiles (s not a multiple of the tile) are masked.
//
// What is left (later work): the backward on the tensor cores with dq
// fused into the dkv pass; wgmma from shared memory and TMA loads in
// place of mma.sync, ldmatrix and cp.async; a deeper K/V ring.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"

// A (b, s, h, d) operand: its data and its strides in elements. The
// last dimension is contiguous (stride 1).
struct Bshd {
  void* ptr;
  int64_t sb, ss, sh;
};

namespace {

constexpr int kTile = 64;       // rows of a query or key tile
constexpr int kThreads = 256;   // 16 x 16: each owns 4 rows of a tile
constexpr int kLdP = kTile + 1; // padded row of a 64 x 64 score tile

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

// x rounded to T and back: the TPU kernels' `.astype(input dtype)`
// before a dot
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// reductions over the 16 lanes that share a row (one half-warp)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__device__ __forceinline__ const T* head_base(const Bshd& x, int b, int h) {
  return static_cast<const T*>(x.ptr) + (int64_t)b * x.sb + (int64_t)h * x.sh;
}

// rows [r0, r0 + 64) of one (batch, head) slice into a [64][D + 1] f32
// tile; rows at or past n are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int64_t ss, int r0, int n) {
#pragma unroll 4
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i % D, row = r0 + r;
    dst[r * (D + 1) + c] = row < n ? to_f32(src[(int64_t)row * ss + c]) : 0.f;
  }
}

// 64 entries of a per-row f32 vector (lse or delta); zero past n
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src,
                                          int r0, int n) {
  if (threadIdx.x < kTile) {
    const int row = r0 + threadIdx.x;
    dst[threadIdx.x] = row < n ? src[row] : 0.f;
  }
}

// s[r][c] = sum_d A[4ty + r][d] * B[tx + 16c][d]  (A.B^T of two tiles)
template <int D>
__device__ __forceinline__ void mm_abt(const float* A, const float* B,
                                       float (&s)[4][4]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* a = A + ty * 4 * (D + 1);
  const float* b = B + tx * (D + 1);
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) av[r] = a[r * (D + 1) + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) bv[c] = b[c * 16 * (D + 1) + d];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = fmaf(av[r], bv[c], s[r][c]);
  }
}

// acc[r][j] += sum_k P[4ty + r][k] * B[k][tx + 16j]  (P.B, P a 64 x 64
// score tile, B a [64][D + 1] tile)
template <int D>
__device__ __forceinline__ void mm_pb(const float* P, const float* B,
                                      float (&acc)[4][D / 16]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* p = P + ty * 4 * kLdP;
  const float* b = B + tx;
#pragma unroll 4
  for (int k = 0; k < kTile; ++k) {
    float pv[4], bv[D / 16];
#pragma unroll
    for (int r = 0; r < 4; ++r) pv[r] = p[r * kLdP + k];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) bv[j] = b[k * (D + 1) + 16 * j];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[r][j] = fmaf(pv[r], bv[j], acc[r][j]);
  }
}

// rows of a [4][D/16] register block back to a (b, s, h, d) operand
template <typename T, int D>
__device__ __forceinline__ void store_rows(const Bshd& x, int b, int h, int r0,
                                           int n, const float (&acc)[4][D / 16]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  T* base = static_cast<T*>(x.ptr) + (int64_t)b * x.sb + (int64_t)h * x.sh;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = r0 + ty * 4 + r;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      base[(int64_t)row * x.ss + tx + 16 * j] = from_f32<T>(acc[r][j]);
    }
  }
}

// ------------------------------------------------------------ forward
// grid (ceil(Sq / 64), H, B); one CTA per 64 query rows of one head
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(Bshd q, Bshd k, Bshd v, Bshd o, float* __restrict__ lse,
                     int H, int Sq, int Sk, int causal, float scale) {
  constexpr int LD = D + 1, NJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* Ps = Vs + kTile * LD;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* kp = head_base<T>(k, b, h);
  const T* vp = head_base<T>(v, b, h);

  load_tile<T, D>(Qs, head_base<T>(q, b, h), q.ss, q0, Sq);
  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[r][j] = 0.f;
  }
  int n_kt = (Sk + kTile - 1) / kTile;
  if (causal)  // tiles wholly above the diagonal contribute nothing
    n_kt = min(n_kt, (min(q0 + kTile, Sq) - 1) / kTile + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // every thread is done with the previous K, V, P
    load_tile<T, D>(Ks, kp, k.ss, k0, Sk);
    load_tile<T, D>(Vs, vp, v.ss, k0, Sk);
    __syncthreads();
    float s[4][4];
    mm_abt<D>(Qs, Ks, s);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = q0 + ty * 4 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + tx + 16 * c;
        float x = s[r][c] * scale;
        if (kpos >= Sk || (causal && kpos > qpos)) x = -INFINITY;
        s[r][c] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[r], row_max(mx));
      // a row with every key so far masked keeps m = -inf; exp against
      // 0 then gives p = 0 and alpha = 0 instead of NaN
      const float m_ref = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[r] - m_ref);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[r][c] - m_ref);
        psum += p;
        Ps[(ty * 4 + r) * kLdP + tx + 16 * c] = round_to<T>(p);
      }
      l[r] = l[r] * alpha + row_sum(psum);
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[r][j] *= alpha;
    }
    __syncthreads();
    mm_pb<D>(Ps, Vs, acc);
  }

#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[r][j] = acc[r][j] / l[r];
  store_rows<T, D>(o, b, h, q0, Sq, acc);
  if (tx == 0) {
    float* lrow = lse + ((int64_t)b * H + h) * Sq;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = q0 + ty * 4 + r;
      if (qpos < Sq) lrow[qpos] = m[r] + logf(l[r]);
    }
  }
}

// ------------------------------------------------- forward, bf16 (mma)
// grid (ceil(Sq / 128), H, B); one CTA per 128 query rows of one head.
// A warp owns MT m16 tiles (16 * MT query rows): MT = 2 (4 warps) for
// d <= 64, where each K or V fragment loaded from shared memory then
// feeds two products; MT = 1 (8 warps) for d = 128, whose output
// accumulators would not fit twice in registers. q, k, v rows start
// 16-byte aligned (the launcher checks). scale_log2 = scale * log2(e):
// the running max lives in log2 units, so each p is one fma and one
// exp2f; lse is converted back.
constexpr int kFwdM = 128;            // query rows of a CTA
constexpr int kFwdN = 64;             // keys of a K/V tile

// (host and device: the kernel reads them too)
template <int D>
__host__ __device__ constexpr int fwd_mt() { return D <= 64 ? 2 : 1; }
template <int D>
__host__ __device__ constexpr int fwd_threads() {
  return kFwdM / (16 * fwd_mt<D>()) * 32;
}
template <int D>
constexpr size_t fwd_mma_smem() {     // Q, then 2 stages of K and V
  return (size_t)(kFwdM + 4 * kFwdN) * (D + 8) * sizeof(__nv_bfloat16);
}

template <int D>
__global__ void __launch_bounds__(fwd_threads<D>())
    flash_fwd_mma_kernel(Bshd q, Bshd k, Bshd v, Bshd o,
                         float* __restrict__ lse, int H, int Sq, int Sk,
                         int causal, float scale_log2) {
  using tc::bf16;
  constexpr int MT = fwd_mt<D>();      // m16 tiles of a warp
  constexpr int NT = fwd_threads<D>();
  constexpr int LD = D + 8;        // padded smem row: ldmatrix conflict-free
  constexpr int KD = D / 16;       // k16 steps of q.k^T
  constexpr int ND = D / 8;        // n8 tiles of the output
  constexpr int NS = kFwdN / 8;    // n8 tiles of a score tile
  constexpr int CH = D / 8;        // 16-byte chunks of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kFwdM * LD;      // [2][kFwdN][LD]
  bf16* Vs = Ks + 2 * kFwdN * LD;  // [2][kFwdN][LD]
  const int q0 = blockIdx.x * kFwdM, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = q0 + warp * 16 * MT;  // this warp's first query row
  const bf16* kp = head_base<bf16>(k, b, h);
  const bf16* vp = head_base<bf16>(v, b, h);

  // rows [first, first + R) of a head slice; rows at or past n are zeros
  auto stage = [&](bf16* dst, const bf16* src, int64_t ss, int first, int R,
                   int n) {
    for (int i = threadIdx.x; i < R * CH; i += NT) {
      const int r = i / CH, c = i % CH, row = first + r;
      tc::cp_async16(dst + r * LD + c * 8,
                     src + (int64_t)min(row, n - 1) * ss + c * 8,
                     row < n ? 16 : 0);
    }
  };
  int n_kt = (Sk + kFwdN - 1) / kFwdN;
  if (causal)  // tiles wholly above the diagonal are never loaded
    n_kt = min(n_kt, (min(q0 + kFwdM, Sq) - 1) / kFwdN + 1);
  stage(Qs, head_base<bf16>(q, b, h), q.ss, q0, kFwdM, Sq);
  stage(Ks, kp, k.ss, 0, kFwdN, Sk);
  stage(Vs, vp, v.ss, 0, kFwdN, Sk);
  tc::cp_async_commit();

  uint32_t qf[MT][KD][4];          // this warp's Q rows, for the whole loop
  float m[MT][2], l[MT][2], acc[MT][ND][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kFwdN, buf = kt & 1;
    if (kt + 1 < n_kt) {  // the next K/V tile streams in behind this one
      stage(Ks + (buf ^ 1) * kFwdN * LD, kp, k.ss, k0 + kFwdN, kFwdN, Sk);
      stage(Vs + (buf ^ 1) * kFwdN * LD, vp, v.ss, k0 + kFwdN, kFwdN, Sk);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();        // everything but the newest group landed
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kd = 0; kd < KD; ++kd)
          tc::ldsm_x4(qf[mt][kd],
                      Qs + (r0 - q0 + mt * 16 + tc::lane_mk_row(lane)) * LD +
                          kd * 16 + tc::lane_mk_col(lane));
    }
    // a warp whose rows are past Sq, or (causal) all above this tile's
    // first key, has nothing to add from it
    const bool live = r0 < Sq && !(causal && k0 > r0 + 16 * MT - 1);
    if (live) {
      const bf16* Kt = Ks + buf * kFwdN * LD;
      const bf16* Vt = Vs + buf * kFwdN * LD;
      float s[MT][NS][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
#pragma unroll
        for (int p = 0; p < NS / 2; ++p) {
          uint32_t kb[4];
          tc::ldsm_x4(kb, Kt + (p * 16 + tc::lane_km_row(lane)) * LD +
                              kd * 16 + tc::lane_km_col(lane));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            tc::mma16816(s[mt][2 * p], qf[mt][kd], kb[0], kb[1]);
            tc::mma16816(s[mt][2 * p + 1], qf[mt][kd], kb[2], kb[3]);
          }
        }
      const bool masked =
          k0 + kFwdN > Sk || (causal && k0 + kFwdN - 1 > r0);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {  // rows gid and gid + 8 of tile mt
          const int qpos = r0 + mt * 16 + gid + 8 * hr;
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kpos = k0 + j * 8 + 2 * tig + e;
              if (masked && (kpos >= Sk || (causal && kpos > qpos)))
                s[mt][j][2 * hr + e] = -INFINITY;
              mx = fmaxf(mx, s[mt][j][2 * hr + e]);
            }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          // the scale after the dot: scale_log2 > 0, so the row max of
          // the scaled scores is the scaled row max
          const float m_new = fmaxf(m[mt][hr], mx * scale_log2);
          // a row with every key so far masked keeps m = -inf; exp
          // against 0 then gives p = 0 and alpha = 0 instead of NaN
          const float m_ref = m_new == -INFINITY ? 0.f : m_new;
          const float alpha = exp2f(m[mt][hr] - m_ref);
          float psum = 0.f;
#pragma unroll
          for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float p =
                  exp2f(fmaf(s[mt][j][2 * hr + e], scale_log2, -m_ref));
              s[mt][j][2 * hr + e] = p;
              psum += p;                // l sums the unrounded p
            }
          psum += __shfl_xor_sync(0xffffffffu, psum, 1);
          psum += __shfl_xor_sync(0xffffffffu, psum, 2);
          l[mt][hr] = l[mt][hr] * alpha + psum;
          m[mt][hr] = m_new;
#pragma unroll
          for (int j = 0; j < ND; ++j) {
            acc[mt][j][2 * hr] *= alpha;
            acc[mt][j][2 * hr + 1] *= alpha;
          }
        }
      // p rounded to bf16 in registers is the A operand of p.v
#pragma unroll
      for (int kk = 0; kk < kFwdN / 16; ++kk) {
        uint32_t pa[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          pa[mt][0] = tc::pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
          pa[mt][1] = tc::pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
          pa[mt][2] = tc::pack_bf16(s[mt][2 * kk + 1][0],
                                    s[mt][2 * kk + 1][1]);
          pa[mt][3] = tc::pack_bf16(s[mt][2 * kk + 1][2],
                                    s[mt][2 * kk + 1][3]);
        }
#pragma unroll
        for (int p = 0; p < ND / 2; ++p) {
          uint32_t vb[4];
          tc::ldsm_x4_t(vb, Vt + (kk * 16 + tc::lane_mk_row(lane)) * LD +
                                p * 16 + tc::lane_mk_col(lane));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            tc::mma16816(acc[mt][2 * p], pa[mt], vb[0], vb[1]);
            tc::mma16816(acc[mt][2 * p + 1], pa[mt], vb[2], vb[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with buf before it is refilled
  }

  bf16* ob = static_cast<bf16*>(o.ptr) + (int64_t)b * o.sb + (int64_t)h * o.sh;
  float* lrow = lse + ((int64_t)b * H + h) * Sq;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = r0 + mt * 16 + gid + 8 * hr;
      if (row >= Sq) continue;
      const float lr = l[mt][hr];
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)row * o.ss + j * 8 +
                                           2 * tig) =
            __floats2bfloat162_rn(acc[mt][j][2 * hr] / lr,
                                  acc[mt][j][2 * hr + 1] / lr);
      }
      if (tig == 0)
        lrow[row] = m[mt][hr] * 0.69314718055994531f + logf(lr);
    }
}

// ---------------------------------------------------------------- dq
// grid (ceil(Sq / 64), H, B); one CTA per 64 query rows of one head
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(Bshd q, Bshd k, Bshd v, Bshd dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, Bshd dq, int H,
                        int Sq, int Sk, int causal, float scale) {
  constexpr int LD = D + 1, NJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kTile * LD;
  float* Ks = dOs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* dSs = Vs + kTile * LD;
  float* lse_s = dSs + kTile * kLdP;
  float* dl_s = lse_s + kTile;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* kp = head_base<T>(k, b, h);
  const T* vp = head_base<T>(v, b, h);
  const int64_t row_off = ((int64_t)b * H + h) * Sq;

  load_tile<T, D>(Qs, head_base<T>(q, b, h), q.ss, q0, Sq);
  load_tile<T, D>(dOs, head_base<T>(dout, b, h), dout.ss, q0, Sq);
  load_rows(lse_s, lse + row_off, q0, Sq);
  load_rows(dl_s, delta + row_off, q0, Sq);
  float acc[4][NJ];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[r][j] = 0.f;
  int n_kt = (Sk + kTile - 1) / kTile;
  if (causal) n_kt = min(n_kt, (min(q0 + kTile, Sq) - 1) / kTile + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<T, D>(Ks, kp, k.ss, k0, Sk);
    load_tile<T, D>(Vs, vp, v.ss, k0, Sk);
    __syncthreads();
    float s[4][4], dp[4][4];
    mm_abt<D>(Qs, Ks, s);
    mm_abt<D>(dOs, Vs, dp);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = ty * 4 + r, qpos = q0 + row;
      const float lr = lse_s[row], dr = dl_s[row];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + tx + 16 * c;
        const bool live = qpos < Sq && kpos < Sk && !(causal && kpos > qpos);
        const float p = live ? expf(s[r][c] * scale - lr) : 0.f;
        dSs[row * kLdP + tx + 16 * c] =
            round_to<T>(p * (dp[r][c] - dr) * scale);
      }
    }
    __syncthreads();
    mm_pb<D>(dSs, Ks, acc);
  }
  store_rows<T, D>(dq, b, h, q0, Sq, acc);
}

// --------------------------------------------------------------- dkv
// grid (ceil(Sk / 64), H, B); one CTA per 64 key rows of one head. The
// tiles are computed transposed (rows = keys): S^T = K.Q^T, dP^T = V.dO^T.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(Bshd q, Bshd k, Bshd v, Bshd dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, Bshd dk, Bshd dv,
                         int H, int Sq, int Sk, int causal, float scale) {
  constexpr int LD = D + 1, NJ = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTile * LD;
  float* Qs = Vs + kTile * LD;
  float* dOs = Qs + kTile * LD;
  float* Ps = dOs + kTile * LD;
  float* dSs = Ps + kTile * kLdP;
  float* lse_s = dSs + kTile * kLdP;
  float* dl_s = lse_s + kTile;
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* qp = head_base<T>(q, b, h);
  const T* dop = head_base<T>(dout, b, h);
  const int64_t row_off = ((int64_t)b * H + h) * Sq;

  load_tile<T, D>(Ks, head_base<T>(k, b, h), k.ss, k0, Sk);
  load_tile<T, D>(Vs, head_base<T>(v, b, h), v.ss, k0, Sk);
  float dka[4][NJ], dva[4][NJ];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dka[r][j] = dva[r][j] = 0.f;
  const int n_qt = (Sq + kTile - 1) / kTile;
  // query tiles wholly before this key tile see none of it; with
  // k0 >= Sq the loop is empty and dk = dv = 0
  const int qt0 = causal ? k0 / kTile : 0;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile<T, D>(Qs, qp, q.ss, q0, Sq);
    load_tile<T, D>(dOs, dop, dout.ss, q0, Sq);
    load_rows(lse_s, lse + row_off, q0, Sq);
    load_rows(dl_s, delta + row_off, q0, Sq);
    __syncthreads();
    float st[4][4], dpt[4][4];
    mm_abt<D>(Ks, Qs, st);
    mm_abt<D>(Vs, dOs, dpt);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = ty * 4 + r, kpos = k0 + row;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = tx + 16 * c, qpos = q0 + col;
        const bool live = qpos < Sq && kpos < Sk && !(causal && kpos > qpos);
        const float p = live ? expf(st[r][c] * scale - lse_s[col]) : 0.f;
        Ps[row * kLdP + col] = round_to<T>(p);
        dSs[row * kLdP + col] = round_to<T>(p * (dpt[r][c] - dl_s[col]) * scale);
      }
    }
    __syncthreads();
    mm_pb<D>(Ps, dOs, dva);
    mm_pb<D>(dSs, Qs, dka);
  }
  store_rows<T, D>(dk, b, h, k0, Sk, dka);
  store_rows<T, D>(dv, b, h, k0, Sk, dva);
}

// ------------------------------------------------------------ launch
struct Problem {
  int B, H, Sq, Sk, causal;
  float scale;
  cudaStream_t stream;
};

template <int D>
constexpr size_t tiles_bytes(int tiles, int scores, int vectors) {
  return ((size_t)tiles * kTile * (D + 1) + (size_t)scores * kTile * kLdP +
          (size_t)vectors * kTile) *
         sizeof(float);
}

template <typename Kernel>
cudaError_t prepare(Kernel kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// 16-byte copies need a 16-byte aligned base and strides that are
// multiples of 8 bf16
bool aligned16(const Bshd& x) {
  return reinterpret_cast<uintptr_t>(x.ptr) % 16 == 0 && x.sb % 8 == 0 &&
         x.ss % 8 == 0 && x.sh % 8 == 0;
}

template <int D>
cudaError_t fwd_mma(const Problem& p, const Bshd& q, const Bshd& k,
                    const Bshd& v, const Bshd& o, float* lse) {
  if (!aligned16(q) || !aligned16(k) || !aligned16(v))
    return cudaErrorMisalignedAddress;
  const size_t smem = fwd_mma_smem<D>();
  auto kern = flash_fwd_mma_kernel<D>;
  cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((p.Sq + kFwdM - 1) / kFwdM, p.H, p.B);
  constexpr int threads = fwd_threads<D>();
  kern<<<grid, threads, smem, p.stream>>>(
      q, k, v, o, lse, p.H, p.Sq, p.Sk, p.causal,
      (float)((double)p.scale * 1.4426950408889634));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t fwd(const Problem& p, const Bshd& q, const Bshd& k, const Bshd& v,
                const Bshd& o, float* lse) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return fwd_mma<D>(p, q, k, v, o, lse);   // tensor cores
  } else {                                   // f32: CUDA-core FMAs
    const size_t smem = tiles_bytes<D>(3, 1, 0);
    auto kern = flash_fwd_kernel<T, D>;
    cudaError_t e = prepare(kern, smem);
    if (e != cudaSuccess) return e;
    dim3 grid((p.Sq + kTile - 1) / kTile, p.H, p.B);
    kern<<<grid, kThreads, smem, p.stream>>>(q, k, v, o, lse, p.H, p.Sq,
                                            p.Sk, p.causal, p.scale);
    return cudaGetLastError();
  }
}

template <typename T, int D>
cudaError_t bwd_dq(const Problem& p, const Bshd& q, const Bshd& k,
                   const Bshd& v, const Bshd& dout, const float* lse,
                   const float* delta, const Bshd& dq) {
  const size_t smem = tiles_bytes<D>(4, 1, 2);
  auto kern = flash_bwd_dq_kernel<T, D>;
  cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((p.Sq + kTile - 1) / kTile, p.H, p.B);
  kern<<<grid, kThreads, smem, p.stream>>>(q, k, v, dout, lse, delta, dq, p.H,
                                          p.Sq, p.Sk, p.causal, p.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dkv(const Problem& p, const Bshd& q, const Bshd& k,
                    const Bshd& v, const Bshd& dout, const float* lse,
                    const float* delta, const Bshd& dk, const Bshd& dv) {
  const size_t smem = tiles_bytes<D>(4, 2, 2);
  auto kern = flash_bwd_dkv_kernel<T, D>;
  cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((p.Sk + kTile - 1) / kTile, p.H, p.B);
  kern<<<grid, kThreads, smem, p.stream>>>(q, k, v, dout, lse, delta, dk, dv,
                                          p.H, p.Sq, p.Sk, p.causal, p.scale);
  return cudaGetLastError();
}

bool valid(int B, int H, int Sq, int Sk) {
  return B >= 1 && B <= 65535 && H >= 1 && H <= 65535 && Sq >= 1 && Sk >= 1;
}

// dtype code 0 = float32, 1 = bfloat16; head_dim 32, 64 or 128
#define FLASH_DISPATCH(CALL)                                        \
  switch (dtype * 1000 + D) {                                       \
    case 32: return (int)CALL(float, 32);                           \
    case 64: return (int)CALL(float, 64);                           \
    case 128: return (int)CALL(float, 128);                         \
    case 1032: return (int)CALL(__nv_bfloat16, 32);                 \
    case 1064: return (int)CALL(__nv_bfloat16, 64);                 \
    case 1128: return (int)CALL(__nv_bfloat16, 128);                \
  }                                                                 \
  return (int)cudaErrorInvalidValue;

}  // namespace

// Pointers are device pointers; the Bshd structs themselves are host
// memory (passed by pointer, copied into the kernel's arguments). lse
// and delta are contiguous (B, H, Sq) f32. Each launcher enqueues one
// kernel on `stream` and returns cudaGetLastError() (0 on success); the
// caller raises on anything else.
extern "C" int flash_fwd_launch(int dtype, const Bshd* q, const Bshd* k,
                                const Bshd* v, const Bshd* o, float* lse,
                                int B, int H, int Sq, int Sk, int D,
                                int causal, float scale, void* stream) {
  if (!valid(B, H, Sq, Sk)) return (int)cudaErrorInvalidValue;
  const Problem p{B, H, Sq, Sk, causal, scale,
                  static_cast<cudaStream_t>(stream)};
#define CALL(T, DD) fwd<T, DD>(p, *q, *k, *v, *o, lse)
  FLASH_DISPATCH(CALL)
#undef CALL
}

extern "C" int flash_bwd_dq_launch(int dtype, const Bshd* q, const Bshd* k,
                                   const Bshd* v, const Bshd* dout,
                                   const float* lse, const float* delta,
                                   const Bshd* dq, int B, int H, int Sq,
                                   int Sk, int D, int causal, float scale,
                                   void* stream) {
  if (!valid(B, H, Sq, Sk)) return (int)cudaErrorInvalidValue;
  const Problem p{B, H, Sq, Sk, causal, scale,
                  static_cast<cudaStream_t>(stream)};
#define CALL(T, DD) bwd_dq<T, DD>(p, *q, *k, *v, *dout, lse, delta, *dq)
  FLASH_DISPATCH(CALL)
#undef CALL
}

extern "C" int flash_bwd_dkv_launch(int dtype, const Bshd* q, const Bshd* k,
                                    const Bshd* v, const Bshd* dout,
                                    const float* lse, const float* delta,
                                    const Bshd* dk, const Bshd* dv, int B,
                                    int H, int Sq, int Sk, int D, int causal,
                                    float scale, void* stream) {
  if (!valid(B, H, Sq, Sk)) return (int)cudaErrorInvalidValue;
  const Problem p{B, H, Sq, Sk, causal, scale,
                  static_cast<cudaStream_t>(stream)};
#define CALL(T, DD) \
  bwd_dkv<T, DD>(p, *q, *k, *v, *dout, lse, delta, *dk, *dv)
  FLASH_DISPATCH(CALL)
#undef CALL
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
