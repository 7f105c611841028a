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
// Head dims 32, 64, 128 and 256 are instantiated; the wrapper zero-pads
// any other d up to the next of them (exact: zero lanes add 0 to every
// dot) and keeps the scale of the unpadded d.
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
// In bf16 at d <= 128 all three run on the tensor cores (mma.sync
// m16n8k16, bf16 in, f32 sums; ldmatrix; a two-stage cp.async ring of
// padded bf16 rows, the next tile in flight while this one is used).
// The forward (flash_fwd_mma_kernel) has the shape of FlashAttention-2:
// a CTA owns 128 query rows of one (batch, head); its Q rows go once
// through shared memory into mma A fragments that stay in registers for
// the whole key loop; K and V tiles of 64 keys stream through the ring.
// The online softmax works on the accumulator fragments, a row's max and
// sum reducing over the 4 lanes of a quad; p, rounded to bf16 in
// registers, is the A operand of p.v as it stands, because the C layout
// of two n8 tiles is the A layout of one k16 step — p never touches
// shared memory. The scale is applied to the f32 dot, folded with
// log2(e) so that every exponential is one exp2f of one fma: p =
// exp2(s * scale * log2(e) - m), m the running max in log2 units (lse
// is converted back). This exp2f for expf moves results by rounding
// only, far inside the bf16 tolerance of the checks. l sums the
// unrounded p; o = acc / l is rounded to bf16.
//
// The backward keeps the TPU's two kernels (no f32 atomics, so dq's
// summation order is fixed): flash_bwd_dq_mma_kernel owns 64 query rows
// (4 warps, 16 rows a warp) and streams K and V; flash_bwd_dkv_mma_kernel
// owns 64 keys and streams Q, dO and their lse and delta rows. At ~200
// registers a thread two such CTAs share an SM and their barriers
// interleave: on an H100 that beat one CTA of 8 warps owning 128 rows,
// which streams half the bytes (tools/torch_flash_time.py, run on a
// copy with kBwdRows = 128 and kBwdThreads = 256). Both compute s and
// dp = do.v^T (transposed in dkv: S^T = K.Q^T, dP^T = V.dO^T) as mma
// products whose A operand is the owned rows' fragments (held in
// registers at d <= 64, reloaded from shared memory at d = 128, whose
// f32 accumulators leave no room), then p = exp2(s * scale * log2(e) -
// lse * log2(e)) and ds on the accumulator fragments, and feed p and ds,
// packed to bf16 in registers, as A operands into dq += ds.K and
// dv += p^T.dO, dk += ds^T.Q, the streamed operand as B through
// ldmatrix.trans. lse and delta are per query: per row in dq (two rows a
// thread, read once), per column in dkv (staged in shared memory with
// each tile).
//
// The f32 kernels, and both types at d = 256, run on the CUDA cores:
// one CTA of 256 threads owns a TL-row tile (queries for forward and
// dq, keys for dkv; TL = 64, or 32 at d = 256 so that four f32 tiles
// fit the 227 KB of shared memory) and loops over the other side's
// TL-row tiles, so the TPU kernel's sequential grid axis becomes a loop
// inside the block and no state crosses blocks. Tiles are staged in
// shared memory as f32 (rows padded by one word so neither the
// row-broadcast nor the column reads conflict on banks); each thread
// holds a TL/16 x TL/16 block of the score tile and a TL/16 x d/16
// block of the output in registers; row reductions are shuffles within
// 16 lanes. Their dots run as f32 FMAs under the f32 peak of 67
// TFLOP/s — for f32 inputs that is the contract (exact f32, no TF32).
//
// In every kernel, causal tiles wholly above the diagonal are never
// loaded (the forward and dq loops stop at the diagonal tile, dkv starts
// its loop there), inside the diagonal tile the mask makes p exactly 0,
// and tails (s not a multiple of the tile) are masked: query rows at or
// past Sq and keys at or past Sk give p = 0, and lse and delta are never
// read past Sq. The wrapper hands the bf16 tensor-core kernels rows that
// start 16-byte aligned (a view that is not is copied); their launchers
// refuse anything else.
//
// What is left (later work): wgmma from shared memory and TMA loads in
// place of mma.sync, ldmatrix and cp.async; a deeper ring; dq fused into
// the dkv pass (f32 atomics on dq); tensor cores at d = 256.

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

constexpr int kThreads = 256;   // 16 x 16: each owns TL/16 rows of a tile
constexpr float kLog2e = 1.4426950408889634f;

// rows of a CUDA-core tile: 64, or 32 at d = 256
template <int D>
__host__ __device__ constexpr int core_tile() { return D > 128 ? 32 : 64; }

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

// rows [r0, r0 + TL) of one (batch, head) slice into a [TL][D + 1] f32
// tile; rows at or past n are zero
template <typename T, int D, int TL>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int64_t ss, int r0, int n) {
#pragma unroll 4
  for (int i = threadIdx.x; i < TL * D; i += kThreads) {
    const int r = i / D, c = i % D, row = r0 + r;
    dst[r * (D + 1) + c] = row < n ? to_f32(src[(int64_t)row * ss + c]) : 0.f;
  }
}

// TL entries of a per-row f32 vector (lse or delta); zero past n
template <int TL>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src,
                                          int r0, int n) {
  if (threadIdx.x < TL) {
    const int row = r0 + threadIdx.x;
    dst[threadIdx.x] = row < n ? src[row] : 0.f;
  }
}

// s[r][c] = sum_d A[R ty + r][d] * B[tx + 16c][d]  (A.B^T of two tiles,
// R = TL / 16)
template <int D, int TL>
__device__ __forceinline__ void mm_abt(const float* A, const float* B,
                                       float (&s)[TL / 16][TL / 16]) {
  constexpr int R = TL / 16;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* a = A + ty * R * (D + 1);
  const float* b = B + tx * (D + 1);
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < R; ++c) s[r][c] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[R], bv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) av[r] = a[r * (D + 1) + d];
#pragma unroll
    for (int c = 0; c < R; ++c) bv[c] = b[c * 16 * (D + 1) + d];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < R; ++c) s[r][c] = fmaf(av[r], bv[c], s[r][c]);
  }
}

// acc[r][j] += sum_k P[R ty + r][k] * B[k][tx + 16j]  (P.B, P a TL x TL
// score tile with rows of TL + 1, B a [TL][D + 1] tile)
template <int D, int TL>
__device__ __forceinline__ void mm_pb(const float* P, const float* B,
                                      float (&acc)[TL / 16][D / 16]) {
  constexpr int R = TL / 16, LP = TL + 1;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* p = P + ty * R * LP;
  const float* b = B + tx;
#pragma unroll 4
  for (int k = 0; k < TL; ++k) {
    float pv[R], bv[D / 16];
#pragma unroll
    for (int r = 0; r < R; ++r) pv[r] = p[r * LP + k];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) bv[j] = b[k * (D + 1) + 16 * j];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[r][j] = fmaf(pv[r], bv[j], acc[r][j]);
  }
}

// rows of a [TL/16][D/16] register block back to a (b, s, h, d) operand
template <typename T, int D, int TL>
__device__ __forceinline__ void store_rows(const Bshd& x, int b, int h, int r0,
                                           int n,
                                           const float (&acc)[TL / 16][D / 16]) {
  constexpr int R = TL / 16;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  T* base = static_cast<T*>(x.ptr) + (int64_t)b * x.sb + (int64_t)h * x.sh;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = r0 + ty * R + r;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      base[(int64_t)row * x.ss + tx + 16 * j] = from_f32<T>(acc[r][j]);
    }
  }
}

// ------------------------------------------------------------ forward
// grid (ceil(Sq / TL), H, B); one CTA per TL query rows of one head
template <typename T, int D, int TL>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(Bshd q, Bshd k, Bshd v, Bshd o, float* __restrict__ lse,
                     int H, int Sq, int Sk, int causal, float scale) {
  constexpr int LD = D + 1, NJ = D / 16, R = TL / 16, LP = TL + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + TL * LD;
  float* Vs = Ks + TL * LD;
  float* Ps = Vs + TL * LD;
  const int q0 = blockIdx.x * TL, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* kp = head_base<T>(k, b, h);
  const T* vp = head_base<T>(v, b, h);

  load_tile<T, D, TL>(Qs, head_base<T>(q, b, h), q.ss, q0, Sq);
  float m[R], l[R], acc[R][NJ];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[r][j] = 0.f;
  }
  int n_kt = (Sk + TL - 1) / TL;
  if (causal)  // tiles wholly above the diagonal contribute nothing
    n_kt = min(n_kt, (min(q0 + TL, Sq) - 1) / TL + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * TL;
    __syncthreads();  // every thread is done with the previous K, V, P
    load_tile<T, D, TL>(Ks, kp, k.ss, k0, Sk);
    load_tile<T, D, TL>(Vs, vp, v.ss, k0, Sk);
    __syncthreads();
    float s[R][R];
    mm_abt<D, TL>(Qs, Ks, s);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int qpos = q0 + ty * R + r;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < R; ++c) {
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
      for (int c = 0; c < R; ++c) {
        const float p = expf(s[r][c] - m_ref);
        psum += p;
        Ps[(ty * R + r) * LP + tx + 16 * c] = round_to<T>(p);
      }
      l[r] = l[r] * alpha + row_sum(psum);
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[r][j] *= alpha;
    }
    __syncthreads();
    mm_pb<D, TL>(Ps, Vs, acc);
  }

#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[r][j] = acc[r][j] / l[r];
  store_rows<T, D, TL>(o, b, h, q0, Sq, acc);
  if (tx == 0) {
    float* lrow = lse + ((int64_t)b * H + h) * Sq;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int qpos = q0 + ty * R + r;
      if (qpos < Sq) lrow[qpos] = m[r] + logf(l[r]);
    }
  }
}

// ----------------------------------------- bf16 tensor-core staging
// rows [first, first + R) of a (batch, head) slice of D bf16 into a
// [R][D + 8] shared tile (the padding keeps ldmatrix conflict-free),
// 16-byte cp.async copies spread over NT threads; rows at or past n are
// zero filled and their source is never read
template <int D, int NT>
__device__ __forceinline__ void stage_rows(tc::bf16* dst, const tc::bf16* src,
                                           int64_t ss, int first, int R,
                                           int n) {
  constexpr int LD = D + 8, CH = D / 8;  // CH 16-byte chunks a row
  for (int i = threadIdx.x; i < R * CH; i += NT) {
    const int r = i / CH, c = i % CH, row = first + r;
    tc::cp_async16(dst + r * LD + c * 8,
                   src + (int64_t)min(row, n - 1) * ss + c * 8,
                   row < n ? 16 : 0);
  }
}

// entries [first, first + R) of a per-query f32 vector (lse or delta)
// into shared memory; zero past n, never read there
template <int NT>
__device__ __forceinline__ void stage_vec(float* dst, const float* src,
                                          int first, int R, int n) {
  for (int i = threadIdx.x; i < R; i += NT) {
    const int row = first + i;
    tc::cp_async4(dst + i, src + min(row, n - 1), row < n ? 4 : 0);
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

  int n_kt = (Sk + kFwdN - 1) / kFwdN;
  if (causal)  // tiles wholly above the diagonal are never loaded
    n_kt = min(n_kt, (min(q0 + kFwdM, Sq) - 1) / kFwdN + 1);
  stage_rows<D, NT>(Qs, head_base<bf16>(q, b, h), q.ss, q0, kFwdM, Sq);
  stage_rows<D, NT>(Ks, kp, k.ss, 0, kFwdN, Sk);
  stage_rows<D, NT>(Vs, vp, v.ss, 0, kFwdN, Sk);
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
      stage_rows<D, NT>(Ks + (buf ^ 1) * kFwdN * LD, kp, k.ss, k0 + kFwdN,
                        kFwdN, Sk);
      stage_rows<D, NT>(Vs + (buf ^ 1) * kFwdN * LD, vp, v.ss, k0 + kFwdN,
                        kFwdN, Sk);
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
// grid (ceil(Sq / TL), H, B); one CTA per TL query rows of one head
template <typename T, int D, int TL>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(Bshd q, Bshd k, Bshd v, Bshd dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, Bshd dq, int H,
                        int Sq, int Sk, int causal, float scale) {
  constexpr int LD = D + 1, NJ = D / 16, R = TL / 16, LP = TL + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + TL * LD;
  float* Ks = dOs + TL * LD;
  float* Vs = Ks + TL * LD;
  float* dSs = Vs + TL * LD;
  float* lse_s = dSs + TL * LP;
  float* dl_s = lse_s + TL;
  const int q0 = blockIdx.x * TL, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* kp = head_base<T>(k, b, h);
  const T* vp = head_base<T>(v, b, h);
  const int64_t row_off = ((int64_t)b * H + h) * Sq;

  load_tile<T, D, TL>(Qs, head_base<T>(q, b, h), q.ss, q0, Sq);
  load_tile<T, D, TL>(dOs, head_base<T>(dout, b, h), dout.ss, q0, Sq);
  load_rows<TL>(lse_s, lse + row_off, q0, Sq);
  load_rows<TL>(dl_s, delta + row_off, q0, Sq);
  float acc[R][NJ];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[r][j] = 0.f;
  int n_kt = (Sk + TL - 1) / TL;
  if (causal) n_kt = min(n_kt, (min(q0 + TL, Sq) - 1) / TL + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * TL;
    __syncthreads();
    load_tile<T, D, TL>(Ks, kp, k.ss, k0, Sk);
    load_tile<T, D, TL>(Vs, vp, v.ss, k0, Sk);
    __syncthreads();
    float s[R][R], dp[R][R];
    mm_abt<D, TL>(Qs, Ks, s);
    mm_abt<D, TL>(dOs, Vs, dp);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = ty * R + r, qpos = q0 + row;
      const float lr = lse_s[row], dr = dl_s[row];
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const int kpos = k0 + tx + 16 * c;
        const bool live = qpos < Sq && kpos < Sk && !(causal && kpos > qpos);
        const float p = live ? expf(s[r][c] * scale - lr) : 0.f;
        dSs[row * LP + tx + 16 * c] =
            round_to<T>(p * (dp[r][c] - dr) * scale);
      }
    }
    __syncthreads();
    mm_pb<D, TL>(dSs, Ks, acc);
  }
  store_rows<T, D, TL>(dq, b, h, q0, Sq, acc);
}

// --------------------------------------------------------------- dkv
// grid (ceil(Sk / TL), H, B); one CTA per TL key rows of one head. The
// tiles are computed transposed (rows = keys): S^T = K.Q^T, dP^T = V.dO^T.
template <typename T, int D, int TL>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(Bshd q, Bshd k, Bshd v, Bshd dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, Bshd dk, Bshd dv,
                         int H, int Sq, int Sk, int causal, float scale) {
  constexpr int LD = D + 1, NJ = D / 16, R = TL / 16, LP = TL + 1;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + TL * LD;
  float* Qs = Vs + TL * LD;
  float* dOs = Qs + TL * LD;
  float* Ps = dOs + TL * LD;
  float* dSs = Ps + TL * LP;
  float* lse_s = dSs + TL * LP;
  float* dl_s = lse_s + TL;
  const int k0 = blockIdx.x * TL, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* qp = head_base<T>(q, b, h);
  const T* dop = head_base<T>(dout, b, h);
  const int64_t row_off = ((int64_t)b * H + h) * Sq;

  load_tile<T, D, TL>(Ks, head_base<T>(k, b, h), k.ss, k0, Sk);
  load_tile<T, D, TL>(Vs, head_base<T>(v, b, h), v.ss, k0, Sk);
  float dka[R][NJ], dva[R][NJ];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dka[r][j] = dva[r][j] = 0.f;
  const int n_qt = (Sq + TL - 1) / TL;
  // query tiles wholly before this key tile see none of it; with
  // k0 >= Sq the loop is empty and dk = dv = 0
  const int qt0 = causal ? k0 / TL : 0;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * TL;
    __syncthreads();
    load_tile<T, D, TL>(Qs, qp, q.ss, q0, Sq);
    load_tile<T, D, TL>(dOs, dop, dout.ss, q0, Sq);
    load_rows<TL>(lse_s, lse + row_off, q0, Sq);
    load_rows<TL>(dl_s, delta + row_off, q0, Sq);
    __syncthreads();
    float st[R][R], dpt[R][R];
    mm_abt<D, TL>(Ks, Qs, st);
    mm_abt<D, TL>(Vs, dOs, dpt);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = ty * R + r, kpos = k0 + row;
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const int col = tx + 16 * c, qpos = q0 + col;
        const bool live = qpos < Sq && kpos < Sk && !(causal && kpos > qpos);
        const float p = live ? expf(st[r][c] * scale - lse_s[col]) : 0.f;
        Ps[row * LP + col] = round_to<T>(p);
        dSs[row * LP + col] = round_to<T>(p * (dpt[r][c] - dl_s[col]) * scale);
      }
    }
    __syncthreads();
    mm_pb<D, TL>(Ps, dOs, dva);
    mm_pb<D, TL>(dSs, Qs, dka);
  }
  store_rows<T, D, TL>(dk, b, h, k0, Sk, dka);
  store_rows<T, D, TL>(dv, b, h, k0, Sk, dva);
}

// ------------------------------------------------ backward, bf16 (mma)
// Both kernels: 4 warps, a warp owning 16 rows (queries in dq, keys in
// dkv), 64 owned rows a CTA; the other side streams in BT-row tiles
// through a two-stage ring. BT = 64, or 32 at d = 128 to keep the f32
// score tiles in registers beside the wider accumulators. At d <= 64 a
// warp's owned-row A fragments stay in registers for the whole loop; at
// d = 128 they are reloaded from shared memory at each use.
constexpr int kBwdRows = 64;
constexpr int kBwdThreads = 128;

template <int D>
__host__ __device__ constexpr int bwd_tile() { return D <= 64 ? 64 : 32; }
template <int D>
__host__ __device__ constexpr bool bwd_regs() { return D <= 64; }
// the owned rows' two operands, then 2 stages of the two streamed ones;
// dkv adds 2 stages of the streamed queries' lse and delta
template <int D>
constexpr size_t bwd_mma_smem(bool dkv) {
  return (size_t)(2 * kBwdRows + 4 * bwd_tile<D>()) * (D + 8) *
             sizeof(__nv_bfloat16) +
         (dkv ? 4 * bwd_tile<D>() * sizeof(float) : 0);
}

// grid (ceil(Sq / 64), H, B)
template <int D>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_dq_mma_kernel(Bshd q, Bshd k, Bshd v, Bshd dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta, Bshd dq, int H,
                            int Sq, int Sk, int causal, float scale,
                            float scale_log2) {
  using tc::bf16;
  constexpr int BN = bwd_tile<D>();   // keys of a K/V tile
  constexpr bool REG = bwd_regs<D>();
  constexpr int LD = D + 8, KD = D / 16, ND = D / 8, NS = BN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + kBwdRows * LD;
  bf16* Ks = dOs + kBwdRows * LD;     // [2][BN][LD]
  bf16* Vs = Ks + 2 * BN * LD;        // [2][BN][LD]
  const int q0 = blockIdx.x * kBwdRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = q0 + warp * 16;      // this warp's first query row
  const bf16* kp = head_base<bf16>(k, b, h);
  const bf16* vp = head_base<bf16>(v, b, h);

  int n_kt = (Sk + BN - 1) / BN;
  if (causal)  // tiles wholly above the diagonal are never loaded
    n_kt = min(n_kt, (min(q0 + kBwdRows, Sq) - 1) / BN + 1);
  stage_rows<D, kBwdThreads>(Qs, head_base<bf16>(q, b, h), q.ss, q0,
                             kBwdRows, Sq);
  stage_rows<D, kBwdThreads>(dOs, head_base<bf16>(dout, b, h), dout.ss, q0,
                             kBwdRows, Sq);
  stage_rows<D, kBwdThreads>(Ks, kp, k.ss, 0, BN, Sk);
  stage_rows<D, kBwdThreads>(Vs, vp, v.ss, 0, BN, Sk);
  tc::cp_async_commit();

  // lse (in log2 units) and delta of this thread's rows gid and gid + 8
  const int64_t row_off = ((int64_t)b * H + h) * Sq;
  float lse2[2], dl[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + gid + 8 * hr;
    lse2[hr] = row < Sq ? lse[row_off + row] * kLog2e : 0.f;
    dl[hr] = row < Sq ? delta[row_off + row] : 0.f;
  }
  // where this lane points ldmatrix at the warp's Q and dO rows
  const int own = (warp * 16 + tc::lane_mk_row(lane)) * LD +
                  tc::lane_mk_col(lane);
  uint32_t qf[REG ? KD : 1][4], df[REG ? KD : 1][4];
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BN, buf = kt & 1;
    if (kt + 1 < n_kt) {  // the next K/V tile streams in behind this one
      stage_rows<D, kBwdThreads>(Ks + (buf ^ 1) * BN * LD, kp, k.ss,
                                 k0 + BN, BN, Sk);
      stage_rows<D, kBwdThreads>(Vs + (buf ^ 1) * BN * LD, vp, v.ss,
                                 k0 + BN, BN, Sk);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // everything but the newest group landed
    __syncthreads();
    if constexpr (REG) {
      if (kt == 0) {
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
          tc::ldsm_x4(qf[kd], Qs + own + kd * 16);
          tc::ldsm_x4(df[kd], dOs + own + kd * 16);
        }
      }
    }
    // a warp whose rows are past Sq, or (causal) all above this tile's
    // first key, has nothing to add from it
    const bool live = r0 < Sq && !(causal && k0 > r0 + 15);
    if (live) {
      const bf16* Kt = Ks + buf * BN * LD;
      const bf16* Vt = Vs + buf * BN * LD;
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      // s = q.k^T and dp = do.v^T: K and V rows are B without .trans
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t qa[4], da[4];
        if constexpr (REG) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            qa[e] = qf[kd][e];
            da[e] = df[kd][e];
          }
        } else {
          tc::ldsm_x4(qa, Qs + own + kd * 16);
          tc::ldsm_x4(da, dOs + own + kd * 16);
        }
#pragma unroll
        for (int p = 0; p < NS / 2; ++p) {
          const int off = (p * 16 + tc::lane_km_row(lane)) * LD + kd * 16 +
                          tc::lane_km_col(lane);
          uint32_t kb[4], vb[4];
          tc::ldsm_x4(kb, Kt + off);
          tc::ldsm_x4(vb, Vt + off);
          tc::mma16816(s[2 * p], qa, kb[0], kb[1]);
          tc::mma16816(s[2 * p + 1], qa, kb[2], kb[3]);
          tc::mma16816(dp[2 * p], da, vb[0], vb[1]);
          tc::mma16816(dp[2 * p + 1], da, vb[2], vb[3]);
        }
      }
      // p = exp(s * scale - lse), ds = p * (dp - delta) * scale, in
      // place of s; masked pairs and rows past Sq give p = 0
      const bool masked =
          k0 + BN > Sk || r0 + 16 > Sq || (causal && k0 + BN - 1 > r0);
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1;
          float p = exp2f(fmaf(s[j][e], scale_log2, -lse2[hr]));
          if (masked) {
            const int qpos = r0 + gid + 8 * hr;
            const int kpos = k0 + j * 8 + 2 * tig + (e & 1);
            if (qpos >= Sq || kpos >= Sk || (causal && kpos > qpos)) p = 0.f;
          }
          s[j][e] = p * (dp[j][e] - dl[hr]) * scale;
        }
      // dq += ds.K: ds rounded to bf16 in registers is the A operand,
      // K the B operand through ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        uint32_t a[4];
        a[0] = tc::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        a[1] = tc::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        a[2] = tc::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a[3] = tc::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int p = 0; p < ND / 2; ++p) {
          uint32_t kb[4];
          tc::ldsm_x4_t(kb, Kt + (kk * 16 + tc::lane_mk_row(lane)) * LD +
                                p * 16 + tc::lane_mk_col(lane));
          tc::mma16816(acc[2 * p], a, kb[0], kb[1]);
          tc::mma16816(acc[2 * p + 1], a, kb[2], kb[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with buf before it is refilled
  }

  bf16* out = static_cast<bf16*>(dq.ptr) + (int64_t)b * dq.sb +
              (int64_t)h * dq.sh;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + gid + 8 * hr;
    if (row >= Sq) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)row * dq.ss + j * 8 +
                                         2 * tig) =
          __floats2bfloat162_rn(acc[j][2 * hr], acc[j][2 * hr + 1]);
  }
}

// grid (ceil(Sk / 64), H, B). C fragments are transposed tiles (rows =
// keys, columns = queries), so lse and delta index their columns.
template <int D>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_dkv_mma_kernel(Bshd q, Bshd k, Bshd v, Bshd dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta, Bshd dk,
                             Bshd dv, int H, int Sq, int Sk, int causal,
                             float scale, float scale_log2) {
  using tc::bf16;
  constexpr int BM = bwd_tile<D>();   // queries of a Q/dO tile
  constexpr bool REG = bwd_regs<D>();
  constexpr int LD = D + 8, KD = D / 16, ND = D / 8, NQ = BM / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kBwdRows * LD;
  bf16* Qs = Vs + kBwdRows * LD;      // [2][BM][LD]
  bf16* dOs = Qs + 2 * BM * LD;       // [2][BM][LD]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * BM * LD);  // [2][BM] lse
  float* Ds = Ls + 2 * BM;                                  // [2][BM] delta
  const int k0 = blockIdx.x * kBwdRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int kr0 = k0 + warp * 16;     // this warp's first key row
  const bf16* qp = head_base<bf16>(q, b, h);
  const bf16* dop = head_base<bf16>(dout, b, h);
  const int64_t row_off = ((int64_t)b * H + h) * Sq;

  const int n_qt = (Sq + BM - 1) / BM;
  // query tiles wholly before this CTA's first key see none of its keys;
  // with k0 >= Sq the loop is empty and dk = dv = 0
  const int qt0 = causal ? k0 / BM : 0;
  auto stage_q = [&](int qt, int stage) {
    const int first = qt * BM;
    stage_rows<D, kBwdThreads>(Qs + stage * BM * LD, qp, q.ss, first, BM,
                               Sq);
    stage_rows<D, kBwdThreads>(dOs + stage * BM * LD, dop, dout.ss, first,
                               BM, Sq);
    stage_vec<kBwdThreads>(Ls + stage * BM, lse + row_off, first, BM, Sq);
    stage_vec<kBwdThreads>(Ds + stage * BM, delta + row_off, first, BM, Sq);
  };
  stage_rows<D, kBwdThreads>(Ks, head_base<bf16>(k, b, h), k.ss, k0,
                             kBwdRows, Sk);
  stage_rows<D, kBwdThreads>(Vs, head_base<bf16>(v, b, h), v.ss, k0,
                             kBwdRows, Sk);
  if (qt0 < n_qt) stage_q(qt0, 0);
  tc::cp_async_commit();

  // where this lane points ldmatrix at the warp's K and V rows
  const int own = (warp * 16 + tc::lane_mk_row(lane)) * LD +
                  tc::lane_mk_col(lane);
  uint32_t kf[REG ? KD : 1][4], vf[REG ? KD : 1][4];
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int i = qt - qt0, buf = i & 1, q0 = qt * BM;
    if (qt + 1 < n_qt) stage_q(qt + 1, buf ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // everything but the newest group landed
    __syncthreads();
    if constexpr (REG) {
      if (i == 0) {
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
          tc::ldsm_x4(kf[kd], Ks + own + kd * 16);
          tc::ldsm_x4(vf[kd], Vs + own + kd * 16);
        }
      }
    }
    // a warp whose keys are past Sk, or (causal) all after this tile's
    // last query, has nothing to add from it
    const bool live = kr0 < Sk && !(causal && q0 + BM - 1 < kr0);
    if (live) {
      const bf16* Qt = Qs + buf * BM * LD;
      const bf16* dOt = dOs + buf * BM * LD;
      const float* Lt = Ls + buf * BM;
      const float* Dt = Ds + buf * BM;
      float st[NQ][4], dpt[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
      // S^T = k.q^T and dP^T = v.do^T: Q and dO rows are B without .trans
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t ka[4], va[4];
        if constexpr (REG) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ka[e] = kf[kd][e];
            va[e] = vf[kd][e];
          }
        } else {
          tc::ldsm_x4(ka, Ks + own + kd * 16);
          tc::ldsm_x4(va, Vs + own + kd * 16);
        }
#pragma unroll
        for (int p = 0; p < NQ / 2; ++p) {
          const int off = (p * 16 + tc::lane_km_row(lane)) * LD + kd * 16 +
                          tc::lane_km_col(lane);
          uint32_t qb[4], db[4];
          tc::ldsm_x4(qb, Qt + off);
          tc::ldsm_x4(db, dOt + off);
          tc::mma16816(st[2 * p], ka, qb[0], qb[1]);
          tc::mma16816(st[2 * p + 1], ka, qb[2], qb[3]);
          tc::mma16816(dpt[2 * p], va, db[0], db[1]);
          tc::mma16816(dpt[2 * p + 1], va, db[2], db[3]);
        }
      }
      // p^T in place of S^T, ds^T in place of dP^T; lse and delta of
      // the columns 2 tig and 2 tig + 1 of each n8 tile
      const bool masked =
          q0 + BM > Sq || kr0 + 16 > Sk || (causal && kr0 + 15 > q0);
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = j * 8 + 2 * tig + c;
          const float l2 = Lt[col] * kLog2e, dl = Dt[col];
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int e = 2 * hr + c;
            float p = exp2f(fmaf(st[j][e], scale_log2, -l2));
            if (masked) {
              const int qpos = q0 + col, kpos = kr0 + gid + 8 * hr;
              if (qpos >= Sq || kpos >= Sk || (causal && kpos > qpos))
                p = 0.f;
            }
            dpt[j][e] = p * (dpt[j][e] - dl) * scale;
            st[j][e] = p;
          }
        }
      // dv += p^T.dO, dk += ds^T.Q: p^T and ds^T rounded to bf16 in
      // registers are the A operands, dO and Q the B operands through
      // ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
        uint32_t pa[4], sa[4];
        pa[0] = tc::pack_bf16(st[2 * kk][0], st[2 * kk][1]);
        pa[1] = tc::pack_bf16(st[2 * kk][2], st[2 * kk][3]);
        pa[2] = tc::pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]);
        pa[3] = tc::pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3]);
        sa[0] = tc::pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]);
        sa[1] = tc::pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]);
        sa[2] = tc::pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]);
        sa[3] = tc::pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]);
#pragma unroll
        for (int p = 0; p < ND / 2; ++p) {
          const int off = (kk * 16 + tc::lane_mk_row(lane)) * LD + p * 16 +
                          tc::lane_mk_col(lane);
          uint32_t db[4], qb[4];
          tc::ldsm_x4_t(db, dOt + off);
          tc::mma16816(dva[2 * p], pa, db[0], db[1]);
          tc::mma16816(dva[2 * p + 1], pa, db[2], db[3]);
          tc::ldsm_x4_t(qb, Qt + off);
          tc::mma16816(dka[2 * p], sa, qb[0], qb[1]);
          tc::mma16816(dka[2 * p + 1], sa, qb[2], qb[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with buf before it is refilled
  }
  tc::cp_async_wait<0>();  // an empty loop leaves the K/V copies in flight

  auto store = [&](const Bshd& x, const float (&acc)[ND][4]) {
    bf16* out = static_cast<bf16*>(x.ptr) + (int64_t)b * x.sb +
                (int64_t)h * x.sh;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = kr0 + gid + 8 * hr;
      if (row >= Sk) continue;
#pragma unroll
      for (int j = 0; j < ND; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)row * x.ss +
                                           j * 8 + 2 * tig) =
            __floats2bfloat162_rn(acc[j][2 * hr], acc[j][2 * hr + 1]);
    }
  };
  store(dk, dka);
  store(dv, dva);
}

// ------------------------------------------------------------ launch
struct Problem {
  int B, H, Sq, Sk, causal;
  float scale;
  cudaStream_t stream;
};

template <int D, int TL>
constexpr size_t tiles_bytes(int tiles, int scores, int vectors) {
  return ((size_t)tiles * TL * (D + 1) + (size_t)scores * TL * (TL + 1) +
          (size_t)vectors * TL) *
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

float log2_scale(float scale) {
  return (float)((double)scale * 1.4426950408889634);
}

// bf16 at d <= 128 takes the tensor-core kernels
template <typename T, int D>
constexpr bool use_mma() {
  return std::is_same_v<T, __nv_bfloat16> && D <= 128;
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
  kern<<<grid, threads, smem, p.stream>>>(q, k, v, o, lse, p.H, p.Sq, p.Sk,
                                          p.causal, log2_scale(p.scale));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t fwd(const Problem& p, const Bshd& q, const Bshd& k, const Bshd& v,
                const Bshd& o, float* lse) {
  if constexpr (use_mma<T, D>()) {
    return fwd_mma<D>(p, q, k, v, o, lse);   // tensor cores
  } else {                                   // CUDA-core FMAs
    constexpr int TL = core_tile<D>();
    const size_t smem = tiles_bytes<D, TL>(3, 1, 0);
    auto kern = flash_fwd_kernel<T, D, TL>;
    cudaError_t e = prepare(kern, smem);
    if (e != cudaSuccess) return e;
    dim3 grid((p.Sq + TL - 1) / TL, p.H, p.B);
    kern<<<grid, kThreads, smem, p.stream>>>(q, k, v, o, lse, p.H, p.Sq,
                                            p.Sk, p.causal, p.scale);
    return cudaGetLastError();
  }
}

template <typename T, int D>
cudaError_t bwd_dq(const Problem& p, const Bshd& q, const Bshd& k,
                   const Bshd& v, const Bshd& dout, const float* lse,
                   const float* delta, const Bshd& dq) {
  if constexpr (use_mma<T, D>()) {           // tensor cores
    if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout))
      return cudaErrorMisalignedAddress;
    const size_t smem = bwd_mma_smem<D>(false);
    auto kern = flash_bwd_dq_mma_kernel<D>;
    cudaError_t e = prepare(kern, smem);
    if (e != cudaSuccess) return e;
    dim3 grid((p.Sq + kBwdRows - 1) / kBwdRows, p.H, p.B);
    kern<<<grid, kBwdThreads, smem, p.stream>>>(
        q, k, v, dout, lse, delta, dq, p.H, p.Sq, p.Sk, p.causal, p.scale,
        log2_scale(p.scale));
    return cudaGetLastError();
  } else {                                   // CUDA-core FMAs
    constexpr int TL = core_tile<D>();
    const size_t smem = tiles_bytes<D, TL>(4, 1, 2);
    auto kern = flash_bwd_dq_kernel<T, D, TL>;
    cudaError_t e = prepare(kern, smem);
    if (e != cudaSuccess) return e;
    dim3 grid((p.Sq + TL - 1) / TL, p.H, p.B);
    kern<<<grid, kThreads, smem, p.stream>>>(q, k, v, dout, lse, delta, dq,
                                            p.H, p.Sq, p.Sk, p.causal,
                                            p.scale);
    return cudaGetLastError();
  }
}

template <typename T, int D>
cudaError_t bwd_dkv(const Problem& p, const Bshd& q, const Bshd& k,
                    const Bshd& v, const Bshd& dout, const float* lse,
                    const float* delta, const Bshd& dk, const Bshd& dv) {
  if constexpr (use_mma<T, D>()) {           // tensor cores
    if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout))
      return cudaErrorMisalignedAddress;
    const size_t smem = bwd_mma_smem<D>(true);
    auto kern = flash_bwd_dkv_mma_kernel<D>;
    cudaError_t e = prepare(kern, smem);
    if (e != cudaSuccess) return e;
    dim3 grid((p.Sk + kBwdRows - 1) / kBwdRows, p.H, p.B);
    kern<<<grid, kBwdThreads, smem, p.stream>>>(
        q, k, v, dout, lse, delta, dk, dv, p.H, p.Sq, p.Sk, p.causal,
        p.scale, log2_scale(p.scale));
    return cudaGetLastError();
  } else {                                   // CUDA-core FMAs
    constexpr int TL = core_tile<D>();
    const size_t smem = tiles_bytes<D, TL>(4, 2, 2);
    auto kern = flash_bwd_dkv_kernel<T, D, TL>;
    cudaError_t e = prepare(kern, smem);
    if (e != cudaSuccess) return e;
    dim3 grid((p.Sk + TL - 1) / TL, p.H, p.B);
    kern<<<grid, kThreads, smem, p.stream>>>(q, k, v, dout, lse, delta, dk,
                                            dv, p.H, p.Sq, p.Sk, p.causal,
                                            p.scale);
    return cudaGetLastError();
  }
}

bool valid(int B, int H, int Sq, int Sk) {
  return B >= 1 && B <= 65535 && H >= 1 && H <= 65535 && Sq >= 1 && Sk >= 1;
}

// dtype code 0 = float32, 1 = bfloat16; head_dim 32, 64, 128 or 256 (the
// wrapper pads any other head_dim up to one of them)
#define FLASH_DISPATCH(CALL)                                        \
  switch (dtype * 1000 + D) {                                       \
    case 32: return (int)CALL(float, 32);                           \
    case 64: return (int)CALL(float, 64);                           \
    case 128: return (int)CALL(float, 128);                         \
    case 256: return (int)CALL(float, 256);                         \
    case 1032: return (int)CALL(__nv_bfloat16, 32);                 \
    case 1064: return (int)CALL(__nv_bfloat16, 64);                 \
    case 1128: return (int)CALL(__nv_bfloat16, 128);                \
    case 1256: return (int)CALL(__nv_bfloat16, 256);                \
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
