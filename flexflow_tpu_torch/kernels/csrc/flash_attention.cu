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
// time is 17-35 us in bf16 and 0.26-0.51 ms in f32.
//
// What this design does about that bound: it is the simple one. One
// CTA of 256 threads owns a 64-row tile (queries for forward and dq,
// keys for dkv) and loops over the other side's 64-row tiles, so the
// TPU kernel's sequential grid axis becomes a loop inside the block and
// no state crosses blocks. Tiles are staged in shared memory as f32
// (rows padded by one word so neither the row-broadcast nor the
// column reads conflict on banks); each thread holds a 4 x 4 block of
// the score tile and a 4 x d/16 block of the output in registers, and
// the running max, sum and accumulator of the online softmax stay in
// registers; row reductions are shuffles within 16 lanes. The dots run
// as f32 FMAs on the CUDA cores — the f32 peak, 67 TFLOP/s, is the
// ceiling for both input types, so bf16 runs far from its tensor-core
// bound. Causal tiles wholly above the diagonal are never loaded: the
// forward and dq loops stop at the diagonal tile, dkv starts its loop
// there. Tail tiles (s not a multiple of 64) are masked.
//
// What it leaves on the table (later work): tensor cores (mma.sync or
// wgmma on bf16 tiles), TMA loads into a multi-stage ring, and fusing
// dq into the dkv pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

template <typename T, int D>
cudaError_t fwd(const Problem& p, const Bshd& q, const Bshd& k, const Bshd& v,
                const Bshd& o, float* lse) {
  const size_t smem = tiles_bytes<D>(3, 1, 0);
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((p.Sq + kTile - 1) / kTile, p.H, p.B);
  kern<<<grid, kThreads, smem, p.stream>>>(q, k, v, o, lse, p.H, p.Sq, p.Sk,
                                          p.causal, p.scale);
  return cudaGetLastError();
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
