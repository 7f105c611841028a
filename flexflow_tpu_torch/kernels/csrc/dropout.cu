// Dropout for Hopper (sm_90a): JAX's bernoulli mask drawn and applied in
// one pass, bit for bit the stream of the JAX package's dropout.
//
// No TPU kernel is replaced: the JAX package computes its dropout in XLA
// (flexflow_tpu/ops/elementwise.py Dropout.forward, ops/attention.py's
// output dropout), from jax.random.bernoulli over threefry2x32 in the
// partitionable mode. This kernel reproduces that stream so that a
// training run with dropout on can be held against JAX exactly.
//
// What it computes (the plain version is dropout_ref in
// flexflow_tpu_torch/kernels/dropout.py), for a contiguous x of n
// elements, a step key (k0, k1) read from device memory and the op's
// fold-in value `fold` (its _stable_hash, a launch constant):
//   op key   = threefry2x32((k0, k1), (0, fold))       (jax fold_in)
//   bits_i   = x0 ^ x1 of threefry2x32(op key, (hi32(base + i),
//                                               lo32(base + i)))
//   u_i      = bitcast((bits_i >> 9) | 0x3F800000) - 1.0f
//   y_i      = u_i < keep ? x_i * recip                  (float32)
//                        : round(float(x_i) / keep_c)    (bfloat16)
//              else 0
// keep is the keep probability in f32 (bernoulli's p). The jitted
// reference computes `x / keep` for an f32 x as x * f32(1 / keep): XLA
// rewrites a division by a constant into a product with its reciprocal,
// rounded to f32 once (recip = float32(1) / float32(keep), a launch
// constant), and so does this kernel. For bf16, keep_c is keep rounded
// to bf16, then widened (JAX's weak typing rounds the Python float of
// `x / keep` to bf16 first); the division is IEEE f32 (nvcc's default
// -prec-div=true), rounded to nearest even into bf16, which is what the
// jitted reference computes there. The backward of dropout is this same
// function of the incoming gradient with the same key: JAX's VJP of
// where(mask, x / keep, 0) is where(mask, g / keep, 0).
//
// The key is read from device memory, not passed by value, so a captured
// CUDA graph replays with each step's key (the executor writes it into
// the graph's static input before each replay). The element index is a
// 64-bit count split into two words: on one device element i's count is
// i (base 0); on an executing mesh x is a rank's block of a larger tensor
// and its counts are the elements' global indices, so every rank draws
// the mask the one-device run draws for the same global elements. A
// block of the batch (dim 0 split) is contiguous: base + i, row_len 0.
// A block of the sequence (dim 1 split too) is one run a row: element i
// is base + (i / row_len) * row_stride + i % row_len. The wrapper takes
// n < 2^31.
//
// Bound on an H100 SXM at the LM's activation (16 x 512 x 512, bf16): it
// reads x once and writes y once, 16.8 MB, 0.005 ms at 3.35 TB/s. The
// hash and the uniform cost 75 32-bit integer operations an element (2
// initial adds, 20 rounds of add, rotate and xor, 5 key injections of two
// adds, then xor, shift and or), 0.31 G in all; an SM has 64 INT32 lanes,
// 16.7 T operations/s on 132 SMs at 1.98 GHz (the data sheet's clock),
// so the integer work (0.019 ms), not the bytes, bounds it (chip_smoke.py
// computes both). Design: one thread derives the op key once and then
// walks a grid-stride loop of elements, ILP of 4 independent hashes a
// thread; rotations are __funnelshift_l; loads and stores are coalesced
// across the warp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
#define FF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r); \
  x1 ^= x0;
  x0 += k0;
  x1 += k1;
  FF_ROUND(13) FF_ROUND(15) FF_ROUND(26) FF_ROUND(6)
  x0 += k1;
  x1 += k2 + 1u;
  FF_ROUND(17) FF_ROUND(29) FF_ROUND(16) FF_ROUND(24)
  x0 += k2;
  x1 += k0 + 2u;
  FF_ROUND(13) FF_ROUND(15) FF_ROUND(26) FF_ROUND(6)
  x0 += k0;
  x1 += k1 + 3u;
  FF_ROUND(17) FF_ROUND(29) FF_ROUND(16) FF_ROUND(24)
  x0 += k1;
  x1 += k2 + 4u;
  FF_ROUND(13) FF_ROUND(15) FF_ROUND(26) FF_ROUND(6)
  x0 += k2;
  x1 += k0 + 5u;
#undef FF_ROUND
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// a kept element: the product with the f32 reciprocal (float32), the
// f32 quotient by keep_c rounded to bf16 (bfloat16)
__device__ __forceinline__ float kept(float v, float keep_c, float recip) {
  return __fmul_rn(v, recip);
}
__device__ __forceinline__ __nv_bfloat16 kept(__nv_bfloat16 v, float keep_c,
                                              float recip) {
  return __float2bfloat16_rn(__bfloat162float(v) / keep_c);
}

// kRows: a block of the sequence (one run a row); without it the
// contiguous block's code, as the one-device path has always run it
template <typename T, bool kRows>
__global__ void __launch_bounds__(kThreads)
    dropout_kernel(const T* __restrict__ x, T* __restrict__ y,
                   const uint32_t* __restrict__ key, uint32_t fold,
                   float keep, float keep_c, float recip, uint32_t n,
                   uint64_t base, uint32_t row_len, uint64_t row_stride) {
  uint32_t ok0 = 0u, ok1 = fold;               // fold_in(key, fold)
  threefry2x32(key[0], key[1], ok0, ok1);
  const uint32_t stride = gridDim.x * kThreads;
  uint32_t i = blockIdx.x * kThreads + threadIdx.x;
  for (; i < n; i += kUnroll * stride) {
    uint32_t h[kUnroll], l[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t j = i + u * stride;
      // a block of the sequence: row j / row_len of the global order
      const uint64_t g =
          base + (kRows ? (uint64_t)(j / row_len) * row_stride +
                              (j % row_len)
                        : (uint64_t)j);
      h[u] = (uint32_t)(g >> 32);
      l[u] = (uint32_t)g;
      threefry2x32(ok0, ok1, h[u], l[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t j = i + u * stride;
      if (j < n) {  // n < 2^31: i + 4 * stride never wraps
        const float uni =
            __uint_as_float(((h[u] ^ l[u]) >> 9) | 0x3F800000u) - 1.0f;
        y[j] = uni < keep ? kept(x[j], keep_c, recip) : from_f32<T>(0.0f);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, const void* key, uint32_t fold,
                   float keep, float keep_c, float recip, uint32_t n,
                   uint64_t base, uint32_t row_len, uint64_t row_stride,
                   cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // enough blocks to fill the card (8 of 256 threads an SM), never more
  // than the elements need
  uint32_t want = (n + kThreads - 1) / kThreads;
  uint32_t cap = (uint32_t)(sms > 0 ? sms : 132) * 8u;
  uint32_t blocks = want < cap ? want : cap;
  if (blocks == 0) blocks = 1;
  if (row_len == 0u)
    dropout_kernel<T, false><<<blocks, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(y),
        static_cast<const uint32_t*>(key), fold, keep, keep_c, recip, n,
        base, row_len, row_stride);
  else
    dropout_kernel<T, true><<<blocks, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(y),
        static_cast<const uint32_t*>(key), fold, keep, keep_c, recip, n,
        base, row_len, row_stride);
  return cudaGetLastError();
}

}  // namespace

// dtype 0: float32, 1: bfloat16. n must be below 2^31; base (>= 0) is
// the 64-bit count of the first element; row_len 0 for a contiguous
// block, else the run length (dividing n, at most row_stride).
extern "C" int dropout_launch(int dtype, const void* x, void* y,
                              const void* key, unsigned int fold,
                              float keep, float keep_c, float recip,
                              long long n, long long base, long long row_len,
                              long long row_stride, void* stream) {
  if (n < 0 || n >= (1LL << 31) || base < 0 || row_len < 0 ||
      row_len >= (1LL << 31) || (row_len > 0 && row_stride < row_len))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, y, key, fold, keep, keep_c, recip,
                              (uint32_t)n, (uint64_t)base,
                              (uint32_t)row_len, (uint64_t)row_stride, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, y, key, fold, keep, keep_c, recip,
                                      (uint32_t)n, (uint64_t)base,
                                      (uint32_t)row_len,
                                      (uint64_t)row_stride, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dropout_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
