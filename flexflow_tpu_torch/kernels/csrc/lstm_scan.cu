// LSTM recurrence for Hopper (sm_90a): the forward walk over time and
// the reverse walk with recompute, the sequence loop of the LSTM op.
//
// Replaces (flexflow_tpu/kernels/lstm_scan.py):
//   lstm_fwd  <- _fwd_kernel  (:65, launched by _fwd_pallas)
//   lstm_bwd  <- _bwd_kernel  (:119, launched by _bwd_pallas)
// the kernels of the custom VJP _lstm_seq, reached from LSTM.forward
// (ops/rnn.py) once per layer per forward and once per layer per
// backward.
//
// What they compute (the plain versions are lstm_fwd_ref and
// lstm_bwd_ref in flexflow_tpu_torch/kernels/lstm_scan.py), on
// contiguous xg (T, B, 4H), wh (H, 4H), gates [i, f, g, o]:
//   forward:  lin = xg_t + h_{t-1}.wh, c_t = f*c_{t-1} + i*g,
//             h_t = o*tanh(c_t); ys_t = h_t in xg's type, cs_t = c_t f32.
//             h_{t-1} is the f32 carry rounded to wh's type — with xg and
//             wh of one type that is ys_{t-1} (h0 at t = 0), so the carry
//             is read back from ys and cs and needs no buffer of its own.
//   backward: per step, from t = T-1 down to 0: recompute lin from
//             hs_prev_t = ys_{t-1} (h0), dh = dys_t + dlin_{t+1}.wh^T,
//             dc = dh*o*(1 - tanh(c)^2) + dc_carry, dlin from the gate
//             derivatives, dxg_t = dlin in xg's type, dc_carry = dc*f.
//             Then dh0 = dlin_0.wh^T, and dwh = sum_t hs_prev_t^T.dlin_t
//             accumulated in f32.
// Products read f32 or bf16 operands and accumulate in f32 (no TF32);
// bf16 products are exact in f32. The roundings of the TPU kernels are
// kept: h_{t-1} and dlin enter every product in wh's type (dlin is read
// back from dxg, which is that type), ys and dxg are written in xg's
// type, cs, dwh, dh0 and dc0 in f32. Activations are expf/tanhf, not
// the fast intrinsics.
//
// Bound on an H100 SXM at the NMT shapes (T=40, B=256, H=1024): the
// forward does 2*T*B*H*4H = 85.9 GFLOP on ~155 MB (bf16 xg and ys, f32
// cs), the backward three such products, 258 GFLOP. At 989 TFLOP/s
// (bf16 tensor cores) or 67 TFLOP/s (f32) both are bound by operations:
// 0.087 / 0.26 ms in bf16, 1.28 / 3.85 ms in f32.
//
// What this design does about that: it is the simple one. The TPU walks
// time on its sequential grid with wh resident in VMEM. Here h_t needs
// all of h_{t-1}, a grid-wide dependency, so each time step is its own
// launch and the kernel boundary is the barrier; wh (8 MB bf16, 16 MB
// f32) is re-read each step through the 50 MB L2. A step's CTA of 256
// threads owns 64 batch rows x 32 hidden units, all four gates of each
// (128 columns of wh), so the gate nonlinearity, the cell update and
// its derivative stay in the thread that holds the four sums; 128 CTAs
// at B=256, H=1024. Operands are staged through shared memory as f32 in
// slices of 16, two buffers deep, the next slice's global loads issued
// before the current slice's FMAs; each thread holds 4 rows x 2 units x
// 4 gates of sums. The backward step fuses the product that carries dh
// (dlin_{t+1}.wh^T over the tile's 32 rows of wh) with the gate
// recompute, so a step is one launch; dh0 takes one more launch, and
// dwh — a product over all T*B rows — one launch after the loop, a plain
// tiled f32 GEMM (64 x 128 tiles). A forward call makes T device
// launches, a backward call T + 2. The sums run as f32 FMAs on the CUDA
// cores: f32's 67 TFLOP/s is the ceiling for both types, so bf16 runs
// far from its tensor-core bound.
//
// What it leaves on the table (later work): tensor cores (mma.sync or
// wgmma on bf16 slices), one persistent cooperative launch per sequence
// with each CTA's wh slice held in shared memory, and TMA loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16: rows tr*4.., units tu*2..
constexpr int kBM = 64;         // batch rows of a step tile
constexpr int kBU = 32;         // hidden units of a step tile
constexpr int kBN = 4 * kBU;    // wh columns of a step tile (4 gates)
constexpr int kBK = 16;         // depth of one staged slice
constexpr int kLdA = kBM + 4;   // padded row of a transposed row slice
constexpr int kLdW = kBU + 2;   // padded row of a transposed wh slice
constexpr int kSlice = kBK * kBN;  // floats of the larger staging slice

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

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// The staging loop of every product here: slices of kBK along the
// reduction, two shared buffers of kSlice floats each per operand. The
// next slice's global loads (load, into registers) are issued before the
// current slice's FMAs (compute), then stored (store) into the other
// buffer; one barrier a slice.
template <int NA, int NB, class Load, class Store, class Compute>
__device__ __forceinline__ void staged(int depth, Load load, Store store,
                                       Compute compute) {
  float ra[NA], rb[NB];
  const int n = (depth + kBK - 1) / kBK;
  load(0, ra, rb);
  store(0, ra, rb);
  __syncthreads();
  for (int s = 0; s < n; ++s) {
    if (s + 1 < n) load((s + 1) * kBK, ra, rb);
    compute(s & 1);
    if (s + 1 < n) store((s + 1) & 1, ra, rb);
    __syncthreads();
  }
}

// acc[r][g][u] += sum_k hp[b0 + tr*4 + r][k] * wh[k][g*H + j0 + tu*2 + u]
// over k < H: the recurrent product of a step tile, all four gates.
// hp is (B, H), wh (H, 4H), both of type T. sa/sb: 2 x kSlice floats.
template <typename T>
__device__ __forceinline__ void recurrent_product(
    const T* __restrict__ hp, const T* __restrict__ wh, int B, int H, int b0,
    int j0, float* sa, float* sb, float (&acc)[4][4][2]) {
  const int tid = threadIdx.x, tr = tid / 16, tu = tid % 16;
  const int64_t H4 = 4 * (int64_t)H;
  // A slice (64 rows x 16 k) -> sa[kk][m]: 4 a thread, k fastest
  auto load = [&](int k0, float (&ra)[4], float (&rb)[8]) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int i = tid + p * kThreads, m = i / kBK, k = k0 + i % kBK;
      const int b = b0 + m;
      ra[p] = (b < B && k < H) ? to_f32(hp[(int64_t)b * H + k]) : 0.f;
    }
    // B slice (16 k x 4 gates x 32 units) -> sb[kk][g*32 + u]: 8 a
    // thread, units fastest
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int i = tid + p * kThreads, u = i % kBU, g = (i / kBU) % 4;
      const int k = k0 + i / kBN, j = j0 + u;
      rb[p] = (j < H && k < H) ? to_f32(wh[(int64_t)k * H4 + g * H + j])
                               : 0.f;
    }
  };
  auto store = [&](int buf, float (&ra)[4], float (&rb)[8]) {
    float* a = sa + buf * kSlice;
    float* w = sb + buf * kSlice;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int i = tid + p * kThreads;
      a[(i % kBK) * kLdA + i / kBK] = ra[p];
    }
#pragma unroll
    for (int p = 0; p < 8; ++p) w[tid + p * kThreads] = rb[p];
  };
  auto compute = [&](int buf) {
    const float* a = sa + buf * kSlice;
    const float* w = sb + buf * kSlice;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 av4 =
          *reinterpret_cast<const float4*>(a + kk * kLdA + tr * 4);
      const float av[4] = {av4.x, av4.y, av4.z, av4.w};
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float2 wv = *reinterpret_cast<const float2*>(
            w + kk * kBN + g * kBU + tu * 2);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[r][g][0] = fmaf(av[r], wv.x, acc[r][g][0]);
          acc[r][g][1] = fmaf(av[r], wv.y, acc[r][g][1]);
        }
      }
    }
  };
  staged<4, 8>(H, load, store, compute);
}

// dacc[r][u] += sum_c d[b0 + tr*4 + r][c] * wh[j0 + tu*2 + u][c] over
// c < 4H: the product dlin.wh^T that carries dh, for a step tile's rows
// and its 32 units (rows of wh). d is (B, 4H) of type T.
template <typename T>
__device__ __forceinline__ void dh_product(const T* __restrict__ d,
                                           const T* __restrict__ wh, int B,
                                           int H, int b0, int j0, float* sa,
                                           float* sb, float (&dacc)[4][2]) {
  const int tid = threadIdx.x, tr = tid / 16, tu = tid % 16;
  const int H4 = 4 * H;
  // A slice (64 rows x 16 c) -> sa[kk][m]; wh slice (32 rows x 16 c) ->
  // sb[kk][u]: 4 and 2 a thread, c fastest in both
  auto load = [&](int c0, float (&ra)[4], float (&rb)[2]) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int i = tid + p * kThreads, m = i / kBK, c = c0 + i % kBK;
      const int b = b0 + m;
      ra[p] = (b < B && c < H4) ? to_f32(d[(int64_t)b * H4 + c]) : 0.f;
    }
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int i = tid + p * kThreads, u = i / kBK, c = c0 + i % kBK;
      const int j = j0 + u;
      rb[p] = (j < H && c < H4) ? to_f32(wh[(int64_t)j * H4 + c]) : 0.f;
    }
  };
  auto store = [&](int buf, float (&ra)[4], float (&rb)[2]) {
    float* a = sa + buf * kSlice;
    float* w = sb + buf * kSlice;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int i = tid + p * kThreads;
      a[(i % kBK) * kLdA + i / kBK] = ra[p];
    }
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int i = tid + p * kThreads;
      w[(i % kBK) * kLdW + i / kBK] = rb[p];
    }
  };
  auto compute = [&](int buf) {
    const float* a = sa + buf * kSlice;
    const float* w = sb + buf * kSlice;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 av4 =
          *reinterpret_cast<const float4*>(a + kk * kLdA + tr * 4);
      const float av[4] = {av4.x, av4.y, av4.z, av4.w};
      const float2 wv =
          *reinterpret_cast<const float2*>(w + kk * kLdW + tu * 2);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        dacc[r][0] = fmaf(av[r], wv.x, dacc[r][0]);
        dacc[r][1] = fmaf(av[r], wv.y, dacc[r][1]);
      }
    }
  };
  staged<4, 2>(H4, load, store, compute);
}

// ------------------------------------------------------------- forward
// One time step: xg, ys, cs point at step t's (B, 4H) / (B, H) slices;
// hp = ys_{t-1} (or h0 in wh's type), cp = cs_{t-1} (or c0 in f32).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    lstm_fwd_step_kernel(const T* __restrict__ xg, const T* __restrict__ wh,
                         const T* __restrict__ hp,
                         const float* __restrict__ cp, T* __restrict__ ys,
                         float* __restrict__ cs, int B, int H) {
  __shared__ __align__(16) float sa[2 * kSlice];
  __shared__ __align__(16) float sb[2 * kSlice];
  const int b0 = blockIdx.y * kBM, j0 = blockIdx.x * kBU;
  const int tr = threadIdx.x / 16, tu = threadIdx.x % 16;
  float acc[4][4][2] = {};
  recurrent_product(hp, wh, B, H, b0, j0, sa, sb, acc);
  const int64_t H4 = 4 * (int64_t)H;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int b = b0 + tr * 4 + r;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = j0 + tu * 2 + u;
      if (b >= B || j >= H) continue;
      const T* x = xg + (int64_t)b * H4 + j;
      const float i = sigmoid(to_f32(x[0]) + acc[r][0][u]);
      const float f = sigmoid(to_f32(x[H]) + acc[r][1][u]);
      const float g = tanhf(to_f32(x[2 * H]) + acc[r][2][u]);
      const float o = sigmoid(to_f32(x[3 * H]) + acc[r][3][u]);
      const int64_t idx = (int64_t)b * H + j;
      const float c = f * cp[idx] + i * g;
      ys[idx] = from_f32<T>(o * tanhf(c));
      cs[idx] = c;
    }
  }
}

// ------------------------------------------------------------ backward
// One reverse step t. dnext = dxg_{t+1} (null at t = T-1: dh carry 0);
// dc is the (B, H) f32 dc carry, read and overwritten in place (each
// element by the one thread that owns it).
template <typename T>
__global__ void __launch_bounds__(kThreads) lstm_bwd_step_kernel(
    const T* __restrict__ xg, const T* __restrict__ wh,
    const T* __restrict__ hp, const float* __restrict__ cp,
    const float* __restrict__ cs, const T* __restrict__ dys,
    const T* __restrict__ dnext, T* __restrict__ dxg, float* __restrict__ dc,
    int B, int H) {
  __shared__ __align__(16) float sa[2 * kSlice];
  __shared__ __align__(16) float sb[2 * kSlice];
  const int b0 = blockIdx.y * kBM, j0 = blockIdx.x * kBU;
  const int tr = threadIdx.x / 16, tu = threadIdx.x % 16;
  float dacc[4][2] = {};
  if (dnext != nullptr) dh_product(dnext, wh, B, H, b0, j0, sa, sb, dacc);
  float acc[4][4][2] = {};
  recurrent_product(hp, wh, B, H, b0, j0, sa, sb, acc);
  const int64_t H4 = 4 * (int64_t)H;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int b = b0 + tr * 4 + r;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = j0 + tu * 2 + u;
      if (b >= B || j >= H) continue;
      const T* x = xg + (int64_t)b * H4 + j;
      const float i = sigmoid(to_f32(x[0]) + acc[r][0][u]);
      const float f = sigmoid(to_f32(x[H]) + acc[r][1][u]);
      const float g = tanhf(to_f32(x[2 * H]) + acc[r][2][u]);
      const float o = sigmoid(to_f32(x[3 * H]) + acc[r][3][u]);
      const int64_t idx = (int64_t)b * H + j;
      const float tanh_c = tanhf(cs[idx]);
      const float dh = to_f32(dys[idx]) + dacc[r][u];
      const float dcv = dh * o * (1.f - tanh_c * tanh_c) + dc[idx];
      const float dov = dh * tanh_c;
      const float di = dcv * g, dg = dcv * i, df = dcv * cp[idx];
      T* dx = dxg + (int64_t)b * H4 + j;
      dx[0] = from_f32<T>(di * i * (1.f - i));
      dx[H] = from_f32<T>(df * f * (1.f - f));
      dx[2 * H] = from_f32<T>(dg * (1.f - g * g));
      dx[3 * H] = from_f32<T>(dov * o * (1.f - o));
      dc[idx] = dcv * f;
    }
  }
}

// dh0 = dlin_0.wh^T (dlin_0 read from dxg_0), f32 (B, H).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    lstm_dh0_kernel(const T* __restrict__ d, const T* __restrict__ wh,
                    float* __restrict__ dh0, int B, int H) {
  __shared__ __align__(16) float sa[2 * kSlice];
  __shared__ __align__(16) float sb[2 * kSlice];
  const int b0 = blockIdx.y * kBM, j0 = blockIdx.x * kBU;
  const int tr = threadIdx.x / 16, tu = threadIdx.x % 16;
  float dacc[4][2] = {};
  dh_product(d, wh, B, H, b0, j0, sa, sb, dacc);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int b = b0 + tr * 4 + r;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = j0 + tu * 2 + u;
      if (b < B && j < H) dh0[(int64_t)b * H + j] = dacc[r][u];
    }
  }
}

// dwh[k][c] = sum_n hs_prev[n][k] * dxg[n][c] over the n < T*B rows of
// the sequence, f32 (H, 4H). hs_prev row n is h0[n] for n < B, else
// ys[n - B] (ys is (T, B, H), so row n - B of its (T*B, H) view). A
// 64 (k) x 128 (c) tile a CTA; a thread holds rows tr*4.. and the
// columns tu*4.. and 64 + tu*4...
template <typename T>
__global__ void __launch_bounds__(kThreads)
    lstm_dwh_kernel(const T* __restrict__ h0, const T* __restrict__ ys,
                    const T* __restrict__ dxg, float* __restrict__ dwh,
                    int rows, int B, int H) {
  __shared__ __align__(16) float sa[2 * kSlice];
  __shared__ __align__(16) float sb[2 * kSlice];
  const int tid = threadIdx.x, tr = tid / 16, tu = tid % 16;
  const int m0 = blockIdx.y * kBM, c0 = blockIdx.x * kBN;
  const int H4 = 4 * H;
  float acc[4][8] = {};
  // hs_prev slice (16 rows x 64 k) -> sa[kk][m], k fastest; dxg slice
  // (16 rows x 128 c) -> sb[kk][n], c fastest: 4 and 8 a thread
  auto load = [&](int n0, float (&ra)[4], float (&rb)[8]) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int i = tid + p * kThreads, n = n0 + i / kBM, k = m0 + i % kBM;
      const T* row = n < B ? h0 + (int64_t)n * H : ys + (int64_t)(n - B) * H;
      ra[p] = (n < rows && k < H) ? to_f32(row[k]) : 0.f;
    }
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int i = tid + p * kThreads, n = n0 + i / kBN, c = c0 + i % kBN;
      rb[p] = (n < rows && c < H4) ? to_f32(dxg[(int64_t)n * H4 + c]) : 0.f;
    }
  };
  auto store = [&](int buf, float (&ra)[4], float (&rb)[8]) {
    float* a = sa + buf * kSlice;
    float* w = sb + buf * kSlice;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int i = tid + p * kThreads;
      a[(i / kBM) * kLdA + i % kBM] = ra[p];
    }
#pragma unroll
    for (int p = 0; p < 8; ++p) w[tid + p * kThreads] = rb[p];
  };
  auto compute = [&](int buf) {
    const float* a = sa + buf * kSlice;
    const float* w = sb + buf * kSlice;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 av4 =
          *reinterpret_cast<const float4*>(a + kk * kLdA + tr * 4);
      const float4 w0 =
          *reinterpret_cast<const float4*>(w + kk * kBN + tu * 4);
      const float4 w1 =
          *reinterpret_cast<const float4*>(w + kk * kBN + 64 + tu * 4);
      const float av[4] = {av4.x, av4.y, av4.z, av4.w};
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(av[r], wv[q], acc[r][q]);
    }
  };
  staged<4, 8>(rows, load, store, compute);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int k = m0 + tr * 4 + r;
    if (k >= H) continue;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int c = c0 + (q < 4 ? tu * 4 + q : 64 + tu * 4 + q - 4);
      if (c < H4) dwh[(int64_t)k * H4 + c] = acc[r][q];
    }
  }
}

template <typename T>
cudaError_t fwd(const void* xg_, const void* wh_, const void* h0_,
                const float* c0, void* ys_, float* cs, int Tn, int B, int H,
                cudaStream_t stream, int* launched) {
  const T* xg = static_cast<const T*>(xg_);
  const T* wh = static_cast<const T*>(wh_);
  const T* h0 = static_cast<const T*>(h0_);
  T* ys = static_cast<T*>(ys_);
  const int64_t bh = (int64_t)B * H, bh4 = 4 * bh;
  const dim3 grid((H + kBU - 1) / kBU, (B + kBM - 1) / kBM);
  for (int t = 0; t < Tn; ++t) {
    const T* hp = t == 0 ? h0 : ys + (t - 1) * bh;
    const float* cp = t == 0 ? c0 : cs + (t - 1) * bh;
    lstm_fwd_step_kernel<T><<<grid, kThreads, 0, stream>>>(
        xg + t * bh4, wh, hp, cp, ys + t * bh, cs + t * bh, B, H);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    ++*launched;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t bwd(const void* xg_, const void* wh_, const void* h0_,
                const float* c0, const void* ys_, const float* cs,
                const void* dys_, void* dxg_, float* dwh, float* dh0,
                float* dc, int Tn, int B, int H, cudaStream_t stream,
                int* launched) {
  const T* xg = static_cast<const T*>(xg_);
  const T* wh = static_cast<const T*>(wh_);
  const T* h0 = static_cast<const T*>(h0_);
  const T* ys = static_cast<const T*>(ys_);
  const T* dys = static_cast<const T*>(dys_);
  T* dxg = static_cast<T*>(dxg_);
  const int64_t bh = (int64_t)B * H, bh4 = 4 * bh;
  const dim3 grid((H + kBU - 1) / kBU, (B + kBM - 1) / kBM);
  cudaError_t e;
  for (int t = Tn - 1; t >= 0; --t) {
    const T* hp = t == 0 ? h0 : ys + (t - 1) * bh;
    const float* cp = t == 0 ? c0 : cs + (t - 1) * bh;
    const T* dnext = t + 1 < Tn ? dxg + (t + 1) * bh4 : nullptr;
    lstm_bwd_step_kernel<T><<<grid, kThreads, 0, stream>>>(
        xg + t * bh4, wh, hp, cp, cs + t * bh, dys + t * bh, dnext,
        dxg + t * bh4, dc, B, H);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    ++*launched;
  }
  lstm_dh0_kernel<T><<<grid, kThreads, 0, stream>>>(dxg, wh, dh0, B, H);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ++*launched;
  const dim3 wgrid((4 * H + kBN - 1) / kBN, (H + kBM - 1) / kBM);
  lstm_dwh_kernel<T><<<wgrid, kThreads, 0, stream>>>(h0, ys, dxg, dwh,
                                                      Tn * B, B, H);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ++*launched;
  return cudaSuccess;
}

// T*B*4H and (H, 4H) index within int64 offsets; T*B rows and the grid
// within int
bool valid(int Tn, int B, int H) {
  return Tn >= 1 && B >= 1 && H >= 1 && (int64_t)Tn * B < (1LL << 31) &&
         4LL * H < (1LL << 31) && (B + kBM - 1) / kBM <= 65535 &&
         (H + kBM - 1) / kBM <= 65535;
}

}  // namespace

// Pointers are contiguous device arrays: xg (T, B, 4H), wh (H, 4H), h0
// (B, H) in the dtype (0 = float32, 1 = bfloat16); c0 (B, H) f32; ys
// (T, B, H) in the dtype, cs (T, B, H) f32. The backward also takes dys
// (T, B, H) in the dtype and writes dxg (T, B, 4H) in the dtype, dwh
// (H, 4H), dh0 and dc0 (B, H) in f32; dc0 must hold zeros on entry (it
// is the dc carry). Each launcher enqueues its kernels on `stream`,
// adds one to *launched for each kernel enqueued, and returns the first
// non-zero cudaGetLastError() (0 on success); the caller raises on
// anything else.
extern "C" int lstm_fwd_launch(int dtype, const void* xg, const void* wh,
                               const void* h0, const float* c0, void* ys,
                               float* cs, int Tn, int B, int H,
                               void* stream, int* launched) {
  if (!valid(Tn, B, H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)fwd<float>(xg, wh, h0, c0, ys, cs, Tn, B, H, s, launched);
  if (dtype == 1)
    return (int)fwd<__nv_bfloat16>(xg, wh, h0, c0, ys, cs, Tn, B, H, s,
                                   launched);
  return (int)cudaErrorInvalidValue;
}

extern "C" int lstm_bwd_launch(int dtype, const void* xg, const void* wh,
                               const void* h0, const float* c0,
                               const void* ys, const float* cs,
                               const void* dys, void* dxg, float* dwh,
                               float* dh0, float* dc0, int Tn, int B, int H,
                               void* stream, int* launched) {
  if (!valid(Tn, B, H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)bwd<float>(xg, wh, h0, c0, ys, cs, dys, dxg, dwh, dh0, dc0,
                           Tn, B, H, s, launched);
  if (dtype == 1)
    return (int)bwd<__nv_bfloat16>(xg, wh, h0, c0, ys, cs, dys, dxg, dwh,
                                   dh0, dc0, Tn, B, H, s, launched);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* lstm_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
