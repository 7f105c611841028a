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
// 0.087 / 0.26 ms in bf16, 1.28 / 3.85 ms in f32. On the CUDA cores
// every type is capped at f32's 67 TFLOP/s; only the tensor cores reach
// the bf16 bound. Below the operations lies a second limit: a step tile
// re-reads its operands from L2 (a backward step tile ~1.2 MB: its rows
// of h_{t-1} and dlin_{t+1}, a 128-column and a 32-row slice of wh).
//
// The shape shared by both directions: the TPU walks time on its
// sequential grid with wh resident in VMEM. Here h_t needs all of
// h_{t-1}, a grid-wide dependency, so each time step is its own launch
// and the kernel boundary is the barrier; wh (8 MB bf16, 16 MB f32) is
// re-read each step through the 50 MB L2. A step's CTA of 256 threads
// owns 64 batch rows x 32 hidden units, all four gates of each (128
// columns of wh), so the gate nonlinearity, the cell update and its
// derivative are computed by one thread for a (row, unit); 128 CTAs at
// B=256, H=1024. The backward step fuses the product that carries dh
// (dlin_{t+1}.wh^T over the tile's 32 rows of wh) with the gate
// recompute, so a step is one launch; dh0 takes one more launch, and
// dwh — a product over all T*B rows — one launch after the loop. A
// forward call makes T device launches, a backward call T + 2.
//
// The bf16 backward runs its three products on the tensor cores
// (lstm_bwd_step_mma_kernel, lstm_dh0_mma_kernel, lstm_dwh_mma_kernel):
// mma.sync m16n8k16 with bf16 operands and f32 sums, fed by ldmatrix
// from padded bf16 slices in shared memory that 16-byte cp.async copies
// fill through a ring of stages: six in a step, whose one CTA an SM
// keeps ~130 KB of L2 reads in flight, one ring for both of its
// products so that it does not drain between them; three in dwh. Rows
// that do not start 16-byte aligned (H not a multiple of 8) are staged
// element by element into the same ring. In a step, 8 warps take the
// recompute h_{t-1}.wh as 2 (rows) x 4 (gates), B from row-major wh
// through ldmatrix.trans, and the dh product dlin_{t+1}.wh^T over 4H as
// 2 (rows) x 4 (k16 steps of a slice), whose B — rows of wh — is
// already the col-major operand mma wants; both sets of f32 sums then
// meet in shared memory, where the
// ring was, so that one thread reads i, f, g, o and dh of its
// (row, unit). dh0 is the same dh product; dwh is a 128 x 128-tiled
// GEMM with both operands through ldmatrix.trans. Operands stay bf16
// (h_{t-1} = ys_{t-1}, dlin = dxg_{t+1}), so the products are exact in
// f32 and only the order of the sums changes.
//
// The bf16 forward runs the same recurrent product on the tensor cores
// (lstm_fwd_step_mma_kernel: recurrent_load and recurrent_mma in a ring
// of its own, then the same shared-memory epilogue, whose xg and c
// reads are issued before the ring), so its step tile reads ~0.4 MB and
// the 128 tiles ~48 MB a step, a third of the backward's.
//
// The split form (ops/rnn.py on a mesh whose model axis splits the gate
// columns): a rank holds the [i, f, g, o] columns of its Hu = H/n units,
// wh (Hin, 4Hu) with Hin = H the whole contraction, and every step needs
// all of h_{t-1}, which the ranks gather between two steps. So the
// kernels take Hin (the rows of wh, the width of h_{t-1}) and Hu (the
// units: xg/4, ys, cs, dys) apart, and the split launchers run one step,
// or one product, a call: the forward step reads h_{t-1} from the
// caller's gathered history; the backward step takes the dh carry as an
// f32 addend (the ranks' partial products summed by a reduce-scatter)
// in place of computing dlin_{t+1}.wh^T itself; the partial product
// dlin_t.wh_local^T -> (B, Hin) f32 is the dh0 kernel's; dwh reads
// h_{t-1} from the history. A forward walk is T launches, a backward walk
// 2T + 1. The tiles are the whole-H kernels' (64 rows x 32 units x 4
// gates a CTA): at Hu 512 a step is 64 CTAs on 132 SMs. With Hin == Hu
// the whole-sequence launchers run, as without a mesh.
//
// The f32 forward and backward run on the CUDA cores: operands
// staged through shared memory as f32 in slices of 16, two buffers
// deep, the next slice's global loads issued before the current slice's
// FMAs; each thread holds 4 rows x 2 units x 4 gates of sums; dwh a
// tiled f32 GEMM (64 x 128 tiles). Their sums run as f32 FMAs on the
// CUDA cores, the contract for f32 (no TF32).
//
// What bounds a bf16 step now is that L2 traffic, not its products:
// the 128 backward tiles re-read ~147 MB a step (each row tile all of
// wh twice, each unit tile all of h_{t-1} and dlin_{t+1}), ~2.8 TB/s at
// the measured ~52 us a step on an H100, while its mma work would take
// a few us. What is left (later work): cutting that traffic — thread
// block clusters whose CTAs share operand slices through TMA multicast
// or distributed shared memory, or a persistent cooperative launch per
// sequence with each CTA's wh slice held in shared memory; wgmma and
// TMA in place of mma.sync, ldmatrix and cp.async.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"

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

// acc[r][g][u] += sum_k hp[b0 + tr*4 + r][k] * wh[k][g*Hu + j0 + tu*2 + u]
// over k < Hin: the recurrent product of a step tile, all four gates.
// hp is (B, Hin), wh (Hin, 4Hu), both of type T (Hin = Hu = H but in
// the split form). sa/sb: 2 x kSlice floats.
template <typename T>
__device__ __forceinline__ void recurrent_product(
    const T* __restrict__ hp, const T* __restrict__ wh, int B, int Hin,
    int Hu, int b0, int j0, float* sa, float* sb, float (&acc)[4][4][2]) {
  const int tid = threadIdx.x, tr = tid / 16, tu = tid % 16;
  const int64_t H4 = 4 * (int64_t)Hu;
  // A slice (64 rows x 16 k) -> sa[kk][m]: 4 a thread, k fastest
  auto load = [&](int k0, float (&ra)[4], float (&rb)[8]) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int i = tid + p * kThreads, m = i / kBK, k = k0 + i % kBK;
      const int b = b0 + m;
      ra[p] = (b < B && k < Hin) ? to_f32(hp[(int64_t)b * Hin + k]) : 0.f;
    }
    // B slice (16 k x 4 gates x 32 units) -> sb[kk][g*32 + u]: 8 a
    // thread, units fastest
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int i = tid + p * kThreads, u = i % kBU, g = (i / kBU) % 4;
      const int k = k0 + i / kBN, j = j0 + u;
      rb[p] = (j < Hu && k < Hin)
                  ? to_f32(wh[(int64_t)k * H4 + (int64_t)g * Hu + j])
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
  staged<4, 8>(Hin, load, store, compute);
}

// dacc[r][u] += sum_c d[b0 + tr*4 + r][c] * wh[j0 + tu*2 + u][c] over
// c < H4: the product dlin.wh^T that carries dh, for a step tile's rows
// and its 32 rows j < Hr of wh (the units of h_{t-1}). d is (B, H4) and
// wh (Hr, H4), of type T: H4 = 4H and Hr = H, or 4Hu and Hin in the
// split form's partial product.
template <typename T>
__device__ __forceinline__ void dh_product(const T* __restrict__ d,
                                           const T* __restrict__ wh, int B,
                                           int Hr, int H4, int b0, int j0,
                                           float* sa, float* sb,
                                           float (&dacc)[4][2]) {
  const int tid = threadIdx.x, tr = tid / 16, tu = tid % 16;
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
      rb[p] = (j < Hr && c < H4) ? to_f32(wh[(int64_t)j * H4 + c]) : 0.f;
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
// One time step: xg, ys, cs point at step t's (B, 4Hu) / (B, Hu) slices;
// hp = ys_{t-1} (or h0 in wh's type), (B, Hin): the whole-H walk reads
// it from ys (Hin = Hu = H), the split form from the gathered history;
// cp = cs_{t-1} (or c0 in f32).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    lstm_fwd_step_kernel(const T* __restrict__ xg, const T* __restrict__ wh,
                         const T* __restrict__ hp,
                         const float* __restrict__ cp, T* __restrict__ ys,
                         float* __restrict__ cs, int B, int Hin, int Hu) {
  __shared__ __align__(16) float sa[2 * kSlice];
  __shared__ __align__(16) float sb[2 * kSlice];
  const int b0 = blockIdx.y * kBM, j0 = blockIdx.x * kBU;
  const int tr = threadIdx.x / 16, tu = threadIdx.x % 16;
  float acc[4][4][2] = {};
  recurrent_product(hp, wh, B, Hin, Hu, b0, j0, sa, sb, acc);
  const int64_t H4 = 4 * (int64_t)Hu;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int b = b0 + tr * 4 + r;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = j0 + tu * 2 + u;
      if (b >= B || j >= Hu) continue;
      const T* x = xg + (int64_t)b * H4 + j;
      const float i = sigmoid(to_f32(x[0]) + acc[r][0][u]);
      const float f = sigmoid(to_f32(x[Hu]) + acc[r][1][u]);
      const float g = tanhf(to_f32(x[2 * Hu]) + acc[r][2][u]);
      const float o = sigmoid(to_f32(x[3 * Hu]) + acc[r][3][u]);
      const int64_t idx = (int64_t)b * Hu + j;
      const float c = f * cp[idx] + i * g;
      ys[idx] = from_f32<T>(o * tanhf(c));
      cs[idx] = c;
    }
  }
}

// ------------------------------------------------------------ backward
// One reverse step t. The dh carry: dnext = dxg_{t+1} (whole H; null at
// t = T-1: carry 0), or in the split form dh_add, the f32 (B, Hu) sum
// of the ranks' partial products (null at t = T-1); at most one is
// given. dc is the (B, Hu) f32 dc carry, read and overwritten in place
// (each element by the one thread that owns it).
template <typename T>
__global__ void __launch_bounds__(kThreads) lstm_bwd_step_kernel(
    const T* __restrict__ xg, const T* __restrict__ wh,
    const T* __restrict__ hp, const float* __restrict__ cp,
    const float* __restrict__ cs, const T* __restrict__ dys,
    const T* __restrict__ dnext, const float* __restrict__ dh_add,
    T* __restrict__ dxg, float* __restrict__ dc, int B, int Hin, int Hu) {
  __shared__ __align__(16) float sa[2 * kSlice];
  __shared__ __align__(16) float sb[2 * kSlice];
  const int b0 = blockIdx.y * kBM, j0 = blockIdx.x * kBU;
  const int tr = threadIdx.x / 16, tu = threadIdx.x % 16;
  const int64_t H4 = 4 * (int64_t)Hu;
  float dacc[4][2] = {};
  if (dnext != nullptr)
    dh_product(dnext, wh, B, Hin, (int)H4, b0, j0, sa, sb, dacc);
  float acc[4][4][2] = {};
  recurrent_product(hp, wh, B, Hin, Hu, b0, j0, sa, sb, acc);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int b = b0 + tr * 4 + r;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = j0 + tu * 2 + u;
      if (b >= B || j >= Hu) continue;
      const T* x = xg + (int64_t)b * H4 + j;
      const float i = sigmoid(to_f32(x[0]) + acc[r][0][u]);
      const float f = sigmoid(to_f32(x[Hu]) + acc[r][1][u]);
      const float g = tanhf(to_f32(x[2 * Hu]) + acc[r][2][u]);
      const float o = sigmoid(to_f32(x[3 * Hu]) + acc[r][3][u]);
      const int64_t idx = (int64_t)b * Hu + j;
      const float tanh_c = tanhf(cs[idx]);
      const float dh =
          to_f32(dys[idx]) + (dh_add != nullptr ? dh_add[idx] : dacc[r][u]);
      const float dcv = dh * o * (1.f - tanh_c * tanh_c) + dc[idx];
      const float dov = dh * tanh_c;
      const float di = dcv * g, dg = dcv * i, df = dcv * cp[idx];
      T* dx = dxg + (int64_t)b * H4 + j;
      dx[0] = from_f32<T>(di * i * (1.f - i));
      dx[Hu] = from_f32<T>(df * f * (1.f - f));
      dx[2 * Hu] = from_f32<T>(dg * (1.f - g * g));
      dx[3 * Hu] = from_f32<T>(dov * o * (1.f - o));
      dc[idx] = dcv * f;
    }
  }
}

// dh = d.wh^T, f32 (B, Hin), d (B, 4Hu) and wh (Hin, 4Hu): dh0 =
// dlin_0.wh^T (dlin_0 read from dxg_0) of the whole-H walk (Hin = Hu
// = H), and the split form's partial product of every reverse step.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    lstm_dh0_kernel(const T* __restrict__ d, const T* __restrict__ wh,
                    float* __restrict__ dh0, int B, int Hin, int Hu) {
  __shared__ __align__(16) float sa[2 * kSlice];
  __shared__ __align__(16) float sb[2 * kSlice];
  const int b0 = blockIdx.y * kBM, j0 = blockIdx.x * kBU;
  const int tr = threadIdx.x / 16, tu = threadIdx.x % 16;
  float dacc[4][2] = {};
  dh_product(d, wh, B, Hin, 4 * Hu, b0, j0, sa, sb, dacc);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int b = b0 + tr * 4 + r;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = j0 + tu * 2 + u;
      if (b < B && j < Hin) dh0[(int64_t)b * Hin + j] = dacc[r][u];
    }
  }
}

// dwh[k][c] = sum_n hs_prev[n][k] * dxg[n][c] over the n < T*B rows of
// the sequence, f32 (Hin, 4Hu). hs_prev row n is h0[n] for n < B, else
// ys[n - B] (ys is (T, B, Hin), so row n - B of its (T*B, Hin) view):
// the whole-H walk's ys, or the split form's gathered history. A
// 64 (k) x 128 (c) tile a CTA; a thread holds rows tr*4.. and the
// columns tu*4.. and 64 + tu*4...
template <typename T>
__global__ void __launch_bounds__(kThreads)
    lstm_dwh_kernel(const T* __restrict__ h0, const T* __restrict__ ys,
                    const T* __restrict__ dxg, float* __restrict__ dwh,
                    int rows, int B, int Hin, int Hu) {
  __shared__ __align__(16) float sa[2 * kSlice];
  __shared__ __align__(16) float sb[2 * kSlice];
  const int tid = threadIdx.x, tr = tid / 16, tu = tid % 16;
  const int m0 = blockIdx.y * kBM, c0 = blockIdx.x * kBN;
  const int H4 = 4 * Hu;
  float acc[4][8] = {};
  // hs_prev slice (16 rows x 64 k) -> sa[kk][m], k fastest; dxg slice
  // (16 rows x 128 c) -> sb[kk][n], c fastest: 4 and 8 a thread
  auto load = [&](int n0, float (&ra)[4], float (&rb)[8]) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int i = tid + p * kThreads, n = n0 + i / kBM, k = m0 + i % kBM;
      const T* row =
          n < B ? h0 + (int64_t)n * Hin : ys + (int64_t)(n - B) * Hin;
      ra[p] = (n < rows && k < Hin) ? to_f32(row[k]) : 0.f;
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
    if (k >= Hin) continue;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int c = c0 + (q < 4 ? tu * 4 + q : 64 + tu * 4 + q - 4);
      if (c < H4) dwh[(int64_t)k * H4 + c] = acc[r][q];
    }
  }
}

// ------------------------------------------------- backward, bf16 (mma)
// The same three launches on the tensor cores: mma.sync m16n8k16 (bf16
// operands, f32 sums) fed by ldmatrix from padded bf16 slices that a
// cp.async ring keeps in flight. recurrent_load and recurrent_mma, the
// product h_{t-1}.wh, also carry the bf16 forward step.
using tc::bf16;

// A step tile's ring holds, a stage each, slices of both products: the
// recompute's (64 rows x 64 k of h_{t-1}, 64 k x 128 columns of wh) and
// the dh product's (64 rows x 128 c of dlin, 32 rows x 128 c of wh).
// One CTA an SM (the step grid is 128 CTAs), so the ring may take most
// of shared memory: six stages keep ~130 KB of loads in flight, what it
// takes to cover L2's latency at its bandwidth.
constexpr int kStepStages = 6;
constexpr int kSK = 64;                 // depth of a recompute slice
constexpr int kSKd = 128;               // depth of a dh-product slice
constexpr int kLdK = kSK + 8;           // padded rows (bf16): ldmatrix
constexpr int kLdKd = kSKd + 8;         // reads are conflict-free
constexpr int kLdN = kBN + 8;
constexpr int kStepStage =
    kBM * kLdK + kSK * kLdN > kBM * kLdKd + kBU * kLdKd
        ? kBM * kLdK + kSK * kLdN
        : kBM * kLdKd + kBU * kLdKd;
// the f32 epilogue staging that reuses the ring: lin (64 x 128) and the
// 4 k-split partials of dh (64 x 32), rows padded by 4 words
constexpr int kLdLin = kBN + 4, kLdDh = kBU + 4;
constexpr size_t kStepSmem =
    (size_t)kStepStages * kStepStage * sizeof(bf16);
static_assert((size_t)(kBM * kLdLin + 4 * kBM * kLdDh) * sizeof(float) <=
                  kStepSmem,
              "the epilogue staging fits in the ring");

// The ring: slices 0..n-1, each load(stage, slice) one committed cp.async
// group; compute(stage, slice) runs once its slice has landed, while the
// next S - 1 slices are in flight. One barrier a slice. On return every
// copy has landed and every warp is done with the ring.
template <int S, class Load, class Compute>
__device__ __forceinline__ void ring(int n, Load load, Compute compute) {
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < n) load(s, s);
    tc::cp_async_commit();
  }
  for (int s = 0; s < n; ++s) {
    tc::cp_async_wait<S - 2>();
    __syncthreads();  // slice s landed; every warp is done with s - 1
    const int next = s + S - 1;
    if (next < n) load(next % S, next);  // into s - 1's stage
    tc::cp_async_commit();
    compute(s % S, s);
  }
  tc::cp_async_wait<0>();
  __syncthreads();
}

__device__ __forceinline__ int clamp8(int n) { return max(0, min(8, n)); }

// The recurrent product h_{t-1}.wh of the step tile (b0, j0), slice by
// slice over k < Hin: 8 warps as 2 (rows) x 4 (gates), warp (wm, g)
// summing rows b0 + wm*32 + 16i, wh columns g*Hu + j0 + 8j.. into
// acc[i][j]; B comes from row-major wh through ldmatrix.trans. hp is
// (B, Hin), wh (Hin, 4Hu).
__device__ __forceinline__ void recurrent_load(
    bf16* st, const bf16* __restrict__ hp, const bf16* __restrict__ wh,
    int B, int Hin, int Hu, int b0, int j0, int k0, bool vec) {
  const int tid = threadIdx.x;
  const int64_t H4 = 4 * (int64_t)Hu;
  bf16* sb = st + kBM * kLdK;
#pragma unroll
  for (int p = 0; p < 2; ++p) {        // h_{t-1}: 64 rows x 8 chunks
    const int i = tid + p * kThreads, r = i >> 3, c = (i & 7) * 8;
    const int b = b0 + r, k = k0 + c;
    const int valid = b < B ? clamp8(Hin - k) : 0;
    tc::stage_chunk(st + r * kLdK + c,
                    valid ? hp + (int64_t)b * Hin + k : hp, valid, vec);
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {        // wh: 64 k x 16 chunks (4 gates)
    const int i = tid + p * kThreads, kr = i >> 4, cc = i & 15;
    const int g = cc >> 2, u = (cc & 3) * 8, k = k0 + kr, j = j0 + u;
    const int valid = k < Hin ? clamp8(Hu - j) : 0;
    tc::stage_chunk(sb + kr * kLdN + g * kBU + u,
                    valid ? wh + (int64_t)k * H4 + (int64_t)g * Hu + j : wh,
                    valid, vec);
  }
}

__device__ __forceinline__ void recurrent_mma(const bf16* st,
                                              float (&acc)[2][4][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const bf16* sb = st + kBM * kLdK;
#pragma unroll
  for (int kk = 0; kk < kSK / 16; ++kk) {
    uint32_t af[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      tc::ldsm_x4(af[i], st + (wm * 32 + i * 16 + tc::lane_mk_row(lane)) *
                                  kLdK +
                              kk * 16 + tc::lane_mk_col(lane));
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      uint32_t bfr[4];
      tc::ldsm_x4_t(bfr, sb + (kk * 16 + tc::lane_mk_row(lane)) * kLdN +
                             wn * kBU + p * 16 + tc::lane_mk_col(lane));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        tc::mma16816(acc[i][2 * p], af[i], bfr[0], bfr[1]);
        tc::mma16816(acc[i][2 * p + 1], af[i], bfr[2], bfr[3]);
      }
    }
  }
}

// The product d.wh^T that carries dh, for the step tile's rows and its
// 32 units j < Hr (rows of wh), slice by slice over c < H4; d is (B, H4),
// wh (Hr, H4) (H4 = 4H, Hr = H; the split form's partial product: 4Hu
// and Hin). The rows of wh are the col-major B that mma wants (plain
// ldmatrix). 8 warps as 2 (rows) x 4 (k16 steps kq and kq + 4 of a
// slice), warp (wm, kq) summing rows b0 + wm*32 + 16i, units j0 + 8j..
// into dacc[i][j]: the 4 partials meet in dh_partials_to_smem.
__device__ __forceinline__ void dh_load(bf16* st, const bf16* __restrict__ d,
                                        const bf16* __restrict__ wh, int B,
                                        int Hr, int H4, int b0, int j0,
                                        int c0, bool vec) {
  const int tid = threadIdx.x;
  bf16* sw = st + kBM * kLdKd;
#pragma unroll
  for (int p = 0; p < 4; ++p) {        // dlin: 64 rows x 16 chunks
    const int i = tid + p * kThreads, r = i >> 4, c = (i & 15) * 8;
    const int b = b0 + r;
    const int valid = b < B ? clamp8(H4 - (c0 + c)) : 0;
    tc::stage_chunk(st + r * kLdKd + c,
                    valid ? d + (int64_t)b * H4 + c0 + c : d, valid, vec);
  }
#pragma unroll
  for (int p = 0; p < 2; ++p) {        // wh rows: 32 units x 16 chunks
    const int i = tid + p * kThreads, r = i >> 4, c = (i & 15) * 8;
    const int j = j0 + r;
    const int valid = j < Hr ? clamp8(H4 - (c0 + c)) : 0;
    tc::stage_chunk(sw + r * kLdKd + c,
                    valid ? wh + (int64_t)j * H4 + c0 + c : wh, valid, vec);
  }
}

__device__ __forceinline__ void dh_mma(const bf16* st,
                                       float (&dacc)[2][4][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 1, kq = warp >> 1;
  const bf16* sw = st + kBM * kLdKd;
#pragma unroll
  for (int h = 0; h < kSKd / 64; ++h) {
    const int kk = kq + 4 * h;
    uint32_t af[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      tc::ldsm_x4(af[i], st + (wm * 32 + i * 16 + tc::lane_mk_row(lane)) *
                                  kLdKd +
                              kk * 16 + tc::lane_mk_col(lane));
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      uint32_t bfr[4];
      tc::ldsm_x4(bfr, sw + (p * 16 + tc::lane_km_row(lane)) * kLdKd +
                           kk * 16 + tc::lane_km_col(lane));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        tc::mma16816(dacc[i][2 * p], af[i], bfr[0], bfr[1]);
        tc::mma16816(dacc[i][2 * p + 1], af[i], bfr[2], bfr[3]);
      }
    }
  }
}

// (row, column) of element e of C fragment [i][j] in a warp's 32 x 32
// block: rows i*16 + gid (+8 for e >= 2), columns j*8 + 2tig + (e & 1)
__device__ __forceinline__ int frag_row(int i, int e) {
  return i * 16 + ((threadIdx.x & 31) >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int frag_col(int j, int e) {
  return j * 8 + 2 * (threadIdx.x & 3) + (e & 1);
}

// dh partials of dh_mma to shared memory, [kq][64][kLdDh] f32
__device__ __forceinline__ void dh_partials_to_smem(
    float* sdh, const float (&dacc)[2][4][4]) {
  const int warp = threadIdx.x >> 5, wm = warp & 1, kq = warp >> 1;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sdh[(kq * kBM + wm * 32 + frag_row(i, e)) * kLdDh + frag_col(j, e)] =
            dacc[i][j][e];
}

__device__ __forceinline__ float dh_sum(const float* sdh, int r, int u) {
  return sdh[r * kLdDh + u] + sdh[(kBM + r) * kLdDh + u] +
         sdh[(2 * kBM + r) * kLdDh + u] + sdh[(3 * kBM + r) * kLdDh + u];
}

// One reverse step t, as lstm_bwd_step_kernel: the dh product (none
// in the split form, which adds dh_add), then the gate recompute, both
// on the tensor cores; the f32 sums meet in shared memory so that one
// thread holds i, f, g, o and dh of a (row, unit).
__global__ void __launch_bounds__(kThreads, 1) lstm_bwd_step_mma_kernel(
    const bf16* __restrict__ xg, const bf16* __restrict__ wh,
    const bf16* __restrict__ hp, const float* __restrict__ cp,
    const float* __restrict__ cs, const bf16* __restrict__ dys,
    const bf16* __restrict__ dnext, const float* __restrict__ dh_add,
    bf16* __restrict__ dxg, float* __restrict__ dc, int B, int Hin, int Hu,
    int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring_smem = reinterpret_cast<bf16*>(smem_raw);
  const int b0 = blockIdx.y * kBM, j0 = blockIdx.x * kBU;
  float dacc[2][4][4] = {}, acc[2][4][4] = {};
  // one ring over both products: the dh product's slices (none at
  // t = T-1), then the recompute's, with no drain between them
  const int n_dh = dnext != nullptr ? (4 * Hu + kSKd - 1) / kSKd : 0;
  ring<kStepStages>(
      n_dh + (Hin + kSK - 1) / kSK,
      [&](int st, int sl) {
        bf16* s = ring_smem + st * kStepStage;
        if (sl < n_dh)
          dh_load(s, dnext, wh, B, Hin, 4 * Hu, b0, j0, sl * kSKd, vec);
        else
          recurrent_load(s, hp, wh, B, Hin, Hu, b0, j0, (sl - n_dh) * kSK,
                         vec);
      },
      [&](int st, int sl) {
        const bf16* s = ring_smem + st * kStepStage;
        if (sl < n_dh)
          dh_mma(s, dacc);
        else
          recurrent_mma(s, acc);
      });
  // the ring is drained: stage the sums in its place
  float* slin = reinterpret_cast<float*>(smem_raw);
  float* sdh = slin + kBM * kLdLin;
  const int warp = threadIdx.x >> 5, wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        slin[(wm * 32 + frag_row(i, e)) * kLdLin + wn * kBU +
             frag_col(j, e)] = acc[i][j][e];
  dh_partials_to_smem(sdh, dacc);
  __syncthreads();
  const int64_t H4 = 4 * (int64_t)Hu;
  for (int idx = threadIdx.x; idx < kBM * kBU; idx += kThreads) {
    const int r = idx / kBU, u = idx % kBU, b = b0 + r, j = j0 + u;
    if (b >= B || j >= Hu) continue;
    const float* lin = slin + r * kLdLin + u;
    const bf16* x = xg + (int64_t)b * H4 + j;
    const float i = sigmoid(to_f32(x[0]) + lin[0]);
    const float f = sigmoid(to_f32(x[Hu]) + lin[kBU]);
    const float g = tanhf(to_f32(x[2 * Hu]) + lin[2 * kBU]);
    const float o = sigmoid(to_f32(x[3 * Hu]) + lin[3 * kBU]);
    const int64_t idx2 = (int64_t)b * Hu + j;
    const float tanh_c = tanhf(cs[idx2]);
    const float dh = to_f32(dys[idx2]) +
                     (dh_add != nullptr ? dh_add[idx2] : dh_sum(sdh, r, u));
    const float dcv = dh * o * (1.f - tanh_c * tanh_c) + dc[idx2];
    const float dov = dh * tanh_c;
    const float di = dcv * g, dg = dcv * i, df = dcv * cp[idx2];
    bf16* dx = dxg + (int64_t)b * H4 + j;
    dx[0] = __float2bfloat16(di * i * (1.f - i));
    dx[Hu] = __float2bfloat16(df * f * (1.f - f));
    dx[2 * Hu] = __float2bfloat16(dg * (1.f - g * g));
    dx[3 * Hu] = __float2bfloat16(dov * o * (1.f - o));
    dc[idx2] = dcv * f;
  }
}

// dh = d.wh^T with the dh product's slices, f32 (B, Hin): dh0 of the
// whole-H walk, the split form's partial product (as lstm_dh0_kernel)
__global__ void __launch_bounds__(kThreads, 1)
    lstm_dh0_mma_kernel(const bf16* __restrict__ d,
                        const bf16* __restrict__ wh,
                        float* __restrict__ dh0, int B, int Hin, int Hu,
                        int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring_smem = reinterpret_cast<bf16*>(smem_raw);
  const int b0 = blockIdx.y * kBM, j0 = blockIdx.x * kBU;
  float dacc[2][4][4] = {};
  ring<kStepStages>(
      (4 * Hu + kSKd - 1) / kSKd,
      [&](int st, int sl) {
        dh_load(ring_smem + st * kStepStage, d, wh, B, Hin, 4 * Hu, b0, j0,
                sl * kSKd, vec);
      },
      [&](int st, int) { dh_mma(ring_smem + st * kStepStage, dacc); });
  float* sdh = reinterpret_cast<float*>(smem_raw);
  dh_partials_to_smem(sdh, dacc);
  __syncthreads();
  for (int idx = threadIdx.x; idx < kBM * kBU; idx += kThreads) {
    const int r = idx / kBU, u = idx % kBU, b = b0 + r, j = j0 + u;
    if (b < B && j < Hin) dh0[(int64_t)b * Hin + j] = dh_sum(sdh, r, u);
  }
}

// dwh = hs_prev^T.dxg over the T*B rows, f32 (Hin, 4Hu), on the tensor
// cores: a 128 (k) x 128 (c) tile a CTA, slices of 32 rows; both
// operands are row-major over the summed rows, so both come through
// ldmatrix.trans. 8 warps as 2 (64 k) x 4 (32 c).
constexpr int kWM = 128, kWN = 128, kWK = 32;
constexpr int kLdW128 = 128 + 8;
constexpr int kDwhStage = 2 * kWK * kLdW128;
constexpr int kDwhStages = 3;  // 2 CTAs an SM, each a 3-stage ring
constexpr size_t kDwhSmem = (size_t)kDwhStages * kDwhStage * sizeof(bf16);

__global__ void __launch_bounds__(kThreads)
    lstm_dwh_mma_kernel(const bf16* __restrict__ h0,
                        const bf16* __restrict__ ys,
                        const bf16* __restrict__ dxg,
                        float* __restrict__ dwh, int rows, int B, int Hin,
                        int Hu, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring_smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * kWM, c0 = blockIdx.x * kWN;
  const int H4 = 4 * Hu;
  float acc[4][4][4] = {};
  auto load = [&](int st, int sl) {
    bf16* sa = ring_smem + st * kDwhStage;
    bf16* sb = sa + kWK * kLdW128;
    const int n0 = sl * kWK;
#pragma unroll
    for (int p = 0; p < 2; ++p) {      // 32 rows x 16 chunks each
      const int i = tid + p * kThreads, rr = i >> 4, cc = (i & 15) * 8;
      const int n = n0 + rr;
      const bf16* hrow = n < B ? h0 + (int64_t)n * Hin
                               : ys + (int64_t)(n - B) * Hin;
      const int va = n < rows ? clamp8(Hin - (m0 + cc)) : 0;
      tc::stage_chunk(sa + rr * kLdW128 + cc, va ? hrow + m0 + cc : h0, va,
                      vec);
      const int vb = n < rows ? clamp8(H4 - (c0 + cc)) : 0;
      tc::stage_chunk(sb + rr * kLdW128 + cc,
                      vb ? dxg + (int64_t)n * H4 + c0 + cc : dxg, vb, vec);
    }
  };
  auto compute = [&](int st, int) {
    const bf16* sa = ring_smem + st * kDwhStage;
    const bf16* sb = sa + kWK * kLdW128;
#pragma unroll
    for (int kk = 0; kk < kWK / 16; ++kk) {
      uint32_t af[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        tc::ldsm_x4_t(af[i], sa + (kk * 16 + tc::lane_km_row(lane)) *
                                      kLdW128 +
                                  wm * 64 + i * 16 + tc::lane_km_col(lane));
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t bfr[4];
        tc::ldsm_x4_t(bfr, sb + (kk * 16 + tc::lane_mk_row(lane)) * kLdW128 +
                               wn * 32 + p * 16 + tc::lane_mk_col(lane));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          tc::mma16816(acc[i][2 * p], af[i], bfr[0], bfr[1]);
          tc::mma16816(acc[i][2 * p + 1], af[i], bfr[2], bfr[3]);
        }
      }
    }
  };
  ring<kDwhStages>((rows + kWK - 1) / kWK, load, compute);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int k = m0 + wm * 64 + frag_row(i, e);
        const int c = c0 + wn * 32 + frag_col(j, e);  // even; 4H is even
        if (k < Hin && c < H4)
          *reinterpret_cast<float2*>(dwh + (int64_t)k * H4 + c) =
              make_float2(acc[i][j][e], acc[i][j][e + 1]);
      }
}

// ------------------------------------------------- forward, bf16 (mma)
// One time step on the tensor cores: the recurrent product h_{t-1}.wh
// through recurrent_load and recurrent_mma (8 warps as 2 rows x 4
// gates), then the f32 sums staged in shared memory where the ring was,
// so that one thread holds i, f, g, o of a (row, unit), and the gate
// math of lstm_fwd_step_kernel with its rounding points: h_{t-1} enters
// in bf16 (ys_{t-1}, or h0), ys is written in bf16 and cs in f32. The
// forward has no dh product, so a stage holds only the recurrent
// product's slices (26 KB). On an H100 the depth of the ring and of a
// slice hardly moved a step (8, 6, 4 or 3 stages of 64- or 128-deep
// slices, and 8 of 32, within 5%): four stages of 64. What did move it
// was issuing the epilogue's own device-memory reads (xg_t and c_{t-1})
// before the ring: 1.20 -> 0.86 ms a 40-step call
// (tools/torch_kernel_time.py and its A/B copies).
constexpr int kFwdStage = kBM * kLdK + kSK * kLdN;
constexpr int kFwdStages = 4;
constexpr size_t kFwdSmem = (size_t)kFwdStages * kFwdStage * sizeof(bf16);
static_assert((size_t)kBM * kLdLin * sizeof(float) <= kFwdSmem,
              "the epilogue staging fits in the ring");
static_assert(kFwdSmem <= 232448, "the ring fits an SM's shared memory");

__global__ void __launch_bounds__(kThreads, 1) lstm_fwd_step_mma_kernel(
    const bf16* __restrict__ xg, const bf16* __restrict__ wh,
    const bf16* __restrict__ hp, const float* __restrict__ cp,
    bf16* __restrict__ ys, float* __restrict__ cs, int B, int Hin, int Hu,
    int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring_smem = reinterpret_cast<bf16*>(smem_raw);
  const int b0 = blockIdx.y * kBM, j0 = blockIdx.x * kBU;
  // the epilogue's operands — the four gate inputs and the cell carry of
  // this thread's 8 (row, unit) outputs — are loaded before the ring, so
  // their device-memory latency hides behind the product
  constexpr int kOut = kBM * kBU / kThreads;
  float xin[kOut][4], cin[kOut];
  const int64_t H4 = 4 * (int64_t)Hu;
#pragma unroll
  for (int k = 0; k < kOut; ++k) {
    const int idx = threadIdx.x + k * kThreads;
    const int r = idx / kBU, u = idx % kBU, b = b0 + r, j = j0 + u;
    const bool in = b < B && j < Hu;
    const bf16* x = xg + (int64_t)b * H4 + j;
#pragma unroll
    for (int g = 0; g < 4; ++g) xin[k][g] = in ? to_f32(x[g * Hu]) : 0.f;
    cin[k] = in ? cp[(int64_t)b * Hu + j] : 0.f;
  }
  float acc[2][4][4] = {};
  ring<kFwdStages>(
      (Hin + kSK - 1) / kSK,
      [&](int st, int sl) {
        recurrent_load(ring_smem + st * kFwdStage, hp, wh, B, Hin, Hu, b0,
                       j0, sl * kSK, vec);
      },
      [&](int st, int) { recurrent_mma(ring_smem + st * kFwdStage, acc); });
  // the ring is drained: stage the sums in its place
  float* slin = reinterpret_cast<float*>(smem_raw);
  const int warp = threadIdx.x >> 5, wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        slin[(wm * 32 + frag_row(i, e)) * kLdLin + wn * kBU +
             frag_col(j, e)] = acc[i][j][e];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kOut; ++k) {
    const int idx = threadIdx.x + k * kThreads;
    const int r = idx / kBU, u = idx % kBU, b = b0 + r, j = j0 + u;
    if (b >= B || j >= Hu) continue;
    const float* lin = slin + r * kLdLin + u;
    const float i = sigmoid(xin[k][0] + lin[0]);
    const float f = sigmoid(xin[k][1] + lin[kBU]);
    const float g = tanhf(xin[k][2] + lin[2 * kBU]);
    const float o = sigmoid(xin[k][3] + lin[3 * kBU]);
    const int64_t idx2 = (int64_t)b * Hu + j;
    const float c = f * cin[k] + i * g;
    ys[idx2] = __float2bfloat16(o * tanhf(c));
    cs[idx2] = c;
  }
}


// The shared memory each tensor-core kernel asks for past 48 KB.
cudaError_t set_smem_limits() {
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(lstm_fwd_step_mma_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)kFwdSmem)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(lstm_bwd_step_mma_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)kStepSmem)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(lstm_dh0_mma_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)kStepSmem)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(lstm_dwh_mma_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)kDwhSmem)) != cudaSuccess)
    return e;
  return cudaSuccess;
}

// 16-byte copies when every row and every gate block starts 16-byte
// aligned: Hin and Hu multiples of 8 (the arrays themselves come from
// the caching allocator)
int vec_ok(int Hin, int Hu) { return Hin % 8 == 0 && Hu % 8 == 0; }

dim3 step_grid(int B, int Hu) {
  return dim3((Hu + kBU - 1) / kBU, (B + kBM - 1) / kBM);
}

// One forward step of B rows: xg (B, 4Hu), wh (Hin, 4Hu), hp (B, Hin) in
// T; cp (B, Hu) f32 in; ys (B, Hu) in T and cs (B, Hu) f32 out.
template <typename T>
cudaError_t fwd_step(const T* xg, const T* wh, const T* hp, const float* cp,
                     T* ys, float* cs, int B, int Hin, int Hu,
                     cudaStream_t stream, int* launched) {
  if constexpr (std::is_same_v<T, bf16>) {
    lstm_fwd_step_mma_kernel<<<step_grid(B, Hu), kThreads, kFwdSmem,
                               stream>>>(xg, wh, hp, cp, ys, cs, B, Hin, Hu,
                                         vec_ok(Hin, Hu));
  } else {  // f32: the CUDA-core kernel, exact f32 sums
    lstm_fwd_step_kernel<T><<<step_grid(B, Hu), kThreads, 0, stream>>>(
        xg, wh, hp, cp, ys, cs, B, Hin, Hu);
  }
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) ++*launched;
  return e;
}

// One reverse step: the dh carry from dnext's product (whole H) or the
// addend dh_add (split form), either may be null (t = T-1).
template <typename T>
cudaError_t bwd_step(const T* xg, const T* wh, const T* hp, const float* cp,
                     const float* cs, const T* dys, const T* dnext,
                     const float* dh_add, T* dxg, float* dc, int B, int Hin,
                     int Hu, cudaStream_t stream, int* launched) {
  if constexpr (std::is_same_v<T, bf16>) {
    lstm_bwd_step_mma_kernel<<<step_grid(B, Hu), kThreads, kStepSmem,
                               stream>>>(xg, wh, hp, cp, cs, dys, dnext,
                                         dh_add, dxg, dc, B, Hin, Hu,
                                         vec_ok(Hin, Hu));
  } else {
    lstm_bwd_step_kernel<T><<<step_grid(B, Hu), kThreads, 0, stream>>>(
        xg, wh, hp, cp, cs, dys, dnext, dh_add, dxg, dc, B, Hin, Hu);
  }
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) ++*launched;
  return e;
}

// out (B, Hin) f32 = d (B, 4Hu) . wh^T (wh (Hin, 4Hu)).
template <typename T>
cudaError_t dh_partial(const T* d, const T* wh, float* out, int B, int Hin,
                       int Hu, cudaStream_t stream, int* launched) {
  const dim3 grid((Hin + kBU - 1) / kBU, (B + kBM - 1) / kBM);
  if constexpr (std::is_same_v<T, bf16>) {
    lstm_dh0_mma_kernel<<<grid, kThreads, kStepSmem, stream>>>(
        d, wh, out, B, Hin, Hu, vec_ok(Hin, Hu));
  } else {
    lstm_dh0_kernel<T><<<grid, kThreads, 0, stream>>>(d, wh, out, B, Hin,
                                                       Hu);
  }
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) ++*launched;
  return e;
}

// dwh (Hin, 4Hu) f32 over the Tn*B rows: h_{t-1} from h0 (B, Hin) and
// ys (Tn, B, Hin), dlin from dxg (Tn, B, 4Hu).
template <typename T>
cudaError_t dwh_sum(const T* h0, const T* ys, const T* dxg, float* dwh,
                    int Tn, int B, int Hin, int Hu, cudaStream_t stream,
                    int* launched) {
  if constexpr (std::is_same_v<T, bf16>) {
    const dim3 wgrid((4 * Hu + kWN - 1) / kWN, (Hin + kWM - 1) / kWM);
    lstm_dwh_mma_kernel<<<wgrid, kThreads, kDwhSmem, stream>>>(
        h0, ys, dxg, dwh, Tn * B, B, Hin, Hu, vec_ok(Hin, Hu));
  } else {
    const dim3 wgrid((4 * Hu + kBN - 1) / kBN, (Hin + kBM - 1) / kBM);
    lstm_dwh_kernel<T><<<wgrid, kThreads, 0, stream>>>(h0, ys, dxg, dwh,
                                                        Tn * B, B, Hin, Hu);
  }
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) ++*launched;
  return e;
}

// The whole-H walks: every step reads h_{t-1} from ys (h0 at t = 0).
template <typename T>
cudaError_t fwd(const void* xg_, const void* wh_, const void* h0_,
                const float* c0, void* ys_, float* cs, int Tn, int B, int H,
                cudaStream_t stream, int* launched) {
  const T* xg = static_cast<const T*>(xg_);
  const T* wh = static_cast<const T*>(wh_);
  const T* h0 = static_cast<const T*>(h0_);
  T* ys = static_cast<T*>(ys_);
  const int64_t bh = (int64_t)B * H, bh4 = 4 * bh;
  cudaError_t e;
  for (int t = 0; t < Tn; ++t) {
    const T* hp = t == 0 ? h0 : ys + (t - 1) * bh;
    const float* cp = t == 0 ? c0 : cs + (t - 1) * bh;
    if ((e = fwd_step<T>(xg + t * bh4, wh, hp, cp, ys + t * bh, cs + t * bh,
                         B, H, H, stream, launched)) != cudaSuccess)
      return e;
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
  cudaError_t e;
  for (int t = Tn - 1; t >= 0; --t) {
    const T* hp = t == 0 ? h0 : ys + (t - 1) * bh;
    const float* cp = t == 0 ? c0 : cs + (t - 1) * bh;
    const T* dnext = t + 1 < Tn ? dxg + (t + 1) * bh4 : nullptr;
    if ((e = bwd_step<T>(xg + t * bh4, wh, hp, cp, cs + t * bh, dys + t * bh,
                         dnext, nullptr, dxg + t * bh4, dc, B, H, H, stream,
                         launched)) != cudaSuccess)
      return e;
  }
  if ((e = dh_partial<T>(dxg, wh, dh0, B, H, H, stream, launched)) !=
      cudaSuccess)
    return e;
  return dwh_sum<T>(h0, ys, dxg, dwh, Tn, B, H, H, stream, launched);
}

// T*B*4Hu and (Hin, 4Hu) index within int64 offsets; T*B rows and the
// grids within int
bool valid(int Tn, int B, int Hin, int Hu) {
  return Tn >= 1 && B >= 1 && Hin >= 1 && Hu >= 1 &&
         (int64_t)Tn * B < (1LL << 31) && 4LL * Hu < (1LL << 31) &&
         (B + kBM - 1) / kBM <= 65535 && (Hin + kBM - 1) / kBM <= 65535;
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
  if (!valid(Tn, B, H, H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if ((e = set_smem_limits()) != cudaSuccess) return (int)e;
  if (dtype == 0)
    return (int)fwd<float>(xg, wh, h0, c0, ys, cs, Tn, B, H, s, launched);
  if (dtype == 1)
    return (int)fwd<bf16>(xg, wh, h0, c0, ys, cs, Tn, B, H, s, launched);
  return (int)cudaErrorInvalidValue;
}

extern "C" int lstm_bwd_launch(int dtype, const void* xg, const void* wh,
                               const void* h0, const float* c0,
                               const void* ys, const float* cs,
                               const void* dys, void* dxg, float* dwh,
                               float* dh0, float* dc0, int Tn, int B, int H,
                               void* stream, int* launched) {
  if (!valid(Tn, B, H, H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if ((e = set_smem_limits()) != cudaSuccess) return (int)e;
  if (dtype == 0)
    return (int)bwd<float>(xg, wh, h0, c0, ys, cs, dys, dxg, dwh, dh0, dc0,
                           Tn, B, H, s, launched);
  if (dtype == 1)
    return (int)bwd<bf16>(xg, wh, h0, c0, ys, cs, dys, dxg, dwh, dh0, dc0,
                          Tn, B, H, s, launched);
  return (int)cudaErrorInvalidValue;
}

// The split form's launchers: one step, or one product, a call, so that
// the caller can run a collective between two steps. A rank holds the
// [i, f, g, o] columns of its Hu hidden units: xg_t (B, 4Hu), wh
// (Hin, 4Hu), and h_{t-1} (B, Hin) from the gathered history, all in
// the dtype; cp, cs_t, dc, dh_add (B, Hu) f32. With Hin == Hu these are
// the whole-H walks' kernels on the same arguments.
extern "C" int lstm_fwd_step_launch(int dtype, const void* xg,
                                    const void* wh, const void* hp,
                                    const float* cp, void* ys, float* cs,
                                    int B, int Hin, int Hu, void* stream,
                                    int* launched) {
  if (!valid(1, B, Hin, Hu)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if ((e = set_smem_limits()) != cudaSuccess) return (int)e;
  if (dtype == 0)
    return (int)fwd_step<float>(
        static_cast<const float*>(xg), static_cast<const float*>(wh),
        static_cast<const float*>(hp), cp, static_cast<float*>(ys), cs, B,
        Hin, Hu, s, launched);
  if (dtype == 1)
    return (int)fwd_step<bf16>(
        static_cast<const bf16*>(xg), static_cast<const bf16*>(wh),
        static_cast<const bf16*>(hp), cp, static_cast<bf16*>(ys), cs, B, Hin,
        Hu, s, launched);
  return (int)cudaErrorInvalidValue;
}

// dh = dys_t + dh_add (the rank's block of the summed partial products;
// null at t = T-1); writes dxg_t (B, 4Hu) and updates the dc carry.
extern "C" int lstm_bwd_step_launch(int dtype, const void* xg,
                                    const void* wh, const void* hp,
                                    const float* cp, const float* cs,
                                    const void* dys, const float* dh_add,
                                    void* dxg, float* dc, int B, int Hin,
                                    int Hu, void* stream, int* launched) {
  if (!valid(1, B, Hin, Hu)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if ((e = set_smem_limits()) != cudaSuccess) return (int)e;
  if (dtype == 0)
    return (int)bwd_step<float>(
        static_cast<const float*>(xg), static_cast<const float*>(wh),
        static_cast<const float*>(hp), cp, cs,
        static_cast<const float*>(dys), nullptr, dh_add,
        static_cast<float*>(dxg), dc, B, Hin, Hu, s, launched);
  if (dtype == 1)
    return (int)bwd_step<bf16>(
        static_cast<const bf16*>(xg), static_cast<const bf16*>(wh),
        static_cast<const bf16*>(hp), cp, cs, static_cast<const bf16*>(dys),
        nullptr, dh_add, static_cast<bf16*>(dxg), dc, B, Hin, Hu, s,
        launched);
  return (int)cudaErrorInvalidValue;
}

// The partial dh_{t-1} of a rank: out (B, Hin) f32 = d (B, 4Hu) . wh^T,
// d = dxg_t in the dtype (dlin_t as the kernel rounded it).
extern "C" int lstm_dh_partial_launch(int dtype, const void* d,
                                      const void* wh, float* out, int B,
                                      int Hin, int Hu, void* stream,
                                      int* launched) {
  if (!valid(1, B, Hin, Hu)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if ((e = set_smem_limits()) != cudaSuccess) return (int)e;
  if (dtype == 0)
    return (int)dh_partial<float>(static_cast<const float*>(d),
                                  static_cast<const float*>(wh), out, B, Hin,
                                  Hu, s, launched);
  if (dtype == 1)
    return (int)dh_partial<bf16>(static_cast<const bf16*>(d),
                                 static_cast<const bf16*>(wh), out, B, Hin,
                                 Hu, s, launched);
  return (int)cudaErrorInvalidValue;
}

// A rank's dwh (Hin, 4Hu) f32: h_{t-1} from h0 (B, Hin) and the gathered
// history (T, B, Hin), dlin from dxg (T, B, 4Hu).
extern "C" int lstm_dwh_launch(int dtype, const void* h0, const void* hist,
                               const void* dxg, float* dwh, int Tn, int B,
                               int Hin, int Hu, void* stream, int* launched) {
  if (!valid(Tn, B, Hin, Hu)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if ((e = set_smem_limits()) != cudaSuccess) return (int)e;
  if (dtype == 0)
    return (int)dwh_sum<float>(
        static_cast<const float*>(h0), static_cast<const float*>(hist),
        static_cast<const float*>(dxg), dwh, Tn, B, Hin, Hu, s, launched);
  if (dtype == 1)
    return (int)dwh_sum<bf16>(
        static_cast<const bf16*>(h0), static_cast<const bf16*>(hist),
        static_cast<const bf16*>(dxg), dwh, Tn, B, Hin, Hu, s, launched);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* lstm_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
