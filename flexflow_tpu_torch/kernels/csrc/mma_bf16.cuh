// bf16 tensor-core building blocks (sm_80 and later, built for sm_90a):
// 16- and 4-byte cp.async copies into shared memory, ldmatrix fragment loads,
// and the warp-wide mma.sync m16n8k16 product with bf16 operands and
// f32 accumulators. Shared by flash_attention.cu and lstm_scan.cu; the
// paged kernels (paged_ragged_v2.cu, paged_decode.cu) take its copies.
//
// Fragments of m16n8k16 (lane = 4 * gid + tig, gid = lane / 4,
// tig = lane % 4), two bf16 a register, the lower column in the low half:
//   A (16 x 16): a0 (row gid, cols 2tig, 2tig+1), a1 (row gid+8, same),
//                a2 (row gid, cols 2tig+8, +9), a3 (row gid+8, same);
//   B (16 x 8):  b0 (rows 2tig, 2tig+1 of column gid), b1 (rows +8);
//   C (16 x 8):  c0, c1 (row gid, cols 2tig, 2tig+1), c2, c3 (row gid+8).
// The C fragments of two neighbouring n8 tiles are, packed to bf16, the
// A fragment of a k16 step: {c0c1, c2c3} of tile 0 and of tile 1.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without passing through registers; the
// bytes past `bytes` (all 16 when it is 0) are filled with zeros, and
// nothing is read past `bytes`
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}
// 4 bytes (one f32) global -> shared, zero filled past `bytes` (0 or 4)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One 16-byte chunk of a page row into shared memory: `valid` elements
// of type T from src, zeros after them. vec: src is 16-byte aligned and
// valid is 0 or the whole chunk — one cp.async (zero filled when 0);
// otherwise byte by byte (head slices that do not start 16-byte
// aligned).
template <typename T>
__device__ __forceinline__ void stage_row_chunk(unsigned char* dst,
                                                const T* src, int valid,
                                                bool vec) {
  if (vec) {
    cp_async16(dst, src, valid > 0 ? 16 : 0);
    return;
  }
  const unsigned char* s = reinterpret_cast<const unsigned char*>(src);
  const int nbytes = valid * (int)sizeof(T);
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t x = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (4 * k + b < nbytes) x |= (uint32_t)s[4 * k + b] << (8 * b);
    w[k] = x;
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// One 16-byte chunk (8 bf16) of a row into shared memory, `valid` of
// its elements from src and zeros after them. vec: src is 16-byte
// aligned and valid is 0 or 8 — one cp.async; otherwise element by
// element (rows whose start is not 16-byte aligned).
__device__ __forceinline__ void stage_chunk(bf16* dst, const bf16* src,
                                            int valid, bool vec) {
  if (vec) {
    cp_async16(dst, src, valid > 0 ? 16 : 0);
    return;
  }
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t lo = 2 * e < valid ? s[2 * e] : 0u;
    const uint32_t hi = 2 * e + 1 < valid ? s[2 * e + 1] : 0u;
    w[e] = lo | (hi << 16);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// ldmatrix.x4: four 8 x 8 bf16 matrices, lanes 8i..8i+7 giving the row
// addresses of matrix i, register i of every lane receiving matrix i
// (transposed with .trans). Where each lane points, as (row, column)
// offsets into a 16 x 16 block of a row-major tile:
//   lane_mk: A from an [m][k] tile, or B from a [k][n] tile with .trans
//            -> a0..a3, or b0, b1 of n8 tile 0, b0, b1 of n8 tile 1;
//   lane_km: A from a [k][m] tile with .trans, or B from an [n][k] tile
//            -> the same registers.
__device__ __forceinline__ int lane_mk_row(int lane) { return lane & 15; }
__device__ __forceinline__ int lane_mk_col(int lane) {
  return (lane >> 4) << 3;
}
__device__ __forceinline__ int lane_km_row(int lane) {
  return (lane & 7) | ((lane >> 4) << 3);
}
__device__ __forceinline__ int lane_km_col(int lane) {
  return ((lane >> 3) & 1) << 3;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a.b on the tensor cores: a 16 x 16 bf16, b 16 x 8 bf16, c f32
__device__ __forceinline__ void mma16816(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16 and packed, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace tc
