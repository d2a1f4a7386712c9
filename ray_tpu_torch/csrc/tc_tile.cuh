// Tensor-core tile primitives for Hopper (sm_90a), shared by the flash
// attention kernels that run their products on the tensor cores.
//
// - cp.async: 16-byte copies from device to shared memory that run while the
//   issuing warp computes, with zero-fill for rows past a tensor's end
//   (src-size 0: nothing is read, 16 zero bytes are written), grouped by
//   commit and awaited by wait_group; 4-byte copies for f32 statistics.
// - ldmatrix: four 8 x 8 bf16 matrices from shared memory into the fragment
//   layout of mma.sync, plain (rows of the stored tile are the fragment's
//   rows) or .trans (transposed on the way).
// - mma.sync m16n8k16 with bf16 inputs and f32 accumulators: D += A * B with
//   A 16 x 16 row-major and B 16 x 8 column-major. Lane l = 4 g + t holds
//     A: a0 (row g, cols 2t, 2t+1), a1 (row g+8, same cols),
//        a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, cols 2t+8, 2t+9);
//     B: b0 (rows 2t, 2t+1, col g), b1 (rows 2t+8, 2t+9, col g);
//     C: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, same cols).
//   So the C fragments of two neighbouring n8 tiles, packed to bf16 pairs,
//   are the A fragment of a product over their 16 columns: a score tile
//   feeds the next product from registers.
// - quad reductions: the four lanes 4g .. 4g+3 hold one row of a C fragment.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace tc_tile {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to dst (shared) if valid, else 16 zero bytes; src must
// be a readable address either way.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes, for rows of f32 statistics whose start need not be 16-byte
// aligned; zero-filled as above.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Lane l gives the address of row l % 8 of matrix l / 8 (16 bytes each).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// c += a * b on the tensor cores: m16n8k16, bf16 in, f32 sums.
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to bf16 and packed, lo in the low half: the element
// order of a fragment register.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 2^x on the special-function unit (relative error about 2^-22; results
// below 2^-126 flush to 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace tc_tile
