// The flash-decode block body shared by decode_attention.cu (K6, contiguous
// cache) and paged_decode_attention.cu (K7, paged pool). The two kernels
// differ only in where logical cache row s lives, which each passes in as a
// Rows object; the tiles, their order and the arithmetic are one copy, so K7
// on a page table gives K6's bits on the same rows laid out contiguously.
//
// One block holds the G query heads of one (sequence, kv head) as rows and
// walks logical cache rows 0..length (inclusive) in tiles of TK = 64. Tiles
// come in with 16-byte loads, are widened to f32 in shared memory (K rows
// padded by one word so the per-key dot products are free of bank
// conflicts), and the online softmax keeps its running max, sum and
// accumulator in f32. As in the Pallas kernel, scores are scaled after the
// f32 dot product, masked positions score NEG_INF = -1e30, the
// probabilities enter the PV product rounded to the cache's dtype, and the
// final division clamps the sum at 1e-30.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace decode_tile {

constexpr int TK = 64;          // cache rows per tile
constexpr int THREADS = 128;    // threads per block
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__host__ __device__ constexpr size_t smem_floats(int G, int D) {
  // q, acc [G][D]; k tile [TK][D+1]; v tile [TK][D]; p [G][TK]; m, l, corr [G]
  return (size_t)2 * G * D + (size_t)TK * (D + 1) + (size_t)TK * D +
         (size_t)G * TK + 3 * (size_t)G;
}

// qb, ob: the block's G query heads, [G][D] contiguous. kb, vb: the block's
// kv head in row 0's page or sequence; rows.k(s) / rows.v(s) give logical
// row s's offset from them, in elements. length: the inclusive last row,
// already clamped to the rows the caller may read. smem: smem_floats(G, D)
// floats of dynamic shared memory.
template <typename T, int D, typename Rows>
__device__ __forceinline__ void decode_block(
    const T* __restrict__ qb, T* __restrict__ ob, const T* __restrict__ kb,
    const T* __restrict__ vb, const Rows& rows, int length, int G,
    float scale, float* smem) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int KP = D + 1;
  float* q_s = smem;
  float* acc_s = q_s + G * D;
  float* k_s = acc_s + G * D;
  float* v_s = k_s + TK * KP;
  float* p_s = v_s + TK * D;
  float* m_s = p_s + G * TK;
  float* l_s = m_s + G;
  float* c_s = l_s + G;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  constexpr int NWARP = THREADS / 32;

  for (int i = tid; i < G * D; i += THREADS) {
    q_s[i] = to_f32(qb[i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }
  __syncthreads();

  for (int t0 = 0; t0 <= length; t0 += TK) {
    const int n = min(TK, length - t0 + 1);   // live rows in this tile
    // Tile load: rows past the length are zero-filled, never read.
    for (int e = tid; e < TK * (D / VEC); e += THREADS) {
      const int j = e / (D / VEC);
      const int c = (e % (D / VEC)) * VEC;
      float kf[VEC], vf[VEC];
      if (j < n) {
        const int s = t0 + j;
        uint4 kr = *reinterpret_cast<const uint4*>(kb + rows.k(s) + c);
        uint4 vr = *reinterpret_cast<const uint4*>(vb + rows.v(s) + c);
        const T* kt = reinterpret_cast<const T*>(&kr);
        const T* vt = reinterpret_cast<const T*>(&vr);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          kf[i] = to_f32(kt[i]);
          vf[i] = to_f32(vt[i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) kf[i] = vf[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        k_s[j * KP + c + i] = kf[i];
        v_s[j * D + c + i] = vf[i];
      }
    }
    __syncthreads();

    // Scores: one (query head, row) pair per thread, f32 dot, then scale.
    for (int e = tid; e < G * TK; e += THREADS) {
      const int g = e / TK, j = e % TK;
      float sc = NEG_INF;
      if (j < n) {
        const float* qr = q_s + g * D;
        const float* kr = k_s + j * KP;
        float a = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) a += qr[d] * kr[d];
        sc = a * scale;
      }
      p_s[g * TK + j] = sc;
    }
    __syncthreads();

    // Online softmax: one warp per query head.
    for (int g = warp; g < G; g += NWARP) {
      float* pr = p_s + g * TK;
      const float m_prev = m_s[g];
      float mx = NEG_INF;
      for (int j = lane; j < TK; j += 32) mx = fmaxf(mx, pr[j]);
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
      for (int j = lane; j < TK; j += 32) {
        const float p = expf(pr[j] - m_new);
        sum += p;
        pr[j] = to_f32(from_f32<T>(p));   // PV takes p in the cache dtype
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // Accumulate P @ V into the f32 accumulator, one (head, dim) per thread.
    for (int o = tid; o < G * D; o += THREADS) {
      const int g = o / D, d = o % D;
      const float* pr = p_s + g * TK;
      float a = acc_s[o] * c_s[g];
      for (int j = 0; j < n; ++j) a += pr[j] * v_s[j * D + d];
      acc_s[o] = a;
    }
    __syncthreads();
  }

  for (int o = tid; o < G * D; o += THREADS)
    ob[o] = from_f32<T>(acc_s[o] / fmaxf(l_s[o / D], 1e-30f));
}

// Opt a kernel into more than 48 KB of dynamic shared memory where needed.
template <typename Kernel>
cudaError_t allow_smem(Kernel kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace decode_tile
