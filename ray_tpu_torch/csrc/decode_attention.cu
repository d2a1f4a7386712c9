// Flash-decode attention for Hopper (sm_90a): one query position per
// sequence against a contiguous KV cache, with per-sequence lengths.
//
// Replaces: ray_tpu/ops/attention.py, _decode_kernel via _flash_decode (the
// Pallas TPU kernel). out[b, h] = softmax(q[b, h] . k[b, 0..L_b, h/G]^T *
// D^-0.5) @ v[b, 0..L_b, h/G], where L_b = lengths[b] is an INCLUSIVE bound
// (lengths[b] + 1 rows are attended, the row just written included), and
// query head h = kh * G + g shares kv head kh (as _repeat_kv).
//
// Bound on this card: bytes. The kernel must read the live rows of K and V,
// 2 * sum_b (L_b + 1) * KH * D * sizeof(T), and does ~4 flops per element
// read times G, far below the ~295 flops/byte ridge for any G a model uses.
// At the flagship decode shape (B=8, KH=16, D=64, bf16) that is 3.1 MB at
// L+1 = 96 (0.94 us at 3.35 TB/s) and 33.5 MB at L+1 = 2048 (10 us).
//
// Design against that bound: one block per (b, kv head), B*KH blocks (128
// at the flagship shape); the G query heads of the group are rows of the
// block, so K and V are read once per group, not once per query head. A loop
// inside the block walks the cache in tiles of 64 rows and stops at the tile
// that holds row L_b, so rows past the length are never read (the TPU's
// sequential grid axis and its truncate_dma index map, in one loop). Tiles
// come in with 16-byte loads straight from the cache's native [B, S, KH, D]
// layout through its strides (the cache is never transposed), are widened to
// f32 in shared memory (K rows padded by one word so the per-key dot products
// are free of bank conflicts), and the online softmax keeps its running max,
// sum and accumulator in f32. As in the Pallas kernel, scores are scaled
// after the f32 dot product, masked positions score NEG_INF = -1e30, the
// probabilities enter the PV product rounded to the cache's dtype, and the
// final division clamps the sum at 1e-30. Split-K across blocks, cp.async/TMA
// pipelining and tensor-core products are left for later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ lengths,
              T* __restrict__ out, int S, int KH, int G, long long k_sb,
              long long k_ss, long long v_sb, long long v_ss, float scale) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int KP = D + 1;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* acc_s = q_s + G * D;
  float* k_s = acc_s + G * D;
  float* v_s = k_s + TK * KP;
  float* p_s = v_s + TK * D;
  float* m_s = p_s + G * TK;
  float* l_s = m_s + G;
  float* c_s = l_s + G;

  const int b = blockIdx.x / KH;
  const int kh = blockIdx.x % KH;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  constexpr int NWARP = THREADS / 32;
  // Callers guarantee 0 <= lengths[b] < S; clamp so a bad length can never
  // read outside the cache.
  const int length = min(max(lengths[b], 0), S - 1);

  const size_t head0 = (size_t)b * KH * G + (size_t)kh * G;
  const T* qb = q + head0 * D;
  for (int i = tid; i < G * D; i += THREADS) {
    q_s[i] = to_f32(qb[i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }
  const T* kb = k + (size_t)b * k_sb + (size_t)kh * D;
  const T* vb = v + (size_t)b * v_sb + (size_t)kh * D;
  __syncthreads();

  for (int t0 = 0; t0 <= length; t0 += TK) {
    const int n = min(TK, length - t0 + 1);   // live rows in this tile
    // Tile load: rows past the length are zero-filled, never read.
    for (int e = tid; e < TK * (D / VEC); e += THREADS) {
      const int j = e / (D / VEC);
      const int c = (e % (D / VEC)) * VEC;
      float kf[VEC], vf[VEC];
      if (j < n) {
        const size_t s = (size_t)(t0 + j);
        uint4 kr = *reinterpret_cast<const uint4*>(kb + s * k_ss + c);
        uint4 vr = *reinterpret_cast<const uint4*>(vb + s * v_ss + c);
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

  T* ob = out + head0 * D;
  for (int o = tid; o < G * D; o += THREADS)
    ob[o] = from_f32<T>(acc_s[o] / fmaxf(l_s[o / D], 1e-30f));
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* out, int B, int S, int KH, int G,
                   long long k_sb, long long k_ss, long long v_sb,
                   long long v_ss, float scale, cudaStream_t stream) {
  const size_t bytes = smem_floats(G, D) * sizeof(float);
  auto kern = decode_kernel<T, D>;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  kern<<<B * KH, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), S, KH, G,
      k_sb, k_ss, v_sb, v_ss, scale);
  return cudaGetLastError();
}

}  // namespace

// Shared memory one block needs, in bytes (the wrapper refuses shapes above
// the card's 227 KB per block).
extern "C" long long decode_attention_smem_bytes(int G, int D) {
  return (long long)(smem_floats(G, D) * sizeof(float));
}

// q, out: [B, H = KH*G, D] contiguous. k, v: [B, S, KH, D] with the last two
// dims contiguous and batch/row strides (in elements) given. lengths: [B]
// int32 on the device. dtype: 0 = float32, 1 = bfloat16; D in {64, 128}.
// Returns cudaGetLastError() after the launch.
extern "C" int decode_attention_forward(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, int B, int S, int KH, int G, int D, long long k_sb,
    long long k_ss, long long v_sb, long long v_ss, float scale, int dtype,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  if (B <= 0 || S <= 0 || KH <= 0 || G <= 0) return (int)cudaErrorInvalidValue;
#define RT_DECODE(T, DD)                                                     \
  return (int)launch<T, DD>(q, k, v, len, out, B, S, KH, G, k_sb, k_ss, v_sb, \
                            v_ss, scale, s)
  if (dtype == 0 && D == 64) RT_DECODE(float, 64);
  if (dtype == 0 && D == 128) RT_DECODE(float, 128);
  if (dtype == 1 && D == 64) RT_DECODE(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) RT_DECODE(__nv_bfloat16, 128);
#undef RT_DECODE
  return (int)cudaErrorInvalidValue;
}
