// Fused RMSNorm forward for Hopper (sm_90a).
//
// Replaces: ray_tpu/ops/fused.py, _rms_norm_kernel via _rms_norm_pallas
// (the Pallas TPU kernel): y = x * rsqrt(mean(x^2) + eps) * w over the last
// axis, f32 inside, one rounding at the end.
//
// Bound on this card: bytes. Each row reads E inputs and writes E outputs and
// does ~4 flops per element, far below the H100's ~295 flops/byte ridge, so
// the least time is (2 * R * E * sizeof(T) + E * sizeof(T)) / 3.35 TB/s. At the
// decode shape (8 rows of 1024 bf16) that is ~33 KB: the launch, not the
// memory, sets the time.
//
// Design against that bound: one pass over each row with 16-byte vector loads
// (8 bf16 or 4 f32 per load, neighbouring threads on neighbouring addresses),
// the sum of squares in f32 reduced with warp shuffles, and the second read of
// the row for the output served from L1. Rows up to 2048 elements take one
// warp each (four rows per block), so the 8-row decode shape is two blocks
// and a 2048-row prefill fills the card; wider rows take a 256-thread block
// each, with the warp sums combined in shared memory. Any R >= 1 and any E
// work; a row that is not 16-byte aligned takes the scalar loop.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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
  return __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// blockDim = (32 * WARPS, ROWS): WARPS warps cooperate on each of ROWS rows.
template <typename T, int WARPS, int ROWS>
__global__ void rms_norm_kernel(const T* __restrict__ x,
                                const T* __restrict__ w, T* __restrict__ y,
                                int R, int E, float eps, int vec) {
  constexpr int VEC = 16 / sizeof(T);
  const int row = blockIdx.x * ROWS + threadIdx.y;
  const int tid = threadIdx.x;
  const int nthr = 32 * WARPS;
  const bool live = row < R;
  const T* xr = x + (size_t)(live ? row : 0) * E;
  T* yr = y + (size_t)(live ? row : 0) * E;

  float ss = 0.f;
  if (live) {
    if (vec) {
      for (int i = tid * VEC; i < E; i += nthr * VEC) {
        uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
        const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          float f = to_f32(v[j]);
          ss += f * f;
        }
      }
    } else {
      for (int i = tid; i < E; i += nthr) {
        float f = to_f32(xr[i]);
        ss += f * f;
      }
    }
  }
  ss = warp_sum(ss);
  if (WARPS > 1) {
    __shared__ float part[ROWS][WARPS];
    if ((tid & 31) == 0) part[threadIdx.y][tid >> 5] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) ss += part[threadIdx.y][k];
  }
  if (!live) return;
  const float inv = rsqrtf(ss / (float)E + eps);

  if (vec) {
    for (int i = tid * VEC; i < E; i += nthr * VEC) {
      uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      uint4 wraw = *reinterpret_cast<const uint4*>(w + i);
      const T* v = reinterpret_cast<const T*>(&raw);
      const T* wv = reinterpret_cast<const T*>(&wraw);
      uint4 oraw;
      T* o = reinterpret_cast<T*>(&oraw);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        o[j] = from_f32<T>(to_f32(v[j]) * inv * to_f32(wv[j]));
      *reinterpret_cast<uint4*>(yr + i) = oraw;
    }
  } else {
    for (int i = tid; i < E; i += nthr)
      yr[i] = from_f32<T>(to_f32(xr[i]) * inv * to_f32(w[i]));
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, int R, int E,
                   float eps, int vec, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* yp = static_cast<T*>(y);
  if (E <= 2048) {
    constexpr int ROWS = 4;
    dim3 block(32, ROWS);
    dim3 grid((R + ROWS - 1) / ROWS);
    rms_norm_kernel<T, 1, ROWS><<<grid, block, 0, stream>>>(xp, wp, yp, R, E,
                                                            eps, vec);
  } else {
    dim3 block(256, 1);
    dim3 grid(R);
    rms_norm_kernel<T, 8, 1><<<grid, block, 0, stream>>>(xp, wp, yp, R, E,
                                                         eps, vec);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x and y are [R, E] row-major, w is [E].
// vec = 1 when x, w and y are 16-byte aligned and E is a multiple of the
// vector width (the wrapper checks). Returns cudaGetLastError() after the
// launch; the caller raises on anything but 0.
extern "C" int rms_norm_forward(const void* x, const void* w, void* y, int R,
                                int E, float eps, int dtype, int vec,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= 0 || E <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)launch<float>(x, w, y, R, E, eps, vec, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, w, y, R, E, eps, vec, s);
  return (int)cudaErrorInvalidValue;
}
