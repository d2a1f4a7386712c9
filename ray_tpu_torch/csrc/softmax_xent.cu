// Per-row softmax cross-entropy forward for Hopper (sm_90a).
//
// Replaces: ray_tpu/ops/fused.py, _xent_kernel via _xent_pallas (the Pallas
// TPU kernel): loss[n] = logsumexp(logits[n, :]) - logits[n, labels[n]], in
// f32 whatever the logits' dtype. As in the Pallas kernel's one-hot pick, a
// label outside [0, V) picks 0.
//
// Bound on this card: bytes. Each row is read once (V * sizeof(T)) and does
// one exp and a few flops per element, far below the ~295 flops/byte ridge.
// At the training path's shape ([16384, 32000] f32 logits) that is 2.10 GB,
// 626 us at 3.35 TB/s.
//
// Design against that bound: one block of 256 threads per row, so the row
// is read once, with 16-byte loads (4 f32 or 8 bf16 per load, neighbouring
// threads on neighbouring addresses) when the row is aligned and a scalar
// loop otherwise. Each thread keeps an online (max, sum of exp(x - max)) pair
// over its elements, rescaling the sum when the max grows; the pairs are
// combined across the warp with shuffles and across the eight warps in
// shared memory, and one thread reads the label's logit by index and writes
// the row's loss. Eight such blocks fit on an SM, so 16384 rows are about
// 16 waves over the 132 SMs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Running (m, s): s = sum exp(x - m) over the values seen. -inf values add
// nothing; a NaN poisons s, so it reaches the loss as XLA's would.
__device__ __forceinline__ void push(float x, float& m, float& s) {
  if (!(x <= m)) {
    s = s * expf(m - x) + 1.f;
    m = x;
  } else if (x != -INFINITY) {
    s += expf(x - m);
  }
}

__device__ __forceinline__ void merge(float& m, float& s, float m2,
                                      float s2) {
  const float mn = fmaxf(m, m2);
  const float a = (m == mn) ? s : s * expf(m - mn);
  const float b = (m2 == mn) ? s2 : s2 * expf(m2 - mn);
  m = mn;
  s = a + b;
}

template <typename T, typename L>
__global__ void __launch_bounds__(THREADS)
xent_kernel(const T* __restrict__ logits, const L* __restrict__ labels,
            float* __restrict__ out, long long V, long long row_stride,
            int vec) {
  constexpr int VEC = 16 / sizeof(T);
  const long long n = blockIdx.x;
  const T* row = logits + n * row_stride;
  float m = -INFINITY, s = 0.f;
  if (vec) {
    const long long nv = V / VEC;
    for (long long i = threadIdx.x; i < nv; i += THREADS) {
      uint4 raw = *reinterpret_cast<const uint4*>(row + i * VEC);
      const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) push(to_f32(t[j]), m, s);
    }
  } else {
    for (long long i = threadIdx.x; i < V; i += THREADS)
      push(to_f32(row[i]), m, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    merge(m, s, m2, s2);
  }
  __shared__ float wm[WARPS], ws[WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    wm[warp] = m;
    ws[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    m = wm[0];
    s = ws[0];
    for (int w = 1; w < WARPS; ++w) merge(m, s, wm[w], ws[w]);
    const long long label = (long long)labels[n];
    const float picked =
        (label >= 0 && label < V) ? to_f32(row[label]) : 0.f;
    out[n] = (m + logf(s)) - picked;
  }
}

template <typename T>
cudaError_t launch_t(const void* logits, const void* labels, void* out,
                     long long N, long long V, long long row_stride,
                     int label_dtype, cudaStream_t stream) {
  const T* lp = static_cast<const T*>(logits);
  constexpr int VEC = 16 / sizeof(T);
  const int vec = (V % VEC == 0 && row_stride % VEC == 0 &&
                   reinterpret_cast<uintptr_t>(logits) % 16 == 0);
  float* op = static_cast<float*>(out);
  if (label_dtype == 0)
    xent_kernel<T, int32_t><<<(unsigned)N, THREADS, 0, stream>>>(
        lp, static_cast<const int32_t*>(labels), op, V, row_stride, vec);
  else
    xent_kernel<T, int64_t><<<(unsigned)N, THREADS, 0, stream>>>(
        lp, static_cast<const int64_t*>(labels), op, V, row_stride, vec);
  return cudaGetLastError();
}

}  // namespace

// logits: [N, V] with unit column stride and row stride row_stride
// (elements); labels: [N] contiguous, int32 (label_dtype 0) or int64 (1);
// out: [N] f32. dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError()
// after the launch; the caller raises on anything but 0.
extern "C" int softmax_xent_forward(const void* logits, const void* labels,
                                    void* out, long long N, long long V,
                                    long long row_stride, int dtype,
                                    int label_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || V <= 0 || N > 2147483647LL || label_dtype < 0 ||
      label_dtype > 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch_t<float>(logits, labels, out, N, V, row_stride,
                                label_dtype, s);
  if (dtype == 1)
    return (int)launch_t<__nv_bfloat16>(logits, labels, out, N, V,
                                        row_stride, label_dtype, s);
  return (int)cudaErrorInvalidValue;
}
