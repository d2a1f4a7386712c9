// Fused RMSNorm for Hopper (sm_90a): the forward, its residual form, and
// the backward.
//
// Replaces: ray_tpu/ops/fused.py, _rms_norm_kernel via _rms_norm_pallas
// (the Pallas TPU kernel): y = x * rsqrt(mean(x^2) + eps) * w over the last
// axis, f32 inside, one rounding at the end; the residual add before it in
// the JAX model's layer (ray_tpu/models/transformer.py, block: h = x + attn,
// then the norm of h), which XLA fused there; and _rms_norm_bwd, the
// custom_vjp backward (XLA on the TPU).
//
// Bound on this card: bytes. Each element takes a few flops, far below the
// H100's ~295 flops/byte ridge, so the least time is the bytes over
// 3.35 TB/s: forward 2 R E sizeof(T) (x in, y out), residual form 4 R E
// sizeof(T) (x, a in; h, y out), backward 4 R E sizeof(T) (h, g_y, g_h in;
// dx out), each plus the weight. At the decode shape (8 rows of 1024 bf16)
// that is tens of KB: the launch, not the memory, sets the time, and the one
// lever is fewer launches, which the residual form gives (the add that came
// before each norm is no longer a launch of its own).
//
// Forward, against that bound: one pass over each row with 16-byte vector
// loads (8 bf16 or 4 f32 per load, neighbouring threads on neighbouring
// addresses), the sum of squares in f32 reduced with warp shuffles, and the
// output computed from the row held in registers (every load of a row, and
// of the weight, goes out at once). Rows up to 2048 elements take one warp
// each (kRows rows per block), so the 8-row decode shape is four blocks and a
// 2048-row prefill fills the card; wider rows take a 256-thread block each,
// with the warp sums combined in shared memory and the second read of the
// row served from L1. The residual form adds x + a in f32 and rounds to T as
// PyTorch's add does (round to nearest even), writes that h, and normalises
// the rounded h with the same reduction as the plain form: its y is the plain
// kernel's y on h, bit for bit, when both take the same load route.
//
// Backward: dx = g_h + inv g_y w - h inv^3 mean(g_y w h), f32 inside and
// rounded once; dw = sum over rows of (h inv) g_y. A block of up to 256
// threads spans a row (K 16-byte vectors a thread) and walks a fixed run of
// rows, so h, g_y and g_h are read once, in one batch of loads a row; the
// two row sums go through warp shuffles and one barrier a row (double-
// buffered shared memory). Each thread keeps its columns' dw sums in
// registers and writes the block's f32 partial row once; a second kernel
// sums the partial rows in block order (32 threads a column, then one
// thread over those 32 in order). No atomics: two launches give the same
// bits. Rows too wide for that, or not 16-byte aligned, take a scalar kernel
// of 1024 threads that keeps its dw sums in the partial row itself.
//
// Any R >= 1 and any E work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// Forward launch shape for rows of up to 2048 elements: kRows warps a block,
// one row each, kRowsPerWarp rows a warp; kHoldRow: such a row stays in the
// warp's registers between the two passes (else the output pass reads it
// again, from L1 where it is still there).
constexpr int kRows = 2;
constexpr int kRowsPerWarp = 1;
constexpr bool kHoldRow = true;
// Backward: the number of blocks (and partial rows of dw) aimed at, and the
// most threads a block spans a row with on the vector route.
constexpr int kBwdBlocks = 1024;
constexpr int kBwdThreads = 256;

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

// ------------------------------------------------------------- forward

// The 16 / sizeof(T) values of a vector as f32.
template <typename T>
__device__ __forceinline__ void unpack(uint4 raw, float* f) {
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < (int)(16 / sizeof(T)); ++j) f[j] = to_f32(v[j]);
}

// x + a of two vectors, added in f32 and rounded to T.
template <typename T>
__device__ __forceinline__ uint4 rounded_sum(uint4 x, uint4 a) {
  const T* xv = reinterpret_cast<const T*>(&x);
  const T* av = reinterpret_cast<const T*>(&a);
  uint4 h;
  T* hv = reinterpret_cast<T*>(&h);
#pragma unroll
  for (int j = 0; j < (int)(16 / sizeof(T)); ++j)
    hv[j] = from_f32<T>(to_f32(xv[j]) + to_f32(av[j]));
  return h;
}

// The vector of the norm's input at xr[i..]: x, or (ADD) x + a rounded to T,
// stored to hr when store is set.
template <typename T, bool ADD>
__device__ __forceinline__ uint4 input_vec(const T* xr, const T* ar, T* hr,
                                           int i, bool store) {
  const uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
  if (!ADD) return raw;
  const uint4 h =
      rounded_sum<T>(raw, *reinterpret_cast<const uint4*>(ar + i));
  if (store) *reinterpret_cast<uint4*>(hr + i) = h;
  return h;
}

// y = f * inv * w for the vector at yr[i..], f its input as f32.
template <typename T>
__device__ __forceinline__ void output_vec(const float* f, const T* w, T* yr,
                                           int i, float inv) {
  constexpr int VEC = 16 / sizeof(T);
  uint4 wraw = *reinterpret_cast<const uint4*>(w + i);
  const T* wv = reinterpret_cast<const T*>(&wraw);
  uint4 oraw;
  T* o = reinterpret_cast<T*>(&oraw);
#pragma unroll
  for (int j = 0; j < VEC; ++j) o[j] = from_f32<T>(f[j] * inv * to_f32(wv[j]));
  *reinterpret_cast<uint4*>(yr + i) = oraw;
}

template <typename T, bool ADD>
__device__ __forceinline__ float input_one(const T* xr, const T* ar, T* hr,
                                           int i, bool store) {
  if (!ADD) return to_f32(xr[i]);
  const T hv = from_f32<T>(to_f32(xr[i]) + to_f32(ar[i]));
  if (store) hr[i] = hv;
  return to_f32(hv);
}

// blockDim = (32 * WARPS, ROWS): WARPS warps cooperate on each of ROWS rows,
// RPW rows in turn. ADD: the input is x + a, written to h.
template <typename T, int WARPS, int ROWS, int RPW, bool ADD>
__global__ void rms_norm_kernel(const T* __restrict__ x,
                                const T* __restrict__ a,
                                const T* __restrict__ w, T* __restrict__ h,
                                T* __restrict__ y, int R, int E, float eps,
                                int vec) {
  constexpr int VEC = 16 / sizeof(T);
  const int tid = threadIdx.x;
  const int nthr = 32 * WARPS;
  __shared__ float part[ROWS][WARPS];
#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    const int row = (blockIdx.x * RPW + k) * ROWS + threadIdx.y;
    const bool live = row < R;
    const size_t off = (size_t)(live ? row : 0) * E;
    const T* xr = x + off;
    const T* ar = ADD ? a + off : nullptr;
    T* hr = ADD ? h + off : nullptr;
    T* yr = y + off;

    float ss = 0.f;
    if (kHoldRow && WARPS == 1 && vec) {
      // A row of up to 2048 in the warp's registers: the same loads and sums
      // in the same order as the loop below, without the second read.
      // Every load of the row and the weight goes out before the first
      // store of h.
      constexpr int HOLD = 2048 / (32 * VEC);
      uint4 held[HOLD], added[ADD ? HOLD : 1], wv[HOLD];
      if (live) {
#pragma unroll
        for (int it = 0; it < HOLD; ++it) {
          const int i = (tid + 32 * it) * VEC;
          if (i >= E) continue;
          held[it] = *reinterpret_cast<const uint4*>(xr + i);
          wv[it] = *reinterpret_cast<const uint4*>(w + i);
          if (ADD)
            added[ADD ? it : 0] = *reinterpret_cast<const uint4*>(ar + i);
        }
#pragma unroll
        for (int it = 0; it < HOLD; ++it) {
          const int i = (tid + 32 * it) * VEC;
          if (i >= E) continue;
          if (ADD) {
            held[it] = rounded_sum<T>(held[it], added[ADD ? it : 0]);
            *reinterpret_cast<uint4*>(hr + i) = held[it];
          }
          float f[VEC];
          unpack<T>(held[it], f);
#pragma unroll
          for (int j = 0; j < VEC; ++j) ss += f[j] * f[j];
        }
      }
      ss = warp_sum(ss);
      if (!live) continue;
      const float inv = rsqrtf(ss / (float)E + eps);
#pragma unroll
      for (int it = 0; it < HOLD; ++it) {
        const int i = (tid + 32 * it) * VEC;
        if (i >= E) continue;
        float f[VEC], wf[VEC];
        unpack<T>(held[it], f);
        unpack<T>(wv[it], wf);
        uint4 oraw;
        T* o = reinterpret_cast<T*>(&oraw);
#pragma unroll
        for (int j = 0; j < VEC; ++j) o[j] = from_f32<T>(f[j] * inv * wf[j]);
        *reinterpret_cast<uint4*>(yr + i) = oraw;
      }
      continue;
    }
    if (live) {
      if (vec) {
        for (int i = tid * VEC; i < E; i += nthr * VEC) {
          float f[VEC];
          unpack<T>(input_vec<T, ADD>(xr, ar, hr, i, true), f);
#pragma unroll
          for (int j = 0; j < VEC; ++j) ss += f[j] * f[j];
        }
      } else {
        for (int i = tid; i < E; i += nthr) {
          const float f = input_one<T, ADD>(xr, ar, hr, i, true);
          ss += f * f;
        }
      }
    }
    ss = warp_sum(ss);
    if (WARPS > 1) {
      if ((tid & 31) == 0) part[threadIdx.y][tid >> 5] = ss;
      __syncthreads();
      ss = 0.f;
#pragma unroll
      for (int k2 = 0; k2 < WARPS; ++k2) ss += part[threadIdx.y][k2];
      if (RPW > 1) __syncthreads();  // part is written again for the next row
    }
    if (!live) continue;
    const float inv = rsqrtf(ss / (float)E + eps);

    if (vec) {
      for (int i = tid * VEC; i < E; i += nthr * VEC) {
        float f[VEC];
        unpack<T>(input_vec<T, ADD>(xr, ar, hr, i, false), f);
        output_vec<T>(f, w, yr, i, inv);
      }
    } else {
      for (int i = tid; i < E; i += nthr)
        yr[i] = from_f32<T>(input_one<T, ADD>(xr, ar, hr, i, false) * inv *
                            to_f32(w[i]));
    }
  }
}

template <typename T, bool ADD>
cudaError_t launch_forward(const void* x, const void* a, const void* w,
                           void* h, void* y, int R, int E, float eps, int vec,
                           cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* ap = static_cast<const T*>(a);
  const T* wp = static_cast<const T*>(w);
  T* hp = static_cast<T*>(h);
  T* yp = static_cast<T*>(y);
  if (E <= 2048) {
    constexpr int per_block = kRows * kRowsPerWarp;
    dim3 block(32, kRows);
    dim3 grid((R + per_block - 1) / per_block);
    rms_norm_kernel<T, 1, kRows, kRowsPerWarp, ADD>
        <<<grid, block, 0, stream>>>(xp, ap, wp, hp, yp, R, E, eps, vec);
  } else {
    dim3 block(256, 1);
    dim3 grid(R);
    rms_norm_kernel<T, 8, 1, 1, ADD>
        <<<grid, block, 0, stream>>>(xp, ap, wp, hp, yp, R, E, eps, vec);
  }
  return cudaGetLastError();
}

// ------------------------------------------------------------ backward

// Rows a backward block walks, and so the number of blocks and of dw's
// partial rows.
int bwd_rows_per_block(int R) { return (R + kBwdBlocks - 1) / kBwdBlocks; }
int bwd_blocks(int R) {
  const int rpb = bwd_rows_per_block(R);
  return (R + rpb - 1) / rpb;
}

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* f) {
  unpack<T>(*reinterpret_cast<const uint4*>(p), f);
}

// Row r's vectors of h, g_y and (GH) g_h at each thread's K columns, as
// loaded (zero past E).
template <typename T, int K, bool GH>
__device__ __forceinline__ void load_row(const T* h, const T* gy,
                                         const T* gh, int r, int E,
                                         uint4 (&v)[3][K]) {
  constexpr int VEC = 16 / sizeof(T);
  const size_t off = (size_t)r * E;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = (threadIdx.x + k * blockDim.x) * VEC;
    const bool in = c < E;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    v[0][k] = in ? *reinterpret_cast<const uint4*>(h + off + c) : zero;
    v[1][k] = in ? *reinterpret_cast<const uint4*>(gy + off + c) : zero;
    v[2][k] = in && GH ? *reinterpret_cast<const uint4*>(gh + off + c) : zero;
  }
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float* f) {
  constexpr int VEC = 16 / sizeof(T);
  uint4 raw;
  T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int j = 0; j < VEC; ++j) v[j] = from_f32<T>(f[j]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// The two row sums of a block of nw warps, in a fixed order; red is one of
// two buffers used in turn, so one barrier a row suffices.
__device__ __forceinline__ void block_sums(float& ss, float& dot,
                                           float (*red)[32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  ss = warp_sum(ss);
  dot = warp_sum(dot);
  if (lane == 0) {
    red[0][warp] = ss;
    red[1][warp] = dot;
  }
  __syncthreads();
  ss = 0.f;
  dot = 0.f;
  for (int k = 0; k < nw; ++k) {
    ss += red[0][k];
    dot += red[1][k];
  }
}

// Vector route: blockDim.x threads (a multiple of 32, at most kBwdThreads)
// span a row, each K vectors of VEC at columns (t + k blockDim.x) VEC; the
// block walks rows [b rpb, (b + 1) rpb) and writes its dw sums to part[b].
template <typename T, int K, bool GH>
__global__ void __launch_bounds__(kBwdThreads)
    rms_norm_bwd_kernel(const T* __restrict__ h, const T* __restrict__ w,
                        const T* __restrict__ gy, const T* __restrict__ gh,
                        T* __restrict__ dx, float* __restrict__ part, int R,
                        int E, float eps, int rpb) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float red[2][2][32];
  const int t = threadIdx.x, nt = blockDim.x;
  float wf[K][VEC], acc[K][VEC];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = (t + k * nt) * VEC;
    if (c < E) load_vec<T>(w + c, wf[k]);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      if (c >= E) wf[k][j] = 0.f;
      acc[k][j] = 0.f;
    }
  }
  const int r0 = blockIdx.x * rpb;
  const int r1 = min(R, r0 + rpb);
  for (int r = r0; r < r1; ++r) {
    uint4 cur[3][K];
    load_row<T, K, GH>(h, gy, gh, r, E, cur);
    float hv[K][VEC], gv[K][VEC];
    float ss = 0.f, dot = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      unpack<T>(cur[0][k], hv[k]);
      unpack<T>(cur[1][k], gv[k]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        ss += hv[k][j] * hv[k][j];
        dot += gv[k][j] * wf[k][j] * hv[k][j];
      }
    }
    block_sums(ss, dot, red[(r - r0) & 1]);
    const float inv = rsqrtf(ss / (float)E + eps);
    const float inv3 = inv * inv * inv;
    const float mean = dot / (float)E;
    const size_t off = (size_t)r * E;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = (t + k * nt) * VEC;
      if (c >= E) continue;
      float d[VEC], ghv[VEC];
      if (GH) unpack<T>(cur[2][k], ghv);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        d[j] = inv * (gv[k][j] * wf[k][j]) - hv[k][j] * inv3 * mean;
        if (GH) d[j] += ghv[j];
        acc[k][j] += hv[k][j] * inv * gv[k][j];
      }
      store_vec<T>(dx + off + c, d);
    }
  }
  float* pr = part + (size_t)blockIdx.x * E;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = (t + k * nt) * VEC;
    if (c >= E) continue;
#pragma unroll
    for (int j = 0; j < VEC; ++j) pr[c + j] = acc[k][j];
  }
}

// Scalar route, for rows not 16-byte aligned or too wide for the vector
// route's registers: 1024 threads span a row an element at a time; each
// thread keeps its columns' dw sums in the block's partial row, which only
// it touches.
template <typename T, bool GH>
__global__ void __launch_bounds__(1024)
    rms_norm_bwd_wide_kernel(const T* __restrict__ h, const T* __restrict__ w,
                             const T* __restrict__ gy,
                             const T* __restrict__ gh, T* __restrict__ dx,
                             float* __restrict__ part, int R, int E, float eps,
                             int rpb) {
  __shared__ float red[2][2][32];
  const int t = threadIdx.x, nt = blockDim.x;
  float* pr = part + (size_t)blockIdx.x * E;
  for (int i = t; i < E; i += nt) pr[i] = 0.f;
  const int r0 = blockIdx.x * rpb;
  const int r1 = min(R, r0 + rpb);
  for (int r = r0; r < r1; ++r) {
    const size_t off = (size_t)r * E;
    float ss = 0.f, dot = 0.f;
    for (int i = t; i < E; i += nt) {
      const float hv = to_f32(h[off + i]);
      ss += hv * hv;
      dot += to_f32(gy[off + i]) * to_f32(w[i]) * hv;
    }
    block_sums(ss, dot, red[(r - r0) & 1]);
    const float inv = rsqrtf(ss / (float)E + eps);
    const float inv3 = inv * inv * inv;
    const float mean = dot / (float)E;
    for (int i = t; i < E; i += nt) {
      const float hv = to_f32(h[off + i]), gv = to_f32(gy[off + i]);
      float d = inv * (gv * to_f32(w[i])) - hv * inv3 * mean;
      if (GH) d += to_f32(gh[off + i]);
      dx[off + i] = from_f32<T>(d);
      pr[i] += hv * inv * gv;
    }
  }
}

// dw[c] = the sum of part[0..nb)[c] in a fixed order: thread (x, y) of a
// 32 x 32 block sums rows y, y + 32, ... of column 32 blockIdx.x + x, then
// thread (x, 0) sums those 32 in order of y.
template <typename T>
__global__ void rms_norm_dw_kernel(const float* __restrict__ part,
                                   T* __restrict__ dw, int nb, int E) {
  __shared__ float s[32][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.f;
  if (c < E) {
    // Unrolled so that the loads go out together; the adds keep their order.
#pragma unroll 8
    for (int b = threadIdx.y; b < nb; b += 32) acc += part[(size_t)b * E + c];
  }
  s[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y != 0 || c >= E) return;
  float v = 0.f;
#pragma unroll
  for (int k = 0; k < 32; ++k) v += s[k][threadIdx.x];
  dw[c] = from_f32<T>(v);
}

template <typename T, bool GH>
cudaError_t launch_backward(const void* h, const void* w, const void* gy,
                            const void* gh, void* dx, void* dw, void* part,
                            int R, int E, float eps, int vec,
                            cudaStream_t stream) {
  const T* hp = static_cast<const T*>(h);
  const T* wp = static_cast<const T*>(w);
  const T* gyp = static_cast<const T*>(gy);
  const T* ghp = static_cast<const T*>(gh);
  T* dxp = static_cast<T*>(dx);
  float* pp = static_cast<float*>(part);
  const int rpb = bwd_rows_per_block(R), nb = bwd_blocks(R);
  // Vectors a row, and the fewest a thread (K) that fit kBwdThreads.
  const int n = vec ? E / (16 / (int)sizeof(T)) : 0;
  const int K = !vec                    ? 0
                : n <= kBwdThreads     ? 1
                : n <= 2 * kBwdThreads ? 2
                : n <= 4 * kBwdThreads ? 4
                                       : 0;
  const int nt = K ? ((n + K - 1) / K + 31) / 32 * 32 : 1024;
#define RMS_BWD_ARGS hp, wp, gyp, ghp, dxp, pp, R, E, eps, rpb
  switch (K) {
    case 1:
      rms_norm_bwd_kernel<T, 1, GH><<<nb, nt, 0, stream>>>(RMS_BWD_ARGS);
      break;
    case 2:
      rms_norm_bwd_kernel<T, 2, GH><<<nb, nt, 0, stream>>>(RMS_BWD_ARGS);
      break;
    case 4:
      rms_norm_bwd_kernel<T, 4, GH><<<nb, nt, 0, stream>>>(RMS_BWD_ARGS);
      break;
    default:
      rms_norm_bwd_wide_kernel<T, GH><<<nb, nt, 0, stream>>>(RMS_BWD_ARGS);
  }
#undef RMS_BWD_ARGS
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rms_norm_dw_kernel<T><<<(E + 31) / 32, dim3(32, 32), 0, stream>>>(
      pp, static_cast<T*>(dw), nb, E);
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward(const void* h, const void* w, const void* gy,
                     const void* gh, void* dx, void* dw, void* part, int R,
                     int E, float eps, int vec, cudaStream_t s) {
  if (gh) return launch_backward<T, true>(h, w, gy, gh, dx, dw, part, R, E,
                                          eps, vec, s);
  return launch_backward<T, false>(h, w, gy, gh, dx, dw, part, R, E, eps,
                                   vec, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x, y (and a, h) are [R, E] row-major, w
// is [E]. a == NULL: y = rms_norm(x); otherwise h = x + a (rounded to the
// dtype) and y = rms_norm(h). vec = 1 when every pointer is 16-byte aligned
// and E is a multiple of the vector width (the wrapper checks). Returns
// cudaGetLastError() after the launch; the caller raises on anything but 0.
extern "C" int rms_norm_forward(const void* x, const void* a, const void* w,
                                void* h, void* y, int R, int E, float eps,
                                int dtype, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= 0 || E <= 0 || (a == nullptr) != (h == nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)(a ? launch_forward<float, true>(x, a, w, h, y, R, E, eps,
                                                 vec, s)
                   : launch_forward<float, false>(x, a, w, h, y, R, E, eps,
                                                  vec, s));
  if (dtype == 1)
    return (int)(a ? launch_forward<__nv_bfloat16, true>(x, a, w, h, y, R, E,
                                                         eps, vec, s)
                   : launch_forward<__nv_bfloat16, false>(x, a, w, h, y, R,
                                                          E, eps, vec, s));
  return (int)cudaErrorInvalidValue;
}

// The number of f32 partial rows of dw that rms_norm_backward needs for R
// rows: the wrapper allocates part as [rms_norm_backward_blocks(R), E].
extern "C" int rms_norm_backward_blocks(int R) {
  return R > 0 ? bwd_blocks(R) : 0;
}

// h, g_y (and g_h, or NULL) and dx are [R, E], w and dw [E], all of dtype;
// part is [rms_norm_backward_blocks(R), E] f32 scratch. Two kernels on the
// stream: the rows' dx and per-block dw sums, then dw. vec as for the
// forward, over h, w, g_y, g_h and dx.
extern "C" int rms_norm_backward(const void* h, const void* w,
                                 const void* gy, const void* gh, void* dx,
                                 void* dw, void* part, int R, int E,
                                 float eps, int dtype, int vec,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= 0 || E <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)backward<float>(h, w, gy, gh, dx, dw, part, R, E, eps, vec,
                                s);
  if (dtype == 1)
    return (int)backward<__nv_bfloat16>(h, w, gy, gh, dx, dw, part, R, E, eps,
                                        vec, s);
  return (int)cudaErrorInvalidValue;
}
