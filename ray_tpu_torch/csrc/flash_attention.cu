// Flash attention forward and backward for Hopper (sm_90a): three kernels.
//
// Replaces (ray_tpu/ops/attention.py, the Pallas TPU kernels):
//   flash_fwd_kernel  <- _flash_kernel via _flash_forward (K3): out and the
//                        row logsumexp lse;
//   flash_dq_kernel   <- _bwd_dq_kernel via _flash_backward, first
//                        pallas_call (K4): dq;
//   flash_dkv_kernel  <- _bwd_dkv_kernel via _flash_backward, second
//                        pallas_call (K5): dk and dv.
// q, out, do: [B, T, H, D]; k, v: [B, S, KH, D] (the JAX layout), read
// through their batch/row/head strides with the last axis contiguous, never
// transposed. Query head h = kh * G + g reads kv head kh. lse, dsum:
// [B, H, T] f32. dq: [B, T, H, D]; dk, dv: [B, S, KH, D], contiguous.
//
// The arithmetic follows the Pallas kernels, not the XLA reference: scores
// are f32 dot products scaled afterwards; masked positions (causal k > q, and
// the ragged tails past T or S) score NEG_INF = -1e30; in the forward the
// online softmax keeps its running max, sum and accumulator in f32, p enters
// the PV product rounded to v's dtype, o = acc / max(l, 1e-30) and
// lse = m + log(max(l, 1e-30)); in the backward p = exp(s - lse) and
// ds = p * (dp - dsum) * scale, with p rounded to do's dtype for dv and ds to
// q's or k's for dk and dq. One difference: dk and dv are summed over the G
// query heads of a group in f32 inside K5, where the JAX package casts each
// head's result to bf16 and sums those.
//
// Bound on this card: operations. At the training path's shape (B 8, T = S
// 2048, H = KH 16, D 64, causal) each of the products is 2*B*H*T*T*D/2 = 34.4
// GFLOP; K3 does 2 of them (69 us at 989 TFLOP/s bf16), K4 3 (104 us), K5 4
// (139 us). The bytes (q, k, v, o, do, once each) are ~34 MB, ~10 us.
//
// Design, simple first: FMA loops on the CUDA cores over f32 tiles in
// shared memory, no tensor cores (so the f32 path has no TF32 either), no
// cp.async/TMA pipelining. Each block holds 64-row tiles; its 256 threads
// form a 16 x 16 grid and each owns a 4 x 4 micro-tile of the 64 x 64 score
// tile (rows ty + 16 i, columns tx + 16 j) and 4 rows x D/16 columns of the
// f32 accumulators, in registers. Tile rows are padded to D + 1 floats so
// the per-row dot products are free of bank conflicts. Row statistics are
// reduced over the 16 threads of a row with shuffles. Tiles above the causal
// diagonal are skipped. Blocks carry nothing between each other, so:
//   K3, K4: one block per (q tile, h, b); a loop over the kv tiles up to the
//           diagonal takes the place of the TPU's sequential grid axis. The
//           q tiles run last-first, the longest loops first.
//   K5:     one block per (kv tile, kh, b), looping over the G query heads
//           of the group and the q tiles from the diagonal on; dk and dv stay
//           in f32 registers over the whole loop and are written once, so
//           there are no atomics and the result is deterministic.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;        // rows per q tile and per kv tile
constexpr int THREADS = 256;    // a 16 x 16 thread grid
constexpr int SP = TILE + 1;    // row pitch of the 64 x 64 score tiles
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
// v rounded to T's precision, kept as f32 (the Pallas kernels' .astype
// before a product with an f32 result).
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Strides {   // element strides of a [B, rows, heads, D] tensor
  long long b, t, h;
};

struct Shape {
  int B, T, S, H, KH, G;
  float scale;
};

// rows [0, valid) of a TILE-row tile starting at src (row stride in
// elements) into dst [TILE][D + 1] f32; rows past valid are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int valid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int P = D + 1;
  for (int e = threadIdx.x; e < TILE * (D / VEC); e += THREADS) {
    const int r = e / (D / VEC), c = (e % (D / VEC)) * VEC;
    float f[VEC];
    if (r < valid) {
      uint4 raw =
          *reinterpret_cast<const uint4*>(src + (long long)r * row_stride + c);
      const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < VEC; ++i) f[i] = to_f32(t[i]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) f[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[r * P + c + i] = f[i];
  }
}

template <int D>
constexpr size_t fwd_smem_floats() { return 3 * TILE * (D + 1) + TILE * SP; }
template <int D>
constexpr size_t dq_smem_floats() { return 4 * TILE * (D + 1) + TILE * SP; }
template <int D>
constexpr size_t dkv_smem_floats() {
  return 4 * TILE * (D + 1) + 2 * TILE * SP + 2 * TILE;
}

// ------------------------------------------------------------------ K3

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
                 Shape sh) {
  constexpr int P = D + 1, DJ = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + TILE * P;
  float* vs = ks + TILE * P;
  float* ps = vs + TILE * P;

  const int qt = gridDim.x - 1 - blockIdx.x;   // longest loops first
  const int h = blockIdx.y, b = blockIdx.z, kh = h / sh.G;
  const int q0 = qt * TILE;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<T, D>(qs, q + b * sq.b + q0 * sq.t + h * sq.h, sq.t,
                  min(TILE, sh.T - q0));
  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }
  const T* kb = k + b * sk.b + kh * sk.h;
  const T* vb = v + b * sv.b + kh * sv.h;
  const int kv_end = CAUSAL ? min(sh.S, q0 + TILE) : sh.S;

  for (int k0 = 0; k0 < kv_end; k0 += TILE) {
    __syncthreads();   // the previous tile's readers are done
    load_tile<T, D>(ks, kb + k0 * sk.t, sk.t, min(TILE, sh.S - k0));
    load_tile<T, D>(vs, vb + k0 * sv.t, sv.t, min(TILE, sh.S - k0));
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * P + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = ks[(tx + 16 * j) * P + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        float x = s[i][j] * sh.scale;
        if (c >= sh.S || (CAUSAL && c > r)) x = NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[(ty + 16 * i) * SP + tx + 16 * j] = round_to<T>(p);
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < TILE; ++c) {
      float p[4], w[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * SP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) w[j] = vs[c * P + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p[i], w[j], acc[i][j]);
    }
  }

  // out is contiguous [B, T, H, D]; lse is [B, H, T].
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= sh.T) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = out + (((long long)b * sh.T + r) * sh.H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      orow[tx + 16 * j] = from_f32<T>(acc[i][j] / den);
    if (tx == 0)
      lse[((long long)b * sh.H + h) * sh.T + r] = m[i] + logf(den);
  }
}

// ------------------------------------------------------------------ K4

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ dsum, T* __restrict__ dq,
                Strides sq, Strides sk, Strides sv, Strides sdo, Shape sh) {
  constexpr int P = D + 1, DJ = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + TILE * P;
  float* ks = dos + TILE * P;
  float* vs = ks + TILE * P;
  float* dss = vs + TILE * P;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kh = h / sh.G;
  const int q0 = qt * TILE;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q_valid = min(TILE, sh.T - q0);

  load_tile<T, D>(qs, q + b * sq.b + q0 * sq.t + h * sq.h, sq.t, q_valid);
  load_tile<T, D>(dos, dout + b * sdo.b + q0 * sdo.t + h * sdo.h, sdo.t,
                  q_valid);
  const long long stat0 = ((long long)b * sh.H + h) * sh.T;
  float lse_r[4], dsum_r[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    lse_r[i] = r < sh.T ? lse[stat0 + r] : 0.f;
    dsum_r[i] = r < sh.T ? dsum[stat0 + r] : 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }
  const T* kb = k + b * sk.b + kh * sk.h;
  const T* vb = v + b * sv.b + kh * sv.h;
  const int kv_end = CAUSAL ? min(sh.S, q0 + TILE) : sh.S;

  for (int k0 = 0; k0 < kv_end; k0 += TILE) {
    __syncthreads();
    load_tile<T, D>(ks, kb + k0 * sk.t, sk.t, min(TILE, sh.S - k0));
    load_tile<T, D>(vs, vb + k0 * sv.t, sv.t, min(TILE, sh.S - k0));
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], g[4], c[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = qs[(ty + 16 * i) * P + d];
        g[i] = dos[(ty + 16 * i) * P + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[j] = ks[(tx + 16 * j) * P + d];
        w[j] = vs[(tx + 16 * j) * P + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], c[j], s[i][j]);
          dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        float x = s[i][j] * sh.scale;
        if (c >= sh.S || (CAUSAL && c > r)) x = NEG_INF;
        const float p = expf(x - lse_r[i]);
        const float ds = p * (dp[i][j] - dsum_r[i]) * sh.scale;
        dss[(ty + 16 * i) * SP + tx + 16 * j] = round_to<T>(ds);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < TILE; ++c) {
      float e[4], w[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) e[i] = dss[(ty + 16 * i) * SP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) w[j] = ks[c * P + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(e[i], w[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= sh.T) continue;
    T* row = dq + (((long long)b * sh.T + r) * sh.H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) row[tx + 16 * j] = from_f32<T>(acc[i][j]);
  }
}

// ------------------------------------------------------------------ K5

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ dsum, T* __restrict__ dk,
                 T* __restrict__ dv, Strides sq, Strides sk, Strides sv,
                 Strides sdo, Shape sh) {
  constexpr int P = D + 1, DJ = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + TILE * P;
  float* qs = vs + TILE * P;
  float* dos = qs + TILE * P;
  float* pts = dos + TILE * P;     // p^T   [kv row][q row], do's dtype
  float* dsts = pts + TILE * SP;   // ds^T  [kv row][q row], q's dtype
  float* lse_s = dsts + TILE * SP;
  float* dsum_s = lse_s + TILE;

  const int kt = blockIdx.x;       // kv tile 0 has the most q tiles
  const int kh = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * TILE;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<T, D>(ks, k + b * sk.b + k0 * sk.t + kh * sk.h, sk.t,
                  min(TILE, sh.S - k0));
  load_tile<T, D>(vs, v + b * sv.b + k0 * sv.t + kh * sv.h, sv.t,
                  min(TILE, sh.S - k0));
  float dka[4][DJ], dva[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dka[i][j] = dva[i][j] = 0.f;
  // q rows below k0 see none of this tile's keys under the causal mask.
  const int q_start = CAUSAL ? (k0 / TILE) * TILE : 0;

  for (int g = 0; g < sh.G; ++g) {
    const int h = kh * sh.G + g;
    const long long stat0 = ((long long)b * sh.H + h) * sh.T;
    for (int q0 = q_start; q0 < sh.T; q0 += TILE) {
      const int q_valid = min(TILE, sh.T - q0);
      __syncthreads();
      load_tile<T, D>(qs, q + b * sq.b + q0 * sq.t + h * sq.h, sq.t,
                      q_valid);
      load_tile<T, D>(dos, dout + b * sdo.b + q0 * sdo.t + h * sdo.h,
                      sdo.t, q_valid);
      for (int r = threadIdx.x; r < TILE; r += THREADS) {
        lse_s[r] = r < q_valid ? lse[stat0 + q0 + r] : 0.f;
        dsum_s[r] = r < q_valid ? dsum[stat0 + q0 + r] : 0.f;
      }
      __syncthreads();

      // Transposed score tile: row c = kv row ty + 16 i, column r = q row
      // tx + 16 j.
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float a[4], w[4], c[4], e[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = ks[(ty + 16 * i) * P + d];
          w[i] = vs[(ty + 16 * i) * P + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          c[j] = qs[(tx + 16 * j) * P + d];
          e[j] = dos[(tx + 16 * j) * P + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            st[i][j] = fmaf(c[j], a[i], st[i][j]);
            dpt[i][j] = fmaf(e[j], w[i], dpt[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int rl = tx + 16 * j, r = q0 + rl;
          float x = st[i][j] * sh.scale;
          if (c >= sh.S || (CAUSAL && c > r)) x = NEG_INF;
          float p = expf(x - lse_s[rl]);
          if (rl >= q_valid) p = 0.f;   // rows past T contribute nothing
          const float ds = p * (dpt[i][j] - dsum_s[rl]) * sh.scale;
          pts[(ty + 16 * i) * SP + rl] = round_to<T>(p);
          dsts[(ty + 16 * i) * SP + rl] = round_to<T>(ds);
        }
      }
      __syncthreads();

      for (int r = 0; r < q_valid; ++r) {
        float pp[4], dd[4], e[DJ], c[DJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pp[i] = pts[(ty + 16 * i) * SP + r];
          dd[i] = dsts[(ty + 16 * i) * SP + r];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          e[j] = dos[r * P + tx + 16 * j];
          c[j] = qs[r * P + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            dva[i][j] = fmaf(pp[i], e[j], dva[i][j]);
            dka[i][j] = fmaf(dd[i], c[j], dka[i][j]);
          }
      }
    }
  }

  // dk, dv are contiguous [B, S, KH, D].
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty + 16 * i;
    if (c >= sh.S) continue;
    const long long base = (((long long)b * sh.S + c) * sh.KH + kh) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[base + tx + 16 * j] = from_f32<T>(dka[i][j]);
      dv[base + tx + 16 * j] = from_f32<T>(dva[i][j]);
    }
  }
}

// ------------------------------------------------------------ launchers

template <typename K>
cudaError_t prepare(K kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

template <typename T, int D, bool CAUSAL>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out,
                void* lse, const long long* st, Shape sh,
                cudaStream_t stream) {
  const size_t bytes = fwd_smem_floats<D>() * sizeof(float);
  auto kern = flash_fwd_kernel<T, D, CAUSAL>;
  cudaError_t err = prepare(kern, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((sh.T + TILE - 1) / TILE, sh.H, sh.B);
  kern<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), sh);
  return cudaGetLastError();
}

template <typename T, int D, bool CAUSAL>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* dsum,
                   void* dq, const long long* st, Shape sh,
                   cudaStream_t stream) {
  const size_t bytes = dq_smem_floats<D>() * sizeof(float);
  auto kern = flash_dq_kernel<T, D, CAUSAL>;
  cudaError_t err = prepare(kern, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((sh.T + TILE - 1) / TILE, sh.H, sh.B);
  kern<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<T*>(dq), strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), sh);
  return cudaGetLastError();
}

template <typename T, int D, bool CAUSAL>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* dsum,
                    void* dk, void* dv, const long long* st, Shape sh,
                    cudaStream_t stream) {
  const size_t bytes = dkv_smem_floats<D>() * sizeof(float);
  auto kern = flash_dkv_kernel<T, D, CAUSAL>;
  cudaError_t err = prepare(kern, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((sh.S + TILE - 1) / TILE, sh.KH, sh.B);
  kern<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<T*>(dk), static_cast<T*>(dv), strides_at(st, 0),
      strides_at(st, 1), strides_at(st, 2), strides_at(st, 3), sh);
  return cudaGetLastError();
}

bool valid_shape(int B, int T, int S, int H, int KH) {
  return B > 0 && T > 0 && S > 0 && KH > 0 && H > 0 && H % KH == 0 &&
         B <= 65535 && H <= 65535;
}

}  // namespace

// Dispatch over dtype (0 = float32, 1 = bfloat16), D in {64, 128} and
// causal in {0, 1}; anything else returns cudaErrorInvalidValue.
#define RT_FLASH_DISPATCH(FN, ...)                                           \
  do {                                                                       \
    if (dtype == 0 && D == 64 && causal)                                     \
      return (int)FN<float, 64, true>(__VA_ARGS__);                          \
    if (dtype == 0 && D == 64 && !causal)                                    \
      return (int)FN<float, 64, false>(__VA_ARGS__);                         \
    if (dtype == 0 && D == 128 && causal)                                    \
      return (int)FN<float, 128, true>(__VA_ARGS__);                         \
    if (dtype == 0 && D == 128 && !causal)                                   \
      return (int)FN<float, 128, false>(__VA_ARGS__);                        \
    if (dtype == 1 && D == 64 && causal)                                     \
      return (int)FN<__nv_bfloat16, 64, true>(__VA_ARGS__);                  \
    if (dtype == 1 && D == 64 && !causal)                                    \
      return (int)FN<__nv_bfloat16, 64, false>(__VA_ARGS__);                 \
    if (dtype == 1 && D == 128 && causal)                                    \
      return (int)FN<__nv_bfloat16, 128, true>(__VA_ARGS__);                 \
    if (dtype == 1 && D == 128 && !causal)                                   \
      return (int)FN<__nv_bfloat16, 128, false>(__VA_ARGS__);                \
    return (int)cudaErrorInvalidValue;                                       \
  } while (0)

// Shared memory one block of each kernel needs, in bytes (which: 0 = K3,
// 1 = K4, 2 = K5), for the wrapper's check against the card's 227 KB.
extern "C" long long flash_smem_bytes(int which, int D) {
  const size_t f = which == 0 ? (D == 64 ? fwd_smem_floats<64>()
                                         : fwd_smem_floats<128>())
                 : which == 1 ? (D == 64 ? dq_smem_floats<64>()
                                         : dq_smem_floats<128>())
                              : (D == 64 ? dkv_smem_floats<64>()
                                         : dkv_smem_floats<128>());
  return (long long)(f * sizeof(float));
}

// strides: 3 per tensor (batch, row, head), in elements, in the order
// q, k, v. out [B, T, H, D] and lse [B, H, T] f32 are written contiguous.
extern "C" int flash_forward(const void* q, const void* k, const void* v,
                             void* out, void* lse, int B, int T, int S,
                             int H, int KH, int D, const long long* strides,
                             float scale, int causal, int dtype,
                             void* stream) {
  if (!valid_shape(B, T, S, H, KH)) return (int)cudaErrorInvalidValue;
  Shape sh{B, T, S, H, KH, H / KH, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RT_FLASH_DISPATCH(fwd, q, k, v, out, lse, strides, sh, s);
}

// strides in the order q, k, v, do. dq [B, T, H, D] is written contiguous.
extern "C" int flash_backward_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* dsum, void* dq, int B, int T,
                                 int S, int H, int KH, int D,
                                 const long long* strides, float scale,
                                 int causal, int dtype, void* stream) {
  if (!valid_shape(B, T, S, H, KH)) return (int)cudaErrorInvalidValue;
  Shape sh{B, T, S, H, KH, H / KH, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RT_FLASH_DISPATCH(bwd_dq, q, k, v, dout, lse, dsum, dq, strides, sh, s);
}

// strides in the order q, k, v, do. dk, dv [B, S, KH, D] are written
// contiguous.
extern "C" int flash_backward_dkv(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* dsum,
                                  void* dk, void* dv, int B, int T, int S,
                                  int H, int KH, int D,
                                  const long long* strides, float scale,
                                  int causal, int dtype, void* stream) {
  if (!valid_shape(B, T, S, H, KH)) return (int)cudaErrorInvalidValue;
  Shape sh{B, T, S, H, KH, H / KH, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RT_FLASH_DISPATCH(bwd_dkv, q, k, v, dout, lse, dsum, dk, dv, strides, sh,
                    s);
}
