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
// are read straight from the cache's native [B, S, KH, D] layout through its
// strides (the cache is never transposed). The block body, its numerics and
// its tiling live in decode_tile.cuh, shared with the paged kernel K7.
// Split-K across blocks, cp.async/TMA pipelining and tensor-core products
// are left for later work.

#include "decode_tile.cuh"

namespace {

using namespace decode_tile;

// Logical row s of one sequence: s rows down the contiguous cache.
struct ContiguousRows {
  long long k_ss, v_ss;
  __device__ __forceinline__ long long k(int s) const { return s * k_ss; }
  __device__ __forceinline__ long long v(int s) const { return s * v_ss; }
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ lengths,
              T* __restrict__ out, int S, int KH, int G, long long k_sb,
              long long k_ss, long long v_sb, long long v_ss, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / KH;
  const int kh = blockIdx.x % KH;
  // Callers guarantee 0 <= lengths[b] < S; clamp so a bad length can never
  // read outside the cache.
  const int length = min(max(lengths[b], 0), S - 1);
  const size_t head0 = (size_t)b * KH * G + (size_t)kh * G;
  decode_block<T, D>(q + head0 * D, out + head0 * D,
                     k + (size_t)b * k_sb + (size_t)kh * D,
                     v + (size_t)b * v_sb + (size_t)kh * D,
                     ContiguousRows{k_ss, v_ss}, length, G, scale, smem);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* out, int B, int S, int KH, int G,
                   long long k_sb, long long k_ss, long long v_sb,
                   long long v_ss, float scale, cudaStream_t stream) {
  const size_t bytes = smem_floats(G, D) * sizeof(float);
  auto kern = decode_kernel<T, D>;
  cudaError_t err = allow_smem(kern, bytes);
  if (err != cudaSuccess) return err;
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
