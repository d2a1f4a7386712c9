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
// L+1 = 96 (0.94 us at 3.35 TB/s) and 67.1 MB at L+1 = 2048 (20 us).
//
// Design against that bound: split-K. Each (b, kv head) runs as n_split
// blocks, B*KH*n_split in all (n_split from the wrapper, a function of
// B*KH, G and D alone, so the bits do not depend on the cache's length or
// the card), each walking a contiguous run of the sequence's 64-row tiles
// and stopping at the tile that holds row L_b, so rows past the length are
// never read (the TPU's sequential grid axis and its truncate_dma index map,
// cut across blocks). The last split to finish merges the others' partial
// softmax states in split order. The G query heads of the group are rows of
// each block, so K and V are read once per group, not once per query head.
// Tiles are read straight from the cache's native [B, S, KH, D] layout
// through its strides (the cache is never transposed), by cp.async a tile
// ahead of the one being computed. The block body, the split plan, the merge
// and their numerics live in decode_tile.cuh, shared with the paged kernel
// K7. Tensor-core products, TMA and clusters are left for later work.

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
              T* __restrict__ out, float* __restrict__ partials,
              int* __restrict__ tickets, int S, int KH, int G, int n_split,
              long long k_sb, long long k_ss, long long v_sb, long long v_ss,
              float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bkh = blockIdx.x / n_split;
  const int split = blockIdx.x % n_split;
  const int b = bkh / KH;
  const int kh = bkh % KH;
  // Callers guarantee 0 <= lengths[b] < S; clamp so a bad length can never
  // read outside the cache.
  const int length = min(max(lengths[b], 0), S - 1);
  const size_t head0 = (size_t)b * KH * G + (size_t)kh * G;
  decode_block<T, D>(q + head0 * D, out + head0 * D,
                     k + (size_t)b * k_sb + (size_t)kh * D,
                     v + (size_t)b * v_sb + (size_t)kh * D,
                     ContiguousRows{k_ss, v_ss}, length, G, scale, split,
                     n_split, partials + bkh * n_split * partial_floats(G, D),
                     tickets + bkh, smem);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* out, float* partials,
                   int* tickets, int B, int S, int KH, int G, int n_split,
                   long long k_sb, long long k_ss, long long v_sb,
                   long long v_ss, float scale, cudaStream_t stream) {
  const size_t bytes = smem_bytes(G, D, sizeof(T));
  auto kern = decode_kernel<T, D>;
  cudaError_t err = allow_smem(kern, bytes);
  if (err != cudaSuccess) return err;
  kern<<<B * KH * n_split, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), partials,
      tickets, S, KH, G, n_split, k_sb, k_ss, v_sb, v_ss, scale);
  return cudaGetLastError();
}

}  // namespace

// Shared memory one block needs, in bytes (the wrapper refuses shapes above
// the card's 227 KB per block). dtype: 0 = float32, 1 = bfloat16.
extern "C" long long decode_attention_smem_bytes(int G, int D, int dtype) {
  return (long long)smem_bytes(G, D, dtype == 0 ? 4 : 2);
}

// q, out: [B, H = KH*G, D] contiguous. k, v: [B, S, KH, D] with the last two
// dims contiguous and batch/row strides (in elements) given. lengths: [B]
// int32 on the device. partials: B*KH*n_split*(G*D + 2*G) floats of scratch,
// any contents; tickets: B*KH ints, 0 before the launch and 0 after it.
// 1 <= n_split <= 64. dtype: 0 = float32, 1 = bfloat16; D in {8, 16, 32,
// 64, 128}.
// Returns cudaGetLastError() after the launch.
extern "C" int decode_attention_forward(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, void* partials, void* tickets, int B, int S, int KH, int G,
    int D, int n_split, long long k_sb, long long k_ss, long long v_sb,
    long long v_ss, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  float* part = static_cast<float*>(partials);
  int* tick = static_cast<int*>(tickets);
  if (B <= 0 || S <= 0 || KH <= 0 || G <= 0 || n_split < 1 ||
      n_split > MAX_SPLIT)
    return (int)cudaErrorInvalidValue;
#define RT_DECODE(T, DD)                                                    \
  return (int)launch<T, DD>(q, k, v, len, out, part, tick, B, S, KH, G,     \
                            n_split, k_sb, k_ss, v_sb, v_ss, scale, s)
#define RT_DECODE_D(DD)                                                     \
  if (D == DD) {                                                            \
    if (dtype == 0) RT_DECODE(float, DD);                                   \
    if (dtype == 1) RT_DECODE(__nv_bfloat16, DD);                           \
  }
  RT_DECODE_D(8)
  RT_DECODE_D(16)
  RT_DECODE_D(32)
  RT_DECODE_D(64)
  RT_DECODE_D(128)
#undef RT_DECODE_D
#undef RT_DECODE
  return (int)cudaErrorInvalidValue;
}
