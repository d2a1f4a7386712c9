// Paged flash-decode attention for Hopper (sm_90a): one query position per
// sequence against a shared pool of KV pages, each sequence's pages named
// by its row of a page table.
//
// Replaces: ray_tpu/ops/paged_attention.py, _paged_flash_decode (the Pallas
// TPU kernel; it reuses _decode_kernel with page-table index maps). For
// sequence b, logical cache row s lives at pool row
//   max(page_table[b, s / ps], 0) * ps + s % ps
// of k_pages/v_pages [num_pages, ps, KH, D], and out[b, h] is K6's
// softmax(q[b, h] . k[b, 0..L_b, h/G]^T * D^-0.5) @ v[b, 0..L_b, h/G] over
// those rows, L_b = lengths[b] INCLUSIVE. A -1 table entry at or before the
// last live page reads page 0 (the engine's scratch page), as the Pallas
// index map's max(page, 0) does: an idle slot (length 0, a table of -1)
// attends scratch row 0 and never yields an empty softmax.
//
// Bound on this card: bytes, as K6: 2 * sum_b (L_b + 1) * KH * D *
// sizeof(T) of live K/V rows plus the table entries those rows name; a few
// flops per byte times G, far below the ridge. At the flagship decode shape
// (B=8, KH=16, D=64, bf16) 8 sequences at L+1 = 600 move 19.7 MB (5.9 us at
// 3.35 TB/s).
//
// Design against that bound: K6's blocks verbatim (decode_tile.cuh): each
// (b, kv head) runs as n_split blocks with K6's split plan (n_split from the
// wrapper, the same function of B*KH, G and D as K6's, never of P * ps, the
// page size or the table), each walking its run of logical 64-row tiles in
// K6's order with K6's arithmetic, the last to finish merging the partials
// in split order, so a paged sequence gives the bits K6 gives on the same
// rows laid out contiguously (the paged engine's greedy outputs equal the
// contiguous engine's). Only the row address differs: each 16-byte cp.async
// looks its page up in the table (an L1-cached int per row), so any page
// size works and pages may lie anywhere in the pool, read through the
// pool's page and row strides (a layer slice of the [L, num_pages, ps, KH,
// D] pool is read in place). Table entries past L_b / ps, which may be -1 or
// stale, are never read; the walk stops at row P * ps - 1, the last row a
// table row can name (the Pallas grid's P steps), and a page id is clamped
// into the pool, so no length or table entry can make the kernel read
// outside it. TMA page gathers and tensor-core products are left for later
// work.

#include "decode_tile.cuh"

namespace {

using namespace decode_tile;

// Logical row s of one sequence, through its row of the page table.
struct PagedRows {
  const int* table;   // this sequence's P page ids, -1 padded
  int ps, last_page;
  long long k_ps, k_rs, v_ps, v_rs;   // page and row strides, in elements
  __device__ __forceinline__ long long page(int s) const {
    return (long long)min(max(__ldg(table + s / ps), 0), last_page);
  }
  __device__ __forceinline__ long long k(int s) const {
    return page(s) * k_ps + (long long)(s % ps) * k_rs;
  }
  __device__ __forceinline__ long long v(int s) const {
    return page(s) * v_ps + (long long)(s % ps) * v_rs;
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ table,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    float* __restrict__ partials, int* __restrict__ tickets,
                    int P, int ps, int num_pages, int KH, int G, int n_split,
                    long long t_sb, long long k_ps, long long k_rs,
                    long long v_ps, long long v_rs, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bkh = blockIdx.x / n_split;
  const int split = blockIdx.x % n_split;
  const int b = bkh / KH;
  const int kh = bkh % KH;
  // The Pallas grid walks P pages, so rows past P * ps - 1 are never read;
  // a negative length attends row 0, as there.
  const int length = min(max(lengths[b], 0), P * ps - 1);
  const size_t head0 = (size_t)b * KH * G + (size_t)kh * G;
  decode_block<T, D>(q + head0 * D, out + head0 * D, k + (size_t)kh * D,
                     v + (size_t)kh * D,
                     PagedRows{table + (size_t)b * t_sb, ps, num_pages - 1,
                               k_ps, k_rs, v_ps, v_rs},
                     length, G, scale, split, n_split,
                     partials + bkh * n_split * partial_floats(G, D),
                     tickets + bkh, smem);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* table, const int* lengths, void* out,
                   float* partials, int* tickets, int B, int P, int ps,
                   int num_pages, int KH, int G, int n_split, long long t_sb,
                   long long k_ps, long long k_rs, long long v_ps,
                   long long v_rs, float scale, cudaStream_t stream) {
  const size_t bytes = smem_bytes(G, D, sizeof(T));
  auto kern = paged_decode_kernel<T, D>;
  cudaError_t err = allow_smem(kern, bytes);
  if (err != cudaSuccess) return err;
  kern<<<B * KH * n_split, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), table, lengths, static_cast<T*>(out),
      partials, tickets, P, ps, num_pages, KH, G, n_split, t_sb, k_ps, k_rs,
      v_ps, v_rs, scale);
  return cudaGetLastError();
}

}  // namespace

// Shared memory one block needs, in bytes (the wrapper refuses shapes above
// the card's 227 KB per block). dtype: 0 = float32, 1 = bfloat16.
extern "C" long long paged_decode_attention_smem_bytes(int G, int D,
                                                       int dtype) {
  return (long long)smem_bytes(G, D, dtype == 0 ? 4 : 2);
}

// q, out: [B, H = KH*G, D] contiguous. k_pages, v_pages: [num_pages, ps, KH,
// D] with the last two dims contiguous and page/row strides (in elements)
// given. page_table: [B, P] int32 with row stride t_sb, -1 padded. lengths:
// [B] int32. partials: B*KH*n_split*(G*D + 2*G) floats of scratch, any
// contents; tickets: B*KH ints, 0 before the launch and 0 after it. All on
// the device. 1 <= n_split <= 64. dtype: 0 = float32, 1 = bfloat16; D in
// {8, 16, 32, 64, 128}. Returns cudaGetLastError() after the launch.
extern "C" int paged_decode_attention_forward(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* lengths, void* out, void* partials,
    void* tickets, int B, int P, int ps, int num_pages, int KH, int G, int D,
    int n_split, long long t_sb, long long k_ps, long long k_rs,
    long long v_ps, long long v_rs, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tbl = static_cast<const int*>(page_table);
  const int* len = static_cast<const int*>(lengths);
  float* part = static_cast<float*>(partials);
  int* tick = static_cast<int*>(tickets);
  if (B <= 0 || P <= 0 || ps <= 0 || num_pages <= 0 || KH <= 0 || G <= 0 ||
      n_split < 1 || n_split > MAX_SPLIT)
    return (int)cudaErrorInvalidValue;
#define RT_PAGED(T, DD)                                                     \
  return (int)launch<T, DD>(q, k_pages, v_pages, tbl, len, out, part, tick, \
                            B, P, ps, num_pages, KH, G, n_split, t_sb, k_ps, \
                            k_rs, v_ps, v_rs, scale, s)
#define RT_PAGED_D(DD)                                                      \
  if (D == DD) {                                                            \
    if (dtype == 0) RT_PAGED(float, DD);                                    \
    if (dtype == 1) RT_PAGED(__nv_bfloat16, DD);                            \
  }
  RT_PAGED_D(8)
  RT_PAGED_D(16)
  RT_PAGED_D(32)
  RT_PAGED_D(64)
  RT_PAGED_D(128)
#undef RT_PAGED_D
#undef RT_PAGED
  return (int)cudaErrorInvalidValue;
}
