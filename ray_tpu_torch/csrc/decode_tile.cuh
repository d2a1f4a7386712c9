// The flash-decode block body shared by decode_attention.cu (K6, contiguous
// cache) and paged_decode_attention.cu (K7, paged pool). The two kernels
// differ only in where logical cache row s lives, which each passes in as a
// Rows object; the split plan, the tiles, their order and the arithmetic are
// one copy, so K7 on a page table gives K6's bits on the same rows laid out
// contiguously.
//
// Split-K. Each (sequence, kv head) runs as n_split blocks. The sequence's
// live tiles, length / TK + 1 of them, go to the splits in runs of
// ceil(tiles / n_split), split 0 first (split_range below): a short sequence
// gets short splits, split 0 always holds row 0, and a split past the last
// live tile returns before it loads anything. n_split is the caller's, one
// function of shapes both kernels know, so their plans agree. A split's
// block holds the G query heads as rows and walks its tiles of TK = 64 rows;
// a sequence with one live split writes its output directly. Otherwise each
// live split writes its running max m, sum l and unnormalised f32
// accumulator [G, D] to the caller's scratch, takes a ticket, and the block
// that takes the last ticket resets the ticket to 0 for the next launch and
// merges the partials in split order:
//   m = max m_i,  l = sum l_i exp(m_i - m),  acc = sum acc_i exp(m_i - m),
//   out = acc / max(l, 1e-30).
// The order is fixed by split index, not by arrival, so two launches give
// the same bits.
//
// The tile walk. Tiles come into shared memory in the cache's dtype by
// 16-byte cp.async, STAGES deep, so the next tile's rows are in flight while
// this tile is computed; K rows are padded by one 16-byte vector so the
// score loop's 16-byte row reads are free of bank conflicts, and rows past
// the length are never copied nor read. The online softmax keeps its running
// max, sum and accumulator in f32. As in the Pallas kernel, scores are
// scaled after the f32 dot product, masked positions score NEG_INF = -1e30,
// the probabilities enter the PV product rounded to the cache's dtype, and
// the final division clamps the sum at 1e-30.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tc_tile.cuh"

namespace decode_tile {

constexpr int TK = 64;          // cache rows per tile
constexpr int THREADS = 128;    // threads per block
constexpr int STAGES = 2;       // tiles in flight per block (1: no prefetch)
constexpr int MAX_SPLIT = TK;   // the merge keeps [n_split][G] weights in p
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

// Elements of one stage: a K tile [TK][D + pad] and a V tile [TK][D], with
// pad = one 16-byte vector of elem-byte values.
__host__ __device__ constexpr size_t stage_elems(int D, int elem) {
  return (size_t)TK * (D + 16 / elem) + (size_t)TK * D;
}

// Dynamic shared memory of one block: the STAGES tile stages in the cache's
// dtype (elem bytes a value), then f32 q, acc [G][D]; p [G][TK]; m, l,
// corr [G].
__host__ __device__ constexpr size_t smem_bytes(int G, int D, int elem) {
  return (size_t)STAGES * stage_elems(D, elem) * elem +
         sizeof(float) * ((size_t)2 * G * D + (size_t)G * TK + 3 * (size_t)G);
}

// Floats of one split's partial: acc [G][D], then m [G], then l [G].
__host__ __device__ constexpr size_t partial_floats(int G, int D) {
  return (size_t)G * D + 2 * (size_t)G;
}

// The split plan: split `split` of a sequence whose inclusive last row is
// `length` walks tiles [*first, *end); it is empty when *first >= *end.
// Returns the number of live splits.
__host__ __device__ __forceinline__ int split_range(int length, int n_split,
                                                   int split, int* first,
                                                   int* end) {
  const int tiles = length / TK + 1;
  const int per = (tiles + n_split - 1) / n_split;
  *first = split * per;
  *end = *first + per < tiles ? *first + per : tiles;
  return (tiles + per - 1) / per;
}

template <typename T, int D>
struct Smem {
  static constexpr int KP = D + 16 / sizeof(T);   // K row pitch, elements
  T* tiles;
  float *q, *acc, *p, *m, *l, *c;
  __device__ __forceinline__ Smem(unsigned char* base, int G) {
    tiles = reinterpret_cast<T*>(base);
    q = reinterpret_cast<float*>(base + STAGES * stage_elems(D, sizeof(T)) *
                                            sizeof(T));
    acc = q + G * D;
    p = acc + G * D;
    m = p + G * TK;
    l = m + G;
    c = l + G;
  }
  __device__ __forceinline__ T* k_tile(int stage) const {
    return tiles + stage * stage_elems(D, sizeof(T));
  }
  __device__ __forceinline__ T* v_tile(int stage) const {
    return k_tile(stage) + TK * KP;
  }
};

// Start the copies of rows t0 .. t0 + n - 1 into one stage (no commit).
template <typename T, int D, typename Rows>
__device__ __forceinline__ void load_tile(const Smem<T, D>& sm, int stage,
                                          const T* __restrict__ kb,
                                          const T* __restrict__ vb,
                                          const Rows& rows, int t0, int n) {
  constexpr int VEC = 16 / sizeof(T);
  T* k_s = sm.k_tile(stage);
  T* v_s = sm.v_tile(stage);
  for (int e = threadIdx.x; e < n * (D / VEC); e += THREADS) {
    const int j = e / (D / VEC);
    const int c = (e % (D / VEC)) * VEC;
    const int s = t0 + j;
    tc_tile::cp_async_16(k_s + j * Smem<T, D>::KP + c, kb + rows.k(s) + c,
                         true);
    tc_tile::cp_async_16(v_s + j * D + c, vb + rows.v(s) + c, true);
  }
}

// The online softmax over tiles [first, end) of rows 0..length; leaves the
// split's m, l and acc in sm.
template <typename T, int D, typename Rows>
__device__ __forceinline__ void walk_tiles(
    const Smem<T, D>& sm, const T* __restrict__ qb, const T* __restrict__ kb,
    const T* __restrict__ vb, const Rows& rows, int first, int end,
    int length, int G, float scale) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int NWARP = THREADS / 32;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  for (int s = 0; s < STAGES - 1; ++s) {
    const int t = first + s;
    if (t < end) load_tile(sm, s, kb, vb, rows, t * TK,
                           min(TK, length - t * TK + 1));
    tc_tile::cp_async_commit();
  }
  for (int i = tid; i < G * D; i += THREADS) {
    sm.q[i] = to_f32(qb[i]);
    sm.acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    sm.m[g] = NEG_INF;
    sm.l[g] = 0.f;
  }

  for (int t = first; t < end; ++t) {
    const int tn = t + STAGES - 1;
    if (tn < end) load_tile(sm, (tn - first) % STAGES, kb, vb, rows, tn * TK,
                            min(TK, length - tn * TK + 1));
    tc_tile::cp_async_commit();
    tc_tile::cp_async_wait<STAGES - 1>();
    __syncthreads();
    const int stage = (t - first) % STAGES;
    const T* k_s = sm.k_tile(stage);
    const T* v_s = sm.v_tile(stage);
    const int n = min(TK, length - t * TK + 1);   // live rows in this tile

    // Scores: one (query head, row) pair per thread, f32 dot, then scale.
    for (int e = tid; e < G * TK; e += THREADS) {
      const int g = e / TK, j = e % TK;
      float sc = NEG_INF;
      if (j < n) {
        const float* qr = sm.q + g * D;
        const T* kr = k_s + j * Smem<T, D>::KP;
        float a = 0.f;
#pragma unroll
        for (int c = 0; c < D; c += VEC) {
          const uint4 raw = *reinterpret_cast<const uint4*>(kr + c);
          const T* kv = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int i = 0; i < VEC; ++i) a += qr[c + i] * to_f32(kv[i]);
        }
        sc = a * scale;
      }
      sm.p[g * TK + j] = sc;
    }
    __syncthreads();

    // Online softmax: one warp per query head.
    for (int g = warp; g < G; g += NWARP) {
      float* pr = sm.p + g * TK;
      const float m_prev = sm.m[g];
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
        sm.c[g] = corr;
        sm.l[g] = sm.l[g] * corr + sum;
        sm.m[g] = m_new;
      }
    }
    __syncthreads();

    // Accumulate P @ V into the f32 accumulator, one (head, dim) per thread.
    for (int o = tid; o < G * D; o += THREADS) {
      const int g = o / D, d = o % D;
      const float* pr = sm.p + g * TK;
      float a = sm.acc[o] * sm.c[g];
      for (int j = 0; j < n; ++j) a += pr[j] * to_f32(v_s[j * D + d]);
      sm.acc[o] = a;
    }
    __syncthreads();   // the stage and p are free for the next tile
  }
}

// One block of a split launch: split `split` of n_split of one (sequence,
// kv head). qb, ob: the G query heads, [G][D] contiguous. kb, vb: the kv
// head in row 0's page or sequence; rows.k(s) / rows.v(s) give logical row
// s's offset from them, in elements. length: the inclusive last row, already
// clamped to the rows the caller may read. part: this (sequence, kv head)'s
// n_split partials of partial_floats(G, D) floats; ticket: its counter, 0
// between launches. smem: smem_bytes(G, D, sizeof(T)) bytes.
template <typename T, int D, typename Rows>
__device__ __forceinline__ void decode_block(
    const T* __restrict__ qb, T* __restrict__ ob, const T* __restrict__ kb,
    const T* __restrict__ vb, const Rows& rows, int length, int G,
    float scale, int split, int n_split, float* __restrict__ part,
    int* ticket, unsigned char* smem) {
  int first, end;
  const int live = split_range(length, n_split, split, &first, &end);
  if (first >= end) return;   // past the last live tile: no loads, no part
  const Smem<T, D> sm(smem, G);
  walk_tiles<T, D>(sm, qb, kb, vb, rows, first, end, length, G, scale);
  const int tid = threadIdx.x;
  if (live == 1) {
    for (int o = tid; o < G * D; o += THREADS)
      ob[o] = from_f32<T>(sm.acc[o] / fmaxf(sm.l[o / D], 1e-30f));
    return;
  }

  const size_t pf = partial_floats(G, D);
  float* mine = part + split * pf;
  for (int o = tid; o < G * D; o += THREADS) mine[o] = sm.acc[o];
  for (int g = tid; g < G; g += THREADS) {
    mine[G * D + g] = sm.m[g];
    mine[G * D + G + g] = sm.l[g];
  }
  __threadfence();   // this block's partial is visible before its ticket
  __syncthreads();
  __shared__ int last;
  if (tid == 0) last = atomicAdd(ticket, 1) == live - 1;
  __syncthreads();
  if (!last) return;
  if (tid == 0) atomicExch(ticket, 0);   // the next launch finds 0
  __threadfence();

  // Merge the live partials in split order (read through L2: other SMs
  // wrote them). w = sm.p holds exp(m_i - m) as [live][G].
  float* w = sm.p;
  for (int g = tid; g < G; g += THREADS) {
    float mx = NEG_INF;
    for (int i = 0; i < live; ++i)
      mx = fmaxf(mx, __ldcg(part + i * pf + G * D + g));
    float l = 0.f;
    for (int i = 0; i < live; ++i) {
      const float wi = expf(__ldcg(part + i * pf + G * D + g) - mx);
      w[i * G + g] = wi;
      l += __ldcg(part + i * pf + G * D + G + g) * wi;
    }
    sm.l[g] = l;
  }
  __syncthreads();
  for (int o = tid; o < G * D; o += THREADS) {
    const int g = o / D;
    float a = 0.f;
    for (int i = 0; i < live; ++i)
      a += __ldcg(part + i * pf + o) * w[i * G + g];
    ob[o] = from_f32<T>(a / fmaxf(sm.l[g], 1e-30f));
  }
}

// Opt a kernel into more than 48 KB of dynamic shared memory where needed.
template <typename Kernel>
cudaError_t allow_smem(Kernel kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace decode_tile
