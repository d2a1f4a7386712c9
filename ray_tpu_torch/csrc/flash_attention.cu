// Flash attention forward and backward for Hopper (sm_90a): six kernels,
// a tensor-core one for bf16 and an FMA one for f32 of each.
//
// Replaces (ray_tpu/ops/attention.py, the Pallas TPU kernels):
//   flash_fwd_tc_kernel (bf16) and flash_fwd_kernel (f32)
//                     <- _flash_kernel via _flash_forward (K3): out and the
//                        row logsumexp lse;
//   flash_dq_tc_kernel (bf16) and flash_dq_kernel (f32)
//                     <- _bwd_dq_kernel via _flash_backward, first
//                        pallas_call (K4): dq;
//   flash_dkv_tc_kernel (bf16) and flash_dkv_kernel (f32)
//                     <- _bwd_dkv_kernel via _flash_backward, second
//                        pallas_call (K5): dk and dv.
// q, out, do: [B, T, H, D]; k, v: [B, S, KH, D] (the JAX layout), read
// through their batch/row/head strides with the last axis contiguous, never
// transposed. Query head h = kh * G + g reads kv head kh. lse, dsum:
// [B, H, T] f32. dq: [B, T, H, D]; dk, dv: [B, S, KH, D], contiguous.
//
// The arithmetic follows the Pallas kernels, not the XLA reference: scores
// are f32 dot products scaled afterwards; masked positions (causal k > q, and
// the ragged tails past T or S) score NEG_INF = -1e30; in the forward the
// online softmax keeps its running max, sum and accumulator in f32, the sum
// takes the unrounded f32 p, p enters the PV product rounded to v's dtype,
// o = acc / max(l, 1e-30) and lse = m + log(max(l, 1e-30)); in the backward
// p = exp(s - lse) and ds = p * (dp - dsum) * scale, with p rounded to do's
// dtype for dv and ds to q's or k's for dk and dq. One difference: dk and dv
// are summed over the G query heads of a group in f32 inside K5, where the
// JAX package casts each head's result to bf16 and sums those.
//
// Head dims: 16, 32, 64 and 128, each in f32 and bf16. The tile shapes
// below were chosen and measured at 64 and 128; 16 and 32, the head dims of
// the small models the examples and soak scripts run, take 128's.
//
// K3, what bounds it on this card: operations. At the training path's shape
// (B 8, T = S 2048, H = KH 16, D 64, causal) each of its two products
// (S = Q K^T, then O = P V) is 2*B*H*D*T*(T+1)/2 = 34.4 GFLOP: 69.5 us at
// 989 TFLOP/s bf16. Its bytes (q, k, v, out once each, lse) are ~34 MB, ~10
// us at 3.35 TB/s. So the design keeps the tensor cores fed and everything
// else (softmax, loads) in their shadow:
//   - both products are mma.sync m16n8k16 bf16 -> f32 (csrc/tc_tile.cuh);
//   - one warp owns 16 query rows. A block holds 128 of them (8 warps) at
//     D 64 and 64 (4 warps) at D 128, and 2 blocks share an SM: the warps
//     in flight are what hides each warp's serial S -> softmax -> PV chain.
//     Q's fragments come by ldmatrix once per block and stay in registers
//     at D 128; at D 64 the 128 registers a thread has at 2 blocks of 8
//     warps do not hold them, so ldmatrix reloads them for every kv tile;
//   - the score tile stays in registers: its f32 accumulators, packed to
//     bf16 pairs, are the A operand of P V, so P never touches shared
//     memory; row max and sum reduce over the quad of lanes holding a row,
//     and each lane keeps its share of l until the end;
//   - K and V arrive as bf16 tiles of 64 rows by cp.async into a ring of
//     three stages at D 64 and two at D 128: the next tiles are in flight
//     while tile i's products run; rows past S are zero-filled; one barrier
//     a tile. Rows are padded to D + 8 elements, so the 8 row addresses of
//     every ldmatrix fall on distinct bank groups;
//   - tiles above a warp's causal diagonal are skipped; only tiles that
//     straddle it or the ragged edge of S are masked, each score by one
//     compare of its column against its row's last column;
//   - the block's q tile is the slowest grid axis, walked last-first, so
//     the longest kv loops start first;
//   - out is staged through the warp's own rows of the Q tile and written
//     with 16-byte stores.
// exp is 2^x on the special-function unit, p = 2^(x log2 e - m log2 e).
// The f32 path keeps the FMA kernel below (no TF32: its results hold the f32
// train step to the CPU's within 3.4e-6).
//
// K4, K5 in bf16. Bound: operations. K4 does 3 causal products of 34.4
// GFLOP at the training shape (S = Q K^T, dP = dO V^T, dQ = dS K: 104 us at
// 989 TFLOP/s), K5 4 (S^T, dP^T, dV = P^T dO, dK = dS^T Q: 139 us); their
// bytes are ~13 us. So, as for K3, every product is mma.sync m16n8k16 and
// the elementwise work between them stays in registers:
//   - two kernels and no atomics, as on the TPU: K4 writes dq, K5 dk and
//     dv, each block its own output tile once, so the bits are the same on
//     every run;
//   - K4: one warp owns 16 query rows and walks the kv tiles up to its
//     diagonal (K3's loop). S and dP take K and V as stored for the B
//     operand; p = 2^(s scale log2 e - lse log2 e) and ds = p (dp - dsum)
//     scale replace them in registers, with lse and dsum of the warp's
//     rows g, g + 8 in four registers; ds, packed to bf16 pairs, is the A
//     fragment of dQ += dS K, K read by ldmatrix.trans. Q and dO are loaded
//     once; K and V stream through a cp.async ring;
//   - K5: one warp owns 16 kv rows and walks the G query heads of its group
//     and the q tiles from the diagonal on. It computes the transposed
//     tiles S^T = K Q^T and dP^T = V dO^T (Q and dO as the B operand, as
//     stored), so that p^T and ds^T, packed, are the A fragments of
//     dV += P^T dO and dK += dS^T Q (dO and Q by ldmatrix.trans): neither
//     touches shared memory. lse and dsum index the columns here: they
//     arrive with each q tile by 4-byte cp.async into a small shared array.
//     q rows past T get p = 0 (their zero-filled q row would give
//     p = 2^0). K and V are loaded once; Q, dO, lse, dsum stream through a
//     cp.async ring;
//   - each pass of S and dP covers a chunk of 32 or 64 columns, not the
//     whole 64-column tile, so that both f32 tiles fit in registers beside
//     the accumulators; the operands' fragments are reloaded by ldmatrix
//     for each chunk;
//   - registers decide the tile sizes (set by measurement with
//     flash_variants.py; ptxas must report no spill, chip_smoke.py fails
//     on one): K4 keeps 16 x D f32 of dq a warp, as K3 keeps out, and runs
//     K3's shapes (8 warps and 128 registers at D 64, 4 warps at D 128, 2
//     blocks per SM). K5 keeps dk and dv, 64 registers a thread at D 64 and
//     128 at D 128, so it runs 4 warps (64 kv rows) a block, 3 blocks per SM
//     at D 64 (168 registers) and 2 at D 128 (255);
//   - K4's q tiles run last-first and K5's kv tile 0 (the most q tiles)
//     first, so the longest loops start first;
//   - one barrier a tile, rows padded to D + 8, masks only on the chunks
//     that straddle the diagonal or a ragged edge, outputs staged through
//     the warp's own rows of the resident tile for 16-byte stores.
//
// K3, K4, K5 in f32. Design, simple first: FMA loops on the CUDA cores over
// f32 tiles in shared memory, no tensor cores (so no TF32: the f32 train
// step holds to the CPU's), no cp.async/TMA pipelining. Each
// block holds 64-row tiles; its 256 threads form a 16 x 16 grid and each
// owns a 4 x 4 micro-tile of the 64 x 64 score tile (rows ty + 16 i,
// columns tx + 16 j) and 4 rows x D/16 columns of the f32 accumulators, in
// registers. Tile rows are padded to D + 1 floats so the per-row dot
// products are free of bank conflicts. Row statistics are reduced over the
// 16 threads of a row with shuffles. Tiles above the causal diagonal are
// skipped. Blocks carry nothing between each other, so:
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

#include "tc_tile.cuh"

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

// ------------------------------------------------------------- K3, f32

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

// ------------------------------------------------------------ K3, bf16

constexpr int TC_BN = 64;          // kv rows per tile
constexpr int TC_MIN_BLOCKS = 2;   // blocks per SM the registers must allow

// By head dim (measured with k3_variants.py): warps per block, each owning
// 16 query rows; the depth of the K/V ring; and whether Q's fragments stay
// in registers for the whole kv loop (else ldmatrix reloads them for every
// tile). At D 64 with 8 warps, 2 blocks per SM leave 128 registers a
// thread, and Q's 16 fragment registers would spill. At D 128 a third
// stage would leave shared memory for one block per SM. D 16 and 32 (the
// small models of the examples and soaks) take D 128's choices, untuned:
// 4 warps, so that a 64-row tile of 2 or 4 16-byte chunks a row is whole
// chunks per thread for tile_async, and Q's one or two fragments stay in
// registers.
template <int D>
__host__ __device__ constexpr int tc_warps() { return D == 64 ? 8 : 4; }
template <int D>
__host__ __device__ constexpr int tc_stages() { return D == 64 ? 3 : 2; }
template <int D>
__host__ __device__ constexpr bool tc_q_in_regs() { return D != 64; }
template <int D>
__host__ __device__ constexpr size_t fwd_tc_smem_bytes() {
  // Q [16 * warps][D + 8], K and V [stages][TC_BN][D + 8], bf16.
  return (size_t)(16 * tc_warps<D>() + 2 * tc_stages<D>() * TC_BN) *
         (D + 8) * sizeof(__nv_bfloat16);
}

// Rows [row0, row0 + ROWS) of a [rows, D] bf16 view (row stride in
// elements) into dst [ROWS][D + 8] by cp.async; rows at or past end are
// zero-filled. Every thread of the block takes part.
template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void tile_async(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long row_stride, int row0,
                                           int end) {
  constexpr int CH = D / 8;   // 16-byte chunks per row
  static_assert(ROWS * CH % THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < ROWS * CH / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int r = e / CH, c = (e % CH) * 8;
    const bool ok = row0 + r < end;
    tc_tile::cp_async_16(
        dst + r * (D + 8) + c,
        ok ? src + (long long)(row0 + r) * row_stride + c : src, ok);
  }
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(32 * tc_warps<D>(), TC_MIN_BLOCKS)
flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                    Strides sq, Strides sk, Strides sv, Shape sh) {
  using namespace tc_tile;
  constexpr int WARPS = tc_warps<D>(), THREADS = 32 * WARPS;
  constexpr int STAGES = tc_stages<D>();
  constexpr int BM = 16 * WARPS, BN = TC_BN, P = D + 8;
  constexpr int KD = D / 16, ND = D / 8, NS = BN / 8;
  constexpr bool QR = tc_q_in_regs<D>();
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + BM * P;               // [STAGES][BN][P]
  __nv_bfloat16* vs = ks + STAGES * BN * P;      // [STAGES][BN][P]

  const int qt = gridDim.y - 1 - blockIdx.y;     // longest loops first
  const int h = blockIdx.x % sh.H, b = blockIdx.x / sh.H, kh = h / sh.G;
  const int q0 = qt * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;          // fragment row, pair
  const int lm = lane >> 3, lr = lane & 7;        // ldmatrix matrix, row
  const int rw = q0 + 16 * warp;                  // the warp's first row
  const __nv_bfloat16* kb = k + b * sk.b + kh * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + kh * sv.h;
  const int kv_end = CAUSAL ? min(sh.S, q0 + BM) : sh.S;
  const int n_kv = (kv_end + BN - 1) / BN;

  // Q and the first STAGES - 1 K/V tiles in flight: one group a tile, Q in
  // the first.
  tile_async<BM, D, THREADS>(qs, q + b * sq.b + h * sq.h, sq.t, q0, sh.T);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_kv) {
      tile_async<BN, D, THREADS>(ks + st * BN * P, kb, sk.t, st * BN, sh.S);
      tile_async<BN, D, THREADS>(vs + st * BN * P, vb, sv.t, st * BN, sh.S);
    }
    cp_async_commit();
  }
  const __nv_bfloat16* q_frag =   // this lane's ldmatrix row of Q
      qs + (16 * warp + 8 * (lm & 1) + lr) * P + 8 * (lm >> 1);

  // Rows g and g + 8 of the warp's 16 (index hf = 0, 1): running max, this
  // lane's share of the sum, and columns 8 j + 2 t, + 1 of the accumulator.
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  uint32_t qa[KD][4];

  for (int i = 0; i < n_kv; ++i) {
    cp_async_wait<STAGES - 2>();   // tile i (and Q) have landed
    // One barrier a tile: past it, tile i is visible to every warp and
    // every warp is done with tile i - 1, whose stage the next load takes.
    __syncthreads();
    const int nxt = i + STAGES - 1;
    if (nxt < n_kv) {
      const int st = nxt % STAGES;
      tile_async<BN, D, THREADS>(ks + st * BN * P, kb, sk.t, nxt * BN, sh.S);
      tile_async<BN, D, THREADS>(vs + st * BN * P, vb, sv.t, nxt * BN, sh.S);
    }
    cp_async_commit();
    if (QR && i == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) ldmatrix_x4(qa[kk], q_frag + 16 * kk);
    }
    const int k0 = i * BN;
    // A tile wholly above the warp's diagonal, or a warp wholly past T,
    // changes nothing: p would be 0 and corr 1.
    if (rw < sh.T && !(CAUSAL && k0 > rw + 15)) {
      const __nv_bfloat16* kt = ks + (i % STAGES) * BN * P;
      const __nv_bfloat16* vt = vs + (i % STAGES) * BN * P;
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      // S = Q K^T: K rows are the B operand's columns, as stored.
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        if (!QR) ldmatrix_x4(qa[kk], q_frag + 16 * kk);
#pragma unroll
        for (int jp = 0; jp < NS / 2; ++jp) {
          uint32_t bk[4];
          ldmatrix_x4(bk, kt + (16 * jp + 8 * (lm >> 1) + lr) * P + 16 * kk +
                              8 * (lm & 1));
          mma_bf16_16816(s[2 * jp], qa[kk], bk[0], bk[1]);
          mma_bf16_16816(s[2 * jp + 1], qa[kk], bk[2], bk[3]);
        }
      }
      // Scale, then mask where the tile straddles the diagonal or S:
      // column c of row r is masked when c > min(r, S - 1) (c >= S, or
      // causal c > r), one compare against a constant per score.
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= sh.scale;
      if (k0 + BN > sh.S || (CAUSAL && k0 + BN - 1 > rw)) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int last = CAUSAL ? min(rw + g + 8 * hf, sh.S - 1) : sh.S - 1;
          const int lim = last - k0 - 2 * t;   // relative to column 8 j + e
#pragma unroll
          for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (8 * j + e > lim) s[j][2 * hf + e] = NEG_INF;
        }
      }
      // Online softmax; p replaces the scores in place.
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float mx = m[hf];
#pragma unroll
        for (int j = 0; j < NS; ++j)
          mx = fmaxf(mx, fmaxf(s[j][2 * hf], s[j][2 * hf + 1]));
        const float m_new = quad_max(mx);
        const float corr = exp2_approx((m[hf] - m_new) * LOG2E);
        const float ml = m_new * LOG2E;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 2 * hf; e < 2 * hf + 2; ++e) {
            const float p = exp2_approx(fmaf(s[j][e], LOG2E, -ml));
            s[j][e] = p;
            sum += p;
          }
        l[hf] = l[hf] * corr + sum;
        m[hf] = m_new;
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          o[j][2 * hf] *= corr;
          o[j][2 * hf + 1] *= corr;
        }
      }
      // O += P V: P from registers as bf16 pairs, V transposed by ldmatrix.
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int jp = 0; jp < KD; ++jp) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vt + (16 * kk + 8 * (lm & 1) + lr) * P +
                                    16 * jp + 8 * (lm >> 1));
          mma_bf16_16816(o[2 * jp], pa, bv[0], bv[1]);
          mma_bf16_16816(o[2 * jp + 1], pa, bv[2], bv[3]);
        }
      }
    }
  }

  // out = acc / max(l, 1e-30) in bf16, staged through the warp's own rows of
  // the Q tile (no other warp reads them) for 16-byte stores;
  // lse = m + log(max(l, 1e-30)).
  __nv_bfloat16* stage = qs + 16 * warp * P;
  __syncwarp();   // the warp's last ldmatrix of Q is done
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const float den = fmaxf(quad_sum(l[hf]), 1e-30f);
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<uint32_t*>(stage + (g + 8 * hf) * P + 8 * j +
                                   2 * t) =
          pack_bf16x2(o[j][2 * hf] / den, o[j][2 * hf + 1] / den);
    const int r = rw + g + 8 * hf;
    if (t == 0 && r < sh.T)
      lse[((long long)b * sh.H + h) * sh.T + r] = m[hf] + logf(den);
  }
  __syncwarp();
#pragma unroll
  for (int e = lane; e < 16 * ND; e += 32) {
    const int r = e / ND, c = (e % ND) * 8;
    if (rw + r < sh.T)
      *reinterpret_cast<uint4*>(
          out + (((long long)b * sh.T + rw + r) * sh.H + h) * D + c) =
          *reinterpret_cast<const uint4*>(stage + r * P + c);
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

// ------------------------------------------------------- K4, K5 in bf16

constexpr int BWD_TILE = 64;   // kv rows per K4 tile, q rows per K5 tile

// By head dim (measured with flash_variants.py): warps per block (each
// owning 16 rows), blocks per SM the registers must allow, the depth of
// the streamed ring and the columns of one S / dP pass. K4 takes K3's
// shapes; 64-column passes at D 64 and a third stage spill at its 128
// registers. K5's dk and dv take D registers a thread: 8-warp blocks (128
// registers) spill at D 64, and at 2 blocks per SM (a cap of 255) it ran
// 15% slower than at 3 (168); 64-column passes spill at both head dims.
// D 16 and 32 take D 128's choices, untuned (4-warp blocks keep
// tile_async's 64-row tiles whole chunks per thread).
template <int D>
__host__ __device__ constexpr int dq_warps() { return D == 64 ? 8 : 4; }
template <int D>
__host__ __device__ constexpr int dq_min_blocks() { return 2; }
template <int D>
__host__ __device__ constexpr int dq_stages() { return 2; }
template <int D>
__host__ __device__ constexpr int dq_cols() { return D == 64 ? 32 : 64; }
template <int D>
__host__ __device__ constexpr int dkv_warps() { return 4; }
template <int D>
__host__ __device__ constexpr int dkv_min_blocks() { return D == 64 ? 3 : 2; }
template <int D>
__host__ __device__ constexpr int dkv_stages() { return 2; }
template <int D>
__host__ __device__ constexpr int dkv_cols() { return 32; }

template <int D>
__host__ __device__ constexpr size_t dq_tc_smem_bytes() {
  // Q and dO [16 * warps][D + 8], K and V [stages][BWD_TILE][D + 8], bf16.
  return (size_t)(2 * 16 * dq_warps<D>() + 2 * dq_stages<D>() * BWD_TILE) *
         (D + 8) * sizeof(__nv_bfloat16);
}
template <int D>
__host__ __device__ constexpr size_t dkv_tc_smem_bytes() {
  // K and V [16 * warps][D + 8], Q and dO [stages][BWD_TILE][D + 8], bf16;
  // lse and dsum [stages][BWD_TILE], f32.
  return (size_t)(2 * 16 * dkv_warps<D>() + 2 * dkv_stages<D>() * BWD_TILE) *
             (D + 8) * sizeof(__nv_bfloat16) +
         (size_t)2 * dkv_stages<D>() * BWD_TILE * sizeof(float);
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(32 * dq_warps<D>(), dq_min_blocks<D>())
flash_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ dsum,
                   __nv_bfloat16* __restrict__ dq, Strides sq, Strides sk,
                   Strides sv, Strides sdo, Shape sh) {
  using namespace tc_tile;
  constexpr int WARPS = dq_warps<D>(), THREADS = 32 * WARPS;
  constexpr int STAGES = dq_stages<D>();
  constexpr int BM = 16 * WARPS, BN = BWD_TILE, P = D + 8;
  constexpr int KD = D / 16, ND = D / 8, NC = dq_cols<D>(), NS = NC / 8;
  static_assert(STAGES >= 2 && BN % NC == 0, "ring and chunks");
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + BM * P;              // [BM][P]
  __nv_bfloat16* ks = dos + BM * P;              // [STAGES][BN][P]
  __nv_bfloat16* vs = ks + STAGES * BN * P;      // [STAGES][BN][P]

  const int qt = gridDim.y - 1 - blockIdx.y;     // longest loops first
  const int h = blockIdx.x % sh.H, b = blockIdx.x / sh.H, kh = h / sh.G;
  const int q0 = qt * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;          // fragment row, pair
  const int lm = lane >> 3, lr = lane & 7;        // ldmatrix matrix, row
  const int rw = q0 + 16 * warp;                  // the warp's first row
  const __nv_bfloat16* kb = k + b * sk.b + kh * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + kh * sv.h;
  const int kv_end = CAUSAL ? min(sh.S, q0 + BM) : sh.S;
  const int n_kv = (kv_end + BN - 1) / BN;

  // Q, dO and the first STAGES - 1 K/V tiles in flight, one group a tile.
  tile_async<BM, D, THREADS>(qs, q + b * sq.b + h * sq.h, sq.t, q0, sh.T);
  tile_async<BM, D, THREADS>(dos, dout + b * sdo.b + h * sdo.h, sdo.t, q0,
                             sh.T);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_kv) {
      tile_async<BN, D, THREADS>(ks + st * BN * P, kb, sk.t, st * BN, sh.S);
      tile_async<BN, D, THREADS>(vs + st * BN * P, vb, sv.t, st * BN, sh.S);
    }
    cp_async_commit();
  }
  const int frag = (16 * warp + 8 * (lm & 1) + lr) * P + 8 * (lm >> 1);

  // lse (in log2 units) and dsum of rows g and g + 8 (hf = 0, 1); rows past
  // T read 0, and their zero-filled q and do rows give ds = 0.
  const long long stat0 = ((long long)b * sh.H + h) * sh.T;
  float lse2[2], dsr[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = rw + g + 8 * hf;
    lse2[hf] = r < sh.T ? lse[stat0 + r] * LOG2E : 0.f;
    dsr[hf] = r < sh.T ? dsum[stat0 + r] : 0.f;
  }
  const float sl2 = sh.scale * LOG2E;
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int i = 0; i < n_kv; ++i) {
    cp_async_wait<STAGES - 2>();   // tile i (and Q, dO) have landed
    __syncthreads();               // and every warp is done with tile i - 1
    const int nxt = i + STAGES - 1;
    if (nxt < n_kv) {
      const int st = nxt % STAGES;
      tile_async<BN, D, THREADS>(ks + st * BN * P, kb, sk.t, nxt * BN, sh.S);
      tile_async<BN, D, THREADS>(vs + st * BN * P, vb, sv.t, nxt * BN, sh.S);
    }
    cp_async_commit();
    if (rw >= sh.T) continue;      // a warp wholly past T
    const __nv_bfloat16* kt = ks + (i % STAGES) * BN * P;
    const __nv_bfloat16* vt = vs + (i % STAGES) * BN * P;
#pragma unroll
    for (int c0 = 0; c0 < BN; c0 += NC) {
      const int kc = i * BN + c0;
      // A chunk wholly above the warp's diagonal or past S adds nothing.
      if (kc >= sh.S || (CAUSAL && kc > rw + 15)) continue;
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      // S = Q K^T and dP = dO V^T: K and V rows are the B operand's columns.
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t qa[4], da[4];
        ldmatrix_x4(qa, qs + frag + 16 * kk);
        ldmatrix_x4(da, dos + frag + 16 * kk);
#pragma unroll
        for (int jp = 0; jp < NS / 2; ++jp) {
          const int at = (c0 + 16 * jp + 8 * (lm >> 1) + lr) * P + 16 * kk +
                         8 * (lm & 1);
          uint32_t bk[4], bv[4];
          ldmatrix_x4(bk, kt + at);
          mma_bf16_16816(s[2 * jp], qa, bk[0], bk[1]);
          mma_bf16_16816(s[2 * jp + 1], qa, bk[2], bk[3]);
          ldmatrix_x4(bv, vt + at);
          mma_bf16_16816(dp[2 * jp], da, bv[0], bv[1]);
          mma_bf16_16816(dp[2 * jp + 1], da, bv[2], bv[3]);
        }
      }
      // p, then ds in place of s. Column c of row r is masked when
      // c > min(r, S - 1), checked only where the chunk straddles it.
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = exp2_approx(fmaf(s[j][e], sl2, -lse2[e >> 1]));
      if (kc + NC > sh.S || (CAUSAL && kc + NC - 1 > rw)) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int last =
              CAUSAL ? min(rw + g + 8 * hf, sh.S - 1) : sh.S - 1;
          const int lim = last - kc - 2 * t;   // relative to column 8 j + e
#pragma unroll
          for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (8 * j + e > lim) s[j][2 * hf + e] = 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = s[j][e] * (dp[j][e] - dsr[e >> 1]) * sh.scale;
      // dQ += dS K: dS from registers as bf16 pairs, K transposed by
      // ldmatrix.
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        const uint32_t a[4] = {
            pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int jp = 0; jp < KD; ++jp) {
          uint32_t bk[4];
          ldmatrix_x4_trans(bk, kt + (c0 + 16 * kk + 8 * (lm & 1) + lr) * P +
                                    16 * jp + 8 * (lm >> 1));
          mma_bf16_16816(acc[2 * jp], a, bk[0], bk[1]);
          mma_bf16_16816(acc[2 * jp + 1], a, bk[2], bk[3]);
        }
      }
    }
  }

  // dq in bf16, staged through the warp's own rows of the Q tile (no other
  // warp reads them) for 16-byte stores.
  __nv_bfloat16* stage = qs + 16 * warp * P;
  __syncwarp();   // the warp's last ldmatrix of Q is done
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<uint32_t*>(stage + (g + 8 * hf) * P + 8 * j +
                                   2 * t) =
          pack_bf16x2(acc[j][2 * hf], acc[j][2 * hf + 1]);
  __syncwarp();
#pragma unroll
  for (int e = lane; e < 16 * ND; e += 32) {
    const int r = e / ND, c = (e % ND) * 8;
    if (rw + r < sh.T)
      *reinterpret_cast<uint4*>(
          dq + (((long long)b * sh.T + rw + r) * sh.H + h) * D + c) =
          *reinterpret_cast<const uint4*>(stage + r * P + c);
  }
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(32 * dkv_warps<D>(), dkv_min_blocks<D>())
flash_dkv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, Strides sq, Strides sk,
                    Strides sv, Strides sdo, Shape sh) {
  using namespace tc_tile;
  constexpr int WARPS = dkv_warps<D>(), THREADS = 32 * WARPS;
  constexpr int STAGES = dkv_stages<D>();
  constexpr int BKV = 16 * WARPS, BQ = BWD_TILE, P = D + 8;
  constexpr int KD = D / 16, ND = D / 8, NC = dkv_cols<D>(), NS = NC / 8;
  static_assert(STAGES >= 2 && BQ % NC == 0, "ring and chunks");
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + BKV * P;              // [BKV][P]
  __nv_bfloat16* qs = vs + BKV * P;              // [STAGES][BQ][P]
  __nv_bfloat16* dos = qs + STAGES * BQ * P;     // [STAGES][BQ][P]
  float* lse_s = reinterpret_cast<float*>(dos + STAGES * BQ * P);
  float* dsum_s = lse_s + STAGES * BQ;           // [STAGES][BQ] each

  const int kvt = blockIdx.y;   // kv tile 0, with the most q tiles, first
  const int kh = blockIdx.x % sh.KH, b = blockIdx.x / sh.KH;
  const int k0 = kvt * BKV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;
  const int kw = k0 + 16 * warp;                  // the warp's first kv row
  // q rows below the block's first kv row see none of its keys under the
  // causal mask: start at the q tile that holds k0.
  const int q_start = CAUSAL ? (k0 / BQ) * BQ : 0;
  const int n_q = q_start < sh.T ? (sh.T - q_start + BQ - 1) / BQ : 0;
  const int n_it = sh.G * n_q;   // (query head, q tile), head-major

  // Q, dO, lse, dsum of item it into stage st.
  auto load = [&](int it, int st) {
    const int gi = it / n_q, q0 = q_start + (it - gi * n_q) * BQ;
    const int h = kh * sh.G + gi;
    tile_async<BQ, D, THREADS>(qs + st * BQ * P, q + b * sq.b + h * sq.h,
                               sq.t, q0, sh.T);
    tile_async<BQ, D, THREADS>(dos + st * BQ * P,
                               dout + b * sdo.b + h * sdo.h, sdo.t, q0, sh.T);
    const long long stat0 = ((long long)b * sh.H + h) * sh.T;
    for (int e = threadIdx.x; e < 2 * BQ; e += THREADS) {
      const int r = e % BQ;
      const bool ok = q0 + r < sh.T;
      cp_async_4((e < BQ ? lse_s : dsum_s) + st * BQ + r,
                 (e < BQ ? lse : dsum) + stat0 + (ok ? q0 + r : 0), ok);
    }
  };

  // K, V and the first STAGES - 1 items in flight, K and V in the first
  // group.
  tile_async<BKV, D, THREADS>(ks, k + b * sk.b + kh * sk.h, sk.t, k0, sh.S);
  tile_async<BKV, D, THREADS>(vs, v + b * sv.b + kh * sv.h, sv.t, k0, sh.S);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_it) load(st, st);
    cp_async_commit();
  }
  const int frag = (16 * warp + 8 * (lm & 1) + lr) * P + 8 * (lm >> 1);
  const float sl2 = sh.scale * LOG2E;
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<STAGES - 2>();   // item it (and K, V) have landed
    __syncthreads();               // and every warp is done with it - 1
    const int nxt = it + STAGES - 1;
    if (nxt < n_it) load(nxt, nxt % STAGES);
    cp_async_commit();
    if (kw >= sh.S) continue;      // a warp wholly past S
    const int st = it % STAGES;
    const int q0 = q_start + (it % n_q) * BQ;
    const __nv_bfloat16* qt = qs + st * BQ * P;
    const __nv_bfloat16* dot = dos + st * BQ * P;
    const float* ls = lse_s + st * BQ;
    const float* dss = dsum_s + st * BQ;
#pragma unroll
    for (int c0 = 0; c0 < BQ; c0 += NC) {
      const int qc = q0 + c0;
      // A chunk wholly past T, or whose q rows all lie above the warp's
      // kv rows (r < c everywhere), adds nothing.
      if (qc >= sh.T || (CAUSAL && qc + NC - 1 < kw)) continue;
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      // S^T = K Q^T and dP^T = V dO^T: Q and dO rows are the B operand's
      // columns, as stored.
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ka[4], va[4];
        ldmatrix_x4(ka, ks + frag + 16 * kk);
        ldmatrix_x4(va, vs + frag + 16 * kk);
#pragma unroll
        for (int jp = 0; jp < NS / 2; ++jp) {
          const int at = (c0 + 16 * jp + 8 * (lm >> 1) + lr) * P + 16 * kk +
                         8 * (lm & 1);
          uint32_t bq[4], bd[4];
          ldmatrix_x4(bq, qt + at);
          mma_bf16_16816(s[2 * jp], ka, bq[0], bq[1]);
          mma_bf16_16816(s[2 * jp + 1], ka, bq[2], bq[3]);
          ldmatrix_x4(bd, dot + at);
          mma_bf16_16816(dp[2 * jp], va, bd[0], bd[1]);
          mma_bf16_16816(dp[2 * jp + 1], va, bd[2], bd[3]);
        }
      }
      // p^T in s and ds^T in dp. Element e of n-tile j is kv row
      // kw + g + 8 (e / 2), q row qc + 8 j + 2 t + e % 2; it is masked
      // when the q row is past T or (causal) below the kv row, checked
      // only where the chunk straddles either.
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(ls + c0 + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = exp2_approx(
              fmaf(s[j][e], sl2, -((e & 1) ? l2.y : l2.x) * LOG2E));
      }
      if (qc + NC > sh.T || (CAUSAL && qc < kw + 15)) {
        const int hi = sh.T - qc - 2 * t;   // relative to column 8 j + e % 2
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int lo = kw + g + 8 * hf - qc - 2 * t;
#pragma unroll
          for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (8 * j + e >= hi || (CAUSAL && 8 * j + e < lo))
                s[j][2 * hf + e] = 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float2 d2 =
            *reinterpret_cast<const float2*>(dss + c0 + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[j][e] = s[j][e] * (dp[j][e] - ((e & 1) ? d2.y : d2.x)) *
                     sh.scale;
      }
      // dV += P^T dO and dK += dS^T Q: the A fragments from registers as
      // bf16 pairs, dO and Q transposed by ldmatrix.
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const uint32_t da[4] = {
            pack_bf16x2(dp[2 * kk][0], dp[2 * kk][1]),
            pack_bf16x2(dp[2 * kk][2], dp[2 * kk][3]),
            pack_bf16x2(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
            pack_bf16x2(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
        for (int jp = 0; jp < KD; ++jp) {
          const int at = (c0 + 16 * kk + 8 * (lm & 1) + lr) * P + 16 * jp +
                         8 * (lm >> 1);
          uint32_t bd[4], bq[4];
          ldmatrix_x4_trans(bd, dot + at);
          mma_bf16_16816(dva[2 * jp], pa, bd[0], bd[1]);
          mma_bf16_16816(dva[2 * jp + 1], pa, bd[2], bd[3]);
          ldmatrix_x4_trans(bq, qt + at);
          mma_bf16_16816(dka[2 * jp], da, bq[0], bq[1]);
          mma_bf16_16816(dka[2 * jp + 1], da, bq[2], bq[3]);
        }
      }
    }
  }

  // dk, dv in bf16, staged through the warp's own rows of the K and V
  // tiles for 16-byte stores, once every copy into them has landed (with
  // no q tile, K and V may still be in flight).
  cp_async_wait<0>();
  __syncthreads();
  __nv_bfloat16* stage_k = ks + 16 * warp * P;
  __nv_bfloat16* stage_v = vs + 16 * warp * P;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int at = (g + 8 * hf) * P + 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(stage_k + at) =
          pack_bf16x2(dka[j][2 * hf], dka[j][2 * hf + 1]);
      *reinterpret_cast<uint32_t*>(stage_v + at) =
          pack_bf16x2(dva[j][2 * hf], dva[j][2 * hf + 1]);
    }
  __syncwarp();
#pragma unroll
  for (int e = lane; e < 16 * ND; e += 32) {
    const int r = e / ND, c = (e % ND) * 8;
    if (kw + r < sh.S) {
      const long long at =
          (((long long)b * sh.S + kw + r) * sh.KH + kh) * D + c;
      *reinterpret_cast<uint4*>(dk + at) =
          *reinterpret_cast<const uint4*>(stage_k + r * P + c);
      *reinterpret_cast<uint4*>(dv + at) =
          *reinterpret_cast<const uint4*>(stage_v + r * P + c);
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
cudaError_t fwd_tc(const void* q, const void* k, const void* v, void* out,
                   void* lse, const long long* st, Shape sh,
                   cudaStream_t stream) {
  static_assert(sizeof(T) == 2, "the tensor-core forward takes bf16");
  constexpr int BM = 16 * tc_warps<D>();
  const long long heads = (long long)sh.H * sh.B;
  const int n_qt = (sh.T + BM - 1) / BM;
  if (heads > 0x7fffffffLL || n_qt > 65535) return cudaErrorInvalidValue;
  const size_t bytes = fwd_tc_smem_bytes<D>();
  auto kern = flash_fwd_tc_kernel<D, CAUSAL>;
  cudaError_t err = prepare(kern, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)heads, n_qt);
  kern<<<grid, 32 * tc_warps<D>(), bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse),
      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2), sh);
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

template <typename T, int D, bool CAUSAL>
cudaError_t bwd_dq_tc(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* dsum,
                      void* dq, const long long* st, Shape sh,
                      cudaStream_t stream) {
  static_assert(sizeof(T) == 2, "the tensor-core dq takes bf16");
  constexpr int BM = 16 * dq_warps<D>();
  const long long heads = (long long)sh.H * sh.B;
  const int n_qt = (sh.T + BM - 1) / BM;
  if (heads > 0x7fffffffLL || n_qt > 65535) return cudaErrorInvalidValue;
  const size_t bytes = dq_tc_smem_bytes<D>();
  auto kern = flash_dq_tc_kernel<D, CAUSAL>;
  cudaError_t err = prepare(kern, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)heads, n_qt);
  kern<<<grid, 32 * dq_warps<D>(), bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<__nv_bfloat16*>(dq), strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), sh);
  return cudaGetLastError();
}

template <typename T, int D, bool CAUSAL>
cudaError_t bwd_dkv_tc(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* dsum,
                       void* dk, void* dv, const long long* st, Shape sh,
                       cudaStream_t stream) {
  static_assert(sizeof(T) == 2, "the tensor-core dk/dv takes bf16");
  constexpr int BKV = 16 * dkv_warps<D>();
  const long long heads = (long long)sh.KH * sh.B;
  const int n_kt = (sh.S + BKV - 1) / BKV;
  if (heads > 0x7fffffffLL || n_kt > 65535) return cudaErrorInvalidValue;
  const size_t bytes = dkv_tc_smem_bytes<D>();
  auto kern = flash_dkv_tc_kernel<D, CAUSAL>;
  cudaError_t err = prepare(kern, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)heads, n_kt);
  kern<<<grid, 32 * dkv_warps<D>(), bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 3), sh);
  return cudaGetLastError();
}

bool valid_shape(int B, int T, int S, int H, int KH) {
  return B > 0 && T > 0 && S > 0 && KH > 0 && H > 0 && H % KH == 0 &&
         B <= 65535 && H <= 65535;
}

}  // namespace

// Dispatch over dtype (0 = float32 to F32, 1 = bfloat16 to BF16), D in
// {16, 32, 64, 128} and causal in {0, 1}; anything else returns
// cudaErrorInvalidValue. The dtype alone picks the route.
#define RT_FLASH_AT(F32, BF16, DD, ...)                                      \
  if (D == DD) {                                                             \
    if (dtype == 0 && causal) return (int)F32<float, DD, true>(__VA_ARGS__); \
    if (dtype == 0 && !causal)                                               \
      return (int)F32<float, DD, false>(__VA_ARGS__);                        \
    if (dtype == 1 && causal)                                                \
      return (int)BF16<__nv_bfloat16, DD, true>(__VA_ARGS__);                \
    if (dtype == 1 && !causal)                                               \
      return (int)BF16<__nv_bfloat16, DD, false>(__VA_ARGS__);               \
  }
#define RT_FLASH_DISPATCH2(F32, BF16, ...)                                   \
  do {                                                                       \
    RT_FLASH_AT(F32, BF16, 16, __VA_ARGS__)                                  \
    RT_FLASH_AT(F32, BF16, 32, __VA_ARGS__)                                  \
    RT_FLASH_AT(F32, BF16, 64, __VA_ARGS__)                                  \
    RT_FLASH_AT(F32, BF16, 128, __VA_ARGS__)                                 \
    return (int)cudaErrorInvalidValue;                                       \
  } while (0)

// Shared memory one block of each kernel needs, in bytes (which: 0 = K3,
// 1 = K4, 2 = K5; dtype as in the launchers), for the wrapper's check
// against the card's 227 KB; -1 for a D the kernels are not built for.
template <int D>
long long smem_bytes_at(int which, int dtype) {
  if (dtype == 1)
    return (long long)(which == 0   ? fwd_tc_smem_bytes<D>()
                       : which == 1 ? dq_tc_smem_bytes<D>()
                                    : dkv_tc_smem_bytes<D>());
  return (long long)((which == 0   ? fwd_smem_floats<D>()
                      : which == 1 ? dq_smem_floats<D>()
                                   : dkv_smem_floats<D>()) *
                     sizeof(float));
}

extern "C" long long flash_smem_bytes(int which, int D, int dtype) {
  switch (D) {
    case 16: return smem_bytes_at<16>(which, dtype);
    case 32: return smem_bytes_at<32>(which, dtype);
    case 64: return smem_bytes_at<64>(which, dtype);
    case 128: return smem_bytes_at<128>(which, dtype);
  }
  return -1;
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
  RT_FLASH_DISPATCH2(fwd, fwd_tc, q, k, v, out, lse, strides, sh, s);
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
  RT_FLASH_DISPATCH2(bwd_dq, bwd_dq_tc, q, k, v, dout, lse, dsum, dq,
                     strides, sh, s);
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
  RT_FLASH_DISPATCH2(bwd_dkv, bwd_dkv_tc, q, k, v, dout, lse, dsum, dk, dv,
                     strides, sh, s);
}
