// Flash attention forward and backward, hand-written for Hopper (sm_90a).
//
// Replaces three TPU kernels of k8s_gpu_device_plugin_tpu/ops/flash_attention.py:
//   flash_fwd      <- _fwd_kernel      (pallas_call in _flash_fwd_bhsd)
//   flash_bwd_dkv  <- _bwd_dkv_kernel  (first pallas_call in _flash_bwd_bhsd)
//   flash_bwd_dq   <- _bwd_dq_kernel   (second pallas_call in _flash_bwd_bhsd)
//
// What they compute. q and dO are (B*Hq, S, hd), k and v (B*Hkv, S, hd),
// rows contiguous; q row r attends kv row r / group (group = Hq / Hkv, the
// reference's _kv_row), so K/V are never expanded. Scores are
// s = (q . k) * scale, masked to -1e30 where causal and k_pos > q_pos (and,
// with a window, q_pos - k_pos >= window).
//   forward:  o = softmax(s) v in q's dtype, lse = m + log(l) in f32
//             (online m/l/acc recurrence; l == 0 guarded as in the reference);
//   dkv:      p = exp(s - lse), dS = p * (dO.v - delta) * scale,
//             dV = sum p^T dO, dK = sum dS^T q, summed over the group's q
//             heads inside one block; f32 out;
//   dq:       dQ = sum dS k; f32 out.
// delta = rowsum(dO * o) - dlse comes in from the caller, as on the TPU.
//
// What bounds them. Per (batch, q head) a causal call does 4 * S^2/2 * hd
// operations (forward), 8 * S^2/2 * hd (dkv: s, dP, dV, dK) and
// 6 * S^2/2 * hd (dq: s, dP, dQ), against ~4 * S * hd bytes of input: about
// S/2 operations per byte, far above the card's ~295 (bf16) balance at
// S = 2048. So all three are bound by operations.
//
// Two engines, by the type of q/k/v/dO. bf16 runs on the tensor cores,
// each kernel over the wgmma mainloop of attention_tile.cuh (swizzled
// 64-row tiles, SS and RS products, a ring of stages on mbarriers):
// - flash_fwd_tc_kernel: two consumer warpgroups (128 q rows) over one
//   ring of K/V tiles that a producer warp fills with TMA boxes from 3-D
//   tensor maps over (B*Hkv, S, hd); q row r reads kv row r / group
//   through the map's outer coordinate. P is rounded to bf16 before P V
//   (wgmma's A operand).
// - flash_bwd_dq_tc_kernel: the forward's blocks (two q tiles, heaviest
//   first) with another body: each consumer warpgroup holds its q tile
//   and dO tile, a producer warpgroup streams (K, V); per kv tile S and dP
//   as SS products, dS = p (dP - delta) scale in f32, rounded once to bf16
//   for dQ += dS K (attention_tile.cuh's dq_step).
// - flash_bwd_dkv_tc_kernel: each consumer warpgroup holds a kv tile's K
//   and V; a producer warpgroup (in both backward kernels it gives its
//   registers to the consumers with setmaxnreg) fills a ring
//   with (Q, dO) tiles by TMA and the tile's lse and delta by a bulk copy,
//   for every q head of the group and live q tile; per stage S^T and dP^T
//   as SS products, dV += bf16(p^T) dO, dK += bf16(dS^T) Q (dkv_step).
// The rounded operands move each gradient from the f32 plain version by at
// most 2^-8 of its sum of |terms| (kernel_support.bf16_grad_mismatch).
// f32 runs every operation in f32 on the CUDA cores (the TPU kernels also
// cast to f32; its pins need f32 products), against the 67 TFLOP/s f32
// rate: it skips every tile the mask empties (the reference's block
// predicates, at 64-row tiles), each thread computes a 4x4 score tile
// from float4 shared-memory loads (8 fused multiply-adds per load), and
// the heaviest tiles (the most live kv tiles under the causal mask) are
// launched first so the tail wave is short. Both engines do the same.
//
// TPU -> CUDA. The TPU grid carries m/l/acc (or dK/dV, dQ) in VMEM scratch
// across its sequential innermost axis; here that axis is a loop inside
// one block, and the other grid axes are independent blocks:
//   forward and dq: one block per (q tile of 64 rows, b * Hq + h) (two
//                   on the tensor cores);
//   dkv:            one block per (kv tile of 64 rows, b * Hkv + h) (two
//                   on the tensor cores), its loop walking the group's q
//                   heads x the live q tiles.
// No atomics: every output element is written by one block, in a fixed
// summation order, so results are deterministic.
//
// Types: f32 or bf16 q/k/v/dO (one type per call), hd in {16, 32, 64,
// 128, 256}, S a multiple of 64. All arithmetic is f32 but the tensor-core
// products (bf16 operands, f32 accumulation).
//
// Head dim 256 (Gemma). A 64 x 256 bf16 tile is 32 KB and an f32 one
// 65 KB, against the 227 KB a block may hold, and a consumer thread's
// 64 x 256 accumulator is 128 f32 registers. So the HD = 256
// instantiations keep fewer tiles:
// - K2 (tensor cores): two ring stages instead of three (197,664 B), and
//   a producer warpgroup that gives its registers to the consumers;
// - K4 (tensor cores): one consumer warpgroup, two stages (197,664 B), its
//   dQ accumulator 128 f32 under the block's 255 registers a thread;
// - K3 (tensor cores): flash_bwd_dkv_tc_halves_kernel, one kv tile a
//   block, whose two consumer warpgroups share the tile's K and V and
//   each keep one half of dK's and dV's columns (128 f32 a thread, as at
//   hd 128): both compute S^T and dP^T over the whole hd, so a stage costs
//   six 64 x 64 x 256 products where one warpgroup owning all columns
//   would cost four (it would need 256 accumulator registers a thread and
//   about 330 KB); two stages (198,688 B);
// - K3 and K4 (CUDA cores): K and V, or Q and dO, take turns in one
//   buffer (kLean below: 217,088 B where four tiles would need 266,240 and
//   six 301,056), reloading a tile where the full kernel keeps it.
// Each sums in the same order as the wider layout would, and no engine is
// dropped at 256: the f32 checks need the CUDA cores.
//
// Narrow head dims. Both engines are built on 64-column blocks of the head
// dim, so hd 16 and 32 run in the HD = 64 instantiation with the live hd
// passed at run time (every row offset counts hd, not HD): the tiles are
// zero-filled past column hd in shared memory (load_tile here; load_rows
// and the TMA boxes' out-of-bounds fill on the tensor cores,
// attention_tile.cuh), only hd columns are read from device memory, and
// only hd columns of o, dQ, dK and dV are stored. The zero columns add
// exact zeros to every sum, so the result is the unpadded one bit for
// bit; the price is 64 / hd times the products (4x at hd 16). lse and
// delta are row quantities: the zeros do not change them.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tile.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads, each a 4 x 4 score tile
constexpr int kTile = 64;      // q rows and kv rows per tile
constexpr int kPStride = kTile + 4;  // padded row of a 64 x 64 f32 tile
constexpr float kNegBig = -1e30f;

// padded shared-memory row of a 64 x HD f32 tile: float4-aligned, and
// rows 4 words apart in the banks, so 8 threads reading 8 rows are
// conflict-free
template <int HD>
__host__ __device__ constexpr int row_stride() { return HD + 4; }

template <int HD>
__host__ __device__ constexpr int tile_floats() { return kTile * row_stride<HD>(); }

// 64 contiguous rows of hd f32 (global) -> padded f32 tile of HD columns
// (shared), columns hd .. HD - 1 zero (hd a multiple of 4)
template <int HD>
__device__ __forceinline__ void load_tile(const float* __restrict__ src,
                                          float* __restrict__ dst, int hd) {
  constexpr int kVecPerRow = HD / 4;
  constexpr int kIters = kTile * kVecPerRow / kThreads;
  static_assert(kTile * kVecPerRow % kThreads == 0, "tile splits evenly");
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int row = i / kVecPerRow;
    const int col = (i % kVecPerRow) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (col < hd) x = __ldg(reinterpret_cast<const float4*>(src + row * hd + col));
    *reinterpret_cast<float4*>(dst + row * row_stride<HD>() + col) = x;
  }
}

// acc[i][j] = A[ty + 16 i] . B[tx + 16 j] over HD (two 64 x HD tiles)
template <int HD>
__device__ __forceinline__ void dot_tile(const float* __restrict__ a,
                                         const float* __restrict__ b, int ty,
                                         int tx, float acc[4][4]) {
  constexpr int kS = row_stride<HD>();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 av[4];
    float4 bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * kS + d);
      bv[i] = *reinterpret_cast<const float4*>(b + (tx + 16 * i) * kS + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[i][j];
        s = fmaf(av[i].x, bv[j].x, s);
        s = fmaf(av[i].y, bv[j].y, s);
        s = fmaf(av[i].z, bv[j].z, s);
        s = fmaf(av[i].w, bv[j].w, s);
        acc[i][j] = s;
      }
    }
  }
}

// acc[i][jj] (float4 at column tx*4 + 64 jj) += sum_c P[ty + 16 i][c] *
// V[c][...]: P a 64 x 64 tile (stride kPStride), V a 64 x HD tile
template <int HD>
__device__ __forceinline__ void pv_tile(const float* __restrict__ p,
                                        const float* __restrict__ v, int ty,
                                        int tx, float4 acc[4][HD / 64]) {
  constexpr int kS = row_stride<HD>();
  constexpr int kJ = HD / 64;
#pragma unroll 2
  for (int c = 0; c < kTile; c += 4) {
    float4 pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      pv[i] = *reinterpret_cast<const float4*>(p + (ty + 16 * i) * kPStride + c);
    }
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
        const float4 vv = *reinterpret_cast<const float4*>(
            v + (c + cc) * kS + tx * 4 + 64 * jj);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float w = cc == 0 ? pv[i].x
                        : cc == 1 ? pv[i].y
                        : cc == 2 ? pv[i].z
                                  : pv[i].w;
          acc[i][jj].x = fmaf(w, vv.x, acc[i][jj].x);
          acc[i][jj].y = fmaf(w, vv.y, acc[i][jj].y);
          acc[i][jj].z = fmaf(w, vv.z, acc[i][jj].z);
          acc[i][jj].w = fmaf(w, vv.w, acc[i][jj].w);
        }
      }
    }
  }
}

__device__ __forceinline__ bool keep(int q_pos, int k_pos, bool causal,
                                     int window) {
  if (!causal) return true;
  return q_pos >= k_pos && (window <= 0 || q_pos - k_pos < window);
}

// kv tiles [lo, hi] that q tile `qt` can see (the reference's forward and
// dq block predicates at 64-row tiles)
__device__ __forceinline__ void kv_span(int qt, int n_tiles, bool causal,
                                        int window, int* lo, int* hi) {
  if (!causal) {
    *lo = 0;
    *hi = n_tiles - 1;
    return;
  }
  *hi = qt;
  const int first = qt * kTile - (window - 1);  // first key the tile's top row sees
  *lo = (window > 0 && first > 0) ? first / kTile : 0;
}

// q tiles [lo, hi] that see kv tile `kt` (the reference's dkv predicate)
__device__ __forceinline__ void q_span(int kt, int n_tiles, bool causal,
                                       int window, int* lo, int* hi) {
  if (!causal) {
    *lo = 0;
    *hi = n_tiles - 1;
    return;
  }
  *lo = kt;
  *hi = n_tiles - 1;
  if (window > 0) {
    *hi = min(*hi, (kt * kTile + (kTile - 1) + (window - 1)) / kTile);
  }
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// --- forward (K2) -------------------------------------------------------------

template <int HD>
constexpr size_t fwd_smem() {
  return sizeof(float) * 3 * tile_floats<HD>();  // q, k (then p), v
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int group, int s_len, int hd,
                 float scale, int causal, int window) {
  constexpr int kJ = HD / 64;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + tile_floats<HD>();  // k tile, then the tile's p
  float* vs = ks + tile_floats<HD>();

  const int n_tiles = s_len / kTile;
  const int qt = n_tiles - 1 - blockIdx.x;  // most kv tiles first
  const int bh = blockIdx.y;
  const int kvh = bh / group;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  load_tile<HD>(q + (size_t(bh) * s_len + qt * kTile) * hd, qs, hd);
  float m[4], l[4];
  float4 acc[4][kJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegBig;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) acc[i][jj] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  int j_lo, j_hi;
  kv_span(qt, n_tiles, causal != 0, window, &j_lo, &j_hi);
  for (int j = j_lo; j <= j_hi; ++j) {
    __syncthreads();  // the previous tile's p and v are consumed
    const size_t kv_off = (size_t(kvh) * s_len + j * kTile) * hd;
    load_tile<HD>(k + kv_off, ks, hd);
    load_tile<HD>(v + kv_off, vs, hd);
    __syncthreads();

    float s[4][4];
    dot_tile<HD>(qs, ks, ty, tx, s);
    __syncthreads();  // every thread is done with k: p takes its place

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      float mx = kNegBig;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = tx + 16 * jj;
        const bool kept = keep(qt * kTile + r, j * kTile + c, causal != 0, window);
        s[i][jj] = kept ? s[i][jj] * scale : kNegBig;
        mx = fmaxf(mx, s[i][jj]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(s[i][jj] - m_new);
        ks[r * kPStride + tx + 16 * jj] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
        acc[i][jj].x *= alpha;
        acc[i][jj].y *= alpha;
        acc[i][jj].z *= alpha;
        acc[i][jj].w *= alpha;
      }
    }
    __syncthreads();
    pv_tile<HD>(ks, vs, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = qt * kTile + ty + 16 * i;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    const float inv = 1.f / l_safe;
    float* orow = o + (size_t(bh) * s_len + row) * hd;
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) {
      const int col = tx * 4 + 64 * jj;
      if (col >= hd) continue;  // a padded column
      orow[col] = acc[i][jj].x * inv;
      orow[col + 1] = acc[i][jj].y * inv;
      orow[col + 2] = acc[i][jj].z * inv;
      orow[col + 3] = acc[i][jj].w * inv;
    }
    if (tx == 0) lse[size_t(bh) * s_len + row] = m[i] + logf(l_safe);
  }
}

// --- forward on the tensor cores (K2, bf16) ----------------------------------

constexpr int kTcConsumers = 2;  // 64-row q tiles (consumer warpgroups) a block
constexpr int kTcStages = 3;     // K/V tiles in flight
constexpr int kTcThreads = kTcConsumers * attn_tile::kWarpgroup + 32;

// K/V tiles in flight: three stages of 64 x 256 would take 263,216 B
template <int HD>
__host__ __device__ constexpr int fwd_stages() { return HD == 256 ? 2 : kTcStages; }

// At hd 256 a consumer thread holds 128 f32 of O, 32 of S and P's bf16
// fragments: the 168 registers a thread of a three-warpgroup block gets
// spill them, so the block takes a whole producer warpgroup, which hands
// its registers to the consumers (setmaxnreg) and keeps one warp.
template <int HD>
__host__ __device__ constexpr int fwd_threads() {
  return HD == 256 ? (kTcConsumers + 1) * attn_tile::kWarpgroup : kTcThreads;
}
constexpr int kFwdProducerRegs = 24;
constexpr int kFwdConsumerRegs = 240;  // (65536 - 128 * 24) / 256, a multiple of 8

// One block: q tiles 2 qb and 2 qb + 1 of row bh = blockIdx.y, the
// heaviest blocks (most live kv tiles) launched first. Warps 0..7 are the
// two consumer warpgroups; warp 8 is the producer, one lane of which
// issues the TMA boxes of each kv tile of the block's span (the union of
// the two q tiles' spans; each consumer computes only its own).
template <int HD>
__global__ void __launch_bounds__(fwd_threads<HD>(), 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __nv_bfloat16* __restrict__ q,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    int group, int s_len, int hd, float scale, int causal,
                    int window) {
  using namespace attn_tile;
  using RingT = Ring<HD, fwd_stages<HD>()>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_tiles = (smem_u32(smem_raw) + 1023) & ~1023u;
  const RingT ring = RingT::at(q_tiles + kTcConsumers * tile_bytes<HD>());

  const int n_tiles = s_len / kTile;
  const int qb = (n_tiles + kTcConsumers - 1) / kTcConsumers - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  int mine_lo[kTcConsumers], mine_hi[kTcConsumers];
  int lo = n_tiles, hi = -1;
#pragma unroll
  for (int w = 0; w < kTcConsumers; ++w) {
    const int qt = kTcConsumers * qb + w;
    if (qt < n_tiles) {
      kv_span(qt, n_tiles, causal != 0, window, &mine_lo[w], &mine_hi[w]);
    } else {  // past the end of S: no rows, an empty span
      mine_lo[w] = 0;
      mine_hi[w] = -1;
    }
    if (mine_lo[w] <= mine_hi[w]) {
      lo = min(lo, mine_lo[w]);
      hi = max(hi, mine_hi[w]);
    }
  }

  if (threadIdx.x == 0) ring.init(1, kTcConsumers * kWarpgroup);
  __syncthreads();
  const int wg = threadIdx.x / kWarpgroup;
  if constexpr (fwd_threads<HD>() != kTcThreads) {  // a producer warpgroup
    if (wg == kTcConsumers) {
      set_max_regs_dec<kFwdProducerRegs>();
      if (threadIdx.x >= kTcConsumers * kWarpgroup + 32) return;  // one warp works
    } else {
      set_max_regs_inc<kFwdConsumerRegs>();
    }
  }
  if (wg == kTcConsumers) {  // the producer warp
    if (threadIdx.x % 32 == 0) {
      const int kvh = bh / group;
      for (int j = lo, n = 0; j <= hi; ++j, ++n) {
        const int s = ring.acquire(n);
        mbar_expect_tx(ring.full(s), 2 * tile_bytes<HD>());
#pragma unroll
        for (int c = 0; c < HD / 64; ++c) {
          tma_load_3d(ring.tile(s, 0) + c * 8192, &tm_k, 64 * c, j * kTile, kvh,
                      ring.full(s));
          tma_load_3d(ring.tile(s, 1) + c * 8192, &tm_v, 64 * c, j * kTile, kvh,
                      ring.full(s));
        }
      }
    }
    return;
  }

  const int qt = kTcConsumers * qb + wg;
  const int q0 = qt * kTile;
  const bool live = qt < n_tiles;
  const uint32_t q_tile = q_tiles + wg * tile_bytes<HD>();
  load_rows<HD>(q_tile, [&](int r) -> const __nv_bfloat16* {
    return live ? q + (size_t(bh) * s_len + q0 + r) * hd : nullptr;
  }, 1 + wg, hd);
  Acc<HD> acc;
  acc.init();
  // a tile needs the mask on the diagonal and where its farthest pair
  // (row q0 + 63, key 64 j) falls out of the window
  auto masked = [&](int j) {
    return causal != 0 &&
           (j >= qt || (window > 0 && q0 + kTile - 1 - j * kTile >= window));
  };
  const int q_row[2] = {q0 + Acc<HD>::row(0), q0 + Acc<HD>::row(2)};
  auto kept = [&](int h, int pos) { return keep(q_row[h], pos, true, window); };
  consume<HD, fwd_stages<HD>()>(acc, ring, q_tile, scale * kLog2e, lo, hi,
                                mine_lo[wg], mine_hi[wg], masked, kept);
  if (!live) return;

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float l_safe = acc.l[h] == 0.f ? 1.f : acc.l[h];
    inv[h] = 1.f / l_safe;
    if (threadIdx.x % 4 == 0) {
      lse[size_t(bh) * s_len + q0 + Acc<HD>::row(2 * h)] =
          acc.m[h] * kLn2 + logf(l_safe);
    }
  }
#pragma unroll
  for (int nb = 0; nb < HD / 64; ++nb) {
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int h = (i >> 1) & 1;
      const int col = 64 * nb + Acc<HD>::col(i);
      if (col >= hd) continue;  // a padded column
      const size_t row = size_t(bh) * s_len + q0 + Acc<HD>::row(i);
      *reinterpret_cast<uint32_t*>(o + row * hd + col) =
          pack_bf16(acc.o[nb][i] * inv[h], acc.o[nb][i + 1] * inv[h]);
    }
  }
}

// --- backward, dK and dV (K3) -------------------------------------------------

// The CUDA-core backward at hd 256: its tiles do not all fit a block, so
// two of them share one buffer, loaded in turn
template <int HD>
constexpr bool kLean = HD == 256;

template <int HD>
constexpr size_t dkv_smem() {
  // k, v (resident), q, dO (per q tile; lean: one buffer for both), p^T and
  // dS^T (64 x 64 each; lean: one buffer for both)
  return kLean<HD> ? sizeof(float) * (3 * tile_floats<HD>() + kTile * kPStride)
                   : sizeof(float) * (4 * tile_floats<HD>() + 2 * kTile * kPStride);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int group, int s_len, int hd,
                     float scale, int causal, int window) {
  constexpr int kJ = HD / 64;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + tile_floats<HD>();
  float* qs = vs + tile_floats<HD>();
  // lean: dO's tile is q's buffer, dS^T p^T's
  float* dos = kLean<HD> ? qs : qs + tile_floats<HD>();
  float* pt = dos + tile_floats<HD>();   // p^T   [kv row][q row]
  float* dst = kLean<HD> ? pt : pt + kTile * kPStride;  // dS^T  [kv row][q row]

  const int n_tiles = s_len / kTile;
  const int kt = blockIdx.x;  // low kv tiles have the most live q tiles
  const int bhkv = blockIdx.y;
  const int tx = threadIdx.x % 16;  // q column of the transposed tiles
  const int ty = threadIdx.x / 16;  // kv row

  const size_t kv_off = (size_t(bhkv) * s_len + kt * kTile) * hd;
  load_tile<HD>(k + kv_off, ks, hd);
  load_tile<HD>(v + kv_off, vs, hd);
  float4 dk_acc[4][kJ];
  float4 dv_acc[4][kJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) {
      dk_acc[i][jj] = make_float4(0.f, 0.f, 0.f, 0.f);
      dv_acc[i][jj] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  int i_lo, i_hi;
  q_span(kt, n_tiles, causal != 0, window, &i_lo, &i_hi);
  for (int g = 0; g < group; ++g) {
    const int bh = bhkv * group + g;
    for (int it = i_lo; it <= i_hi; ++it) {
      __syncthreads();  // the previous q tile's products are done
      const size_t q_off = (size_t(bh) * s_len + it * kTile) * hd;
      load_tile<HD>(q + q_off, qs, hd);
      if constexpr (!kLean<HD>) load_tile<HD>(dout + q_off, dos, hd);
      __syncthreads();

      float s[4][4];   // s^T[kv row][q col]
      float dp[4][4];  // (dO v^T)^T
      dot_tile<HD>(ks, qs, ty, tx, s);
      if constexpr (kLean<HD>) {  // dO takes q's buffer
        __syncthreads();
        load_tile<HD>(dout + q_off, dos, hd);
        __syncthreads();
      }
      dot_tile<HD>(vs, dos, ty, tx, dp);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = tx + 16 * jj;
        const size_t row = size_t(bh) * s_len + it * kTile + c;
        const float lse_c = lse[row];
        const float delta_c = delta[row];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty + 16 * i;
          const bool kept = keep(it * kTile + c, kt * kTile + r, causal != 0, window);
          const float sc = kept ? s[i][jj] * scale : kNegBig;
          const float p = expf(sc - lse_c);
          pt[r * kPStride + c] = p;
          dp[i][jj] = p * (dp[i][jj] - delta_c) * scale;  // dS^T
          if constexpr (!kLean<HD>) dst[r * kPStride + c] = dp[i][jj];
        }
      }
      __syncthreads();
      pv_tile<HD>(pt, dos, ty, tx, dv_acc);
      if constexpr (kLean<HD>) {  // dS^T takes p^T's buffer, q dO's
        __syncthreads();
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dst[(ty + 16 * i) * kPStride + tx + 16 * jj] = dp[i][jj];
          }
        }
        load_tile<HD>(q + q_off, qs, hd);
        __syncthreads();
      }
      pv_tile<HD>(dst, qs, ty, tx, dk_acc);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t row = size_t(bhkv) * s_len + kt * kTile + ty + 16 * i;
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) {
      const int col = tx * 4 + 64 * jj;
      if (col >= hd) continue;  // a padded column
      *reinterpret_cast<float4*>(dk + row * hd + col) = dk_acc[i][jj];
      *reinterpret_cast<float4*>(dv + row * hd + col) = dv_acc[i][jj];
    }
  }
}

// --- backward, dQ (K4) --------------------------------------------------------

template <int HD>
constexpr size_t dq_smem() {
  // q, dO, k, v (then dS); lean: q, dO, k then v then k again, dS
  return kLean<HD> ? sizeof(float) * (3 * tile_floats<HD>() + kTile * kPStride)
                   : sizeof(float) * 4 * tile_floats<HD>();
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int group, int s_len, int hd, float scale, int causal,
                    int window) {
  constexpr int kJ = HD / 64;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + tile_floats<HD>();
  float* ks = dos + tile_floats<HD>();
  // v tile, then the tile's dS; lean: v takes k's buffer, dS one of its own
  float* vs = kLean<HD> ? ks : ks + tile_floats<HD>();
  float* dss = kLean<HD> ? ks + tile_floats<HD>() : vs;

  const int n_tiles = s_len / kTile;
  const int qt = n_tiles - 1 - blockIdx.x;  // most kv tiles first
  const int bh = blockIdx.y;
  const int kvh = bh / group;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  const size_t q_off = (size_t(bh) * s_len + qt * kTile) * hd;
  load_tile<HD>(q + q_off, qs, hd);
  load_tile<HD>(dout + q_off, dos, hd);
  float lse_r[4], delta_r[4];
  float4 acc[4][kJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t row = size_t(bh) * s_len + qt * kTile + ty + 16 * i;
    lse_r[i] = lse[row];
    delta_r[i] = delta[row];
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) acc[i][jj] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  int j_lo, j_hi;
  kv_span(qt, n_tiles, causal != 0, window, &j_lo, &j_hi);
  for (int j = j_lo; j <= j_hi; ++j) {
    __syncthreads();  // the previous tile's dS and k are consumed
    const size_t kv_off = (size_t(kvh) * s_len + j * kTile) * hd;
    load_tile<HD>(k + kv_off, ks, hd);
    if constexpr (!kLean<HD>) load_tile<HD>(v + kv_off, vs, hd);
    __syncthreads();

    float s[4][4];
    float dp[4][4];
    dot_tile<HD>(qs, ks, ty, tx, s);
    if constexpr (kLean<HD>) {  // v takes k's buffer
      __syncthreads();
      load_tile<HD>(v + kv_off, vs, hd);
      __syncthreads();
    }
    dot_tile<HD>(dos, vs, ty, tx, dp);
    __syncthreads();  // every thread is done with v: dS takes its place
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = tx + 16 * jj;
        const bool kept = keep(qt * kTile + r, j * kTile + c, causal != 0, window);
        const float sc = kept ? s[i][jj] * scale : kNegBig;
        const float p = expf(sc - lse_r[i]);
        dss[r * kPStride + c] = p * (dp[i][jj] - delta_r[i]) * scale;
      }
    }
    if constexpr (kLean<HD>) load_tile<HD>(k + kv_off, ks, hd);  // k again
    __syncthreads();
    pv_tile<HD>(dss, ks, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t row = size_t(bh) * s_len + qt * kTile + ty + 16 * i;
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) {
      const int col = tx * 4 + 64 * jj;
      if (col < hd) *reinterpret_cast<float4*>(dq + row * hd + col) = acc[i][jj];
    }
  }
}

// --- backward on the tensor cores (K3, K4, bf16) ----------------------------

// Both backward blocks are two consumer warpgroups and a producer
// warpgroup, one thread of which issues the copies. A consumer thread
// holds its gradient accumulators (64 f32 at hd 128, K3 twice that), S
// and dP (32 each) and the bf16 operands at once: the 168 registers a
// thread of a 3-warpgroup block gets (16,384 per quarter of the SM, three
// warps in the fullest quarter) spill, so the producer hands its
// registers to the consumers (setmaxnreg).
constexpr int kBwdConsumers = 2;  // 64-row tiles (consumer warpgroups) a block
constexpr int kBwdThreads = (kBwdConsumers + 1) * attn_tile::kWarpgroup;
constexpr int kBwdProducerRegs = 24;
constexpr int kBwdConsumerRegs = 240;  // (65536 - 128 * 24) / 256, a multiple of 8
constexpr int kBwdStages = 3;     // (K, V) or (Q, dO) tiles in flight
constexpr int kDkvRowBytes = 2 * kTile * 4;  // a q tile's lse, then its delta

// At hd 256 both backward kernels keep two stages, and K4 one consumer
// warpgroup (two would need about 328 KB); its block of two warpgroups
// leaves a thread 255 registers, so it sets no register budget.
template <int HD>
__host__ __device__ constexpr int bwd_stages() { return HD == 256 ? 2 : kBwdStages; }
template <int HD>
__host__ __device__ constexpr int dq_consumers() { return HD == 256 ? 1 : kBwdConsumers; }
template <int HD>
__host__ __device__ constexpr int dq_threads() { return (dq_consumers<HD>() + 1) * attn_tile::kWarpgroup; }

// One block: q tiles 2 qb and 2 qb + 1 of row bh = blockIdx.y (at hd 256
// q tile qb alone), the heaviest blocks first, as the forward's. Warpgroups
// 0 and 1 are the consumers, each with its q tile and dO tile resident; the
// last warpgroup the producer, which issues the TMA boxes of the K and V
// tiles of the block's span (the union of the q tiles' spans; each
// consumer computes only its own).
template <int HD>
__global__ void __launch_bounds__(dq_threads<HD>(), 1)
flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       float* __restrict__ dq, int group, int s_len, int hd,
                       float scale, int causal, int window) {
  using namespace attn_tile;
  constexpr int kC = dq_consumers<HD>();
  using RingT = Ring<HD, bwd_stages<HD>()>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t resident = (smem_u32(smem_raw) + 1023) & ~1023u;
  const RingT ring = RingT::at(resident + 2 * kC * tile_bytes<HD>());

  const int n_tiles = s_len / kTile;
  const int qb = (n_tiles + kC - 1) / kC - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  int lo = n_tiles, hi = -1;  // the kv tiles some q tile of the block sees
#pragma unroll
  for (int w = 0; w < kC; ++w) {
    const int qt = kC * qb + w;
    if (qt >= n_tiles) continue;
    int a, b;
    kv_span(qt, n_tiles, causal != 0, window, &a, &b);
    lo = min(lo, a);
    hi = max(hi, b);
  }

  if (threadIdx.x == 0) ring.init(1, kC * kWarpgroup);
  __syncthreads();
  const int wg = threadIdx.x / kWarpgroup;
  if (wg == kC) {  // the producer warpgroup: K and V tiles
    if constexpr (kC > 1) set_max_regs_dec<kBwdProducerRegs>();
    if (threadIdx.x % kWarpgroup == 0) {
      for (int j = lo, n = 0; j <= hi; ++j, ++n) {
        const int s = ring.acquire(n);
        mbar_expect_tx(ring.full(s), 2 * tile_bytes<HD>());
#pragma unroll
        for (int c = 0; c < HD / 64; ++c) {
          tma_load_3d(ring.tile(s, 0) + c * 8192, &tm_k, 64 * c, j * kTile,
                      bh / group, ring.full(s));
          tma_load_3d(ring.tile(s, 1) + c * 8192, &tm_v, 64 * c, j * kTile,
                      bh / group, ring.full(s));
        }
      }
    }
    return;
  }
  if constexpr (kC > 1) set_max_regs_inc<kBwdConsumerRegs>();

  const int qt = kC * qb + wg;
  const int q0 = qt * kTile;
  const bool live = qt < n_tiles;
  int mine_lo = 0, mine_hi = -1;
  if (live) kv_span(qt, n_tiles, causal != 0, window, &mine_lo, &mine_hi);
  const uint32_t q_tile = resident + 2 * wg * tile_bytes<HD>();
  const uint32_t do_tile = q_tile + tile_bytes<HD>();
  load_rows<HD>(q_tile, [&](int r) -> const __nv_bfloat16* {
    return live ? q + (size_t(bh) * s_len + q0 + r) * hd : nullptr;
  }, 1 + wg, hd);
  load_rows<HD>(do_tile, [&](int r) -> const __nv_bfloat16* {
    return live ? dout + (size_t(bh) * s_len + q0 + r) * hd : nullptr;
  }, 1 + wg, hd);
  int q_pos[2];
  float lse2[2], dl[2];  // this thread's rows: lse * log2(e), delta
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    q_pos[h] = q0 + Acc<HD>::row(2 * h);
    const size_t row = size_t(bh) * s_len + q_pos[h];
    lse2[h] = live ? lse[row] * kLog2e : 0.f;
    dl[h] = live ? delta[row] : 0.f;
  }
  float acc[HD / 64][32];
#pragma unroll
  for (int nb = 0; nb < HD / 64; ++nb) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;
  }
  // the forward's mask test: the diagonal, and tiles whose farthest pair
  // falls out of the window
  auto masked = [&](int j) {
    return causal != 0 &&
           (j >= qt || (window > 0 && q0 + kTile - 1 - j * kTile >= window));
  };
  auto kept = [&](int h, int pos) { return keep(q_pos[h], pos, true, window); };
  walk(ring, hi - lo + 1, [&](int n, int s) {
    const int j = lo + n;
    if (j >= mine_lo && j <= mine_hi) {
      dq_step<HD>(acc, q_tile, do_tile, ring.tile(s, 0), ring.tile(s, 1),
                  scale * kLog2e, scale, lse2, dl, j * kTile, masked(j), kept);
    }
  });
  if (!live) return;
#pragma unroll
  for (int nb = 0; nb < HD / 64; ++nb) {
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int col = 64 * nb + Acc<HD>::col(i);
      if (col >= hd) continue;  // a padded column
      const size_t row = size_t(bh) * s_len + q0 + Acc<HD>::row(i);
      *reinterpret_cast<float2*>(dq + row * hd + col) =
          make_float2(acc[nb][i], acc[nb][i + 1]);
    }
  }
}

// K3's producer (one thread): for each q head of the group in turn and q
// tiles lo .. lo + n_q - 1, the Q and dO tiles (TMA boxes from 3-D tensor
// maps over (B*Hq, S, hd)) and the tile's 64 lse and 64 delta (bulk
// copies) into the ring's next stage.
template <int HD, class RingT>
__device__ __forceinline__ void dkv_produce(const RingT& ring, const void* tm_q,
                                            const void* tm_do,
                                            const float* __restrict__ lse,
                                            const float* __restrict__ delta,
                                            int bhkv, int group, int lo, int n_q,
                                            int s_len) {
  using namespace attn_tile;
  for (int n = 0; n < group * n_q; ++n) {
    const int bh = bhkv * group + n / n_q;
    const int it = lo + n % n_q;
    const int s = ring.acquire(n);
    mbar_expect_tx(ring.full(s), 2 * tile_bytes<HD>() + kDkvRowBytes);
#pragma unroll
    for (int c = 0; c < HD / 64; ++c) {
      tma_load_3d(ring.tile(s, 0) + c * 8192, tm_q, 64 * c, it * kTile, bh,
                  ring.full(s));
      tma_load_3d(ring.tile(s, 1) + c * 8192, tm_do, 64 * c, it * kTile, bh,
                  ring.full(s));
    }
    const size_t row = size_t(bh) * s_len + it * kTile;
    bulk_load(ring.rows(s), lse + row, kDkvRowBytes / 2, ring.full(s));
    bulk_load(ring.rows(s) + kDkvRowBytes / 2, delta + row, kDkvRowBytes / 2,
              ring.full(s));
  }
}

// One block: kv tiles 2 kb and 2 kb + 1 of kv row bhkv = blockIdx.y, the
// heaviest (lowest, under the causal mask) first. Warpgroups 0 and 1 are
// the consumers, each with its kv tile's K and V resident; warpgroup 2 the
// producer, one thread of which fills the ring, for each q head of the
// group in turn and each q tile some kv tile of the block sees, with the
// Q and dO tiles (TMA boxes from 3-D tensor maps over (B*Hq, S, hd)) and
// the tile's 64 lse and 64 delta (bulk copies). Each consumer computes
// the q tiles its own kv tile sees and sums the group's heads in the ring's
// order.
template <int HD>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_do,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dk, float* __restrict__ dv,
                        int group, int s_len, int hd, float scale, int causal,
                        int window) {
  using namespace attn_tile;
  using RingT = Ring<HD, kBwdStages, kDkvRowBytes>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t resident = (smem_u32(smem_raw) + 1023) & ~1023u;
  const RingT ring = RingT::at(resident + 2 * kBwdConsumers * tile_bytes<HD>());

  const int n_tiles = s_len / kTile;
  const int kb = blockIdx.x;
  const int bhkv = blockIdx.y;
  int lo = n_tiles, hi = -1;  // the q tiles some kv tile of the block sees
#pragma unroll
  for (int w = 0; w < kBwdConsumers; ++w) {
    const int kt = kBwdConsumers * kb + w;
    if (kt >= n_tiles) continue;
    int a, b;
    q_span(kt, n_tiles, causal != 0, window, &a, &b);
    lo = min(lo, a);
    hi = max(hi, b);
  }
  const int n_q = max(hi - lo + 1, 0);  // loads per q head

  if (threadIdx.x == 0) ring.init(1, kBwdConsumers * kWarpgroup);
  __syncthreads();
  const int wg = threadIdx.x / kWarpgroup;
  if (wg == kBwdConsumers) {  // the producer warpgroup
    set_max_regs_dec<kBwdProducerRegs>();
    if (threadIdx.x % kWarpgroup == 0) {
      dkv_produce<HD>(ring, &tm_q, &tm_do, lse, delta, bhkv, group, lo, n_q,
                      s_len);
    }
    return;
  }
  set_max_regs_inc<kBwdConsumerRegs>();

  const int kt = kBwdConsumers * kb + wg;
  const int k0 = kt * kTile;
  const bool live = kt < n_tiles;
  int mine_lo = 0, mine_hi = -1;
  if (live) q_span(kt, n_tiles, causal != 0, window, &mine_lo, &mine_hi);
  const uint32_t k_tile = resident + 2 * wg * tile_bytes<HD>();
  const uint32_t v_tile = k_tile + tile_bytes<HD>();
  load_rows<HD>(k_tile, [&](int r) -> const __nv_bfloat16* {
    return live ? k + (size_t(bhkv) * s_len + k0 + r) * hd : nullptr;
  }, 1 + wg, hd);
  load_rows<HD>(v_tile, [&](int r) -> const __nv_bfloat16* {
    return live ? v + (size_t(bhkv) * s_len + k0 + r) * hd : nullptr;
  }, 1 + wg, hd);
  float dk_acc[HD / 64][32], dv_acc[HD / 64][32];
#pragma unroll
  for (int nb = 0; nb < HD / 64; ++nb) {
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[nb][i] = dv_acc[nb][i] = 0.f;
  }
  // the diagonal, and q tiles whose farthest pair (q row it * 64 + 63,
  // key k0) falls out of the window
  auto masked = [&](int it) {
    return causal != 0 &&
           (it == kt || (window > 0 && it * kTile + kTile - 1 - k0 >= window));
  };
  const int k_pos[2] = {k0 + Acc<HD>::row(0), k0 + Acc<HD>::row(2)};
  auto kept = [&](int h, int pos) { return keep(pos, k_pos[h], true, window); };
  walk(ring, group * n_q, [&](int n, int s) {
    const int it = lo + n % n_q;
    if (it >= mine_lo && it <= mine_hi) {
      dkv_step<HD>(dk_acc, dv_acc, k_tile, v_tile, ring.tile(s, 0),
                   ring.tile(s, 1), ring.rows(s), scale * kLog2e, scale,
                   it * kTile, masked(it), kept);
    }
  });
  if (!live) return;
#pragma unroll
  for (int nb = 0; nb < HD / 64; ++nb) {
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int col = 64 * nb + Acc<HD>::col(i);
      if (col >= hd) continue;  // a padded column
      const size_t off = (size_t(bhkv) * s_len + k0 + Acc<HD>::row(i)) * hd + col;
      *reinterpret_cast<float2*>(dk + off) = make_float2(dk_acc[nb][i], dk_acc[nb][i + 1]);
      *reinterpret_cast<float2*>(dv + off) = make_float2(dv_acc[nb][i], dv_acc[nb][i + 1]);
    }
  }
}

// K3 at hd 256. One block: kv tile kt = blockIdx.x of kv row bhkv =
// blockIdx.y, the heaviest (lowest, under the causal mask) first.
// Warpgroup 0 loads the tile's K and warpgroup 1 its V into shared memory
// both read; warpgroup 2 is K3's producer. Each consumer warpgroup walks
// every stage (the group's q heads x the q tiles the kv tile sees), computes
// S^T and dP^T over the whole hd, and keeps dK and dV for its half of the
// columns (dkv_step's OUT = HD / 2 from column wg * HD / 2).
template <int HD>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dkv_tc_halves_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_do,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               float* __restrict__ dk, float* __restrict__ dv,
                               int group, int s_len, int hd, float scale,
                               int causal, int window) {
  using namespace attn_tile;
  constexpr int kHalf = HD / 2;
  using RingT = Ring<HD, bwd_stages<HD>(), kDkvRowBytes>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t k_tile = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t v_tile = k_tile + tile_bytes<HD>();
  const RingT ring = RingT::at(v_tile + tile_bytes<HD>());

  const int n_tiles = s_len / kTile;
  const int kt = blockIdx.x;
  const int k0 = kt * kTile;
  const int bhkv = blockIdx.y;
  int lo, hi;  // the q tiles the kv tile sees: never empty
  q_span(kt, n_tiles, causal != 0, window, &lo, &hi);
  const int n_q = hi - lo + 1;

  if (threadIdx.x == 0) ring.init(1, kBwdConsumers * kWarpgroup);
  __syncthreads();
  const int wg = threadIdx.x / kWarpgroup;
  if (wg == kBwdConsumers) {  // the producer warpgroup
    set_max_regs_dec<kBwdProducerRegs>();
    if (threadIdx.x % kWarpgroup == 0) {
      dkv_produce<HD>(ring, &tm_q, &tm_do, lse, delta, bhkv, group, lo, n_q,
                      s_len);
    }
    return;
  }
  set_max_regs_inc<kBwdConsumerRegs>();

  const __nv_bfloat16* kv = wg == 0 ? k : v;
  load_rows<HD>(wg == 0 ? k_tile : v_tile, [&](int r) -> const __nv_bfloat16* {
    return kv + (size_t(bhkv) * s_len + k0 + r) * hd;
  }, 1 + wg, hd);
  named_sync<kBwdConsumers * kWarpgroup>(3);  // both tiles are in place
  float dk_acc[kHalf / 64][32], dv_acc[kHalf / 64][32];
#pragma unroll
  for (int nb = 0; nb < kHalf / 64; ++nb) {
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[nb][i] = dv_acc[nb][i] = 0.f;
  }
  // the diagonal, and q tiles whose farthest pair falls out of the window
  auto masked = [&](int it) {
    return causal != 0 &&
           (it == kt || (window > 0 && it * kTile + kTile - 1 - k0 >= window));
  };
  const int k_pos[2] = {k0 + Acc<HD>::row(0), k0 + Acc<HD>::row(2)};
  auto kept = [&](int h, int pos) { return keep(pos, k_pos[h], true, window); };
  walk(ring, group * n_q, [&](int n, int s) {
    const int it = lo + n % n_q;
    dkv_step<HD, kHalf>(dk_acc, dv_acc, k_tile, v_tile, ring.tile(s, 0),
                        ring.tile(s, 1), ring.rows(s), scale * kLog2e, scale,
                        it * kTile, masked(it), kept, wg * kHalf);
  });
#pragma unroll
  for (int nb = 0; nb < kHalf / 64; ++nb) {
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int col = wg * kHalf + 64 * nb + Acc<HD>::col(i);
      const size_t off = (size_t(bhkv) * s_len + k0 + Acc<HD>::row(i)) * hd + col;
      *reinterpret_cast<float2*>(dk + off) = make_float2(dk_acc[nb][i], dk_acc[nb][i + 1]);
      *reinterpret_cast<float2*>(dv + off) = make_float2(dv_acc[nb][i], dv_acc[nb][i + 1]);
    }
  }
}

// --- launchers ----------------------------------------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

template <int HD>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int group, int s_len, int hd,
                       float scale, int causal, int window,
                       cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<HD>;
  cudaError_t err = allow_smem(kernel, fwd_smem<HD>());
  if (err != cudaSuccess) return err;
  const dim3 grid(s_len / kTile, bh);
  kernel<<<grid, kThreads, fwd_smem<HD>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), group, s_len, hd, scale, causal, window);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query (no link against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// a (rows, S, hd) bf16 tensor as TMA boxes of 64 rows x 64 columns
// (128 bytes), written to shared memory in the 128-byte swizzle; at hd 16
// or 32 the box is wider than a row and the copy fills the columns past hd
// with zeros (CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE), counting them in the
// bytes it completes on the barrier
bool tile_map(CUtensorMap* map, const void* base, int rows, int s_len, int hd) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {cuuint64_t(hd), cuuint64_t(s_len), cuuint64_t(rows)};
  const cuuint64_t strides[2] = {cuuint64_t(hd) * 2, cuuint64_t(s_len) * hd * 2};
  const cuuint32_t box[3] = {64, kTile, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch_fwd_tc(const void* q, const void* k, const void* v, void* o,
                          void* lse, int bh, int group, int s_len, int hd,
                          float scale, int causal, int window,
                          cudaStream_t stream) {
  CUtensorMap tm_k, tm_v;
  if (!tile_map(&tm_k, k, bh / group, s_len, hd) ||
      !tile_map(&tm_v, v, bh / group, s_len, hd)) {
    return cudaErrorNotSupported;
  }
  constexpr size_t smem =
      attn_tile::smem_bytes<HD, fwd_stages<HD>(), kTcConsumers>();
  auto kernel = flash_fwd_tc_kernel<HD>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = s_len / kTile;
  const dim3 grid((n_tiles + kTcConsumers - 1) / kTcConsumers, bh);
  kernel<<<grid, fwd_threads<HD>(), smem, stream>>>(
      tm_k, tm_v, static_cast<const __nv_bfloat16*>(q),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), group, s_len,
      hd, scale, causal, window);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int bh_kv, int group, int s_len,
                       int hd, float scale, int causal, int window,
                       cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_kernel<HD>;
  cudaError_t err = allow_smem(kernel, dkv_smem<HD>());
  if (err != cudaSuccess) return err;
  const dim3 grid(s_len / kTile, bh_kv);
  kernel<<<grid, kThreads, dkv_smem<HD>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), group, s_len, hd,
      scale, causal, window);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv_tc(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse, const void* delta,
                          void* dk, void* dv, int bh_kv, int group, int s_len,
                          int hd, float scale, int causal, int window,
                          cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  CUtensorMap tm_q, tm_do;
  if (!tile_map(&tm_q, q, bh_kv * group, s_len, hd) ||
      !tile_map(&tm_do, dout, bh_kv * group, s_len, hd)) {
    return cudaErrorNotSupported;
  }
  // at hd 256 one kv tile a block (the halves kernel), else two
  constexpr bool kHalves = HD == 256;
  constexpr int kTiles = kHalves ? 1 : kBwdConsumers;
  constexpr size_t smem = attn_tile::smem_bytes<HD, bwd_stages<HD>(),
                                                2 * kTiles, kDkvRowBytes>();
  auto kernel = [] {  // only the one that runs is instantiated
    if constexpr (HD == 256) {
      return flash_bwd_dkv_tc_halves_kernel<HD>;
    } else {
      return flash_bwd_dkv_tc_kernel<HD>;
    }
  }();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = s_len / kTile;
  const dim3 grid((n_tiles + kTiles - 1) / kTiles, bh_kv);
  kernel<<<grid, kBwdThreads, smem, stream>>>(
      tm_q, tm_do, static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), group, s_len, hd,
      scale, causal, window);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int bh, int group, int s_len, int hd,
                      float scale, int causal, int window,
                      cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<HD>;
  cudaError_t err = allow_smem(kernel, dq_smem<HD>());
  if (err != cudaSuccess) return err;
  const dim3 grid(s_len / kTile, bh);
  kernel<<<grid, kThreads, dq_smem<HD>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), group, s_len, hd, scale, causal, window);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dq_tc(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dq, int bh, int group, int s_len, int hd,
                         float scale, int causal, int window,
                         cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  CUtensorMap tm_k, tm_v;
  if (!tile_map(&tm_k, k, bh / group, s_len, hd) ||
      !tile_map(&tm_v, v, bh / group, s_len, hd)) {
    return cudaErrorNotSupported;
  }
  constexpr int kC = dq_consumers<HD>();
  constexpr size_t smem = attn_tile::smem_bytes<HD, bwd_stages<HD>(), 2 * kC>();
  auto kernel = flash_bwd_dq_tc_kernel<HD>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = s_len / kTile;
  const dim3 grid((n_tiles + kC - 1) / kC, bh);
  kernel<<<grid, dq_threads<HD>(), smem, stream>>>(
      tm_k, tm_v, static_cast<const bf16*>(q), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), group, s_len, hd, scale, causal, window);
  return cudaGetLastError();
}

// the head dims the kernels take: 128 and 256 in their own
// instantiations, 64, 32 and 16 in the 64-column one (the narrow ones
// zero-padded in shared memory)
bool valid(int rows, int group, int s_len, int hd, int dtype) {
  return rows > 0 && group > 0 && s_len > 0 && s_len % kTile == 0 &&
         (hd == 16 || hd == 32 || hd == 64 || hd == 128 || hd == 256) &&
         (dtype == 0 || dtype == 1);
}

}  // namespace

// C interface (loaded with ctypes). dtype: 0 = f32 (the CUDA cores), 1 =
// bf16 (the tensor cores), the type of q, k, v, dO and o; lse, delta, dk,
// dv and dq are f32. Layouts as above, contiguous, 16-byte aligned; bh =
// B * Hq rows of q, bh_kv = B * Hkv rows of k, group = Hq / Hkv. Each
// returns the cudaError_t of its launch (0 = launched).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int dtype, int bh, int group, int s_len,
                         int hd, float scale, int causal, int window,
                         void* stream) {
  if (!valid(bh, group, s_len, hd, dtype) || bh % group != 0) {
    return int(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch =
      dtype == 0 ? (hd == 256 ? launch_fwd<256> : hd == 128 ? launch_fwd<128> : launch_fwd<64>)
                 : (hd == 256 ? launch_fwd_tc<256>
                    : hd == 128 ? launch_fwd_tc<128> : launch_fwd_tc<64>);
  return int(launch(q, k, v, o, lse, bh, group, s_len, hd, scale, causal,
                    window, st));
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int dtype,
                             int bh_kv, int group, int s_len, int hd,
                             float scale, int causal, int window,
                             void* stream) {
  if (!valid(bh_kv, group, s_len, hd, dtype)) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch =
      dtype == 0 ? (hd == 256 ? launch_dkv<256> : hd == 128 ? launch_dkv<128> : launch_dkv<64>)
                 : (hd == 256 ? launch_dkv_tc<256>
                    : hd == 128 ? launch_dkv_tc<128> : launch_dkv_tc<64>);
  return int(launch(q, k, v, dout, lse, delta, dk, dv, bh_kv, group, s_len,
                    hd, scale, causal, window, st));
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int dtype, int bh,
                            int group, int s_len, int hd, float scale,
                            int causal, int window, void* stream) {
  if (!valid(bh, group, s_len, hd, dtype) || bh % group != 0) {
    return int(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch =
      dtype == 0 ? (hd == 256 ? launch_dq<256> : hd == 128 ? launch_dq<128> : launch_dq<64>)
                 : (hd == 256 ? launch_dq_tc<256>
                    : hd == 128 ? launch_dq_tc<128> : launch_dq_tc<64>);
  return int(launch(q, k, v, dout, lse, delta, dq, bh, group, s_len, hd,
                    scale, causal, window, st));
}
