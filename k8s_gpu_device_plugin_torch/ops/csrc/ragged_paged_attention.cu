// Ragged-paged attention, hand-written for Hopper (sm_90a): the dense and
// the paged route, over bf16/f32 caches and over int8 or packed int4 codes
// dequantized in the kernel.
//
// Replaces the TPU kernel _rpa_kernel in
// k8s_gpu_device_plugin_tpu/ops/ragged_paged_attention.py (the one Pallas
// body the reference builds in _rpa_call, with its static
// specializations: the page-table index map and `quantized`).
//
// What it computes. q is (B, T, Hq, hd): T query rows per slot, row r of
// slot b at position q_pos = max(base[b] + r, 0). k and v are the dense
// cache (B, S, Hkv, hd), or a pool of pages (n_pages, ps, Hkv, hd) read
// through a table (B, n_slot_pages) int32: cache row `pos` of slot b is
// pool row table[b, pos / ps] * ps + pos % ps, and S = n_slot_pages * ps.
// Row r attends cache rows pos <= q_pos (and, when window > 0,
// q_pos - pos < window); softmax in f32 with the online (m, l, acc)
// recurrence; out = acc / max(l, 1e-30) in q's dtype. The
// q_pos clamp keeps one attended row for an empty slot (base = -1): its
// output is defined and then discarded by the caller. GQA folds the
// `group = Hq / Hkv` q heads of one kv head onto that head: K/V are never
// expanded.
//
// What bounds it. Decode (T = 1) does ~4 flops per byte of K/V it reads
// (group 4, hd 128, bf16): far below the card's ~295 flop/byte balance,
// so a decode call is bound by the bytes of the live K/V span. The design
// reads each live byte once per kv head: one CUDA block per
// (slot, kv head, row tile) serves all `group` q heads of its row tile
// from one shared-memory K/V tile, and the block's kv loop covers only
// the live span first_block(base+1) .. last_block(base+T) of its row tile
// (the TPU kernel's clamped index map), so dead cache rows are never
// loaded. int8 codes halve those bytes (a row is hd codes and one f32
// scale per kv head), int4 codes halve them again (hd / 2 bytes and the
// same scale). The next K/V tile is fetched into registers while the
// current one is consumed.
//
// Two engines, chosen by the caller (ops/ragged_paged_attention.py runs
// every bf16 launch on the tensor cores, f32 queries on the CUDA cores):
// - cuda_cores (rpa_kernel): f32 arithmetic on the CUDA cores, any q type
//   and T; a row tile of 8 query vectors for decode and any window of
//   <= 8, of 64 past that.
// - tensor_cores (rpa_tc_kernel): bf16 queries in row tiles of 64 query
//   vectors on the wgmma mainloop of attention_tile.cuh. A producer
//   warpgroup gathers each 64-row K/V tile through the page table: bf16
//   rows with cp.async, int8/int4 codes through registers, widened and
//   multiplied by their row's scale in f32, rounded once to bf16. Either
//   way it writes the swizzled bf16 tile the wgmma descriptors read, one
//   consumer warpgroup computes while the producer fills the next stages.
//   P is rounded to bf16 for P V.
//   * A prefill chunk (T 256) does 4 * hd operations per (query vector,
//     attended row) against one read of the span: bound by operations.
//     One block per row tile walks its whole live span.
//   * A narrow window (decode, verify: group * T <= 8 query vectors, one
//     row tile) is bound by the bytes of its span, and one block per
//     (slot, kv head) would leave most SMs idle while the longest slot's
//     block walks its span alone. So its span is split (split-KV): block
//     z of grid (B, Hkv, n_split) walks the absolute kv tiles
//     [z K, (z + 1) K) of the live span (K = split_tiles, the wrapper's
//     constant; n_split from the table's virtual extent, never from data),
//     a block whose split holds no live tile exits before it touches the
//     ring, and a span of one split is written as a chunk's is. Else each
//     block writes its query vectors' (m, l, unnormalised o) in f32 to a
//     workspace, and the last of the row tile's blocks to finish (a ticket
//     counter that it resets) reduces every split's partial in ascending
//     split order: o = sum_s o_s 2^(m_s - m) / sum_s l_s 2^(m_s - m), so the
//     result does not depend on which block came last. The padded q tile
//     (4 of 64 rows at group 4) wastes products, not bytes.
//
// TPU -> CUDA. The TPU grid walks kv blocks in order and carries m/l/acc
// in VMEM scratch across grid steps; here that sequential axis is a loop
// inside the block (a split's loop, for a narrow window on the tensor
// cores), and the row tiles of one slot are independent blocks (so T has
// no cap). The accumulation order per row is fixed (ascending kv tiles,
// fixed in-tile order, splits combined in ascending order) and no atomic
// touches the data (the one atomic is the split ticket): a slot's output
// depends neither on its neighbours nor on the launch.
//
// Layouts. The kv loop walks the same 64-row tiles whatever the layout
// and resolves each row of a tile through the table, so a row's
// accumulation order depends neither on the layout nor on the page size:
// the paged route's output is bit-identical to the dense route's on the
// same rows. The table is never checked on the device (its rows come
// from the host's page allocator). Entries past a slot's reservation are
// 0, the trap page: a tile that straddles the end of the reservation
// reads page 0's rows under a mask. A masked row gets the weight
// exp(-1e30 - m) = 0 exactly, and 0 * x is 0 only for a finite x: the
// pool starts as zeros and every later write (a live row, or an inactive
// slot's write into the trap page) is a finite activation, its code or
// its scale, so no row of the pool ever holds a NaN or an infinity.
//
// Quantized caches. int8 codes arrive with two f32 scale planes shaped
// like the cache with a last axis of 1, addressed by the same row. A
// code widens to f32 and multiplies its row's scale while its tile goes
// to shared memory, before either product (the TPU body does the same in
// VMEM); the products never see a code. The cache's element type and the
// layout are template parameters: the bf16 dense instantiation has no
// table lookup, no scale load and no branch on either.
//
// int4 codes. The TPU's jnp.int4 is packed by XLA; here the storage is the
// port's own (ops/quant.py): two codes per byte along the head dim, code
// 2j in the low nibble of byte j and 2j + 1 in its high nibble, two's
// complement. A row of the cache is hd / 2 bytes, so the element type is a
// one-byte tag (Int4x2) and every row offset counts bytes: an element
// offset halved. The scale planes are int8's, addressed by the same row. A
// thread loads 8 bytes (16 codes, int8's count per load), which keeps the
// 64-row tile an exact multiple of the block's 256 threads at hd 64 and
// 128, and sign-extends each nibble with two shifts.
//
// The tensor-core engine keeps the layout invariant: a tile's rows are
// resolved through the table one by one and written to the same bits of
// the same shared-memory tile whatever the layout and page size, so its
// paged output equals its dense output bit for bit, and the trap-page
// reasoning above holds unchanged (a dequantized trap row is finite).
//
// Types: q and out in f32 or bf16; k and v in q's type, or int8 or packed
// int4 codes with scales; hd in {16, 32, 64, 128, 256}; ps a power of two;
// CUDA-core arithmetic is f32, tensor-core products take bf16 operands and
// accumulate in f32.
//
// Narrow head dims. Both engines tile the head dim by 64 columns (HD), so
// hd 16 and 32 run in the HD = 64 instantiation with the live hd passed at
// run time: every row offset counts hd, the loaders read only the chunks
// of a row below hd (a bf16 row of hd 16 is 32 bytes: two 16-byte chunks;
// an int8 row 16 bytes; a packed int4 row 8 bytes: the tensor-core
// producer's 8-code loads are 8 and 4 bytes, the CUDA-core loader's
// 16-code ones 16 and 8, each a whole part of the row) and write zeros
// past it, and only hd columns are stored. Zero columns add exact zeros
// to the scores and give zero output columns, never stored, so the result
// is the unpadded one bit for bit, and paged still equals dense.
//
// Head dim 256 (Gemma) has instantiations of its own. The chunk route's
// three stages of 64 x 256 bf16 K/V tiles and its q tile take 230,448 B
// of the 232,448 a block may hold; the split route's two stages 164,896 B,
// so one split block fits an SM, and its consumer's 128 f32 accumulators
// a thread need the registers of one block an SM (split_blocks_per_sm).
// The CUDA-core engine's row tile of 64 takes 214,272 B.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockK = 64;  // kv rows per tile (two per lane in softmax)
constexpr float kNegBig = -1e30f;

// the element type of a packed int4 cache: one byte, two codes
struct Int4x2 {
  uint8_t b;
};
static_assert(sizeof(Int4x2) == 1, "a packed int4 pair is one byte");

// Per element type: the vector one thread loads (Vec), the elements it
// holds (kPerVec), the elements one storage unit of the type holds
// (kPerUnit), and how a vector widens to f32.
template <typename T>
struct Io;

template <>
struct Io<float> {
  using Vec = uint4;
  static constexpr int kPerVec = 4;  // elements per 16-byte load
  static constexpr int kPerUnit = 1;
  __device__ static __forceinline__ void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static __forceinline__ float load(const float* p) { return *p; }
  __device__ static __forceinline__ void store(float* p, float x) { *p = x; }
};

template <>
struct Io<__nv_bfloat16> {
  using Vec = uint4;
  static constexpr int kPerVec = 8;
  static constexpr int kPerUnit = 1;
  __device__ static __forceinline__ void unpack(const uint4& u, float* f) {
    // bf16 is the high half of an f32: widening is a 16-bit shift
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ static __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
  }
};

template <>
struct Io<int8_t> {
  using Vec = uint4;
  static constexpr int kPerVec = 16;
  static constexpr int kPerUnit = 1;
  __device__ static __forceinline__ void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        f[4 * i + e] = float(int(int8_t((w[i] >> (8 * e)) & 0xffu)));
      }
    }
  }
};

template <>
struct Io<Int4x2> {
  using Vec = uint2;                  // 8 bytes: 16 codes
  static constexpr int kPerVec = 16;
  static constexpr int kPerUnit = 2;  // codes per byte
  __device__ static __forceinline__ void unpack(const uint2& u, float* f) {
    // little-endian: code e of a word sits in bits 4e .. 4e + 3; shifting
    // it to the top and back arithmetically sign-extends it
    const uint32_t w[2] = {u.x, u.y};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        f[8 * i + e] = float(int32_t(w[i] << (28 - 4 * e)) >> 28);
      }
    }
  }
};

// first kv tile a windowed query at `length - 1` can see (0 without one)
__device__ __forceinline__ int first_block(int length, int window) {
  if (window <= 0) return 0;
  const int lo = length - window;
  return (lo > 0 ? lo : 0) / kBlockK;
}

// last kv tile holding live rows; >= 0 even for an empty slot
__device__ __forceinline__ int last_block(int length) {
  const int hi = (length + kBlockK - 1) / kBlockK - 1;
  return hi > 0 ? hi : 0;
}

template <int HD, int ROWS>
constexpr size_t smem_bytes() {
  return sizeof(float) * (ROWS * HD               // q
                          + kBlockK * (HD + 1)    // k (padded rows)
                          + kBlockK * HD          // v
                          + ROWS * kBlockK        // scores / probs
                          + 3 * ROWS)             // m, l, alpha
         + sizeof(int) * ROWS;                    // q positions
}

// One block: ROWS query vectors (tq = ROWS / group query rows x group q
// heads) of slot blockIdx.x, kv head blockIdx.y, row tile blockIdx.z.
// TKV is the cache's element type (T, or int8_t or Int4x2 with scale
// planes); PAGED
// reads k/v as a pool through `pages` (page size 1 << page_shift). The
// scale and table pointers are read only by the instantiations that need
// them.
template <typename T, typename TKV, int HD, int ROWS, bool PAGED>
__global__ void __launch_bounds__(kThreads)
rpa_kernel(const T* __restrict__ q, const TKV* __restrict__ k,
           const TKV* __restrict__ v, const float* __restrict__ k_scale,
           const float* __restrict__ v_scale, const int* __restrict__ base,
           const int* __restrict__ pages, T* __restrict__ out, int n_q,
           int hq, int hkv, int s_len, int hd, int page_shift, float scale,
           int window) {
  using Vec = typename Io<TKV>::Vec;
  constexpr bool kQuant = !std::is_same<TKV, T>::value;
  constexpr int kPerVec = Io<TKV>::kPerVec;
  constexpr int kVecPerRow = HD / kPerVec;
  constexpr int kVecPerThread = kBlockK * kVecPerRow / kThreads;
  static_assert(kBlockK * kVecPerRow % kThreads == 0, "tile splits evenly");
  constexpr int kKStride = HD + 1;  // conflict-free column reads of K
  constexpr int kScoreGroups = kThreads / kBlockK;
  constexpr int kScoreRows = ROWS / kScoreGroups;
  constexpr int kPvGroups = kThreads / HD;
  constexpr int kPvRows = ROWS / kPvGroups;
  static_assert(ROWS % kScoreGroups == 0 && ROWS % kPvGroups == 0,
                "row tile splits evenly");

  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + ROWS * HD;
  float* vs = ks + kBlockK * kKStride;
  float* ss = vs + kBlockK * HD;
  float* m_s = ss + ROWS * kBlockK;
  float* l_s = m_s + ROWS;
  float* a_s = l_s + ROWS;
  int* qpos_s = reinterpret_cast<int*>(a_s + ROWS);

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int group = hq / hkv;
  const int tq = ROWS / group;
  const int t0 = blockIdx.z * tq;
  const int t_valid = min(tq, n_q - t0);
  const int tile_base = base[b] + t0;
  // live kv span of this row tile: its first query's window floor up to
  // its last query's own row (the caller's cache write precedes the read)
  const int j_max = (s_len + kBlockK - 1) / kBlockK - 1;
  const int j_hi = min(last_block(tile_base + t_valid), j_max);
  const int j_lo = min(first_block(tile_base + 1, window), j_hi);

  for (int r = tid; r < ROWS; r += kThreads) {
    // rows past the chunk's end mirror its last row: finite, never stored
    const int t = min(r / group, t_valid - 1);
    qpos_s[r] = max(tile_base + t, 0);
    m_s[r] = kNegBig;
    l_s[r] = 0.f;
  }
  for (int e = tid; e < ROWS * HD; e += kThreads) {
    const int r = e / HD;
    const int t = r / group;
    float x = 0.f;
    if (t < t_valid && e % HD < hd) {
      const size_t row = (size_t(b) * n_q + t0 + t) * hq + h * group + r % group;
      x = Io<T>::load(q + row * hd + e % HD);
    }
    qs[e] = x;
  }

  Vec kreg[kVecPerThread];
  Vec vreg[kVecPerThread];
  float kscl[kQuant ? kVecPerThread : 1];  // the vectors' rows' scales
  float vscl[kQuant ? kVecPerThread : 1];
  const int* table = PAGED ? pages + size_t(b) * (s_len >> page_shift) : nullptr;
  auto fetch = [&](int j) {
#pragma unroll
    for (int i = 0; i < kVecPerThread; ++i) {
      const int vec = tid + i * kThreads;
      const int pos = j * kBlockK + vec / kVecPerRow;
      const int col = (vec % kVecPerRow) * kPerVec;
      if (pos < s_len && col < hd) {
        size_t row;  // of the dense cache, or of the pool
        if constexpr (PAGED) {
          const int page = __ldg(table + (pos >> page_shift));
          row = (size_t(page) << page_shift) + (pos & ((1 << page_shift) - 1));
        } else {
          row = size_t(b) * s_len + pos;
        }
        // in storage units of TKV: packed int4 halves the element offset
        const size_t off = ((row * hkv + h) * hd + col) / Io<TKV>::kPerUnit;
        kreg[i] = __ldg(reinterpret_cast<const Vec*>(k + off));
        vreg[i] = __ldg(reinterpret_cast<const Vec*>(v + off));
        if constexpr (kQuant) {
          kscl[i] = __ldg(k_scale + row * hkv + h);
          vscl[i] = __ldg(v_scale + row * hkv + h);
        }
      } else {
        kreg[i] = Vec{};
        vreg[i] = Vec{};
        if constexpr (kQuant) {
          kscl[i] = 0.f;
          vscl[i] = 0.f;
        }
      }
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < kVecPerThread; ++i) {
      const int vec = tid + i * kThreads;
      const int row = vec / kVecPerRow;
      const int col = (vec % kVecPerRow) * kPerVec;
      float kf[kPerVec];
      float vf[kPerVec];
      Io<TKV>::unpack(kreg[i], kf);
      Io<TKV>::unpack(vreg[i], vf);
#pragma unroll
      for (int e = 0; e < kPerVec; ++e) {
        if constexpr (kQuant) {  // dequantize: code * its row's scale, f32
          kf[e] *= kscl[i];
          vf[e] *= vscl[i];
        }
        ks[row * kKStride + col + e] = kf[e];
        vs[row * HD + col + e] = vf[e];
      }
    }
  };

  const int sc_col = tid % kBlockK;  // score phase: one kv row per thread
  const int sc_grp = tid / kBlockK;  // ... and every kScoreGroups-th q row
  const int pv_d = tid % HD;         // PV phase: one head-dim lane
  const int pv_grp = tid / HD;       // ... and every kPvGroups-th q row
  const int warp = tid / 32;
  const int lane = tid % 32;
  float acc[kPvRows];
#pragma unroll
  for (int i = 0; i < kPvRows; ++i) acc[i] = 0.f;

  fetch(j_lo);
  for (int j = j_lo; j <= j_hi; ++j) {
    __syncthreads();  // the previous tile's PV is done with vs / ss
    stage();
    __syncthreads();
    if (j < j_hi) fetch(j + 1);  // in flight while this tile computes

    // scores: s[r][c] = (q_r . k_c) * scale, masked to kNegBig
    float dot[kScoreRows];
#pragma unroll
    for (int i = 0; i < kScoreRows; ++i) dot[i] = 0.f;
    for (int d = 0; d < HD; ++d) {
      const float kd = ks[sc_col * kKStride + d];
#pragma unroll
      for (int i = 0; i < kScoreRows; ++i) {
        dot[i] += qs[(sc_grp + i * kScoreGroups) * HD + d] * kd;
      }
    }
    const int pos = j * kBlockK + sc_col;
#pragma unroll
    for (int i = 0; i < kScoreRows; ++i) {
      const int r = sc_grp + i * kScoreGroups;
      const int qp = qpos_s[r];
      bool keep = pos <= qp && pos < s_len;
      if (window > 0) keep = keep && (qp - pos < window);
      ss[r * kBlockK + sc_col] = keep ? dot[i] * scale : kNegBig;
    }
    __syncthreads();

    // online softmax, one warp per row: m, l, alpha; ss becomes p
    for (int r = warp; r < ROWS; r += kWarps) {
      const float x0 = ss[r * kBlockK + lane];
      const float x1 = ss[r * kBlockK + lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      }
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = expf(x0 - m_new);
      const float p1 = expf(x1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      }
      ss[r * kBlockK + lane] = p0;
      ss[r * kBlockK + lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ v
#pragma unroll
    for (int i = 0; i < kPvRows; ++i) acc[i] *= a_s[pv_grp + i * kPvGroups];
    for (int c = 0; c < kBlockK; ++c) {
      const float vv = vs[c * HD + pv_d];
#pragma unroll
      for (int i = 0; i < kPvRows; ++i) {
        acc[i] += ss[(pv_grp + i * kPvGroups) * kBlockK + c] * vv;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kPvRows; ++i) {
    const int r = pv_grp + i * kPvGroups;
    const int t = r / group;
    if (t < t_valid && pv_d < hd) {
      const size_t row = (size_t(b) * n_q + t0 + t) * hq + h * group + r % group;
      Io<T>::store(out + row * hd + pv_d, acc[i] / fmaxf(l_s[r], 1e-30f));
    }
  }
}

// --- the tensor-core engine (bf16 q) -----------------------------------------

constexpr int kTcStages = 3;
constexpr int kTcProducers = 128;  // one producer warpgroup
constexpr int kTcThreads = attn_tile::kWarpgroup + kTcProducers;

// A split block (a narrow window) walks at most a few tiles: a ring of two
// stages keeps its shared memory at 83 KB for hd 128, so two blocks fit an
// SM and one's start and combine overlap the other's copies. At hd 256 one
// block fits (164,896 B), and the bound of two would cap a thread at the
// 128 registers its accumulator alone needs.
constexpr int kSplitStages = 2;
template <int HD>
__host__ __device__ constexpr int split_blocks_per_sm() { return HD == 256 ? 1 : 2; }
// query vectors of a narrow window (the wrapper's NARROW_TILE): rows 0..7
// of the consumer's fragment, all in its warp 0
constexpr int kSplitRows = 8;
// one split ticket per (slot, kv head): zero at load, and reset to zero by
// the last block of every launch that takes it
constexpr int kMaxTickets = 1 << 16;
__device__ unsigned int g_tickets[kMaxTickets];

// Fills ring stages with the kv tiles of one (slot, kv head): row
// pos = 64 j + r of tile j from the dense cache or through the table,
// rows at or past s_len, and columns at or past hd, as zeros. Thread `pt`
// of the producers writes 16-byte chunks pt, pt + 128, ... of each of K
// and V.
template <typename TKV, int HD, bool PAGED>
struct ChunkProducer {
  static constexpr bool kCopy = std::is_same<TKV, __nv_bfloat16>::value;
  static constexpr int kChunksPerRow = HD / 8;  // 8 bf16 values a chunk
  static constexpr int kPerThread = attn_tile::kKv * kChunksPerRow / kTcProducers;

  const TKV* k;
  const TKV* v;
  const float* k_scale;
  const float* v_scale;
  const int* table;  // this slot's row of the page table (paged)
  int b, h, hkv, s_len, hd, page_shift;

  // the cache (or pool) row of position pos
  __device__ __forceinline__ size_t row_of(int pos) const {
    if constexpr (PAGED) {
      const int page = __ldg(table + (pos >> page_shift));
      return (size_t(page) << page_shift) + (pos & ((1 << page_shift) - 1));
    } else {
      return size_t(b) * s_len + pos;
    }
  }

  // bf16 rows: cp.async into the swizzled tile (completion is the
  // caller's cp.async group)
  __device__ __forceinline__ void copy(int j, uint32_t k_dst, uint32_t v_dst,
                                       int pt) const {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int e = pt + i * kTcProducers;
      const int r = e / kChunksPerRow;
      const int c = e % kChunksPerRow;
      const int pos = j * attn_tile::kKv + r;
      const bool live = pos < s_len && 8 * c < hd;
      const size_t off = live ? (row_of(pos) * hkv + h) * hd + 8 * c : 0;
      const uint32_t at = attn_tile::swizzle(r, 8 * c);
      attn_tile::cp_async_16(k_dst + at, k + off, live);
      attn_tile::cp_async_16(v_dst + at, v + off, live);
    }
  }

  // int8 or int4 codes: load every chunk's codes and scale, then widen,
  // scale in f32, round once to bf16 and store
  __device__ __forceinline__ void dequant(int j, uint32_t k_dst, uint32_t v_dst,
                                          int pt) const {
    using Raw = typename std::conditional<std::is_same<TKV, int8_t>::value,
                                          uint2, uint32_t>::type;
    Raw kr[kPerThread], vr[kPerThread];
    float ks[kPerThread], vs[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int e = pt + i * kTcProducers;
      const int pos = j * attn_tile::kKv + e / kChunksPerRow;
      const int col = 8 * (e % kChunksPerRow);
      if (pos < s_len && col < hd) {
        const size_t row = row_of(pos) * hkv + h;
        // in bytes: an int4 pair is one byte, so its offset halves
        const size_t off = (row * hd + col) / Io<TKV>::kPerUnit;
        kr[i] = __ldg(reinterpret_cast<const Raw*>(k + off));
        vr[i] = __ldg(reinterpret_cast<const Raw*>(v + off));
        ks[i] = __ldg(k_scale + row);
        vs[i] = __ldg(v_scale + row);
      } else {
        kr[i] = Raw{};
        vr[i] = Raw{};
        ks[i] = vs[i] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int e = pt + i * kTcProducers;
      const uint32_t at = attn_tile::swizzle(e / kChunksPerRow,
                                             8 * (e % kChunksPerRow));
      attn_tile::st_shared_16(k_dst + at, widen(kr[i], ks[i]));
      attn_tile::st_shared_16(v_dst + at, widen(vr[i], vs[i]));
    }
  }

  // eight codes times their row's scale (f32), rounded to bf16
  __device__ __forceinline__ static uint4 widen(uint2 w, float scale) {
    float f[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const uint32_t word = e < 4 ? w.x : w.y;
      f[e] = float(int(int8_t((word >> (8 * (e % 4))) & 0xffu))) * scale;
    }
    return pack8(f);
  }
  __device__ __forceinline__ static uint4 widen(uint32_t w, float scale) {
    float f[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      // code e in bits 4e .. 4e + 3: to the top and back sign-extends it
      f[e] = float(int32_t(w << (28 - 4 * e)) >> 28) * scale;
    }
    return pack8(f);
  }
  __device__ __forceinline__ static uint4 pack8(const float (&f)[8]) {
    return make_uint4(attn_tile::pack_bf16(f[0], f[1]),
                      attn_tile::pack_bf16(f[2], f[3]),
                      attn_tile::pack_bf16(f[4], f[5]),
                      attn_tile::pack_bf16(f[6], f[7]));
  }
};

// A narrow window's split, past its products: this block's partial (m, l
// and the unnormalised o of query vectors 0 .. n_vec - 1, which warp 0's
// fragment rows 0..7 hold) to its slot of `part`, (B, Hkv, n_split,
// kSplitRows, HD + 2) f32 (the instantiation's width, padded columns
// included); then the row tile's ticket, and the block that draws the last
// one reduces the live splits first .. first + n_live - 1 in ascending
// order into the hd columns of out (bf16) and resets the ticket.
template <int HD>
__device__ __forceinline__ void combine_splits(const attn_tile::Acc<HD>& acc,
                                               float* __restrict__ part,
                                               __nv_bfloat16* __restrict__ out,
                                               int b, int h, int n_q, int hq,
                                               int hkv, int hd, int n_vec,
                                               int first, int n_live) {
  using namespace attn_tile;
  constexpr int kStride = HD + 2;  // o, then m (log2 domain), then l
  constexpr int kSplitStride = kSplitRows * kStride;
  __shared__ int last;
  const int group = hq / hkv;
  const int bh = b * hkv + h;
  float* mine = part + (size_t(bh) * gridDim.z + blockIdx.z) * kSplitStride;
  if (threadIdx.x < 32 && Acc<HD>::row(0) < n_vec) {
    float* row = mine + Acc<HD>::row(0) * kStride;
#pragma unroll
    for (int nb = 0; nb < HD / 64; ++nb) {
#pragma unroll
      for (int i = 0; i < 32; i += 4) {  // registers i, i + 1: row(0)'s
        *reinterpret_cast<float2*>(row + 64 * nb + Acc<HD>::col(i)) =
            make_float2(acc.o[nb][i], acc.o[nb][i + 1]);
      }
    }
    if (threadIdx.x % 4 == 0) {
      row[HD] = acc.m[0];
      row[HD + 1] = acc.l[0];
    }
  }
  __threadfence();  // the partial is visible before the ticket is drawn
  warpgroup_sync(1);
  if (threadIdx.x == 0) {
    last = atomicAdd(&g_tickets[bh], 1u) == unsigned(n_live - 1);
  }
  warpgroup_sync(1);
  if (!last) return;
  __threadfence();
  const float* split0 = part + (size_t(bh) * gridDim.z + first) * kSplitStride;
  for (int e = threadIdx.x; e < n_vec * hd; e += kWarpgroup) {
    const int r = e / hd;
    const int c = e % hd;
    const float* p = split0 + r * kStride;
    float m = kNegBig;
    for (int s = 0; s < n_live; ++s) m = fmaxf(m, __ldcg(p + s * kSplitStride + HD));
    float l = 0.f;
    float o = 0.f;
    for (int s = 0; s < n_live; ++s) {
      const float* ps = p + s * kSplitStride;
      const float w = exp2f(__ldcg(ps + HD) - m);
      l += __ldcg(ps + HD + 1) * w;
      o += __ldcg(ps + c) * w;
    }
    const size_t row = (size_t(b) * n_q + r / group) * hq + h * group + r % group;
    out[row * hd + c] = __float2bfloat16(o / fmaxf(l, 1e-30f));
  }
  if (threadIdx.x == 0) g_tickets[bh] = 0u;
}

// One block: the 64 query vectors of row tile blockIdx.z (tq = 64 / group
// query rows x group q heads) of slot blockIdx.x, kv head blockIdx.y: the
// CUDA-core kernel's grid, live span and q-vector folding. SPLIT (a narrow
// window: one row tile) walks split blockIdx.z of the span instead, K =
// split_tiles tiles (combine_splits). Threads 0..127 are the consumer
// warpgroup, 128..255 the producers.
template <typename TKV, int HD, bool PAGED, bool SPLIT>
__global__ void __launch_bounds__(kTcThreads,
                                  SPLIT ? split_blocks_per_sm<HD>() : 1)
rpa_tc_kernel(const __nv_bfloat16* __restrict__ q, const TKV* __restrict__ k,
              const TKV* __restrict__ v, const float* __restrict__ k_scale,
              const float* __restrict__ v_scale, const int* __restrict__ base,
              const int* __restrict__ pages, __nv_bfloat16* __restrict__ out,
              float* __restrict__ part, int n_q, int hq, int hkv, int s_len,
              int hd, int page_shift, float scale, int window,
              int split_tiles) {
  using namespace attn_tile;
  constexpr int kStages = SPLIT ? kSplitStages : kTcStages;
  using RingT = Ring<HD, kStages>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_tile = (smem_u32(smem_raw) + 1023) & ~1023u;
  const RingT ring = RingT::at(q_tile + tile_bytes<HD>());

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int group = hq / hkv;
  const int tq = kRows / group;
  const int t0 = SPLIT ? 0 : blockIdx.z * tq;
  const int t_valid = min(tq, n_q - t0);
  const int tile_base = base[b] + t0;
  const int j_max = (s_len + kBlockK - 1) / kBlockK - 1;
  const int span_hi = min(last_block(tile_base + t_valid), j_max);
  const int span_lo = min(first_block(tile_base + 1, window), span_hi);
  // a split: the absolute tiles [z K, (z + 1) K) of the live span
  const int j_lo = SPLIT ? max(span_lo, int(blockIdx.z) * split_tiles) : span_lo;
  const int j_hi = SPLIT ? min(span_hi, int(blockIdx.z + 1) * split_tiles - 1)
                         : span_hi;
  if (SPLIT && j_lo > j_hi) return;  // no live tile: the ring is never touched

  if (threadIdx.x == 0) ring.init(kTcProducers, kWarpgroup);
  __syncthreads();
  if (threadIdx.x >= kWarpgroup) {  // the producer warpgroup
    using Producer = ChunkProducer<TKV, HD, PAGED>;
    const Producer prod{k, v, k_scale, v_scale,
                        PAGED ? pages + size_t(b) * (s_len >> page_shift) : nullptr,
                        b, h, hkv, s_len, hd, page_shift};
    const int pt = threadIdx.x - kWarpgroup;
    int prev = -1;  // the stage whose copies are still in flight
    for (int j = j_lo, n = 0; j <= j_hi; ++j, ++n) {
      const int s = ring.acquire(n);
      if constexpr (Producer::kCopy) {
        prod.copy(j, ring.tile(s, 0), ring.tile(s, 1), pt);
        cp_async_commit();
        if (prev >= 0) {  // the previous tile landed: hand it over
          cp_async_wait<1>();
          fence_async_shared();
          mbar_arrive(ring.full(prev));
        }
        prev = s;
      } else {
        prod.dequant(j, ring.tile(s, 0), ring.tile(s, 1), pt);
        fence_async_shared();
        mbar_arrive(ring.full(s));
      }
    }
    if (prev >= 0) {
      cp_async_wait<0>();
      fence_async_shared();
      mbar_arrive(ring.full(prev));
    }
    return;
  }

  // query vector r is query row t = r / group of q head h * group + r % group
  load_rows<HD>(q_tile, [&](int r) -> const __nv_bfloat16* {
    const int t = r / group;
    if (t >= t_valid) return nullptr;
    return q + ((size_t(b) * n_q + t0 + t) * hq + h * group + r % group) * hd;
  }, 1, hd);
  int qpos[2];  // this thread's two rows; rows past the chunk mirror its last
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = min(Acc<HD>::row(2 * hh) / group, t_valid - 1);
    qpos[hh] = max(tile_base + t, 0);
  }
  Acc<HD> acc;
  acc.init();
  auto kept = [&](int hh, int pos) {
    const int qp = qpos[hh];
    return pos <= qp && pos < s_len && (window <= 0 || qp - pos < window);
  };
  consume<HD, kStages>(acc, ring, q_tile, scale * kLog2e, j_lo, j_hi, j_lo,
                       j_hi, [](int) { return true; }, kept);
  if constexpr (SPLIT) {
    const int first = span_lo / split_tiles;
    const int n_live = span_hi / split_tiles - first + 1;
    if (n_live > 1) {
      combine_splits<HD>(acc, part, out, b, h, n_q, hq, hkv, hd,
                         group * t_valid, first, n_live);
      return;
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = Acc<HD>::row(2 * hh);
    const int t = r / group;
    if (t >= t_valid) continue;
    const float l = fmaxf(acc.l[hh], 1e-30f);
    const size_t row = (size_t(b) * n_q + t0 + t) * hq + h * group + r % group;
#pragma unroll
    for (int nb = 0; nb < HD / 64; ++nb) {
#pragma unroll
      for (int i = 2 * hh; i < 32; i += 4) {
        const int col = 64 * nb + Acc<HD>::col(i);
        if (col >= hd) continue;  // a padded column
        *reinterpret_cast<uint32_t*>(out + row * hd + col) =
            pack_bf16(acc.o[nb][i] / l, acc.o[nb][i + 1] / l);
      }
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* k_scale;  // null unless the cache holds int8 or int4 codes
  const void* v_scale;
  const void* base;
  const void* pages;    // null on the dense route
  void* out;
  void* part;           // f32 split partials (a narrow window's split launch)
  int b, t, hq, hkv, s_len, hd, page_shift;
  float scale;
  int window;
  int engine;       // 0: CUDA cores, 1: tensor cores
  int split_tiles;  // > 0: a narrow window's split launch on the tensor cores
  cudaStream_t stream;
};

// blocks one SM holds of the tensor-core instantiation last launched (the
// occupancy API), for rpa_blocks_per_sm
int g_blocks_per_sm = 0;

template <typename T, typename TKV, int HD, int ROWS, bool PAGED>
cudaError_t launch(const Args& a) {
  constexpr size_t smem = smem_bytes<HD, ROWS>();
  auto kernel = rpa_kernel<T, TKV, HD, ROWS, PAGED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int tq = ROWS / (a.hq / a.hkv);
  const dim3 grid(a.b, a.hkv, (a.t + tq - 1) / tq);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const TKV*>(a.k),
      static_cast<const TKV*>(a.v), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<const int*>(a.base),
      static_cast<const int*>(a.pages), static_cast<T*>(a.out), a.t, a.hq,
      a.hkv, a.s_len, a.hd, a.page_shift, a.scale, a.window);
  return cudaGetLastError();
}

template <typename TKV, int HD, bool PAGED, bool SPLIT>
cudaError_t launch_tc(const Args& a) {
  constexpr size_t smem =
      attn_tile::smem_bytes<HD, SPLIT ? kSplitStages : kTcStages, 1>();
  auto kernel = rpa_tc_kernel<TKV, HD, PAGED, SPLIT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  static const int resident = [&] {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kTcThreads, smem);
    return n;
  }();
  g_blocks_per_sm = resident;
  const int tq = attn_tile::kRows / (a.hq / a.hkv);
  const int split_rows = kBlockK * a.split_tiles;
  const dim3 grid(a.b, a.hkv,
                  SPLIT ? (a.s_len + split_rows - 1) / split_rows
                        : (a.t + tq - 1) / tq);
  kernel<<<grid, kTcThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const TKV*>(a.k),
      static_cast<const TKV*>(a.v), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<const int*>(a.base),
      static_cast<const int*>(a.pages), static_cast<__nv_bfloat16*>(a.out),
      static_cast<float*>(a.part), a.t, a.hq, a.hkv, a.s_len, a.hd,
      a.page_shift, a.scale, a.window, a.split_tiles);
  return cudaGetLastError();
}

// The engine is the caller's choice; this picks the launch within it.
template <typename T, typename TKV, int HD>
cudaError_t dispatch_rows(const Args& a) {
  if (a.engine == 1) {  // the tensor-core kernel takes bf16 q only
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      if (a.split_tiles > 0) {
        return a.pages ? launch_tc<TKV, HD, true, true>(a)
                       : launch_tc<TKV, HD, false, true>(a);
      }
      return a.pages ? launch_tc<TKV, HD, true, false>(a)
                     : launch_tc<TKV, HD, false, false>(a);
    }
    return cudaErrorInvalidValue;
  }
  const int group = a.hq / a.hkv;
  // decode (and any window of <= 8 query vectors) takes the narrow row
  // tile: 8 q vectors, so a T=1 GQA-4 block wastes half, not 15/16
  if (group * a.t <= 8) {
    return a.pages ? launch<T, TKV, HD, 8, true>(a)
                   : launch<T, TKV, HD, 8, false>(a);
  }
  return a.pages ? launch<T, TKV, HD, 64, true>(a)
                 : launch<T, TKV, HD, 64, false>(a);
}

template <typename T, int HD>
cudaError_t dispatch_codes(const Args& a, int codes) {
  switch (codes) {
    case 0:
      return dispatch_rows<T, T, HD>(a);
    case 8:
      return dispatch_rows<T, int8_t, HD>(a);
    case 4:
      return dispatch_rows<T, Int4x2, HD>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

// hd 128 and 256 in their own instantiations; 64, 32 and 16 in the
// 64-column one
template <typename T>
cudaError_t dispatch_cache(const Args& a, int codes) {
  if (a.hd == 256) return dispatch_codes<T, 256>(a, codes);
  if (a.hd == 128) return dispatch_codes<T, 128>(a, codes);
  if (a.hd == 64 || a.hd == 32 || a.hd == 16) {
    return dispatch_codes<T, 64>(a, codes);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// C interface (loaded with ctypes). dtype (of q and out): 0 = f32,
// 1 = bf16. engine: 0 = the CUDA cores (any q type and T), 1 = the tensor
// cores (bf16 q); the caller chooses. split_tiles > 0 (tensor cores, a
// window of group * t <= 8 query vectors) splits each live span into
// splits of that many 64-row kv tiles, part then being an f32 workspace of
// b * hkv * ceil(s_len / (64 split_tiles)) * 8 * (HD + 2) floats, HD = hd
// at 128 and 256 and 64 below 128 (the instantiation's width); 0 walks each span
// in one block (part unused). codes: 0 = k and v hold q's type
// (k_scale and v_scale null);
// 8 = int8 codes, 4 = int4 codes packed two per byte (rows of hd / 2
// bytes), both with f32 scale planes. pages null: k and v are the dense
// cache (B, s_len, Hkv, hd). Else they are a pool
// (n_pages, 1 << page_shift, Hkv, hd), pages is (B, s_len >> page_shift)
// int32 and s_len the table's virtual extent. hd is q's head dim.
// Everything contiguous and on the device. Returns the cudaError_t of the
// launch (0 = launched).
extern "C" int rpa_forward(const void* q, const void* k, const void* v,
                           const void* k_scale, const void* v_scale,
                           const void* base, const void* pages, void* out,
                           void* part, int dtype, int codes, int b, int t,
                           int hq, int hkv, int s_len, int hd, int page_shift,
                           float scale, int window, int engine,
                           int split_tiles, void* stream) {
  if (b <= 0 || t <= 0 || hkv <= 0 || hq % hkv != 0 || s_len <= 0 ||
      hq / hkv > 64 || (k_scale == nullptr) != (v_scale == nullptr) ||
      (codes == 0) != (k_scale == nullptr) || page_shift < 0 ||
      page_shift > 30 || engine < 0 || engine > 1 ||
      (pages != nullptr && (s_len >> page_shift) << page_shift != s_len)) {
    return int(cudaErrorInvalidValue);
  }
  if (split_tiles < 0 ||
      (split_tiles > 0 && (engine != 1 || (hq / hkv) * t > kSplitRows ||
                           part == nullptr || b * hkv > kMaxTickets))) {
    return int(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, k_scale, v_scale, base, pages, out, part, b, t, hq,
               hkv, s_len, hd, page_shift, scale, window, engine, split_tiles,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = dispatch_cache<float>(a, codes);
  } else if (dtype == 1) {
    err = dispatch_cache<__nv_bfloat16>(a, codes);
  }
  return int(err);
}

// Blocks one SM holds of the tensor-core instantiation launched last (0
// before the first): the occupancy API's answer for its threads and
// shared memory.
extern "C" int rpa_blocks_per_sm() { return g_blocks_per_sm; }
