// The tensor-core attention mainloop shared by the flash forward and
// backward (K2, K3, K4, flash_attention.cu) and the ragged-paged kernel's
// prefill-chunk route (K1, ragged_paged_attention.cu), hand-written for
// Hopper (sm_90a).
//
// What it computes. A consumer warpgroup (128 threads) owns 64 query
// vectors, held in shared memory as bf16. For each 64-row K/V tile of its
// span, in ascending order:
//   S = Q K^T          wgmma m64n64k16, bf16 in, f32 accumulate, hd/16 steps;
//   mask, online softmax on the accumulator fragment's rows (in the log2
//                      domain: x = s * scale * log2(e), p = 2^(x - m)), the
//                      row max and row sum over a quad with two shuffles;
//   O = O * alpha + P V  P rounded once to bf16 in registers and used as
//                      wgmma's A operand; V read from shared memory through
//                      the descriptor's transpose bit, one m64n64k16 per 64
//                      columns of hd.
// The caller's epilogue divides by l and rounds once to its output type.
// The backward's steps (dq_step, dkv_step below) run the same products on
// the same tiles with lse final, so no running max: S and dP as SS
// products, p and dS in f32 on the fragment, each rounded once to bf16 as
// the register A operand of its gradient product.
//
// Why tensor cores. At the training and prefill shapes both kernels do
// hundreds of operations per byte they read: they are bound by operations,
// and the card does bf16 products at 989 TFLOP/s in wgmma against 67 in f32
// on the CUDA cores. What the design does for it: the products run on
// wgmma from swizzled shared memory (no bank conflicts, no register copies
// of Q, K or V); softmax never leaves registers; K/V tiles stream through
// a ring of kStages stages guarded by mbarriers, filled by producer warps
// while the consumers compute, so loads overlap the products.
//
// Shared-memory layout of a 64-row tile with hd columns, bf16: hd / 64
// sub-tiles of 64 rows x 128 bytes, each 1024-byte aligned, the 16-byte
// chunk c of row r stored at chunk c ^ (r % 8) (the 128-byte swizzle that
// TMA's CU_TENSOR_MAP_SWIZZLE_128B writes and wgmma's descriptors read).
// Q and K are K-major operands (hd contiguous); V is the MN-major B
// operand of P V (its hd columns contiguous), read with trans-b = 1.
//
// The producer is the kernel's own: one warp issuing TMA boxes (K2, K4;
// K3 adds a bulk copy of each q tile's lse and delta rows), or warps
// gathering rows through a page table and dequantizing codes (K1), writing
// the same layout. It signals a stage's full barrier; every consumer
// thread arrives on the stage's empty barrier when its products have read
// it.
//
// Determinism: no atomics; each row's sum runs over the kv tiles in
// ascending order and in wgmma's fixed order inside a tile; the row sum l
// is kept per thread and reduced over the quad in a fixed order at the end.
// A gradient sums over its ring's loads in the order the producer issues
// them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn_tile {

constexpr int kRows = 64;           // query vectors per consumer warpgroup
constexpr int kKv = 64;             // kv rows per tile
constexpr int kWarpgroup = 128;
constexpr float kNegBig = -1e30f;   // the masked score, as the plain versions
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int HD>
__host__ __device__ constexpr uint32_t tile_bytes() { return kRows * HD * 2; }

// byte offset of element (row, col) of a swizzled 64 x HD bf16 tile
__device__ __forceinline__ uint32_t swizzle(int row, int col) {
  const int chunk = (col % 64) / 8;
  return uint32_t((col / 64) * 8192 + row * 128 + ((chunk ^ (row % 8)) << 4) +
                  (col % 8) * 2);
}

// --- PTX helpers -------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// generic-proxy writes to shared memory made visible to wgmma and TMA
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier over the 128 threads of one consumer warpgroup (ids 1..)
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kWarpgroup) : "memory");
}

// `bytes` contiguous bytes (16-byte aligned, a multiple of 16) from global
// into shared memory, completing them on the barrier
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float2 ld_shared_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr));
  return v;
}

// a warpgroup's register budget (setmaxnreg; every thread of the
// warpgroup, on a path that does not rejoin the other warpgroups')
template <int N>
__device__ __forceinline__ void set_max_regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void set_max_regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// one TMA box of a 3-D tensor map (coordinates innermost first) into
// shared memory, completing `bytes` on the barrier
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map, int c0,
                                            int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool fill) {
  // src-size 0 fills the 16 bytes with zeros (reads nothing)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void st_shared_16(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x),
               "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled operand. Every
// operand here spans 64 rows (or one 64-column block) in the dimension
// whose repeat stride matters, so both offsets are the 1024 bytes between
// groups of 8 rows.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  constexpr uint64_t kOffset = 1024 >> 4;
  return uint64_t((addr & 0x3FFFF) >> 4) | (kOffset << 16) | (kOffset << 32) |
         (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns the registers
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ATTN_TILE_D32                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),      \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),             \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),         \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),         \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),         \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),         \
      "+f"(d[31])

#define ATTN_TILE_REGS32                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31}"

// d (+)= A B^T, A (64 x 16) and B (64 x 16) K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ATTN_TILE_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : ATTN_TILE_D32
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B, A (64 x 16) bf16 in registers, B (16 x 64) MN-major in shared
// memory (trans-b)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ATTN_TILE_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : ATTN_TILE_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef ATTN_TILE_D32
#undef ATTN_TILE_REGS32

// d = A B^T over hd: A and B 64-row K-major tiles (hd contiguous), one
// m64n64k16 per 16 columns; the first starts d from zero
template <int HD>
__device__ __forceinline__ void ss_product(float (&d)[32], uint32_t a,
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk / 4) * 8192 + (kk % 4) * 32;
    wgmma_ss(d, make_desc(a + off), make_desc(b + off), kk > 0);
  }
}

// a 64 x 64 accumulator fragment as wgmma's A fragments, each value
// rounded once to bf16: k-step kk holds columns 16 kk .. 16 kk + 15, which
// are accumulator chunks 2 kk and 2 kk + 1
__device__ __forceinline__ void pack_a(const float (&x)[32],
                                       uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) a[kk][e] = pack_bf16(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1]);
  }
}

// d[nb] += A B: A (64 x 64) in registers, B a 64 x HD tile read MN-major
// (trans-b: its 64 rows are the k dimension, its hd columns contiguous),
// one m64n64k16 per 16 rows and 64 columns
template <int HD>
__device__ __forceinline__ void rs_product(float (&d)[HD / 64][32],
                                           const uint32_t (&a)[4][4],
                                           uint32_t b) {
#pragma unroll
  for (int nb = 0; nb < HD / 64; ++nb) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs(d[nb], a[kk], make_desc(b + nb * 8192 + kk * 2048));
    }
  }
}

// --- the ring of stages ------------------------------------------------------

// kStages stages of two 64 x HD bf16 tiles each ((K, V) for the forward
// and dQ, (Q, dO) for dK dV), each tile 1024-byte aligned, then kRowBytes
// a stage of row data (K3's lse and delta; none for the others, whose
// layout is the tiles and barriers alone), then the barriers: full[s]
// (the producer's arrivals and bytes) and empty[s] (one arrival per
// consumer thread).
template <int HD, int kStages, int kRowBytes = 0>
struct Ring {
  uint32_t tiles;  // shared address of stage 0's first tile
  uint32_t bars;   // shared address of full[0]; empty[0] follows full[]

  static constexpr int kCount = kStages;
  static constexpr uint32_t kStageBytes = 2 * tile_bytes<HD>();
  static constexpr uint32_t kBytes =
      kStages * (kStageBytes + kRowBytes) + 16 * kStages;
  static_assert(kRowBytes % 16 == 0, "row slots stay 16-byte aligned");

  // the ring right after `tiles`, its barriers after its last row slot
  __device__ __forceinline__ static Ring at(uint32_t tiles) {
    return Ring{tiles, tiles + kStages * (kStageBytes + kRowBytes)};
  }
  // tile i (0 or 1) of stage s
  __device__ __forceinline__ uint32_t tile(int s, int i) const {
    return tiles + s * kStageBytes + i * tile_bytes<HD>();
  }
  __device__ __forceinline__ uint32_t rows(int s) const {
    return tiles + kStages * kStageBytes + s * kRowBytes;
  }
  __device__ __forceinline__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return bars + 8 * (kStages + s);
  }
  // one thread, before the block's first __syncthreads
  __device__ __forceinline__ void init(uint32_t full_count,
                                       uint32_t empty_count) const {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), full_count);
      mbar_init(empty(s), empty_count);
    }
    mbar_init_fence();
  }
  // the producer's turn at load n: wait until the consumers released the
  // stage's previous tile (load n - kStages); returns the stage
  __device__ __forceinline__ int acquire(int n) const {
    const int s = n % kStages;
    if (n >= kStages) mbar_wait(empty(s), ((n / kStages) - 1) & 1);
    return s;
  }
};

// the shared memory a block needs: its resident tiles (a query tile per
// consumer warpgroup; the backward's two per warpgroup), the ring, and
// the slack that aligns the first tile to 1024 bytes
template <int HD, int kStages, int kResident, int kRowBytes = 0>
__host__ __device__ constexpr size_t smem_bytes() {
  return 1024 + kResident * tile_bytes<HD>() +
         Ring<HD, kStages, kRowBytes>::kBytes;
}

// --- one consumer warpgroup --------------------------------------------------

// the accumulator fragment of one thread: rows row(0) and row(2) of the
// warpgroup's 64, 16 columns of every 64 (m64nNk16's f32 D layout)
template <int HD>
struct Acc {
  float o[HD / 64][32];  // P V, one block of 64 columns per wgmma
  float m[2];            // running row max, log2 domain
  float l[2];            // this thread's share of the row sum

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int nb = 0; nb < HD / 64; ++nb) {
#pragma unroll
      for (int i = 0; i < 32; ++i) o[nb][i] = 0.f;
    }
    m[0] = m[1] = kNegBig;
    l[0] = l[1] = 0.f;
  }
  // row (of 64) and column (of 64) of register i
  __device__ __forceinline__ static int row(int i) {
    const int t = threadIdx.x % kWarpgroup;
    return 16 * (t / 32) + (t % 32) / 4 + ((i & 2) ? 8 : 0);
  }
  __device__ __forceinline__ static int col(int i) {
    return 8 * (i / 4) + 2 * (threadIdx.x % 4) + (i & 1);
  }
  // the row sums over the quad (every thread of it gets the same bits)
  __device__ __forceinline__ void finish() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
  }
};

// 64 rows into a swizzled tile resident for the warpgroup's life (its
// query vectors; the backward's K and V, or Q and dO): row_ptr(r) is row
// r's hd bf16 values (16-byte aligned), or null for a zero row. Ends with
// the warpgroup synchronised on named barrier `bar_id`.
template <int HD, class RowPtr>
__device__ __forceinline__ void load_rows(uint32_t tile, RowPtr row_ptr,
                                          int bar_id) {
  constexpr int kChunks = kRows * HD / 8;
  for (int e = threadIdx.x % kWarpgroup; e < kChunks; e += kWarpgroup) {
    const int r = e / (HD / 8);
    const int c = e % (HD / 8);
    const __nv_bfloat16* src = row_ptr(r);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (src != nullptr) v = __ldg(reinterpret_cast<const uint4*>(src + 8 * c));
    st_shared_16(tile + swizzle(r, 8 * c), v);
  }
  fence_async_shared();
  warpgroup_sync(bar_id);
}

// One kv tile: S = Q K^T, the mask (keep(h, pos) for this thread's row
// Acc::row(2 h) and tile column c at pos = kv0 + c, applied only when
// `masked`), the online update, and O = O * alpha + P V with P rounded to
// bf16.
template <int HD, class Keep>
__device__ __forceinline__ void tile_step(Acc<HD>& acc, uint32_t q_tile,
                                          uint32_t k_tile, uint32_t v_tile,
                                          float scale_log2, int kv0,
                                          bool masked, Keep keep) {
  float s[32];
  fence_regs(s);
  wgmma_fence();
  ss_product<HD>(s, q_tile, k_tile);
  wgmma_commit();
  wgmma_wait0();
  fence_regs(s);

  float mx[2] = {kNegBig, kNegBig};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float x = s[i] * scale_log2;
    if (masked && !keep((i >> 1) & 1, kv0 + Acc<HD>::col(i))) x = kNegBig;
    s[i] = x;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
  }
  float alpha[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(acc.m[h], mx[h]);
    alpha[h] = exp2f(acc.m[h] - m_new);
    acc.m[h] = m_new;
    acc.l[h] *= alpha[h];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    const float p = exp2f(s[i] - acc.m[h]);
    acc.l[h] += p;
    s[i] = p;
  }
  uint32_t pa[4][4];
  pack_a(s, pa);
#pragma unroll
  for (int nb = 0; nb < HD / 64; ++nb) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc.o[nb][i] *= alpha[(i >> 1) & 1];
    fence_regs(acc.o[nb]);
  }
  wgmma_fence();
  rs_product<HD>(acc.o, pa, v_tile);
  wgmma_commit();
  wgmma_wait0();
#pragma unroll
  for (int nb = 0; nb < HD / 64; ++nb) fence_regs(acc.o[nb]);
}

// A warpgroup's turn at loads 0 .. n_loads - 1 of a ring: for each, wait
// until it landed, step(n, stage), release the stage.
template <class RingT, class Step>
__device__ __forceinline__ void walk(const RingT& ring, int n_loads,
                                     Step step) {
  for (int n = 0; n < n_loads; ++n) {
    const int s = n % RingT::kCount;
    mbar_wait(ring.full(s), (n / RingT::kCount) & 1);
    step(n, s);
    mbar_arrive(ring.empty(s));
  }
}

// A consumer warpgroup's walk over the ring: loads lo .. hi of the block
// (load n is kv tile lo + n); it computes the tiles in [mine_lo, mine_hi]
// and only waits for and releases the others, so the block's warpgroups
// may have different spans over one ring. masked(j) says whether tile j
// needs the mask.
template <int HD, int kStages, class Masked, class Keep>
__device__ __forceinline__ void consume(Acc<HD>& acc, const Ring<HD, kStages>& ring,
                                        uint32_t q_tile, float scale_log2,
                                        int lo, int hi, int mine_lo,
                                        int mine_hi, Masked masked, Keep keep) {
  walk(ring, hi - lo + 1, [&](int n, int s) {
    const int j = lo + n;
    if (j >= mine_lo && j <= mine_hi) {
      tile_step<HD>(acc, q_tile, ring.tile(s, 0), ring.tile(s, 1), scale_log2,
                    j * kKv, masked(j), keep);
    }
  });
  acc.finish();
}

// --- the backward (K3, K4) ---------------------------------------------------

// One kv tile of dQ (K4), for the warpgroup's 64 q rows: S = Q K^T and
// dP = dO V^T (SS, one commit group); p = 2^(s scale log2(e) - lse
// log2(e)) with lse final (masked: 0); dS = p (dP - delta) scale in f32,
// rounded once to bf16 as the A operand of dQ += dS K, K read MN-major
// (trans-b). lse2[h] (lse log2(e)) and delta[h] are row Acc::row(2 h)'s;
// keep(h, pos) as in tile_step.
template <int HD, class Keep>
__device__ __forceinline__ void dq_step(float (&dq)[HD / 64][32],
                                        uint32_t q_tile, uint32_t do_tile,
                                        uint32_t k_tile, uint32_t v_tile,
                                        float scale_log2, float scale,
                                        const float (&lse2)[2],
                                        const float (&delta)[2], int kv0,
                                        bool masked, Keep keep) {
  float s[32], dp[32];
  fence_regs(s);
  fence_regs(dp);
  wgmma_fence();
  ss_product<HD>(s, q_tile, k_tile);
  ss_product<HD>(dp, do_tile, v_tile);
  wgmma_commit();
  wgmma_wait0();
  fence_regs(s);
  fence_regs(dp);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    float x = s[i] * scale_log2 - lse2[h];
    if (masked && !keep(h, kv0 + Acc<HD>::col(i))) x = kNegBig;
    dp[i] = exp2f(x) * (dp[i] - delta[h]) * scale;
  }
  uint32_t dsa[4][4];
  pack_a(dp, dsa);
#pragma unroll
  for (int nb = 0; nb < HD / 64; ++nb) fence_regs(dq[nb]);
  wgmma_fence();
  rs_product<HD>(dq, dsa, k_tile);
  wgmma_commit();
  wgmma_wait0();
#pragma unroll
  for (int nb = 0; nb < HD / 64; ++nb) fence_regs(dq[nb]);
}

// One q tile of dK and dV (K3), for the warpgroup's 64 kv rows, transposed:
// S^T = K Q^T and dP^T = V dO^T (SS, one commit group), masked with q
// position = column and k position = row; p^T and dS^T as in dq_step from
// each column's lse and delta (`rows`: the stage's 64 lse, then its 64
// delta, f32); dV += bf16(p^T) dO and dK += bf16(dS^T) Q, dO and Q read
// MN-major. keep(h, q_pos) for row Acc::row(2 h).
template <int HD, class Keep>
__device__ __forceinline__ void dkv_step(float (&dk)[HD / 64][32],
                                         float (&dv)[HD / 64][32],
                                         uint32_t k_tile, uint32_t v_tile,
                                         uint32_t q_tile, uint32_t do_tile,
                                         uint32_t rows, float scale_log2,
                                         float scale, int q0, bool masked,
                                         Keep keep) {
  float st[32], dpt[32];
  fence_regs(st);
  fence_regs(dpt);
  wgmma_fence();
  ss_product<HD>(st, k_tile, q_tile);
  ss_product<HD>(dpt, v_tile, do_tile);
  wgmma_commit();
  wgmma_wait0();
  fence_regs(st);
  fence_regs(dpt);
#pragma unroll
  for (int c = 0; c < 8; ++c) {  // registers 4 c .. 4 c + 3: columns col, col + 1
    const int col = 8 * c + 2 * (threadIdx.x % 4);
    const float2 lse = ld_shared_f2(rows + 4 * col);
    const float2 delta = ld_shared_f2(rows + 4 * (kKv + col));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * c + e;
      float x = st[i] * scale_log2 - ((e & 1) ? lse.y : lse.x) * kLog2e;
      if (masked && !keep((i >> 1) & 1, q0 + col + (e & 1))) x = kNegBig;
      const float p = exp2f(x);
      st[i] = p;
      dpt[i] = p * (dpt[i] - ((e & 1) ? delta.y : delta.x)) * scale;
    }
  }
  uint32_t pa[4][4], dsa[4][4];
  pack_a(st, pa);
  pack_a(dpt, dsa);
#pragma unroll
  for (int nb = 0; nb < HD / 64; ++nb) {
    fence_regs(dk[nb]);
    fence_regs(dv[nb]);
  }
  wgmma_fence();
  rs_product<HD>(dv, pa, do_tile);
  rs_product<HD>(dk, dsa, q_tile);
  wgmma_commit();
  wgmma_wait0();
#pragma unroll
  for (int nb = 0; nb < HD / 64; ++nb) {
    fence_regs(dk[nb]);
    fence_regs(dv[nb]);
  }
}

}  // namespace attn_tile
