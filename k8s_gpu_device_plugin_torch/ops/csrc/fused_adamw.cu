// Fused AdamW: the global-norm pass and the single elementwise update,
// hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel. Its reference is k8s_gpu_device_plugin_tpu/ops/
// fused_optim.py (fused_adamw_update), which is plain JAX that XLA fuses;
// the port writes the passes by hand because the eager update
// (models/train.py AdamW.update) runs about ten kernels a leaf with f32
// temporaries of every leaf.
//
// What it computes, per step over the leaves of one model:
//   norm pass:  adamw_sumsq writes, for one leaf, one partial sum of g^2 per
//               block (double: a thread sums thousands of squares) into a
//               fixed slot of a partials array; adamw_finalize (one block)
//               sums every partial in a fixed order and writes
//               gn[0] = sqrt(sum) and
//               gn[1] = scale = min(1, clip / max(gn[0], 1e-16)) (f32).
//   update:     adamw_update reads g, m, v, p of one leaf, scale from gn[1],
//               and writes m, v, p in place:
//                 g  = g * scale
//                 m  = b1 * m + (1 - b1) * g
//                 v  = b2 * v + ((1 - b2) * g) * g
//                 u  = (m / bc1) / (sqrt(v / bc2) + eps)
//                 p  = p - lr * (u + wd * p)
//               in f32, each value rounded once to the leaf's dtype (bf16 or
//               f32). Every operation is an explicitly rounded intrinsic
//               (__fmul_rn, __fadd_rn, ...): nvcc would contract a*b+c into
//               an FMA, eager PyTorch rounds each operation, and with the
//               same order and rounding the kernel equals the plain version
//               (ops/fused_optim.py) bit for bit whenever both see the same
//               scale.
// No atomics anywhere: the grid of each launch depends only on the leaf's
// size, so every sum is taken in the same order on every run, and a
// training run's losses repeat bit for bit.
//
// What bounds it. Bytes: the update reads g, m, v, p and writes m, v, p
// (14 bytes a bf16 parameter, 28 an f32 one), the norm pass reads g once
// more (2 or 4 bytes); a few operations an element against hundreds the
// card could do per byte. So: 16-byte vector loads and stores (8 bf16 or 4
// f32 values a thread an iteration), a grid-stride loop over a grid of at
// most kMaxBlocks, and the scalars the host owns (lr, bias corrections:
// the update count is a host integer) passed by value, so nothing waits on
// the host.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 4;  // four blocks per SM of an H100
constexpr int kFinalizeThreads = 1024;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// values of T in 16 bytes
template <typename T> struct Vec { static constexpr int kN = 16 / sizeof(T); };

// one 16-byte vector of T, loaded and stored whole
template <typename T>
struct alignas(16) Pack {
  T e[Vec<T>::kN];
  __device__ __forceinline__ void load(const T* base, long long i) {
    *reinterpret_cast<uint4*>(e) = reinterpret_cast<const uint4*>(base)[i];
  }
  __device__ __forceinline__ void store(T* base, long long i) const {
    reinterpret_cast<uint4*>(base)[i] = *reinterpret_cast<const uint4*>(e);
  }
};

// the number of blocks a launch over n values uses: a function of n alone
int blocks_for(long long n, int per_thread) {
  long long need = (n + (long long)kThreads * per_thread - 1) /
                   ((long long)kThreads * per_thread);
  if (need < 1) need = 1;
  return need < kMaxBlocks ? int(need) : kMaxBlocks;
}

// deterministic block sum: shuffle within warps, then warp 0 over the warps
__device__ __forceinline__ double block_sum(double x, double* smem) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) smem[warp] = x;
  __syncthreads();
  x = threadIdx.x < blockDim.x / 32 ? smem[threadIdx.x] : 0.0;
  if (warp == 0) {
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    adamw_sumsq(const T* __restrict__ g, long long n, double* __restrict__ partial) {
  constexpr int kN = Vec<T>::kN;
  __shared__ double smem[kThreads / 32];
  const long long n_vec = n / kN;
  const long long stride = (long long)gridDim.x * blockDim.x;
  double acc = 0.0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n_vec;
       i += stride) {
    Pack<T> pk;
    pk.load(g, i);
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const double x = to_f(pk.e[j]);
      acc += x * x;
    }
  }
  // the tail past the last whole vector, taken by block 0
  if (blockIdx.x == 0) {
    for (long long i = n_vec * kN + threadIdx.x; i < n; i += blockDim.x) {
      const double x = to_f(g[i]);
      acc += x * x;
    }
  }
  acc = block_sum(acc, smem);
  if (threadIdx.x == 0) partial[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(kFinalizeThreads)
    adamw_finalize(const double* __restrict__ partial, int n, float clip,
                   float* __restrict__ gn) {
  __shared__ double smem[kFinalizeThreads];
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) acc += partial[i];
  smem[threadIdx.x] = acc;
  __syncthreads();
  for (int half = blockDim.x / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) smem[threadIdx.x] += smem[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float norm = float(sqrt(smem[0]));
    gn[0] = norm;
    gn[1] = fminf(1.f, __fdiv_rn(clip, fmaxf(norm, 1e-16f)));
  }
}

struct Hyper {
  float lr, b1, omb1, b2, omb2, bc1, bc2, eps, wd;
};

__device__ __forceinline__ void adamw_one(float g, float& m, float& v, float& p,
                                          float scale, const Hyper& h) {
  g = __fmul_rn(g, scale);
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, g), g));
  const float u = __fdiv_rn(__fdiv_rn(m, h.bc1),
                            __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.bc2)), h.eps));
  p = __fsub_rn(p, __fmul_rn(h.lr, __fadd_rn(u, __fmul_rn(h.wd, p))));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    adamw_update(const T* __restrict__ g, T* __restrict__ m, T* __restrict__ v,
                 T* __restrict__ p, long long n, const float* __restrict__ gn,
                 Hyper h) {
  constexpr int kN = Vec<T>::kN;
  const float scale = gn[1];
  const long long n_vec = n / kN;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n_vec;
       i += stride) {
    Pack<T> pg, pm, pv, pp;
    pg.load(g, i);
    pm.load(m, i);
    pv.load(v, i);
    pp.load(p, i);
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      float mj = to_f(pm.e[j]), vj = to_f(pv.e[j]), pj = to_f(pp.e[j]);
      adamw_one(to_f(pg.e[j]), mj, vj, pj, scale, h);
      pm.e[j] = from_f<T>(mj);
      pv.e[j] = from_f<T>(vj);
      pp.e[j] = from_f<T>(pj);
    }
    pm.store(m, i);
    pv.store(v, i);
    pp.store(p, i);
  }
  if (blockIdx.x == 0) {
    for (long long i = n_vec * kN + threadIdx.x; i < n; i += blockDim.x) {
      float mj = to_f(m[i]), vj = to_f(v[i]), pj = to_f(p[i]);
      adamw_one(to_f(g[i]), mj, vj, pj, scale, h);
      m[i] = from_f<T>(mj);
      v[i] = from_f<T>(vj);
      p[i] = from_f<T>(pj);
    }
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (the wrapper's codes). Every entry returns the
// launch's cudaError_t (0 = launched).

// the number of partial sums adamw_sumsq writes for a leaf of n values
extern "C" int adamw_partials(long long n, int dtype) {
  return blocks_for(n, dtype == 0 ? Vec<float>::kN : Vec<__nv_bfloat16>::kN);
}

extern "C" int adamw_sumsq_launch(const void* g, long long n, int dtype,
                                  void* partial, void* stream) {
  if (n < 1 || (dtype != 0 && dtype != 1)) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = adamw_partials(n, dtype);
  if (dtype == 0) {
    adamw_sumsq<float><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(g), n, static_cast<double*>(partial));
  } else {
    adamw_sumsq<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(g), n, static_cast<double*>(partial));
  }
  return int(cudaGetLastError());
}

extern "C" int adamw_finalize_launch(const void* partial, int n, float clip,
                                     void* gn, void* stream) {
  if (n < 1) return int(cudaErrorInvalidValue);
  adamw_finalize<<<1, kFinalizeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(partial), n, clip, static_cast<float*>(gn));
  return int(cudaGetLastError());
}

extern "C" int adamw_update_launch(const void* g, void* m, void* v, void* p,
                                   long long n, int dtype, const void* gn,
                                   float lr, float b1, float omb1, float b2,
                                   float omb2, float bc1, float bc2, float eps,
                                   float wd, void* stream) {
  if (n < 1 || (dtype != 0 && dtype != 1)) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Hyper h{lr, b1, omb1, b2, omb2, bc1, bc2, eps, wd};
  const float* gnp = static_cast<const float*>(gn);
  if (dtype == 0) {
    adamw_update<float><<<blocks_for(n, Vec<float>::kN), kThreads, 0, st>>>(
        static_cast<const float*>(g), static_cast<float*>(m), static_cast<float*>(v),
        static_cast<float*>(p), n, gnp, h);
  } else {
    using B = __nv_bfloat16;
    adamw_update<B><<<blocks_for(n, Vec<B>::kN), kThreads, 0, st>>>(
        static_cast<const B*>(g), static_cast<B*>(m), static_cast<B*>(v),
        static_cast<B*>(p), n, gnp, h);
  }
  return int(cudaGetLastError());
}
