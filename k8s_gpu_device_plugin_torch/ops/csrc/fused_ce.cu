// Fused lm_head + cross-entropy: the per-chunk row passes, hand-written for
// Hopper (sm_90a).
//
// Replaces no TPU kernel. Its reference is k8s_gpu_device_plugin_tpu/ops/
// fused_ce.py, a lax.scan over vocabulary chunks that XLA fuses; the port
// keeps the chunk products on cuBLAS (as the reference leaves them to XLA)
// and writes the two passes over each chunk's f32 logits by hand, so that
// the (N, V) logits, their cotangent and its bf16 cast never exist.
//
// What they compute, for one chunk of columns [c0, c0 + width) of the
// vocabulary, over the chunk's f32 logits (N, width), rows contiguous:
//   ce_chunk_fwd (K6): per row n, the chunk's max c and sum-exp
//       s_c = sum_j exp(l_j - c), folded into the running (m, s):
//       m' = max(m, c), s' = s exp(m - m') + s_c exp(c - m');
//       and tl[n] = l[t_n - c0] when the chunk owns the target t_n.
//   ce_chunk_bwd (K7): dlogits = (g / N) ((1 + 2 z lse) softmax - onehot),
//       softmax = exp(l - lse), written in the activations' dtype (bf16 or
//       f32), for the chunk's columns only.
// The last chunk of a vocabulary that the chunk does not divide (128,256 =
// 31 x 4096 + 1280) is simply narrower: the kernels take its width, so no
// column is padded and no padded copy of the head is ever made.
//
// What bounds them. Bytes: K6 reads the chunk's f32 logits once (one block
// a row, each thread an online max / sum-exp over its columns, combined
// across the block), K7 reads them once and writes the cotangent once; both
// are a few operations a byte. The chunk's two cuBLAS products (the
// forward's and the backward's recompute) are what the loss costs: at
// N 4096, D 4096 one chunk of 4096 columns is 137 GFLOP against K6's 67 MB.
// One block a row keeps a row's reduction inside the block: no atomics, the
// same order on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// combine two (max, sum-exp) pairs
__device__ __forceinline__ void combine(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;  // both empty
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    ce_chunk_fwd_kernel(const float* __restrict__ logits, int width,
                        const int64_t* __restrict__ targets, long long c0,
                        float* __restrict__ m_run, float* __restrict__ s_run,
                        float* __restrict__ tl) {
  __shared__ float sm_m[kThreads / 32], sm_s[kThreads / 32];
  const long long row = blockIdx.x;
  const float* l = logits + row * width;
  float m = -INFINITY, s = 0.f;
  if (kVec) {
    const float4* l4 = reinterpret_cast<const float4*>(l);
    for (int i = threadIdx.x; i < width / 4; i += blockDim.x) {
      const float4 x = l4[i];
      const float mx = fmaxf(fmaxf(x.x, x.y), fmaxf(x.z, x.w));
      const float mn = fmaxf(m, mx);
      s = s * expf(m - mn) + expf(x.x - mn) + expf(x.y - mn) + expf(x.z - mn) +
          expf(x.w - mn);
      m = mn;
    }
  } else {
    for (int i = threadIdx.x; i < width; i += blockDim.x) {
      const float x = l[i];
      const float mn = fmaxf(m, x);
      s = s * expf(m - mn) + expf(x - mn);
      m = mn;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    combine(m, s, __shfl_xor_sync(0xffffffffu, m, off),
            __shfl_xor_sync(0xffffffffu, s, off));
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sm_m[warp] = m;
    sm_s[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float cm = sm_m[0], cs = sm_s[0];
    for (int w = 1; w < kThreads / 32; ++w) combine(cm, cs, sm_m[w], sm_s[w]);
    float rm = m_run[row], rs = s_run[row];
    combine(rm, rs, cm, cs);
    m_run[row] = rm;
    s_run[row] = rs;
    const long long t = targets[row] - c0;
    if (t >= 0 && t < width) tl[row] = l[t];
  }
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// one block a row (grid-stride over rows), the threads over its columns
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    ce_chunk_bwd_kernel(const float* __restrict__ logits, long long n_rows,
                        int width, const int64_t* __restrict__ targets,
                        long long c0, const float* __restrict__ lse,
                        const float* __restrict__ g, float z, T* __restrict__ out) {
  const float g_n = __fdiv_rn(g[0], float(n_rows));
  const float z2 = __fmul_rn(2.f, z);
  for (long long row = blockIdx.x; row < n_rows; row += gridDim.x) {
    const float r = lse[row];
    const float coef = __fadd_rn(1.f, __fmul_rn(z2, r));
    const long long t = targets[row] - c0;
    const float* l = logits + row * width;
    T* o = out + row * width;
    auto one = [&](float x, long long col) {
      float d = __fmul_rn(coef, expf(__fsub_rn(x, r)));
      if (col == t) d = __fsub_rn(d, 1.f);
      return from_f<T>(__fmul_rn(g_n, d));
    };
    if (kVec) {
      for (int i = threadIdx.x; i < width / 4; i += blockDim.x) {
        const float4 x = reinterpret_cast<const float4*>(l)[i];
        const long long c = 4LL * i;
        o[c] = one(x.x, c);
        o[c + 1] = one(x.y, c + 1);
        o[c + 2] = one(x.z, c + 2);
        o[c + 3] = one(x.w, c + 3);
      }
    } else {
      for (int i = threadIdx.x; i < width; i += blockDim.x) o[i] = one(l[i], i);
    }
  }
}

}  // namespace

extern "C" int ce_chunk_fwd(const void* logits, long long n_rows, int width,
                            const void* targets, long long c0, void* m_run,
                            void* s_run, void* tl, void* stream) {
  if (n_rows < 1 || width < 1 || n_rows > 0x7fffffffLL) {
    return int(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(logits);
  const int64_t* t = static_cast<const int64_t*>(targets);
  float *m = static_cast<float*>(m_run), *s = static_cast<float*>(s_run),
        *tv = static_cast<float*>(tl);
  if (width % 4 == 0 && reinterpret_cast<uintptr_t>(l) % 16 == 0) {
    ce_chunk_fwd_kernel<true><<<unsigned(n_rows), kThreads, 0, st>>>(l, width, t, c0,
                                                                    m, s, tv);
  } else {
    ce_chunk_fwd_kernel<false><<<unsigned(n_rows), kThreads, 0, st>>>(l, width, t, c0,
                                                                     m, s, tv);
  }
  return int(cudaGetLastError());
}

// dtype: 0 = f32, 1 = bf16 (the cotangent's, the activations' dtype)
extern "C" int ce_chunk_bwd(const void* logits, long long n_rows, int width,
                            const void* targets, long long c0, const void* lse,
                            const void* g, float z, int dtype, void* out,
                            void* stream) {
  if (n_rows < 1 || width < 1 || (dtype != 0 && dtype != 1)) {
    return int(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = unsigned(n_rows < 132 * 64 ? n_rows : 132 * 64);
  const float* l = static_cast<const float*>(logits);
  const int64_t* t = static_cast<const int64_t*>(targets);
  const float* r = static_cast<const float*>(lse);
  const float* gp = static_cast<const float*>(g);
  const bool vec = width % 4 == 0 && reinterpret_cast<uintptr_t>(l) % 16 == 0;
  if (dtype == 0) {
    auto k = vec ? ce_chunk_bwd_kernel<float, true> : ce_chunk_bwd_kernel<float, false>;
    k<<<blocks, kThreads, 0, st>>>(l, n_rows, width, t, c0, r, gp, z,
                                   static_cast<float*>(out));
  } else {
    using B = __nv_bfloat16;
    auto k = vec ? ce_chunk_bwd_kernel<B, true> : ce_chunk_bwd_kernel<B, false>;
    k<<<blocks, kThreads, 0, st>>>(l, n_rows, width, t, c0, r, gp, z,
                                   static_cast<B*>(out));
  }
  return int(cudaGetLastError());
}
