// add_layer_norm: a residual add and the LayerNorm after it, in one kernel.
//
// Replaces no TPU kernel: in the JAX package XLA fuses `x + delta` into
// the following `nn.LayerNorm`. Unfused in torch the two ops are five
// CUDA kernels (the add, the casts of the row and the weight to float32,
// the norm, the cast back), each a launch of a few microseconds on a row
// of 4096, and the MPT decode step (nn/mpt.py `MptBlock.decode_step`)
// has 65 norms a token. This kernel is all five in one launch.
//
// What it computes, per row r of x (rows, d):
//   s    = x + delta, rounded to x's dtype (torch's bf16 add: the f32 sum
//          rounded to nearest even); written back as the new residual
//   y    = (s - mean(s)) * rsqrt(var(s) + eps) * w, rounded to x's dtype
// with mean and the biased variance in float32 over the rounded s (two
// passes over registers), and w read in its stored dtype and widened in
// registers. Without delta, s = x and no residual is written.
//
// What bounds it on Hopper: the bytes of x, delta, w, s and y, each read
// or written once (about 40 KB a bf16 row of 4096, 12 ns at 3.35 TB/s),
// so at a decode step's one or two rows it is latency: one block a row,
// every load issued up front as 16-byte vectors (x, delta and the weight
// together), the two sums by warp shuffles and one shared-memory step.
// A plain launch: as a programmatic dependent of the product before it
// the kernel alone ran 0.2-0.4 us faster by graph on an H100, and
// MPT-7B's graphed decode step 0.04-0.05 ms slower.
// A thread holds CHUNKS x 8 elements, so d <= 16384.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int VEC = 8;      // elements a chunk
constexpr int CHUNKS = 2;   // chunks a thread
constexpr int MAX_THREADS = 1024;

// Eight elements from i0 as floats: one 16-byte load of bf16, two of f32
// where `vec`, else element by element, zeros past n.
template <typename T>
__device__ __forceinline__ void load8(const T* p, int i0, int n, bool vec, float (&f)[VEC]) {
  if (vec) {
    constexpr int EPC = 16 / (int)sizeof(T);
#pragma unroll
    for (int c = 0; c < VEC / EPC; ++c) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + i0 + c * EPC);
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int t = 0; t < EPC; ++t) f[c * EPC + t] = haff::to_f<T>(e[t]);
    }
  } else {
#pragma unroll
    for (int t = 0; t < VEC; ++t) f[t] = i0 + t < n ? haff::to_f<T>(p[i0 + t]) : 0.f;
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* p, int i0, int n, bool vec, const float (&f)[VEC]) {
  if (vec) {
    constexpr int EPC = 16 / (int)sizeof(T);
#pragma unroll
    for (int c = 0; c < VEC / EPC; ++c) {
      uint4 v;
      T* e = reinterpret_cast<T*>(&v);
#pragma unroll
      for (int t = 0; t < EPC; ++t) e[t] = haff::from_f<T>(f[c * EPC + t]);
      *reinterpret_cast<uint4*>(p + i0 + c * EPC) = v;
    }
  } else {
#pragma unroll
    for (int t = 0; t < VEC; ++t)
      if (i0 + t < n) p[i0 + t] = haff::from_f<T>(f[t]);
  }
}

// The block's sum of v, in every thread (blockDim a multiple of 32).
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = haff::warp_sum(v);
  __syncthreads();  // red is reused
  if (lane == 0) red[warp] = v;
  __syncthreads();
  return haff::warp_sum(lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f);
}

template <typename T, typename TW, bool DELTA>
__global__ void __launch_bounds__(MAX_THREADS)
add_layer_norm_kernel(const T* __restrict__ x, const T* __restrict__ delta,
                      const TW* __restrict__ w, T* __restrict__ res, T* __restrict__ y, int d,
                      float eps, int vec) {
  __shared__ float red[MAX_THREADS / 32];
  const long off = (long)blockIdx.x * d;
  float s[CHUNKS][VEC] = {}, wf[CHUNKS][VEC] = {};
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int i0 = (threadIdx.x + c * blockDim.x) * VEC;
    if (i0 < d) {
      load8<T>(x + off, i0, d, vec, s[c]);
      load8<TW>(w, i0, d, vec, wf[c]);
      if (DELTA) {
        float dl[VEC];
        load8<T>(delta + off, i0, d, vec, dl);
#pragma unroll
        for (int t = 0; t < VEC; ++t)
          s[c][t] = haff::to_f<T>(haff::from_f<T>(s[c][t] + dl[t]));
        store8<T>(res + off, i0, d, vec, s[c]);
      }
#pragma unroll
      for (int t = 0; t < VEC; ++t) sum += i0 + t < d ? s[c][t] : 0.f;
    }
  }
  const float mean = block_sum(sum, red) / (float)d;
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int i0 = (threadIdx.x + c * blockDim.x) * VEC;
#pragma unroll
    for (int t = 0; t < VEC; ++t) {
      const float e = s[c][t] - mean;
      if (i0 + t < d) sq = fmaf(e, e, sq);
    }
  }
  const float rstd = rsqrtf(block_sum(sq, red) / (float)d + eps);
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int i0 = (threadIdx.x + c * blockDim.x) * VEC;
    if (i0 < d) {
      float o[VEC];
#pragma unroll
      for (int t = 0; t < VEC; ++t) o[t] = (s[c][t] - mean) * rstd * wf[c][t];
      store8<T>(y + off, i0, d, vec, o);
    }
  }
}

template <typename T, typename TW>
cudaError_t launch(const void* x, const void* delta, const void* w, void* res, void* y,
                   int rows, int d, float eps, cudaStream_t stream) {
  const int threads = ((d + VEC * CHUNKS - 1) / (VEC * CHUNKS) + 31) / 32 * 32;
  if (threads > MAX_THREADS) return cudaErrorInvalidValue;
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec = d % VEC == 0 && aligned(x) && aligned(w) && aligned(y) &&
                  (delta == nullptr || (aligned(delta) && aligned(res)));
  const T* xt = static_cast<const T*>(x);
  const T* dt = static_cast<const T*>(delta);
  const TW* wt = static_cast<const TW*>(w);
  T* rt = static_cast<T*>(res);
  T* yt = static_cast<T*>(y);
  if (delta != nullptr)
    add_layer_norm_kernel<T, TW, true><<<rows, threads, 0, stream>>>(xt, dt, wt, rt, yt, d, eps,
                                                                     vec);
  else
    add_layer_norm_kernel<T, TW, false><<<rows, threads, 0, stream>>>(xt, dt, wt, rt, yt, d, eps,
                                                                      vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_w(int w_bf16, const void* x, const void* delta, const void* w, void* res,
                       void* y, int rows, int d, float eps, cudaStream_t s) {
  if (w_bf16) return launch<T, __nv_bfloat16>(x, delta, w, res, y, rows, d, eps, s);
  return launch<T, float>(x, delta, w, res, y, rows, d, eps, s);
}

}  // namespace

// x, delta, res, y: (rows, d) contiguous, bf16 (x_bf16) or f32; w: (d,)
// bf16 (w_bf16) or f32. delta null: y = LayerNorm(x) and res is not
// written; else res = x + delta and y = LayerNorm(res). res and y are
// new tensors: neither may overlap an input.
extern "C" int add_layer_norm(const void* x, const void* delta, const void* w, void* res,
                              void* y, int rows, int d, float eps, int x_bf16, int w_bf16,
                              void* stream) {
  if (rows < 0 || d <= 0 || (delta != nullptr && res == nullptr))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return (int)dispatch_w<__nv_bfloat16>(w_bf16, x, delta, w, res, y, rows, d, eps, s);
  return (int)dispatch_w<float>(w_bf16, x, delta, w, res, y, rows, d, eps, s);
}
