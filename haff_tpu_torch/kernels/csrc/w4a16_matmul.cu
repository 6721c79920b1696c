// w4a16_matmul: float activations times a packed-int4 weight with group
// scales, for the decode steps of a 4-bit model (small M).
//
// Replaces haff_tpu/nn/quant.py::_w4a16_kernel (launched by
// pallas_int4_matmul).
//
// What it computes:
//   out[m, n] = sum_k x[m, k] * W[n, k]
//   W[n, k]   = round_T(nibble(n, k) * scale[n, k / group])
// with x (M, K) in T (bf16 or f32), packed (N, K/2) uint8 where byte r of
// row n holds input 2r in its low nibble and 2r+1 in its high nibble, each
// a signed 4-bit value (v > 7 means v - 16), and scale (N, K/group) f32.
// The dequantized weight is rounded to T before the multiply, products
// accumulate in f32, the sum is rounded to T once. The nibbles are
// unpacked in registers: the weight crosses device memory packed, half a
// byte an element, and no float copy of it ever exists.
//
// What bounds it on Hopper: at M = 2 the packed weight bytes (each read
// once). The design: a block owns 8 output columns, one a warp; the warp
// streams its weight row once over all of K, 4 bytes (8 inputs) a lane a
// step, coalesced, while the block stages the activations' matching K
// chunk in shared memory as f32 for all its warps. A lane holds one f32
// accumulator for each of up to MT activation rows; a warp reduction ends
// the column. For M > MT the grid's second axis walks row groups, which
// re-read the strip (from L2, mostly); the main path has M = 2.
// group % 8 == 0 keeps a lane's 8 inputs inside one scale group (the
// wrapper asks for group % 16 == 0, as the JAX package does).
#include "common.cuh"

#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KC = 1024;  // activations' K chunk in shared memory

template <typename T, int MT>
__global__ void __launch_bounds__(THREADS)
w4a16_kernel(const T* __restrict__ x, const uint8_t* __restrict__ packed,
             const float* __restrict__ scale, T* __restrict__ out, int M, int N, int K,
             int group) {
  using haff::from_f;
  using haff::to_f;
  __shared__ __align__(16) float xs[MT][KC];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const long n = (long)blockIdx.x * WARPS + (tid >> 5);
  const int m0 = blockIdx.y * MT;
  const bool col_ok = n < N;
  const int ngroups = K / group;
  const uint8_t* wrow = packed + (col_ok ? n : 0) * (long)(K / 2);
  const float* srow = scale + (col_ok ? n : 0) * (long)ngroups;

  float acc[MT];
#pragma unroll
  for (int r = 0; r < MT; ++r) acc[r] = 0.f;

  for (int kc = 0; kc < K; kc += KC) {
    const int kn = min(KC, K - kc);
    __syncthreads();  // the previous chunk is no longer read
    for (int o = tid; o < MT * KC; o += THREADS) {
      const int r = o / KC, k = o - r * KC;
      xs[r][k] = (m0 + r < M && k < kn) ? to_f(x[(long)(m0 + r) * K + kc + k]) : 0.f;
    }
    __syncthreads();
    if (!col_ok) continue;
    for (int k = 8 * lane; k < kn; k += 8 * 32) {
      const uint32_t bits = *reinterpret_cast<const uint32_t*>(wrow + (kc + k) / 2);
      const float sc = srow[(kc + k) / group];
      float wv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        int v = (bits >> (4 * i)) & 0xF;   // nibble i is input k + i
        v = v > 7 ? v - 16 : v;
        wv[i] = to_f(from_f<T>((float)v * sc));
      }
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(&xs[r][k]);
        const float4 b = *reinterpret_cast<const float4*>(&xs[r][k + 4]);
        float s = acc[r];
        s = fmaf(a.x, wv[0], s); s = fmaf(a.y, wv[1], s);
        s = fmaf(a.z, wv[2], s); s = fmaf(a.w, wv[3], s);
        s = fmaf(b.x, wv[4], s); s = fmaf(b.y, wv[5], s);
        s = fmaf(b.z, wv[6], s); s = fmaf(b.w, wv[7], s);
        acc[r] = s;
      }
    }
  }
  if (!col_ok) return;
#pragma unroll
  for (int r = 0; r < MT; ++r) {
    const float v = haff::warp_sum(acc[r]);
    if (lane == 0 && m0 + r < M) out[(long)(m0 + r) * N + n] = from_f<T>(v);
  }
}

template <typename T, int MT>
cudaError_t launch_mt(const void* x, const void* packed, const void* scale, void* out,
                      int M, int N, int K, int group, cudaStream_t stream) {
  dim3 grid((N + WARPS - 1) / WARPS, (M + MT - 1) / MT);
  w4a16_kernel<T, MT><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scale), static_cast<T*>(out), M, N, K, group);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* packed, const void* scale, void* out, int M,
                   int N, int K, int group, cudaStream_t stream) {
  if (K % 8 || group % 8 || K % group || reinterpret_cast<uintptr_t>(packed) % 4)
    return cudaErrorInvalidValue;
  if (M <= 2) return launch_mt<T, 2>(x, packed, scale, out, M, N, K, group, stream);
  if (M <= 4) return launch_mt<T, 4>(x, packed, scale, out, M, N, K, group, stream);
  return launch_mt<T, 8>(x, packed, scale, out, M, N, K, group, stream);
}

}  // namespace

extern "C" int w4a16_matmul(const void* x, const void* packed, const void* scale, void* out,
                            int M, int N, int K, int group, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return (int)launch<__nv_bfloat16>(x, packed, scale, out, M, N, K, group, s);
  return (int)launch<float>(x, packed, scale, out, M, N, K, group, s);
}
