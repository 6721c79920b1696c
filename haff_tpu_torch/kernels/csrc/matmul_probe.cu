// matmul_probe: one tiled matrix product, one structure, instantiated for
// int8 operands (int32 sums through __dp4a) and for bf16 operands (float32
// sums through FMA). It answers one question: at equal tiling, what is the
// rate ratio of the card's int8 and bf16 paths outside the tensor cores.
//
// Replaces the probe `mm_kernel` of tools/bench_kernels.py (cmd_int8mxu),
// which asks the TPU's matrix unit the same question with one Pallas body
// instantiated for both types.
//
// What it computes: C (M, N) = A (M, K) @ B (N, K)^T, both operands
// K-contiguous (the port keeps weights (out, in)), C int32 for int8 and
// float32 for bf16.
//
// Structure: a block owns a 64 x 64 tile of C; 256 threads, each a 4 x 4
// register tile over rows ty + 16 r and columns tx + 16 c. A K step stages
// 8 32-bit words a row of both operands in shared memory (32 int8 or 16
// bf16: equal bytes, equal loads), rows padded to 9 words so that the 16
// columns a half-warp reads fall in 16 banks. Ragged M and N are masked;
// K must be a multiple of 32 elements and rows 4-byte aligned (the wrapper
// checks both). Products by operations bound it at this shape, and without
// tensor cores it runs far below that bound: the probe is for the ratio.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64;
constexpr int KW = 8;          // 32-bit words a K step
constexpr int KWP = KW + 1;    // padded row
constexpr int THREADS = 256;

template <typename T>
struct Elem;

template <>
struct Elem<int8_t> {
  using Acc = int;
  static constexpr int PER_WORD = 4;
  static __device__ __forceinline__ Acc mac(unsigned a, unsigned b, Acc acc) {
    return __dp4a((int)a, (int)b, acc);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  using Acc = float;
  static constexpr int PER_WORD = 2;
  static __device__ __forceinline__ Acc mac(unsigned a, unsigned b, Acc acc) {
    // A bf16 is the high half of its float32.
    acc = fmaf(__uint_as_float(a << 16), __uint_as_float(b << 16), acc);
    return fmaf(__uint_as_float(a & 0xffff0000u), __uint_as_float(b & 0xffff0000u), acc);
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
probe_kernel(const unsigned* __restrict__ a, const unsigned* __restrict__ b,
             typename Elem<T>::Acc* __restrict__ c, int M, int N, int kwords) {
  using E = Elem<T>;
  __shared__ unsigned As[BM * KWP];
  __shared__ unsigned Bs[BN * KWP];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  typename E::Acc acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) acc[r][cc] = 0;

  for (int k0 = 0; k0 < kwords; k0 += KW) {
    __syncthreads();  // the previous step's readers are done
    for (int o = tid; o < BM * KW; o += THREADS) {
      const int row = o / KW, w = o - row * KW;
      As[row * KWP + w] = (m0 + row < M) ? a[(long long)(m0 + row) * kwords + k0 + w] : 0u;
      Bs[row * KWP + w] = (n0 + row < N) ? b[(long long)(n0 + row) * kwords + k0 + w] : 0u;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < KW; ++w) {
      unsigned av[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) av[r] = As[(ty + 16 * r) * KWP + w];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) bv[cc] = Bs[(tx + 16 * cc) * KWP + w];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) acc[r][cc] = E::mac(av[r], bv[cc], acc[r][cc]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = m0 + ty + 16 * r;
    if (m >= M) continue;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int n = n0 + tx + 16 * cc;
      if (n < N) c[(long long)m * N + n] = acc[r][cc];
    }
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* b, void* c, int M, int N, int K,
                   cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  probe_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const unsigned*>(a), static_cast<const unsigned*>(b),
      static_cast<typename Elem<T>::Acc*>(c), M, N, K / Elem<T>::PER_WORD);
  return cudaGetLastError();
}

}  // namespace

// K % 32 == 0 and 4-byte aligned operands; the wrapper checks both.
extern "C" int matmul_probe(const void* a, const void* b, void* c, int M, int N, int K,
                            int is_int8, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_int8) return (int)launch<int8_t>(a, b, c, M, N, K, s);
  return (int)launch<__nv_bfloat16>(a, b, c, M, N, K, s);
}
