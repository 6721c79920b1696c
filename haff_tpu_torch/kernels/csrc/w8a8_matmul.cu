// w8a8_matmul: int8 x int8 -> int32 matrix product with the fused dual
// rescale, for every int8-quantized dense layer (LLaMA projections and
// lm_head at prefill and decode, the SAM ViT encoder's qkv/proj/MLP).
//
// Replaces haff_tpu/nn/quant.py::_w8a8_kernel (launched by
// pallas_int8_matmul).
//
// What it computes:
//   out[m, n] = float(sum_k xq[m, k] * w[n, k]) * sx[m] * sw[n]
// with xq (M, K) int8 activations, w (N, K) int8 weights (the port keeps a
// dense weight as (out, in), so both operands are contiguous along K and
// an output-column split of the layer is a contiguous row block of w),
// sx (M,) per-token and sw (N,) per-channel float32 scales. The int32 sum
// is exact; the two float32 multiplies run in that order, so a float32
// output equals the plain version's bit for bit.
//
// What bounds it on Hopper: at prefill and in the SAM encoder (M in the
// thousands) the operations, at decode (M = 2) the weight bytes. This
// first version uses __dp4a (four int8 multiply-adds an instruction, int32
// accumulate) on CUDA cores, not the int8 tensor cores, so the large-M
// shape is bound by the dp4a instruction rate, far under the card's int8
// tensor-core peak. Two launch shapes:
//   * tile (M > 16): a 128 x 64 output tile a block, K walked in 64-byte
//     steps through shared memory, each thread an 8 x 4 register tile;
//     ragged M, N and K edges are zero-filled on load and masked on store;
//   * skinny (M <= 16): a warp owns one output column and streams that
//     weight row once, 16 bytes a lane a step, against up to 8 activation
//     rows (read through L1; they are a few KB), then a warp reduction:
//     the weight is read from device memory once.
// 16-byte vector loads need K % 16 == 0 and 16-byte aligned bases; other
// shapes (the tiny preset, odd K) take byte loads in the same kernels.
// Tensor-core mma / wgmma tiles are later work.
#include "common.cuh"

#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 64, BK = 64;  // BK in bytes (= int8 elements)
constexpr int KW = BK / 4;                 // 32-bit words per tile row
constexpr int KWP = KW + 1;                // padded: conflict-free columns
constexpr int THREADS = 256;
constexpr int TM = 8, TN = 4;              // per-thread register tile
constexpr int SKINNY_M = 16;               // largest M of the skinny shape
constexpr int SKINNY_ROWS = 8;             // activation rows a warp holds

// 16 bytes of row `row` at byte offset k0 as four words; zero beyond K or
// for a row outside the matrix.
__device__ __forceinline__ void load16(const int8_t* __restrict__ base, long row,
                                       bool row_ok, int k0, int K, bool vec,
                                       int32_t (&w)[4]) {
  w[0] = w[1] = w[2] = w[3] = 0;
  if (!row_ok || k0 >= K) return;
  const int8_t* p = base + row * (long)K + k0;
  if (vec) {  // K % 16 == 0 and aligned bases: the whole chunk is inside
    const int4 v = *reinterpret_cast<const int4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    return;
  }
  const int n = min(16, K - k0);
  for (int i = 0; i < n; ++i) {
    const uint32_t byte = (uint32_t)(uint8_t)p[i];
    w[i >> 2] |= (int32_t)(byte << (8 * (i & 3)));
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
w8a8_tile_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ w,
                 const float* __restrict__ sx, const float* __restrict__ sw,
                 T* __restrict__ out, int M, int N, int K, int vec) {
  __shared__ int32_t As[BM][KWP];
  __shared__ int32_t Bs[BN][KWP];
  const int tid = threadIdx.x;
  const int tx = tid & 15;   // output columns tx + 16 j
  const int ty = tid >> 4;   // output rows ty + 16 i
  const long m0 = (long)blockIdx.y * BM;
  const long n0 = (long)blockIdx.x * BN;

  int32_t acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  // Loader mapping: 4 chunks of 16 bytes a tile row.
  const int lr = tid >> 2, lc = tid & 3;
  for (int k0 = 0; k0 < K; k0 += BK) {
    int32_t v[4];
#pragma unroll
    for (int h = 0; h < BM / 64; ++h) {
      const int r = lr + 64 * h;
      load16(xq, m0 + r, m0 + r < M, k0 + 16 * lc, K, vec, v);
#pragma unroll
      for (int c = 0; c < 4; ++c) As[r][4 * lc + c] = v[c];
    }
    load16(w, n0 + lr, n0 + lr < N, k0 + 16 * lc, K, vec, v);
#pragma unroll
    for (int c = 0; c < 4; ++c) Bs[lr][4 * lc + c] = v[c];
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < KW; ++kk) {
      int32_t a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[tx + 16 * j][kk];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long m = m0 + ty + 16 * i;
    if (m >= M) continue;
    const float s_m = sx[m];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const long n = n0 + tx + 16 * j;
      if (n < N) out[m * N + n] = haff::from_f<T>((float)acc[i][j] * s_m * sw[n]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
w8a8_skinny_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ w,
                   const float* __restrict__ sx, const float* __restrict__ sw,
                   T* __restrict__ out, int M, int N, int K, int vec) {
  const int lane = threadIdx.x & 31;
  const long n = (long)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const int m0 = blockIdx.y * SKINNY_ROWS;
  if (n >= N) return;  // whole warps leave; no block-wide barrier follows
  const int rows = min(SKINNY_ROWS, M - m0);

  int32_t acc[SKINNY_ROWS];
#pragma unroll
  for (int r = 0; r < SKINNY_ROWS; ++r) acc[r] = 0;

  for (int k0 = 16 * lane; k0 < K; k0 += 16 * 32) {
    int32_t wv[4];
    load16(w, n, true, k0, K, vec, wv);
#pragma unroll
    for (int r = 0; r < SKINNY_ROWS; ++r) {
      if (r < rows) {
        int32_t xv[4];
        load16(xq, m0 + r, true, k0, K, vec, xv);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r] = __dp4a(xv[c], wv[c], acc[r]);
      }
    }
  }
  const float s_n = sw[n];
#pragma unroll
  for (int r = 0; r < SKINNY_ROWS; ++r) {
    if (r < rows) {
      int32_t v = acc[r];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0)
        out[(long)(m0 + r) * N + n] = haff::from_f<T>((float)v * sx[m0 + r] * s_n);
    }
  }
}

template <typename T>
cudaError_t launch(const void* xq, const void* w, const void* sx, const void* sw,
                   void* out, int M, int N, int K, cudaStream_t stream) {
  const int8_t* a = static_cast<const int8_t*>(xq);
  const int8_t* b = static_cast<const int8_t*>(w);
  const float* fx = static_cast<const float*>(sx);
  const float* fw = static_cast<const float*>(sw);
  const int vec = K % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(b) % 16 == 0;
  if (M <= SKINNY_M) {
    dim3 grid((N + THREADS / 32 - 1) / (THREADS / 32),
              (M + SKINNY_ROWS - 1) / SKINNY_ROWS);
    w8a8_skinny_kernel<T><<<grid, THREADS, 0, stream>>>(a, b, fx, fw,
                                                        static_cast<T*>(out), M, N, K, vec);
  } else {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    w8a8_tile_kernel<T><<<grid, THREADS, 0, stream>>>(a, b, fx, fw,
                                                      static_cast<T*>(out), M, N, K, vec);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int w8a8_matmul(const void* xq, const void* w, const void* sx, const void* sw,
                           void* out, int M, int N, int K, int out_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16) return (int)launch<__nv_bfloat16>(xq, w, sx, sw, out, M, N, K, s);
  return (int)launch<float>(xq, w, sx, sw, out, M, N, K, s);
}
