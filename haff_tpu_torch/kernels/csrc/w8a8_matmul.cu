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
// thousands) the operations: 2 M N K int8 operations against the int8
// tensor cores' 1979 TOP/s (LLaMA-7B prefill, 1150 x 4096 x 4096: 0.0195
// ms, where the bytes take 0.0069); at decode (M = 2) the weight bytes.
// Four kernels on three paths, chosen by the wrapper (nn/quant.py
// w8a8_path) before the launch:
//   * wgmma (M > 16, K % 16 == 0, 16-byte aligned bases): int8 warpgroup
//     MMA fed by TMA. Output tiles of 128 x 128; a persistent grid of one
//     block an SM walks them M-fastest, so the blocks in flight share
//     weight tiles in L2 (lm_head's 131 MB weight is read once). A block
//     is a producer warp and two consumer warpgroups of 64 rows. The
//     producer keeps a ring of STAGES = 4 stages in flight, each an A
//     box (128 rows x 128 bytes of K) and a B box (128 weight rows) from
//     2-d tensor maps of xq and w read in place, with the 128-byte
//     swizzle; it runs ahead into the next tile while the consumers
//     finish one. 8-bit wgmma operands have no transposed form, so both
//     are K-major, as the layouts already are. Each consumer runs four
//     m64n128k32 products a stage into 64 int32 accumulators a thread,
//     keeps one stage's products in flight while it waits for the next,
//     and releases a stage when its products retire. TMA's zero fill
//     covers the ragged edges (M = 1150 = 8 x 128 + 126, lm_head's N =
//     32004, K past the last 128 bytes). The epilogue converts each sum
//     to float, times sx[m], times sw[n], rounds to the output type and
//     stages 8 rows at a time through shared memory, then stores whole
//     16-, 8-, 4- or 2-byte chunks of rows: the widest the row pitch
//     allows (a bf16 row of 32004 values is 64008 bytes, so 8), masked
//     at the ragged edges.
//   * skinny (M <= 16, K % 16 == 0, 16-byte aligned bases; every decode
//     product of LLaMA-7B): bound by the weight's bytes (4096 x 4096 at
//     M = 2: 16.8 MB, 5.0 us at 3.35 TB/s), so the design is bytes in
//     flight on every SM. A block owns 16 output columns (weight rows) and
//     streams its weight rows and the activations' matching bytes through
//     a ring of SK_STAGES stages of 512 bytes of K by 16-byte cp.async (no
//     tensor map, so no host-side encoding a call on a path of ~3400
//     launches an evaluate), three stages in flight while it computes on
//     the fourth; each activation byte is read once a block. 16 columns a
//     block give ceil(N / 16) blocks: 256 (4096 x 4096) to 2001 (lm_head),
//     two or more an SM at every 7B decode shape, so K is not split and
//     the int32 sum reaches the one rescale whole. The product is __dp4a
//     from shared memory: a warp owns 4 weight rows, a lane 16 bytes of K
//     of each, so a 512-byte stage row is read conflict-free and each
//     activation word serves 4 rows. At M = 2 that is 8 dp4a a lane per 16
//     weight bytes, about 1 us of issue for a 4096 x 4096 product; the
//     int8 tensor cores (wgmma with the weight as the 64-row A operand)
//     would need a tensor map a weight and an M padded to 8, for
//     arithmetic that is not the bound. The lanes' sums meet by warp
//     shuffles at the end.
//   * scalar (path 0, what the others cannot read: odd K, unaligned bases
//     such as an output-column split of a weight at an odd row): for M >
//     16 the tile kernel, a 128 x 64 output tile a block, K walked in
//     64-byte steps through padded shared memory, each thread an 8 x 4
//     register tile of __dp4a, ragged M, N and K edges zero-filled on load
//     and masked on store; for M <= 16 the first port's skinny kernel, a
//     warp an output column streaming that weight row, 16 bytes a lane a
//     step, against up to 8 activation rows, then a warp reduction. Both
//     take 16-byte vector loads where K % 16 == 0 and the bases are
//     aligned, byte loads otherwise.
#include <stdint.h>

#include "common.cuh"
#include "tc.cuh"

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

// ---- the streamed skinny path; the header has the design ----

constexpr int SK_COLS = 16;     // output columns (weight rows) a block
constexpr int SK_KC = 512;      // bytes of K a stage
constexpr int SK_STAGES = 4;
constexpr int SK_THREADS = 128;  // 4 warps of 4 weight rows

// Stage `slot` <- the 512 bytes of K from k0 of 16 weight rows and MR
// activation rows; bytes past K, rows past N or M are zero-filled.
template <int MR>
__device__ __forceinline__ void sk_load(uint8_t* ring, int slot, const int8_t* __restrict__ xq,
                                        const int8_t* __restrict__ w, long n0, int M, int N,
                                        int K, int k0) {
  constexpr int CPR = SK_KC / 16;  // 16-byte chunks a row
  uint8_t* st = ring + slot * (SK_COLS + MR) * SK_KC;
  for (int i = threadIdx.x; i < (SK_COLS + MR) * CPR; i += SK_THREADS) {
    const int r = i / CPR, c = i - r * CPR;
    const int k = k0 + 16 * c;
    const bool row_ok = r < SK_COLS ? n0 + r < N : r - SK_COLS < M;
    const bool ok = row_ok && k < K;
    const int8_t* src = r < SK_COLS ? w + (ok ? (n0 + r) * K + k : 0)
                                    : xq + (ok ? (long)(r - SK_COLS) * K + k : 0);
    haff::tc::cp_async16(st + r * SK_KC + 16 * c, src, ok ? 16 : 0);
  }
}

template <typename T, int MR>
__global__ void __launch_bounds__(SK_THREADS)
w8a8_stream_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ w,
                   const float* __restrict__ sx, const float* __restrict__ sw,
                   T* __restrict__ out, int M, int N, int K) {
  namespace tc = haff::tc;
  constexpr int SB = (SK_COLS + MR) * SK_KC;  // bytes a stage
  extern __shared__ uint4 sk_smem[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(sk_smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long n0 = (long)blockIdx.x * SK_COLS;
  const int nch = (K + SK_KC - 1) / SK_KC;

  int32_t acc[4][MR];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int m = 0; m < MR; ++m) acc[r][m] = 0;

#pragma unroll
  for (int c = 0; c < SK_STAGES - 1; ++c) {
    if (c < nch) sk_load<MR>(ring, c, xq, w, n0, M, N, K, c * SK_KC);
    tc::cp_async_commit();
  }
  for (int c = 0; c < nch; ++c) {
    tc::cp_async_wait<SK_STAGES - 2>();  // chunk c has landed (this thread's copies)
    __syncthreads();                     // everyone's; and slot c - 1 is free
    const int cn = c + SK_STAGES - 1;
    if (cn < nch) sk_load<MR>(ring, cn % SK_STAGES, xq, w, n0, M, N, K, cn * SK_KC);
    tc::cp_async_commit();
    const uint8_t* st = ring + (c % SK_STAGES) * SB;
    int4 wv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      wv[r] = *reinterpret_cast<const int4*>(st + (warp + 4 * r) * SK_KC + 16 * lane);
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      const int4 xv = *reinterpret_cast<const int4*>(st + (SK_COLS + m) * SK_KC + 16 * lane);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r][m] = __dp4a(xv.x, wv[r].x, acc[r][m]);
        acc[r][m] = __dp4a(xv.y, wv[r].y, acc[r][m]);
        acc[r][m] = __dp4a(xv.z, wv[r].z, acc[r][m]);
        acc[r][m] = __dp4a(xv.w, wv[r].w, acc[r][m]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const long n = n0 + warp + 4 * r;
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      int32_t v = acc[r][m];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0 && m < M && n < N)
        out[(long)m * N + n] = haff::from_f<T>((float)v * sx[m] * sw[n]);
    }
  }
}

template <typename T, int MR>
cudaError_t launch_stream_mr(const int8_t* a, const int8_t* b, const float* fx,
                             const float* fw, T* out, int M, int N, int K,
                             cudaStream_t stream) {
  const size_t smem = (size_t)SK_STAGES * (SK_COLS + MR) * SK_KC;
  cudaError_t e = haff::allow_smem(w8a8_stream_kernel<T, MR>, smem);
  if (e != cudaSuccess) return e;
  const unsigned grid = (unsigned)((N + SK_COLS - 1) / SK_COLS);
  w8a8_stream_kernel<T, MR><<<grid, SK_THREADS, smem, stream>>>(a, b, fx, fw, out, M, N, K);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_stream(const int8_t* a, const int8_t* b, const float* fx, const float* fw,
                          T* out, int M, int N, int K, cudaStream_t stream) {
  if (M < 1 || M > SKINNY_M || K % 16 || reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(b) % 16)
    return cudaErrorInvalidValue;
  if (M <= 1) return launch_stream_mr<T, 1>(a, b, fx, fw, out, M, N, K, stream);
  if (M <= 2) return launch_stream_mr<T, 2>(a, b, fx, fw, out, M, N, K, stream);
  if (M <= 4) return launch_stream_mr<T, 4>(a, b, fx, fw, out, M, N, K, stream);
  if (M <= 8) return launch_stream_mr<T, 8>(a, b, fx, fw, out, M, N, K, stream);
  return launch_stream_mr<T, 16>(a, b, fx, fw, out, M, N, K, stream);
}

// ---- the wgmma path; the header has the design ----

constexpr int TC_STAGES = 4;
constexpr int TC_CONSUMERS = 256;              // two warpgroups of 64 rows
constexpr int TC_THREADS = TC_CONSUMERS + 32;  // and the producer warp
constexpr int TC_BOX = 128 * 128;              // bytes of an A or a B box
constexpr int TC_SDS = 136;                    // staging row pitch (elements)

// Ring, mbarriers, each consumer warp's staging area (8 rows of the
// widest output type); 1 KB of slack to align the ring to the swizzle atom.
constexpr size_t TC_SMEM = 1024 + TC_STAGES * 2 * TC_BOX + 2 * TC_STAGES * sizeof(uint64_t) +
                           (TC_CONSUMERS / 32) * 8 * TC_SDS * sizeof(float);

template <typename T, int VB>
__device__ __forceinline__ void store_chunk(T* dst, const T* src) {
  if constexpr (VB == 16) *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  else if constexpr (VB == 8) *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
  else if constexpr (VB == 4)
    *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(src);
  else *reinterpret_cast<uint16_t*>(dst) = *reinterpret_cast<const uint16_t*>(src);
}

// 8 staged rows (pitch TC_SDS) of 128 columns into out rows m0.. from
// column n0, in chunks of VB bytes; rows >= M and chunks at or past N are
// not stored (N is a multiple of the chunk).
template <typename T, int VB>
__device__ __forceinline__ void store_rows8(const T* stage, T* out, long long m0, int M, int n0,
                                            int N, int lane) {
  constexpr int E = VB / (int)sizeof(T), CH = 128 / E;
#pragma unroll 4
  for (int o = lane; o < 8 * CH; o += 32) {
    const int r = o / CH, c = (o - r * CH) * E;
    if (m0 + r < M && n0 + c < N)
      store_chunk<T, VB>(out + (m0 + r) * (long long)N + n0 + c, stage + r * TC_SDS + c);
  }
}

template <typename T>
__global__ void __launch_bounds__(TC_THREADS, 1)
w8a8_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                  const __grid_constant__ CUtensorMap bmap, const float* __restrict__ sx,
                  const float* __restrict__ sw, T* __restrict__ out, int M, int N, int K,
                  int vb) {
  namespace tc = haff::tc;
  const int tiles_m = (M + 127) / 128, ntiles = tiles_m * ((N + 127) / 128);
  const int kiters = (K + 127) / 128;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ uint4 smem_tc[];
  uint8_t* smem_raw = reinterpret_cast<uint8_t*>(smem_tc);
  uint8_t* ring = smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + TC_STAGES * 2 * TC_BOX);
  uint64_t* empty = full + TC_STAGES;
  T* stage = reinterpret_cast<T*>(empty + TC_STAGES) + warp * 8 * TC_SDS;
  if (tid == 0) {
    for (int s = 0; s < TC_STAGES; ++s) {
      tc::mbar_init(&full[s], 1);
      tc::mbar_init(&empty[s], TC_CONSUMERS);
    }
    tc::mbar_fence_init();
  }
  __syncthreads();

  if (warp == TC_CONSUMERS / 32) {  // the producer
    if (lane == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int m0 = (tile % tiles_m) * 128, n0 = (tile / tiles_m) * 128;
        for (int kb = 0; kb < kiters; ++kb, ++it) {
          const int s = it % TC_STAGES, use = it / TC_STAGES;
          if (use > 0) tc::mbar_wait(&empty[s], (use - 1) & 1);
          tc::mbar_expect_tx(&full[s], 2 * TC_BOX);
          uint8_t* A = ring + s * 2 * TC_BOX;
          tc::tma_load_2d(A, &amap, &full[s], kb * 128, m0);
          tc::tma_load_2d(A + TC_BOX, &bmap, &full[s], kb * 128, n0);
        }
      }
    }
    return;
  }

  const int g = lane >> 2, t = lane & 3, wg = warp >> 2;
  int32_t acc[64];
  int it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int m0 = (tile % tiles_m) * 128, n0 = (tile / tiles_m) * 128;
#pragma unroll
    for (int x = 0; x < 64; ++x) acc[x] = 0;
    for (int kb = 0; kb < kiters; ++kb, ++it) {
      const int s = it % TC_STAGES;
      tc::mbar_wait(&full[s], (it / TC_STAGES) & 1);
      const uint8_t* A = ring + s * 2 * TC_BOX + wg * 64 * 128;
      const uint8_t* B = ring + s * 2 * TC_BOX + TC_BOX;
      tc::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        tc::wgmma_s8_n128(acc, tc::kmajor_desc_sw128(A + kk * 32),
                          tc::kmajor_desc_sw128(B + kk * 32), 1);
      tc::wg_commit();
      tc::wg_wait<1>();  // the previous stage's products have retired
      if (kb > 0) tc::mbar_arrive(&empty[(it - 1) % TC_STAGES]);
    }
    tc::wg_wait<0>();
    tc::wg_hold(acc);
    tc::mbar_arrive(&empty[(it - 1) % TC_STAGES]);

    // Epilogue: the warp's 16 rows, 8 at a time through its staging area.
    const long long r0 = m0 + wg * 64 + (warp & 3) * 16;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const long long m = r0 + g + 8 * hf;
      const float s_m = m < M ? sx[m] : 0.f;
      __syncwarp();  // the area's last readers are done
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const int c = n * 8 + 2 * t, col = n0 + c;
        const float s0 = col < N ? sw[col] : 0.f, s1 = col + 1 < N ? sw[col + 1] : 0.f;
        const float v0 = (float)acc[4 * n + 2 * hf] * s_m * s0;
        const float v1 = (float)acc[4 * n + 2 * hf + 1] * s_m * s1;
        if constexpr (sizeof(T) == 2)
          *reinterpret_cast<uint32_t*>(stage + g * TC_SDS + c) = haff::tc::pack_bf16(v0, v1);
        else
          *reinterpret_cast<float2*>(stage + g * TC_SDS + c) = make_float2(v0, v1);
      }
      __syncwarp();
      const long long mr = r0 + 8 * hf;
      if (vb == 16) store_rows8<T, 16>(stage, out, mr, M, n0, N, lane);
      else if (vb == 8) store_rows8<T, 8>(stage, out, mr, M, n0, N, lane);
      else if (vb == 4) store_rows8<T, 4>(stage, out, mr, M, n0, N, lane);
      else if constexpr (sizeof(T) == 2) store_rows8<T, 2>(stage, out, mr, M, n0, N, lane);
    }
  }
}

int sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

template <typename T>
cudaError_t launch_wgmma(const int8_t* a, const int8_t* b, const float* fx, const float* fw,
                         T* out, int M, int N, int K, cudaStream_t stream) {
  if (K % 16 || reinterpret_cast<uintptr_t>(a) % 16 || reinterpret_cast<uintptr_t>(b) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap amap, bmap;
  if (!haff::tc::rows_map_sw128(&amap, a, M, K, 128) ||
      !haff::tc::rows_map_sw128(&bmap, b, N, K, 128))
    return cudaErrorInvalidValue;
  // The widest store the output's row pitch and base allow.
  int vb = 16;
  while (vb > (int)sizeof(T) &&
         (((long long)N * sizeof(T)) % vb || reinterpret_cast<uintptr_t>(out) % vb))
    vb >>= 1;
  cudaError_t e = haff::allow_smem(w8a8_wgmma_kernel<T>, TC_SMEM);
  if (e != cudaSuccess) return e;
  const int ntiles = ((M + 127) / 128) * ((N + 127) / 128);
  const int grid = ntiles < sm_count() ? ntiles : sm_count();
  w8a8_wgmma_kernel<T><<<grid, TC_THREADS, TC_SMEM, stream>>>(
      amap, bmap, fx, fw, out, M, N, K, vb);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* xq, const void* w, const void* sx, const void* sw,
                   void* out, int M, int N, int K, int path, cudaStream_t stream) {
  const int8_t* a = static_cast<const int8_t*>(xq);
  const int8_t* b = static_cast<const int8_t*>(w);
  const float* fx = static_cast<const float*>(sx);
  const float* fw = static_cast<const float*>(sw);
  T* o = static_cast<T*>(out);
  const int vec = K % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(b) % 16 == 0;
  if (path == 1) return launch_wgmma<T>(a, b, fx, fw, o, M, N, K, stream);
  if (path == 2) return launch_stream<T>(a, b, fx, fw, o, M, N, K, stream);
  if (path != 0) return cudaErrorInvalidValue;
  if (M <= SKINNY_M) {
    dim3 grid((N + THREADS / 32 - 1) / (THREADS / 32),
              (M + SKINNY_ROWS - 1) / SKINNY_ROWS);
    w8a8_skinny_kernel<T><<<grid, THREADS, 0, stream>>>(a, b, fx, fw, o, M, N, K, vec);
  } else {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    w8a8_tile_kernel<T><<<grid, THREADS, 0, stream>>>(a, b, fx, fw, o, M, N, K, vec);
  }
  return cudaGetLastError();
}

}  // namespace

// Paths (the wrapper's w8a8_path): 0 the dp4a scalar kernels (the tile
// kernel for M > 16, the first skinny kernel for M <= 16), 1 int8 warpgroup
// MMA (M > 16, K % 16 == 0, 16-byte aligned xq and w), 2 the streamed
// skinny kernel (M <= 16, the same operand rules). xq (M, K) and w (N, K)
// int8 row-major, sx (M,) and sw (N,) f32, out (M, N) bf16 (out_bf16) or
// f32.
extern "C" int w8a8_matmul(const void* xq, const void* w, const void* sx, const void* sw,
                           void* out, int M, int N, int K, int out_bf16, int path,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16) return (int)launch<__nv_bfloat16>(xq, w, sx, sw, out, M, N, K, path, s);
  return (int)launch<float>(xq, w, sx, sw, out, M, N, K, path, s);
}
