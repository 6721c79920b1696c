// matmul_probe: one tensor-core matrix product, one structure, instantiated
// for int8 operands (exact int32 sums, wgmma .s32.s8.s8) and for bf16
// operands (float32 sums, wgmma .f32.bf16.bf16). It answers one question:
// at equal structure, what is the rate ratio of the card's int8 and bf16
// tensor cores.
//
// Replaces the probe `mm_kernel` of tools/bench_kernels.py (cmd_int8mxu),
// which asks the TPU's matrix unit the same question with one Pallas body
// instantiated for both types.
//
// What it computes: C (M, N) = A (M, K) @ B (N, K)^T, both operands
// K-contiguous (the port keeps weights (out, in)), C int32 for int8 and
// float32 for bf16.
//
// What bounds it on Hopper: at the probe's 2048^3 the operations (2 M N K
// against 1979 TOP/s int8, 989 TFLOP/s bf16, 0.0087 and 0.0174 ms); the
// bytes (25 MB, 0.0075 ms) come close, and most of them are the output's.
//
// Structure (the shape of w8a8_matmul.cu's wgmma path): output tiles of
// BM x BN = 128 x 256; a persistent grid of one block an SM walks them
// M-fastest, so the blocks in flight share B tiles in L2. A block is a
// producer warp and two consumer warpgroups of 64 rows. The producer keeps
// a ring of STAGES stages in flight, each an A box (128 rows x 128 bytes
// of K) and a B box (256 rows x 128 bytes of K) loaded by TMA from 2-d
// tensor maps with the 128-byte swizzle; it runs ahead into the next tile
// while the consumers finish one. Both element types are loaded as bytes
// (a bf16 row of K values is 2K bytes), so a stage holds the same bytes
// for both: 128 int8 or 64 bf16 values of K. Each consumer runs four
// m64n256 products a stage, k32 for int8 and k16 for bf16: 32 bytes of
// each row a product, the same descriptors, stepped the same way. The
// product instruction and the accumulator type are the only difference
// between the two instantiations. A consumer keeps one stage's products
// in flight while it waits for the next and releases a stage when its
// products retire. TMA's zero fill covers ragged M and N and K past the
// last full box. The epilogue stores the raw sums through a staging area
// a warp as whole 512-byte row pieces, masked at the edges: at 2048^3 all
// tiles end together, and the output's 16.8 MB leave in one burst.
//
// The tile: 128 x 256 gives 2048^3 128 tiles, one wave on 128 of the 132
// SMs, 128 accumulators a consumer thread (154 registers); 128 x 128 gives
// 256 tiles, 1.94 waves, and reads each B byte from L2 twice as often per
// operation. Measured on the H100 against this structure: 128 x 128 tiles,
// 3 stages, 64-byte K boxes in 8 stages, releasing each stage at once and
// a 2-block cluster multicasting B were all slower; the staged epilogue
// beat 8-byte stores straight from the accumulators at 2048^3.
#include <stdint.h>

#include "common.cuh"
#include "tc.cuh"

namespace {

constexpr int BM = 128, BN = 256;            // output tile
constexpr int BOX_K = 128;                   // bytes of K a stage
constexpr int STAGES = 4;
constexpr int CONSUMERS = 256;               // two warpgroups of 64 rows
constexpr int THREADS = CONSUMERS + 32;      // and the producer warp
constexpr int A_BOX = BM * BOX_K, B_BOX = BN * BOX_K;
constexpr int STAGE = A_BOX + B_BOX;         // 48 KB
constexpr int NACC = BN / 2;                 // accumulators a consumer thread

constexpr int SROW = 128;                    // staged columns a row (512 bytes)

// Ring, mbarriers, each consumer warp's staging area (8 rows of SROW
// sums); 1 KB of slack to align the ring to the swizzle atom.
constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE + 2 * STAGES * sizeof(uint64_t) +
                        (CONSUMERS / 32) * 8 * SROW * 4;

template <typename T>
struct Elem;

template <>
struct Elem<int8_t> {
  using Acc = int32_t;
  using Acc2 = int2;
  static __device__ __forceinline__ void mma(Acc (&d)[NACC], uint64_t da, uint64_t db) {
    haff::tc::wgmma_s8_n256(d, da, db, 1);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  using Acc = float;
  using Acc2 = float2;
  static __device__ __forceinline__ void mma(Acc (&d)[NACC], uint64_t da, uint64_t db) {
    haff::tc::wgmma_ss_n256(d, da, db, 1);
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
probe_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
             typename Elem<T>::Acc* __restrict__ c, int M, int N, int kbytes, int vec) {
  namespace tc = haff::tc;
  using E = Elem<T>;
  using Acc = typename E::Acc;
  const int tiles_m = (M + BM - 1) / BM, ntiles = tiles_m * ((N + BN - 1) / BN);
  const int kiters = (kbytes + BOX_K - 1) / BOX_K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ uint4 smem_probe[];
  uint8_t* smem_raw = reinterpret_cast<uint8_t*>(smem_probe);
  uint8_t* ring = smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      tc::mbar_init(&full[s], 1);
      tc::mbar_init(&empty[s], CONSUMERS);
    }
    tc::mbar_fence_init();
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {  // the producer
    if (lane == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int m0 = (tile % tiles_m) * BM, n0 = (tile / tiles_m) * BN;
        for (int kb = 0; kb < kiters; ++kb, ++it) {
          const int s = it % STAGES, use = it / STAGES;
          if (use > 0) tc::mbar_wait(&empty[s], (use - 1) & 1);
          tc::mbar_expect_tx(&full[s], STAGE);
          uint8_t* A = ring + s * STAGE;
          tc::tma_load_2d(A, &amap, &full[s], kb * BOX_K, m0);
          tc::tma_load_2d(A + A_BOX, &bmap, &full[s], kb * BOX_K, n0);
        }
      }
    }
    return;
  }

  const int g = lane >> 2, t = lane & 3, wg = warp >> 2;
  Acc* stage = reinterpret_cast<Acc*>(empty + STAGES) + warp * 8 * SROW;
  Acc acc[NACC];
  int it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int m0 = (tile % tiles_m) * BM, n0 = (tile / tiles_m) * BN;
#pragma unroll
    for (int x = 0; x < NACC; ++x) acc[x] = 0;
    for (int kb = 0; kb < kiters; ++kb, ++it) {
      const int s = it % STAGES;
      tc::mbar_wait(&full[s], (it / STAGES) & 1);
      const uint8_t* A = ring + s * STAGE + wg * 64 * BOX_K;
      const uint8_t* B = ring + s * STAGE + A_BOX;
      tc::wg_fence();
#pragma unroll
      for (int kk = 0; kk < BOX_K / 32; ++kk)
        E::mma(acc, tc::kmajor_desc_sw128(A + kk * 32), tc::kmajor_desc_sw128(B + kk * 32));
      tc::wg_commit();
      tc::wg_wait<1>();  // the previous stage's products have retired
      if (kb > 0) tc::mbar_arrive(&empty[(it - 1) % STAGES]);
    }
    tc::wg_wait<0>();
    tc::wg_hold(acc);
    tc::mbar_arrive(&empty[(it - 1) % STAGES]);

    // Epilogue: thread (g, t) holds rows g and g + 8 of its warp's 16, and
    // columns 8 n + 2 t, + 1 of the tile (the wgmma accumulator layout).
    // Each 8 rows x 128 columns go through the warp's staging area, 16-byte
    // chunk q of row r at q ^ 2r (no two lanes of a phase on one bank, as
    // an 8-byte write or a 16-byte read), then out as whole 512-byte rows
    // (16-byte stores where the row pitch and base allow).
    const long long r0 = m0 + wg * 64 + (warp & 3) * 16;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
      for (int half = 0; half < BN / SROW; ++half) {
        __syncwarp();  // the area's last readers are done
#pragma unroll
        for (int n = 0; n < SROW / 8; ++n) {
          typename E::Acc2 v;
          v.x = acc[4 * (n + half * SROW / 8) + 2 * hf];
          v.y = acc[4 * (n + half * SROW / 8) + 2 * hf + 1];
          const int q = (2 * n + (t >> 1)) ^ (2 * g);
          *reinterpret_cast<typename E::Acc2*>(stage + g * SROW + 4 * q + 2 * (t & 1)) = v;
        }
        __syncwarp();
        const int n1 = n0 + half * SROW;
#pragma unroll 4
        for (int r = 0; r < 8; ++r) {
          const long long m = r0 + 8 * hf + r;
          const int col = n1 + 4 * lane;
          if (m >= M || col >= N) continue;
          const Acc* src = stage + r * SROW + 4 * (lane ^ (2 * r));
          Acc* dst = c + m * N + col;
          if (vec && col + 3 < N) {
            *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
          } else {
            for (int j = 0; j < 4 && col + j < N; ++j) dst[j] = src[j];
          }
        }
      }
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
cudaError_t launch(const void* a, const void* b, void* c, int M, int N, int K,
                   cudaStream_t stream) {
  if (K % 32 || reinterpret_cast<uintptr_t>(a) % 16 || reinterpret_cast<uintptr_t>(b) % 16)
    return cudaErrorInvalidValue;
  // Rows of K elements as rows of K * sizeof(T) bytes: one map for both types.
  const int kbytes = K * (int)sizeof(T);
  CUtensorMap amap, bmap;
  if (!haff::tc::rows_map_sw128(&amap, a, M, kbytes, BM) ||
      !haff::tc::rows_map_sw128(&bmap, b, N, kbytes, BN))
    return cudaErrorInvalidValue;
  // 16-byte stores where every row's start allows them.
  const int vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(c) % 16 == 0;
  cudaError_t e = haff::allow_smem(probe_kernel<T>, SMEM);
  if (e != cudaSuccess) return e;
  const int ntiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int grid = ntiles < sm_count() ? ntiles : sm_count();
  probe_kernel<T><<<grid, THREADS, SMEM, stream>>>(
      amap, bmap, static_cast<typename Elem<T>::Acc*>(c), M, N, kbytes, vec);
  return cudaGetLastError();
}

}  // namespace

// a (M, K) and b (N, K) row-major, both int8 (is_int8; c int32) or both
// bf16 (c float32); K % 32 == 0 and 16-byte aligned a and b (TMA), which
// the wrapper checks first.
extern "C" int matmul_probe(const void* a, const void* b, void* c, int M, int N, int K,
                            int is_int8, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_int8) return (int)launch<int8_t>(a, b, c, M, N, K, s);
  return (int)launch<__nv_bfloat16>(a, b, c, M, N, K, s);
}
