// sam_global_relpos_attn: flash-style global attention with the
// decomposed relative-position bias, for the global blocks of every SAM
// ViT (L = 64 x 64 = 4096 tokens at ViT-H/L/B) and any grid (H, W); a
// window too large for sam_window_attn.cu's shared memory runs here as a
// batch of small grids.
//
// Replaces haff_tpu/kernels/sam_attention.py::_global_qkv_kernel
// (launched by _global_qkv_fwd through sam_global_attention_qkv) and
// ::_fused_kernel (launched by _fused_fwd through sam_global_attention):
// one function over the fused projection or per-head operands. The TPU
// guards (L >= 256 or 1024, W % 8, 128-lane head halves) do not apply.
//
// What it computes, per batch b, head h and query i:
//   s[i, j] = scale * q_i . k_j + Bh[i, row(j)] + Bw[i, col(j)]
//   o_i     = softmax_j(s[i, :]) @ V
// with row(j) = j / W, col(j) = j % W, Bh[i, y] = q_i . rel_h[row(i) - y
// + H - 1] and Bw[i, x] = q_i . rel_w[col(i) - x + W - 1]. One block owns
// a tile of query rows of one (batch, head) and walks the key tiles with
// an online softmax (running max, sum, f32 accumulator), the loop that
// replaces the TPU kernel's sequential key-block grid axis. The (L, L)
// scores and bias never reach device memory.
//
// Operands: q, k and v are three base pointers, each with a batch stride
// and a row stride in elements; element (b, row i, head h, k) lies at
// base + b * bs + i * rs + h * d + k. The fused projection (B, L, 3C) is
// read in place (k = qkv + C, v = qkv + 2C, row stride 3C), as are
// separate per-head (B, L, nh, d) tensors (row stride C). The output is
// (B, L, C) contiguous. The ragged last query and key tiles are masked.
//
// What bounds it on Hopper: ~4*L*L*d FLOPs per (batch, head) against
// ~4*L*d*2 bytes, ~2000 FLOP/byte: operations, by a wide margin; and,
// since a block re-reads its head's K and V, the L2-to-SM stream (20 KB a
// 64-key tile at d = 80 for 128 query rows). Two paths, chosen by the
// wrapper (kernel_path) before the launch:
//
// * warpgroup MMA (bf16, every grid). A block is a producer warp and two
//   consumer warpgroups of 64 query rows. The producer streams the head's
//   K and V tiles by TMA into a four-stage ring (full / empty mbarrier
//   pairs), so three tiles are in flight while one is consumed; the
//   consumers never meet at a block barrier, so one warpgroup's softmax
//   overlaps the other's products. S = Q K^T and O += P V are wgmma with
//   f32 sums in registers (q and P as register A operands, K and V from
//   shared memory); the score tile never reaches shared memory; the
//   softmax uses exp2 with log2 e folded into the scale. At the SAM ViT
//   grids (W = 64) a 64-key tile is one grid row, so a thread keeps its
//   Bw values in registers and reads one Bh value a row and tile. The
//   band is built in the kernel from the raw rel-pos tables (tc::band_rows:
//   bf16 hi + lo halves of the f32 tables on the tensor cores), and P
//   enters P V as bf16 hi + lo halves (tc.cuh says why). It needs bf16
//   operands with 16-byte aligned bases, batch and row strides that are
//   multiples of 8 elements and d % 8 == 0.
// * scalar (float32 operands, which the card's float32 checks hold to
//   1e-4, and bf16 views a 16-byte copy cannot read): f32 FMAs out of
//   shared memory, every load of one element, the band tables Bh
//   (B, L, nh, H) and Bw (B, L, nh, W) computed by the wrapper (JAX's
//   _natural_band_tables_cat).
#include "common.cuh"
#include "tc.cuh"

#include <cuda.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 8 warps
constexpr int MAXD = 128;
constexpr int ACC = BQ * MAXD / THREADS;  // accumulators per thread

// Batch and row strides of q, k and v, in elements.
struct Strides {
  long long q_b, q_row, k_b, k_row, v_b, v_row;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
global_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ band_h,
                   const float* __restrict__ band_w, T* __restrict__ out, int H, int W,
                   int nh, int d, Strides st, float scale) {
  using haff::from_f;
  using haff::to_f;
  const int L = H * W;
  const int C = nh * d;
  const int i0 = blockIdx.z * BQ;
  const int h = blockIdx.y;
  const long long b = blockIdx.x;  // batch on x: no 65535 limit
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int dp = d + 1;
  const int sp = BQ + 1;

  extern __shared__ float smem[];
  float* Qs = smem;               // BQ * dp
  float* Ks = Qs + BQ * dp;       // BK * d
  float* Vs = Ks + BK * d;        // BK * d
  float* S = Vs + BK * d;         // BK * sp, S[j * sp + i]
  float* Bh = S + BK * sp;        // BQ * H
  float* Bw = Bh + BQ * H;        // BQ * W
  float* m_s = Bw + BQ * W;       // BQ running max
  float* l_s = m_s + BQ;          // BQ running sum
  float* a_s = l_s + BQ;          // BQ rescale of this tile

  const T* qbase = q + b * st.q_b + (long long)h * d;
  const T* kbase = k + b * st.k_b + (long long)h * d;
  const T* vbase = v + b * st.v_b + (long long)h * d;
  for (int o = tid; o < BQ * d; o += THREADS) {
    const int i = o / d, c = o - i * d;
    Qs[i * dp + c] = (i0 + i < L) ? to_f(qbase[(i0 + i) * st.q_row + c]) : 0.f;
  }
  for (int o = tid; o < BQ * H; o += THREADS) {
    const int i = o / H, r = o - i * H;
    Bh[o] = (i0 + i < L) ? band_h[((b * L + i0 + i) * nh + h) * H + r] : 0.f;
  }
  for (int o = tid; o < BQ * W; o += THREADS) {
    const int i = o / W, c = o - i * W;
    Bw[o] = (i0 + i < L) ? band_w[((b * L + i0 + i) * nh + h) * W + c] : 0.f;
  }
  for (int i = tid; i < BQ; i += THREADS) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
  }
  float acc[ACC];
#pragma unroll
  for (int r = 0; r < ACC; ++r) acc[r] = 0.f;

  for (int j0 = 0; j0 < L; j0 += BK) {
    __syncthreads();  // previous tile's readers are done with Ks, Vs, S
    for (int o = tid; o < BK * d; o += THREADS) {
      const int j = o / d, c = o - j * d;
      const bool ok = j0 + j < L;
      Ks[o] = ok ? to_f(kbase[(j0 + j) * st.k_row + c]) : 0.f;
      Vs[o] = ok ? to_f(vbase[(j0 + j) * st.v_row + c]) : 0.f;
    }
    __syncthreads();

    for (int o = tid; o < BQ * BK; o += THREADS) {
      const int j = o / BQ, i = o - j * BQ;
      const int ja = j0 + j;
      float s = -INFINITY;
      if (ja < L) {
        const float* qi = Qs + i * dp;
        const float* kj = Ks + j * d;
        float dot = 0.f;
        for (int c = 0; c < d; ++c) dot = fmaf(qi[c], kj[c], dot);
        s = dot * scale + Bh[i * H + ja / W] + Bw[i * W + ja % W];
      }
      S[j * sp + i] = s;
    }
    __syncthreads();

    // Online softmax: one warp per query row.
    for (int i = warp; i < BQ; i += THREADS / 32) {
      float mx = -INFINITY;
      for (int j = lane; j < BK; j += 32) mx = fmaxf(mx, S[j * sp + i]);
      mx = haff::warp_max(mx);
      const float m_old = m_s[i];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < BK; j += 32) {
        const float p = (m_new == -INFINITY) ? 0.f : expf(S[j * sp + i] - m_new);
        S[j * sp + i] = p;
        sum += p;
      }
      sum = haff::warp_sum(sum);
      if (lane == 0) {
        const float alpha = (m_new == -INFINITY) ? 1.f : expf(m_old - m_new);
        a_s[i] = alpha;
        l_s[i] = l_s[i] * alpha + sum;
        m_s[i] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < ACC; ++r) {
      const int o = tid + r * THREADS;
      if (o < BQ * d) {
        const int i = o / d, c = o - i * d;
        float a = acc[r] * a_s[i];
        for (int j = 0; j < BK; ++j) a = fmaf(S[j * sp + i], Vs[j * d + c], a);
        acc[r] = a;
      }
    }
  }

  T* obase = out + b * L * C + (long)h * d;
#pragma unroll
  for (int r = 0; r < ACC; ++r) {
    const int o = tid + r * THREADS;
    if (o < BQ * d) {
      const int i = o / d, c = o - i * d;
      if (i0 + i < L) obase[(long)(i0 + i) * C + c] = from_f<T>(acc[r] / l_s[i]);
    }
  }
}

size_t smem_bytes(int H, int W, int d) {
  return sizeof(float) * ((size_t)BQ * (d + 1) + 2 * (size_t)BK * d +
                          (size_t)BK * (BQ + 1) + (size_t)BQ * (H + W) + 3 * BQ);
}

// ---- bf16 warpgroup-MMA path: every grid, d % 8 == 0 ----
//
// A block is two consumer warpgroups of 64 query rows each and one
// producer warp. The producer streams the K and V tiles of the block's
// (batch, head) through a ring of WG_STAGES stages by TMA, each stage with
// a full and an empty mbarrier; the consumers never meet at a block
// barrier in the loop, so one warpgroup's softmax runs while the other's
// products occupy the tensor cores. S = Q K^T is one wgmma m64n64k16 per
// 16 columns of the head (q fragments in registers as the A operand, the
// K tile in shared memory as B), O += P V one wgmma m64n{d}k16 per 16 keys
// and per half of P (hi, lo; P from registers, the V tile transposed as
// B). A tile lands in the core-matrix layout of tc.cuh, one TMA box of
// 64 keys x 8 columns (1 KB) per column block; TMA fills the columns past
// d (d rounded up to 16) and the keys past L with zeros, and the softmax
// masks those keys. The band is tc::band_rows into a per-warp table. At
// the SAM ViT grids W = 64 makes a key tile one grid row: Bw stays in
// registers and Bh is one term a row and tile; other grids look up both
// cells of every key.

constexpr int WG_BK = 64;                      // keys per tile
constexpr int WG_STAGES = 4;
constexpr int WG_CONSUMERS = 256;              // two warpgroups
constexpr int WG_THREADS = WG_CONSUMERS + 32;  // and the producer warp

size_t wg_smem_bytes(int H, int W, int dp) {
  return WG_STAGES * 2 * (size_t)WG_BK * dp * sizeof(__nv_bfloat16) +
         2 * WG_STAGES * sizeof(uint64_t) + (size_t)128 * (H + W) * sizeof(float);
}

// O (m64 x n DP) += P V at one 16-key k-step: one product where wgmma has
// the width (64, 80), else one per 16 columns.
template <int DP>
__device__ __forceinline__ void wg_pv(float (&o)[DP / 2], const uint32_t (&p)[4],
                                      const __nv_bfloat16* Vk) {
  namespace tc = haff::tc;
  if constexpr (DP == 80) {
    tc::wgmma_n80<1>(o, p, tc::wg_desc(Vk, 128, 1024), 1);
  } else if constexpr (DP == 64) {
    tc::wgmma_n64<1>(o, p, tc::wg_desc(Vk, 128, 1024), 1);
  } else {
#pragma unroll
    for (int j = 0; j < DP / 16; ++j)
      tc::wgmma_n16<1>(reinterpret_cast<float(&)[8]>(o[8 * j]), p,
                       tc::wg_desc(Vk + j * 2 * 512, 128, 1024), 1);
  }
}

// ROW_TILES: W == 64 and d == DP, the SAM ViT grids: every key tile is a
// whole grid row. A template argument, so that instantiation holds no code
// of the other case and knows W and d.
template <int DP, bool ROW_TILES>
__global__ void __launch_bounds__(WG_THREADS, 1)
global_wg_kernel(const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, const __nv_bfloat16* __restrict__ q,
                 const float* __restrict__ rel_h, const float* __restrict__ rel_w,
                 __nv_bfloat16* __restrict__ out, int H, int W_arg, int nh, int d_arg,
                 long long q_b, long long q_row, float scale) {
  namespace tc = haff::tc;
  constexpr int KS = DP / 16, NO = DP / 8, CB = DP / 8;
  const int W = ROW_TILES ? WG_BK : W_arg, d = ROW_TILES ? DP : d_arg;
  constexpr int TILE = WG_BK * DP;  // elements of one K or V tile
  const int L = H * W, C = nh * d, HW = H + W;
  const int h = blockIdx.y, b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ntiles = (L + WG_BK - 1) / WG_BK;

  extern __shared__ uint4 smem_wg[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_wg);  // [stage][K, V][TILE]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + WG_STAGES * 2 * TILE);
  uint64_t* empty = full + WG_STAGES;
  if (tid == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      tc::mbar_init(&full[s], 1);
      tc::mbar_init(&empty[s], WG_CONSUMERS);
    }
    tc::mbar_fence_init();
  }
  __syncthreads();

  if (warp == WG_CONSUMERS / 32) {  // the producer
    if (lane == 0) {
      for (int tile = 0; tile < ntiles; ++tile) {
        const int s = tile % WG_STAGES, use = tile / WG_STAGES;
        if (use > 0) tc::mbar_wait(&empty[s], (use - 1) & 1);
        tc::mbar_expect_tx(&full[s], 2 * TILE * sizeof(__nv_bfloat16));
        __nv_bfloat16* Ks = ring + s * 2 * TILE;
        for (int cb = 0; cb < CB; ++cb) {
          tc::tma_load_4d(Ks + cb * 512, &kmap, &full[s], cb * 8, h, tile * WG_BK, b);
          tc::tma_load_4d(Ks + TILE + cb * 512, &vmap, &full[s], cb * 8, h, tile * WG_BK, b);
        }
      }
    }
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.z * 128 + warp * 16;
  float* tab = reinterpret_cast<float*>(empty + WG_STAGES) + warp * 16 * HW;
  uint32_t qf[KS][4];
  tc::load_q<KS>(qf, q + b * q_b + (long long)h * d, q_row, row0, L, d, lane);
  tc::band_rows<KS>(qf, H, W, row0, tab, HW, lane,
                    tc::RelFromGlobal{rel_h, rel_w, H, W, d, lane});
  __syncwarp();
  float bw[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      bw[n][e] = ROW_TILES ? tab[(g + (e >> 1) * 8) * HW + H + n * 8 + 2 * t + (e & 1)] : 0.f;

  tc::RowState<NO> rs;
  rs.init();
  float(&o)[NO * 4] = reinterpret_cast<float(&)[NO * 4]>(rs.o);
  float s[8][4] = {};
  float(&s32)[32] = reinterpret_cast<float(&)[32]>(s);
  const float scale_log2 = scale * tc::LOG2E;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int st = tile % WG_STAGES;
    tc::mbar_wait(&full[st], (tile / WG_STAGES) & 1);
    const __nv_bfloat16* Ks = ring + st * 2 * TILE;
    const __nv_bfloat16* Vs = Ks + TILE;
    tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      tc::wgmma_n64<0>(s32, qf[kk], tc::wg_desc(Ks + kk * 2 * 512, 1024, 128), kk > 0);
    tc::wg_commit();
    tc::wg_wait<0>();
    tc::wg_hold(s32);
    if constexpr (ROW_TILES) {
      const float rb[2] = {tab[g * HW + tile], tab[(g + 8) * HW + tile]};
      tc::softmax_tile<false>(
          s, rb, [&](int hf, int n, int e, float x) {
            return fmaf(x, scale_log2, bw[n][hf * 2 + e]);
          },
          WG_BK, rs, lane);
    } else {
      const int j0 = tile * WG_BK, live = min(WG_BK, L - j0);
      const float rb[2] = {0.f, 0.f};
      auto logit = [&](int hf, int n, int e, float x) {
        const int j = j0 + n * 8 + 2 * t + e, y = j / W;
        const float* row = tab + (g + hf * 8) * HW;
        return fmaf(x, scale_log2, row[y] + row[H + j - y * W]);
      };
      if (live == WG_BK)
        tc::softmax_tile<false>(s, rb, logit, live, rs, lane);
      else
        tc::softmax_tile<true>(s, rb, logit, live, rs, lane);
    }
    uint32_t phi[4][4], plo[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) tc::split_p(s, ks, phi[ks], plo[ks]);
    tc::wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      wg_pv<DP>(o, phi[ks], Vs + ks * 16 * 8);
      wg_pv<DP>(o, plo[ks], Vs + ks * 16 * 8);
    }
    tc::wg_commit();
    tc::wg_wait<0>();
    tc::wg_hold(o);
    tc::wg_hold(phi);
    tc::wg_hold(plo);
    tc::mbar_arrive(&empty[st]);  // this thread is done with the stage
  }
  tc::store_rows<NO>(rs, out + (long long)b * L * C + (long long)h * d, C, row0, L, d / 8,
                     lane);
}

// cuTensorMapEncodeTiled, a driver function, through the runtime's entry
// point table (no link against libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The (B, L, nh, d) operand at `base` (row stride `row`, batch stride
// `bs`, in elements) as a 4-d tensor map (d, nh, L, B) with 8 x 1 x 64 x 1
// boxes: one core-matrix column block of a key tile.
bool head_map(CUtensorMap* map, const void* base, int d, int nh, int L, int B, long long row,
              long long bs) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)nh, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)row * 2, (cuuint64_t)bs * 2};
  const cuuint32_t box[4] = {8, 1, (cuuint32_t)WG_BK, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// DP: d rounded up to 16.
template <int DP, bool ROW_TILES>
cudaError_t launch_wg_as(const void* q, const void* k, const void* v, const float* rel_h,
                         const float* rel_w, void* out, int B, int H, int W, int nh, int d,
                         Strides st, float scale, cudaStream_t stream) {
  CUtensorMap kmap, vmap;
  const int L = H * W;
  if (!head_map(&kmap, k, d, nh, L, B, st.k_row, st.k_b) ||
      !head_map(&vmap, v, d, nh, L, B, st.v_row, st.v_b))
    return cudaErrorInvalidValue;
  const size_t smem = wg_smem_bytes(H, W, DP);
  cudaError_t e = haff::allow_smem(global_wg_kernel<DP, ROW_TILES>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(B, nh, (L + 127) / 128);
  global_wg_kernel<DP, ROW_TILES><<<grid, WG_THREADS, smem, stream>>>(
      kmap, vmap, static_cast<const __nv_bfloat16*>(q), rel_h, rel_w,
      static_cast<__nv_bfloat16*>(out), H, W, nh, d, st.q_b, st.q_row, scale);
  return cudaGetLastError();
}

cudaError_t launch_wg(const void* q, const void* k, const void* v, const float* rel_h,
                      const float* rel_w, void* out, int B, int H, int W, int nh, int d,
                      Strides st, float scale, cudaStream_t s) {
  switch ((d + 15) / 16) {
#define HAFF_WG_CASE(n) \
  case n:               \
    return W == WG_BK && d == 16 * n                                                     \
               ? launch_wg_as<16 * n, true>(q, k, v, rel_h, rel_w, out, B, H, W, nh, d, \
                                            st, scale, s)                                \
               : launch_wg_as<16 * n, false>(q, k, v, rel_h, rel_w, out, B, H, W, nh, d, \
                                             st, scale, s);
    HAFF_WG_CASE(1)
    HAFF_WG_CASE(2)
    HAFF_WG_CASE(3)
    HAFF_WG_CASE(4)
    HAFF_WG_CASE(5)
    HAFF_WG_CASE(6)
    HAFF_WG_CASE(7)
    HAFF_WG_CASE(8)
#undef HAFF_WG_CASE
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const float* band_h,
                   const float* band_w, void* out, int B, int H, int W, int nh, int d,
                   Strides st, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(H, W, d);
  cudaError_t e = haff::allow_smem(global_attn_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(B, nh, (H * W + BQ - 1) / BQ);
  global_attn_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      band_h, band_w, static_cast<T*>(out), H, W, nh, d, st, scale);
  return cudaGetLastError();
}

}  // namespace

// Paths (the wrapper's kernel_path): 0 scalar, band_h / band_w the band
// tables (B, L, nh, H) and (B, L, nh, W); 2 warpgroup MMA, bf16 operands
// it can read (see the header), band_h / band_w the raw rel-pos tables
// (2H-1, d) and (2W-1, d). Head dim d <= 128 (MAXD); the wrapper checks it.
extern "C" int sam_global_relpos_attn(const void* q, const void* k, const void* v,
                                      const void* band_h, const void* band_w, void* out,
                                      int B, int H, int W, int nh, int d, long long q_b,
                                      long long q_row, long long k_b, long long k_row,
                                      long long v_b, long long v_row, float scale,
                                      int is_bf16, int path, void* stream) {
  const Strides st{q_b, q_row, k_b, k_row, v_b, v_row};
  const float* bh = static_cast<const float*>(band_h);
  const float* bw = static_cast<const float*>(band_w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 2) {
    if (!is_bf16 || d % 8 || d > MAXD) return (int)cudaErrorInvalidValue;
    return (int)launch_wg(q, k, v, bh, bw, out, B, H, W, nh, d, st, scale, s);
  }
  if (path != 0) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(q, k, v, bh, bw, out, B, H, W, nh, d, st, scale, s);
  return (int)launch<float>(q, k, v, bh, bw, out, B, H, W, nh, d, st, scale, s);
}

// Dynamic shared memory one block of the path needs; the wrapper refuses
// grids above the card's 227 KB per block.
extern "C" size_t sam_global_relpos_attn_smem(int H, int W, int d, int path) {
  return path == 2 ? wg_smem_bytes(H, W, (d + 15) / 16 * 16) : smem_bytes(H, W, d);
}
