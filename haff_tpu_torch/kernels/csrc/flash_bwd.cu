// flash_bwd_dq, flash_bwd_dkv: flash-attention backward for the LLaMA
// training step.
//
// Replace haff_tpu/kernels/flash_attention.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel (launched by _bwd_impl, the custom_vjp backward of
// flash_attention).
//
// What they compute, per batch b, head h (q, k, v, dO in the (B, L, H, D)
// layout of the JAX package, read in place), from the forward's lse and
// delta = rowsum(dO * O) (computed by the wrapper, as JAX computes it in
// XLA outside its kernels):
//   s[i, j]  = scale * q_i . k_j + bias[b, h, i, j]
//   p[i, j]  = exp(s[i, j] - lse_i) where visible, else 0
//   ds[i, j] = p[i, j] * (dO_i . v_j - delta_i) * scale
//   dq_i = sum_j ds[i, j] k_j,  dk_j = sum_i ds[i, j] q_i,  dv_j = sum_i p[i, j] dO_i
// with the forward's masks: causal (j > i + Lk - Lq hidden) and segment ids
// (qseg[i] != kseg[j] or kseg[j] == 0 hidden). A fully-masked query row has
// lse = 0 and p = 0, so its dq is exactly 0; a key that no query sees gets
// dk = dv = 0 exactly. The bias is a constant (JAX returns zeros for it).
//
// What bounds them on Hopper: at the train shapes (B=2, L=575, 32 heads,
// D=128, causal) the work is 6*D*H*pairs FLOPs (dq) and 8*D*H*pairs (dk/dv)
// against ~4 (B, L, H, D) tensors of bytes: 0.014-0.017 ms of bytes, more
// than the bf16 tensor cores need for the operations. Both kernels have
// two paths, chosen by the wrapper (kernel_path) before the launch: the
// warpgroup-MMA path for bf16 with D % 16 == 0, D <= 128 and 16-byte
// aligned operands, the scalar path for float32 and the bf16 operands TMA
// cannot address. Any Lq, Lk >= 1 is taken: ragged edges are masked here,
// not padded by the caller.
//
// flash_bwd_dq:
//
// * warpgroup MMA, the query-major counterpart of dk/dv's path below. A
//   block owns 64 queries of one (batch, head): one consumer warpgroup and
//   a producer warp; blocks are launched longest causal rows first. Q and
//   dO stay in shared memory (TMA, once, the 128-byte swizzled boxes);
//   the producer streams the 64-key tiles of K and V through a two-stage
//   ring from tile 0 to the last tile a row of the block can see, and
//   stages each tile's key segment ids with a one-id flag. The rows' lse
//   (times log2 e), delta and segment ids sit in registers. Per tile the
//   warpgroup computes S = Q K^T and dP = dO V^T (wgmma m64n64k16, both
//   operands K-major in shared memory, as the forward's Q K^T), then P =
//   exp2(S scale log2 e - lse log2 e) where visible and dS = P (dP -
//   delta) scale in registers, with dk/dv's masks (only a warp's tiles
//   that straddle the diagonal, a ragged edge or a segment boundary test
//   elements), and dQ += dS K (wgmma m64n{D}k16, dS from registers as bf16
//   hi + lo, K as the transposed operand, as the forward's V). dQ stays in
//   f32 registers (64 a thread at D = 128) and is written once, staged
//   through shared memory in 16-byte chunks. No atomics: dq is not summed
//   inside the dk/dv kernel (FA3's design), so it does not depend on the
//   order blocks run in, and the two kernels stay JAX's two. Registers:
//   dQ (64), S and dP (2 x 32) and the dS fragments (32); the block is
//   160 threads and the register budget is set for two blocks an SM
//   (DQ_MIN_BLOCKS): ptxas gives 163 registers at D = 128, 168 with a
//   bias, no spills (chip_smoke.py's build log). A 128-query block of two
//   consumer warpgroups sharing the K / V stream, one block an SM, passed
//   the card tests but was slower by CUDA graph at the train shape
//   (tools/flash_ab.py against a scratch tree that differed in that
//   alone), so the block stays one warpgroup.
// * scalar: one block per (64-query tile, head, batch row); it loops over
//   the 64-key tiles up to the causal diagonal, keeping the tile's dq in
//   registers (32 f32 a thread), every product an f32 FMA out of shared
//   memory (inputs widened to f32 once per tile).
//
// flash_bwd_dkv:
//
// * warpgroup MMA (bf16, D % 16 == 0, D <= 128, 16-byte aligned
//   operands), FA2/FA3's key-major backward. A block owns 64 keys of one
//   (batch, head): one consumer warpgroup and a producer warp. The K and V
//   tiles stay in shared memory (TMA, once); the producer streams the
//   64-query tiles of Q and dO by TMA (the 128-byte swizzled boxes of
//   flash_prefill.cu) with their lse (times log2 e), delta and segment
//   ids through a two-stage ring, from the first tile that can see a key
//   of the block. Per tile the warpgroup computes S^T = K Q^T and dP^T =
//   V dO^T (wgmma m64n64k16, both operands from shared memory, keys as
//   M), then P^T = exp2(S^T scale log2 e - lse log2 e) where visible and
//   dS^T = P^T (dP^T - delta) scale in registers (the masks as in the
//   forward: only a warp's tiles that straddle the diagonal, a ragged edge
//   or a segment boundary take the per-element test), and dV += P^T dO,
//   dK += dS^T Q (wgmma m64n{D}k16, P^T and dS^T from registers, dO and Q
//   as transposed operands). P^T and dS^T enter as bf16 hi + lo halves:
//   rounded to bf16 alone they put ~140 of the dk and dv values outside
//   the bf16 tolerance at the train shape in a CPU emulation of the
//   rounding (tests/test_torch_flash_paths.py), at 2.5-2.7x; hi + lo
//   gives 0.45x, and on the card the largest error against the float32
//   plain version at that shape is 0.0155 (chip_smoke.py). dK and dV stay
//   in f32 registers (2 x 64 a thread at D = 128) and are written once,
//   through shared memory.
//   Register budget: with those accumulators, S^T and dP^T (2 x 32) and
//   the A fragments, one consumer warpgroup takes 255 registers a thread
//   without spilling at D = 128 (ptxas, `chip_smoke.py` build log; 12
//   bytes of spill with a bias). Two consumer warpgroups of 64 keys a
//   block, sharing the Q / dO stream, were capped at 168 registers a
//   thread by the 288-thread block and spilled 672 bytes (ptxas), and ran
//   slower; moving registers to them with setmaxnreg from a producer
//   warpgroup left ptxas at 168 with spills. So one warpgroup, one block
//   an SM.
// * scalar (float32, and bf16 operands the tensor-core path cannot
//   read): one block per (64-key tile, head, batch row); it loops over
//   the query tiles at or below the diagonal, keeping dk and dv in
//   registers (64 f32 a thread), every product an f32 FMA.
//
// Both kernels write their outputs like q, k and v, or, with `f32_out`,
// as float32 from the f32 accumulators: ring attention
// (parallel/ring_attention.py) sums one such partial a K/V chunk, and
// bf16 partials would round once a chunk before the sum.
#include <limits.h>
#include <stdint.h>

#include "common.cuh"
#include "tc.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int MAXD = 128;
constexpr int ACC = BQ * MAXD / THREADS;  // per-thread accumulators per (64 x D) tile
static_assert(BQ == BK, "the accumulator count assumes square tiles");

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;      // may be null
  const int32_t* qseg;    // may be null (then kseg is null too)
  const int32_t* kseg;
  const void* dout;       // like q
  const float* lse;       // (B, H, Lq)
  const float* delta;     // (B, H, Lq)
  void* dq;               // like q
  void* dk;               // like k
  void* dv;               // like v
  int64_t bias_sb, bias_sh, bias_si, bias_sj;
  int B, Lq, Lk, H, D;
  float scale;
  int causal;
  int f32_out;            // write dq / dk / dv as float32
};

// Visibility of key ja to query ia (absolute indices), given their
// segment ids as staged in shared memory.
__device__ __forceinline__ bool visible(int ia, int ja, int Lq, int Lk, int causal,
                                        int qs, int ks, bool seg) {
  bool ok = ia < Lq && ja < Lk;
  if (causal) ok = ok && ja <= ia + (Lk - Lq);
  if (seg) ok = ok && qs == ks && ks != 0;
  return ok;
}

// Load rows [r0, r0 + 64) of a (B, L, H, D) tensor for (b, h) into shared
// memory as f32 with row pitch `pitch`; rows at or past L read as 0.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int pitch, const T* src, int b, int h,
                                          int r0, int L, int H, int D) {
  for (int o = threadIdx.x; o < 64 * D; o += THREADS) {
    const int r = o / D, c = o - r * D;
    const int ra = r0 + r;
    dst[r * pitch + c] =
        (ra < L) ? haff::to_f(src[(((int64_t)b * L + ra) * H + h) * D + c]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(Params p) {
  const int Lq = p.Lq, Lk = p.Lk, H = p.H, D = p.D;
  const int i0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x;
  const int dp = D + 1;  // odd pitch: rows i, i+1 fall in different banks
  const int sp = BQ + 1;
  const int q_offset = Lk - Lq;
  const bool seg = p.kseg != nullptr;

  extern __shared__ float smem[];
  float* Qs = smem;                // BQ * dp
  float* dOs = Qs + BQ * dp;       // BQ * dp
  float* Ks = dOs + BQ * dp;       // BK * D
  float* Vs = Ks + BK * D;         // BK * D
  float* dS = Vs + BK * D;         // BK * sp, dS[j * sp + i]
  float* lse_s = dS + BK * sp;     // BQ
  float* dl_s = lse_s + BQ;        // BQ
  int* qs_s = reinterpret_cast<int*>(dl_s + BQ);  // BQ
  int* ks_s = qs_s + BQ;                          // BK

  load_tile(Qs, dp, static_cast<const T*>(p.q), b, h, i0, Lq, H, D);
  load_tile(dOs, dp, static_cast<const T*>(p.dout), b, h, i0, Lq, H, D);
  for (int i = tid; i < BQ; i += THREADS) {
    const int ia = i0 + i;
    const int64_t row = ((int64_t)b * H + h) * Lq + ia;
    lse_s[i] = (ia < Lq) ? p.lse[row] : 0.f;
    dl_s[i] = (ia < Lq) ? p.delta[row] : 0.f;
    qs_s[i] = (seg && ia < Lq) ? p.qseg[(int64_t)b * Lq + ia] : 0;
  }
  float acc[ACC];
#pragma unroll
  for (int r = 0; r < ACC; ++r) acc[r] = 0.f;

  // Last key any row of this block may see under the causal mask.
  const int k_end = p.causal ? min(Lk, q_offset + i0 + BQ) : Lk;
  for (int j0 = 0; j0 < k_end; j0 += BK) {
    __syncthreads();
    load_tile(Ks, D, static_cast<const T*>(p.k), b, h, j0, Lk, H, D);
    load_tile(Vs, D, static_cast<const T*>(p.v), b, h, j0, Lk, H, D);
    for (int j = tid; j < BK; j += THREADS)
      ks_s[j] = (seg && j0 + j < Lk) ? p.kseg[(int64_t)b * Lk + j0 + j] : 0;
    __syncthreads();

    // ds for the (query, key) pairs of this tile; a warp shares j and
    // walks 32 consecutive i (K/V reads broadcast, Q/dO rows conflict-free).
    for (int o = tid; o < BQ * BK; o += THREADS) {
      const int j = o / BQ, i = o - j * BQ;
      const int ia = i0 + i, ja = j0 + j;
      float ds = 0.f;
      if (visible(ia, ja, Lq, Lk, p.causal, qs_s[i], ks_s[j], seg)) {
        const float* qi = Qs + i * dp;
        const float* doi = dOs + i * dp;
        const float* kj = Ks + j * D;
        const float* vj = Vs + j * D;
        float s = 0.f, dpv = 0.f;
        for (int c = 0; c < D; ++c) {
          s = fmaf(qi[c], kj[c], s);
          dpv = fmaf(doi[c], vj[c], dpv);
        }
        s *= p.scale;
        if (p.bias)
          s += p.bias[b * p.bias_sb + h * p.bias_sh + ia * p.bias_si + ja * p.bias_sj];
        const float pr = expf(s - lse_s[i]);
        ds = pr * (dpv - dl_s[i]) * p.scale;
      }
      dS[j * sp + i] = ds;
    }
    __syncthreads();

    // dq[i, c] += sum_j ds[i, j] k[j, c]; a warp shares i, walks c.
#pragma unroll
    for (int r = 0; r < ACC; ++r) {
      const int o = tid + r * THREADS;
      if (o < BQ * D) {
        const int i = o / D, c = o - i * D;
        float a = acc[r];
        for (int j = 0; j < BK; ++j) a = fmaf(dS[j * sp + i], Ks[j * D + c], a);
        acc[r] = a;
      }
    }
  }

  T* dq = static_cast<T*>(p.dq);
#pragma unroll
  for (int r = 0; r < ACC; ++r) {
    const int o = tid + r * THREADS;
    if (o < BQ * D) {
      const int i = o / D, c = o - i * D;
      const int ia = i0 + i;
      if (ia < Lq) {
        const int64_t off = (((int64_t)b * Lq + ia) * H + h) * D + c;
        if (p.f32_out)
          static_cast<float*>(p.dq)[off] = acc[r];
        else
          dq[off] = haff::from_f<T>(acc[r]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(Params p) {
  const int Lq = p.Lq, Lk = p.Lk, H = p.H, D = p.D;
  const int j0 = blockIdx.x * BK;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x;
  const int dp = D + 1;
  const int sp = BK + 1;
  const int q_offset = Lk - Lq;
  const bool seg = p.kseg != nullptr;

  extern __shared__ float smem[];
  float* Ks = smem;                // BK * dp
  float* Vs = Ks + BK * dp;        // BK * dp
  float* Qs = Vs + BK * dp;        // BQ * D
  float* dOs = Qs + BQ * D;        // BQ * D
  float* P = dOs + BQ * D;         // BQ * sp, P[i * sp + j]
  float* dS = P + BQ * sp;         // BQ * sp
  float* lse_s = dS + BQ * sp;     // BQ
  float* dl_s = lse_s + BQ;        // BQ
  int* qs_s = reinterpret_cast<int*>(dl_s + BQ);  // BQ
  int* ks_s = qs_s + BQ;                          // BK

  load_tile(Ks, dp, static_cast<const T*>(p.k), b, h, j0, Lk, H, D);
  load_tile(Vs, dp, static_cast<const T*>(p.v), b, h, j0, Lk, H, D);
  for (int j = tid; j < BK; j += THREADS)
    ks_s[j] = (seg && j0 + j < Lk) ? p.kseg[(int64_t)b * Lk + j0 + j] : 0;
  float acc_k[ACC], acc_v[ACC];
#pragma unroll
  for (int r = 0; r < ACC; ++r) acc_k[r] = acc_v[r] = 0.f;

  // First query that may see key j0 under the causal mask, rounded down to
  // its tile; every later tile holds queries that see part of this block.
  const int q_begin = p.causal ? max(0, j0 - q_offset) / BQ * BQ : 0;
  for (int i0 = q_begin; i0 < Lq; i0 += BQ) {
    __syncthreads();
    load_tile(Qs, D, static_cast<const T*>(p.q), b, h, i0, Lq, H, D);
    load_tile(dOs, D, static_cast<const T*>(p.dout), b, h, i0, Lq, H, D);
    for (int i = tid; i < BQ; i += THREADS) {
      const int ia = i0 + i;
      const int64_t row = ((int64_t)b * H + h) * Lq + ia;
      lse_s[i] = (ia < Lq) ? p.lse[row] : 0.f;
      dl_s[i] = (ia < Lq) ? p.delta[row] : 0.f;
      qs_s[i] = (seg && ia < Lq) ? p.qseg[(int64_t)b * Lq + ia] : 0;
    }
    __syncthreads();

    // p and ds for the pairs of this tile; a warp shares i and walks 32
    // consecutive j (Q/dO reads broadcast, K/V rows conflict-free).
    for (int o = tid; o < BQ * BK; o += THREADS) {
      const int i = o / BK, j = o - i * BK;
      const int ia = i0 + i, ja = j0 + j;
      float pr = 0.f, ds = 0.f;
      if (visible(ia, ja, Lq, Lk, p.causal, qs_s[i], ks_s[j], seg)) {
        const float* qi = Qs + i * D;
        const float* doi = dOs + i * D;
        const float* kj = Ks + j * dp;
        const float* vj = Vs + j * dp;
        float s = 0.f, dpv = 0.f;
        for (int c = 0; c < D; ++c) {
          s = fmaf(qi[c], kj[c], s);
          dpv = fmaf(doi[c], vj[c], dpv);
        }
        s *= p.scale;
        if (p.bias)
          s += p.bias[b * p.bias_sb + h * p.bias_sh + ia * p.bias_si + ja * p.bias_sj];
        pr = expf(s - lse_s[i]);
        ds = pr * (dpv - dl_s[i]) * p.scale;
      }
      P[i * sp + j] = pr;
      dS[i * sp + j] = ds;
    }
    __syncthreads();

    // dv[j, c] += sum_i p[i, j] dO[i, c]; dk[j, c] += sum_i ds[i, j] q[i, c].
#pragma unroll
    for (int r = 0; r < ACC; ++r) {
      const int o = tid + r * THREADS;
      if (o < BK * D) {
        const int j = o / D, c = o - j * D;
        float av = acc_v[r], ak = acc_k[r];
        for (int i = 0; i < BQ; ++i) {
          av = fmaf(P[i * sp + j], dOs[i * D + c], av);
          ak = fmaf(dS[i * sp + j], Qs[i * D + c], ak);
        }
        acc_v[r] = av;
        acc_k[r] = ak;
      }
    }
  }

  T* dk = static_cast<T*>(p.dk);
  T* dv = static_cast<T*>(p.dv);
#pragma unroll
  for (int r = 0; r < ACC; ++r) {
    const int o = tid + r * THREADS;
    if (o < BK * D) {
      const int j = o / D, c = o - j * D;
      const int ja = j0 + j;
      if (ja < Lk) {
        const int64_t off = (((int64_t)b * Lk + ja) * H + h) * D + c;
        if (p.f32_out) {
          static_cast<float*>(p.dk)[off] = acc_k[r];
          static_cast<float*>(p.dv)[off] = acc_v[r];
        } else {
          dk[off] = haff::from_f<T>(acc_k[r]);
          dv[off] = haff::from_f<T>(acc_v[r]);
        }
      }
    }
  }
}

size_t dq_smem_bytes(int D) {
  return sizeof(float) * (2 * (size_t)BQ * (D + 1) + 2 * (size_t)BK * D +
                          (size_t)BK * (BQ + 1) + 3 * BQ + BK);
}

size_t dkv_smem_bytes(int D) {
  return sizeof(float) * (2 * (size_t)BK * (D + 1) + 2 * (size_t)BQ * D +
                          2 * (size_t)BQ * (BK + 1) + 3 * BQ + BK);
}

template <typename T>
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes(p.D);
  cudaError_t e = haff::allow_smem(flash_bwd_dq_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((p.Lq + BQ - 1) / BQ, p.B * p.H);
  flash_bwd_dq_kernel<T><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const Params& p, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes(p.D);
  cudaError_t e = haff::allow_smem(flash_bwd_dkv_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((p.Lk + BK - 1) / BK, p.B * p.H);
  flash_bwd_dkv_kernel<T><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---- flash_bwd_dkv on warpgroup MMA (bf16); the header has the design ----

constexpr int DKV_STAGES = 2;
constexpr int DKV_CONSUMERS = 128;  // one warpgroup, 64 keys
constexpr int BOX_BYTES = 64 * 128;  // one 64-row x 64-column box, swizzled
constexpr int ROWS = 68;             // per stage: 64 values of a row term + a flag

size_t dkv_wg_smem_bytes(int DP) {
  const size_t tile = (size_t)64 * DP * 2;
  return 1024 + (2 + 2 * DKV_STAGES) * tile + DKV_STAGES * 3 * ROWS * 4 +
         (2 * DKV_STAGES + 2) * sizeof(uint64_t) + 4 * 8 * (DP + 8) * 2;
}

template <int DP, bool BIAS>
__global__ void __launch_bounds__(DKV_CONSUMERS + 32, 1)
flash_bwd_dkv_wg_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const __grid_constant__ CUtensorMap domap, Params p) {
  namespace tc = haff::tc;
  constexpr int NO = DP / 8, KS = DP / 16, BOXES = DP / 64, SDS = DP + 8;
  constexpr int TILE = BOXES * BOX_BYTES;
  const int Lq = p.Lq, Lk = p.Lk, H = p.H, D = p.D;
  const int off = Lk - Lq;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int j0 = blockIdx.y * 64;  // the block's first key
  const bool seg = p.kseg != nullptr;
  const int nqt = (Lq + 63) / 64;
  const int q_first = p.causal ? max(0, j0 - off) / 64 : 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ uint4 smem_wg[];
  uint8_t* smem_raw = reinterpret_cast<uint8_t*>(smem_wg);
  uint8_t* kv = smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* stages = kv + 2 * TILE;  // after K and V: [stage][Q, dO]
  float* rows = reinterpret_cast<float*>(stages + DKV_STAGES * 2 * TILE);  // [stage][lse2, delta, qseg]
  uint64_t* full = reinterpret_cast<uint64_t*>(rows + DKV_STAGES * 3 * ROWS);
  uint64_t* empty = full + DKV_STAGES;
  uint64_t* kv_full = empty + DKV_STAGES;
  __nv_bfloat16* stage_out = reinterpret_cast<__nv_bfloat16*>(kv_full + 2);  // 16-byte aligned
  if (tid == 0) {
    for (int s = 0; s < DKV_STAGES; ++s) {
      tc::mbar_init(&full[s], 1);
      tc::mbar_init(&empty[s], DKV_CONSUMERS);
    }
    tc::mbar_init(kv_full, 1);
    tc::mbar_fence_init();
  }
  __syncthreads();

  if (warp == DKV_CONSUMERS / 32) {  // the producer
    if (lane == 0) {
      tc::mbar_expect_tx(kv_full, 2 * TILE);
#pragma unroll
      for (int x = 0; x < BOXES; ++x) {
        tc::tma_load_4d(kv + x * BOX_BYTES, &kmap, kv_full, 64 * x, h, j0, b);
        tc::tma_load_4d(kv + TILE + x * BOX_BYTES, &vmap, kv_full, 64 * x, h, j0, b);
      }
    }
    for (int qt = q_first; qt < nqt; ++qt) {
      const int it = qt - q_first, s = it % DKV_STAGES, use = it / DKV_STAGES, i0 = qt * 64;
      if (use > 0) tc::mbar_wait(&empty[s], (use - 1) & 1);
      float* r = rows + s * 3 * ROWS;
      int* qs = reinterpret_cast<int*>(r + 2 * ROWS);
      int mn = INT_MAX, mx = INT_MIN;
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int i = i0 + lane + 32 * x;
        const int64_t row = ((int64_t)b * H + h) * Lq + i;
        r[lane + 32 * x] = i < Lq ? p.lse[row] * tc::LOG2E : 0.f;
        r[ROWS + lane + 32 * x] = i < Lq ? p.delta[row] : 0.f;
        if (seg) {
          const int id = i < Lq ? p.qseg[(int64_t)b * Lq + i] : 0;
          qs[lane + 32 * x] = id;
          mn = min(mn, id);
          mx = max(mx, id);
        }
      }
      if (seg) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
          mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        }
        if (lane == 0) qs[64] = (mn == mx && mn != 0) ? mn : -1;
      }
      __syncwarp();
      if (lane == 0) {
        tc::mbar_expect_tx(&full[s], 2 * TILE);
        uint8_t* Qs = stages + s * 2 * TILE;
#pragma unroll
        for (int x = 0; x < BOXES; ++x) {
          tc::tma_load_4d(Qs + x * BOX_BYTES, &qmap, &full[s], 64 * x, h, i0, b);
          tc::tma_load_4d(Qs + TILE + x * BOX_BYTES, &domap, &full[s], 64 * x, h, i0, b);
        }
      }
    }
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  const int jw = j0 + warp * 16;  // the warp's first key
  int ks[2] = {0, 0}, wseg = -1;  // the rows' (keys') ids; the warp's one id or -1
  if (seg) {
    int mn = INT_MAX, mx = INT_MIN;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int j = jw + g + 8 * hf;
      if (j < Lk) {
        ks[hf] = p.kseg[(int64_t)b * Lk + j];
        mn = min(mn, ks[hf]);
        mx = max(mx, ks[hf]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
    wseg = (mn == mx && mn != 0) ? mn : -1;
  }
  const float* bias_col[2] = {nullptr, nullptr};  // bias[b, h, :, j] of the thread's keys
  if constexpr (BIAS)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      bias_col[hf] = p.bias + b * p.bias_sb + h * p.bias_sh +
                     (int64_t)min(jw + g + 8 * hf, Lk - 1) * p.bias_sj;

  const uint8_t* Kw = kv;
  const uint8_t* Vw = kv + TILE;
  float dk[NO * 4], dv[NO * 4];
#pragma unroll
  for (int x = 0; x < NO * 4; ++x) dk[x] = dv[x] = 0.f;
  float sT[32] = {}, dpT[32] = {};
  const float scale_log2 = p.scale * tc::LOG2E;
  tc::mbar_wait(kv_full, 0);
  for (int qt = q_first; qt < nqt; ++qt) {
    const int it = qt - q_first, st = it % DKV_STAGES, i0 = qt * 64;
    tc::mbar_wait(&full[st], (it / DKV_STAGES) & 1);
    const uint8_t* Qs = stages + st * 2 * TILE;
    const uint8_t* dOs = Qs + TILE;
    tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int o = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
      tc::wgmma_ss_n64(sT, tc::wg_desc_sw128(Kw + o, 16, 1024),
                       tc::wg_desc_sw128(Qs + o, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int o = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
      tc::wgmma_ss_n64(dpT, tc::wg_desc_sw128(Vw + o, 16, 1024),
                       tc::wg_desc_sw128(dOs + o, 16, 1024), kk > 0);
    }
    tc::wg_commit();
    tc::wg_wait<0>();
    tc::wg_hold(sT);
    tc::wg_hold(dpT);

    const float* lse2 = rows + st * 3 * ROWS;
    const float* delta = lse2 + ROWS;
    const int* qs = reinterpret_cast<const int*>(lse2 + 2 * ROWS);
    const bool mask = i0 + 64 > Lq || jw + 16 > Lk || (p.causal && jw + 15 > i0 + off) ||
                      (seg && (wseg < 0 || qs[64] != wseg));
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1, ii = n * 8 + 2 * t + (e & 1), i = i0 + ii;
        bool vis = true;
        if (mask) {
          const int j = jw + g + 8 * hf;
          vis = i < Lq && j < Lk && (!p.causal || j <= i + off) &&
                (!seg || (qs[ii] == ks[hf] && ks[hf] != 0));
        }
        float x = fmaf(sT[4 * n + e], scale_log2, -lse2[ii]);
        if constexpr (BIAS)
          if (vis) x = fmaf(bias_col[hf][(int64_t)i * p.bias_si], tc::LOG2E, x);
        const float pr = vis ? tc::exp2_approx(x) : 0.f;
        sT[4 * n + e] = pr;
        dpT[4 * n + e] = pr * (dpT[4 * n + e] - delta[ii]) * p.scale;
      }
    uint32_t phi[4][4], plo[4][4], dhi[4][4], dlo[4][4];
#pragma unroll
    for (int k4 = 0; k4 < 4; ++k4) {
      tc::split_p(reinterpret_cast<const float(&)[8][4]>(sT), k4, phi[k4], plo[k4]);
      tc::split_p(reinterpret_cast<const float(&)[8][4]>(dpT), k4, dhi[k4], dlo[k4]);
    }
    tc::wg_fence();
#pragma unroll
    for (int k4 = 0; k4 < 4; ++k4) {
      const uint64_t ddo = tc::wg_desc_sw128(dOs + k4 * 2048, BOX_BYTES, 1024);
      const uint64_t dqq = tc::wg_desc_sw128(Qs + k4 * 2048, BOX_BYTES, 1024);
      if constexpr (DP == 128) {
        tc::wgmma_n128<1>(dv, phi[k4], ddo, 1);
        tc::wgmma_n128<1>(dv, plo[k4], ddo, 1);
        tc::wgmma_n128<1>(dk, dhi[k4], dqq, 1);
        tc::wgmma_n128<1>(dk, dlo[k4], dqq, 1);
      } else {
        tc::wgmma_n64<1>(dv, phi[k4], ddo, 1);
        tc::wgmma_n64<1>(dv, plo[k4], ddo, 1);
        tc::wgmma_n64<1>(dk, dhi[k4], dqq, 1);
        tc::wgmma_n64<1>(dk, dlo[k4], dqq, 1);
      }
    }
    tc::wg_commit();
    tc::wg_wait<0>();
    tc::wg_hold(dv);
    tc::wg_hold(dk);
    tc::wg_hold(phi);
    tc::wg_hold(plo);
    tc::wg_hold(dhi);
    tc::wg_hold(dlo);
    tc::mbar_arrive(&empty[st]);  // this thread is done with the stage
  }

  const float one[2] = {1.f, 1.f};
  const int64_t base = ((int64_t)b * Lk * H + h) * D;
  if (p.f32_out) {
    tc::store_acc_f32<NO>(dk, one, static_cast<float*>(p.dk) + base, (long long)H * D, jw,
                          Lk, D / 8, lane);
    tc::store_acc_f32<NO>(dv, one, static_cast<float*>(p.dv) + base, (long long)H * D, jw,
                          Lk, D / 8, lane);
    return;
  }
  __nv_bfloat16* stage = stage_out + warp * 8 * SDS;
  tc::store_acc_staged<NO, SDS>(dk, one, static_cast<__nv_bfloat16*>(p.dk) + base,
                                (long long)H * D, jw, Lk, D / 8, stage, lane);
  tc::store_acc_staged<NO, SDS>(dv, one, static_cast<__nv_bfloat16*>(p.dv) + base,
                                (long long)H * D, jw, Lk, D / 8, stage, lane);
}

template <int DP, bool BIAS>
cudaError_t launch_dkv_wg_as(const Params& p, cudaStream_t stream) {
  namespace tc = haff::tc;
  CUtensorMap qmap, kmap, vmap, domap;
  if (!tc::bhld_map_sw128(&qmap, p.q, p.D, p.H, p.Lq, p.B) ||
      !tc::bhld_map_sw128(&kmap, p.k, p.D, p.H, p.Lk, p.B) ||
      !tc::bhld_map_sw128(&vmap, p.v, p.D, p.H, p.Lk, p.B) ||
      !tc::bhld_map_sw128(&domap, p.dout, p.D, p.H, p.Lq, p.B))
    return cudaErrorInvalidValue;
  const size_t smem = dkv_wg_smem_bytes(DP);
  cudaError_t e = haff::allow_smem(flash_bwd_dkv_wg_kernel<DP, BIAS>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(p.B * p.H, (p.Lk + 63) / 64);
  flash_bwd_dkv_wg_kernel<DP, BIAS>
      <<<grid, DKV_CONSUMERS + 32, smem, stream>>>(qmap, kmap, vmap, domap, p);
  return cudaGetLastError();
}

cudaError_t launch_dkv_wg(const Params& p, cudaStream_t stream) {
  if (p.D % 16 || p.D > 128) return cudaErrorInvalidValue;
  if (p.D > 64)
    return p.bias ? launch_dkv_wg_as<128, true>(p, stream)
                  : launch_dkv_wg_as<128, false>(p, stream);
  return p.bias ? launch_dkv_wg_as<64, true>(p, stream) : launch_dkv_wg_as<64, false>(p, stream);
}

// ---- flash_bwd_dq on warpgroup MMA (bf16); the header has the design ----

constexpr int DQ_STAGES = 2;
constexpr int DQ_CONSUMERS = 128;  // one warpgroup, 64 queries
constexpr int DQ_MIN_BLOCKS = 2;   // blocks an SM the register budget is set for

// Q and dO, the K / V ring, mbarriers (padded to an even count), the
// stages' key segment ids ([stage][64 ids + the tile's one id or -1 + 3]),
// each consumer warp's output staging; 1 KB of slack for the swizzle atom.
size_t dq_wg_smem_bytes(int DP) {
  const size_t tile = (size_t)64 * DP * 2;
  return 1024 + (2 + 2 * DQ_STAGES) * tile + (2 * DQ_STAGES + 2) * sizeof(uint64_t) +
         DQ_STAGES * 68 * sizeof(int) + 4 * 8 * (DP + 8) * 2;
}

template <int DP, bool BIAS>
__global__ void __launch_bounds__(DQ_CONSUMERS + 32, DQ_MIN_BLOCKS)
flash_bwd_dq_wg_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap domap, Params p) {
  namespace tc = haff::tc;
  constexpr int NO = DP / 8, KS = DP / 16, BOXES = DP / 64, SDS = DP + 8;
  constexpr int TILE = BOXES * BOX_BYTES;
  const int Lq = p.Lq, Lk = p.Lk, H = p.H, D = p.D;
  const int off = Lk - Lq;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int i0 = (gridDim.y - 1 - blockIdx.y) * 64;  // longest rows first
  const bool seg = p.kseg != nullptr;
  // Last key any row of the block may see under the causal mask.
  const int k_end = p.causal ? min(Lk, off + i0 + 64) : Lk;
  const int ntiles = k_end > 0 ? (k_end + 63) / 64 : 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ uint4 smem_wg[];
  uint8_t* smem_raw = reinterpret_cast<uint8_t*>(smem_wg);
  uint8_t* qdo = smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);  // [Q, dO]
  uint8_t* ring = qdo + 2 * TILE;  // [stage][K, V]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + DQ_STAGES * 2 * TILE);
  uint64_t* empty = full + DQ_STAGES;
  uint64_t* qdo_full = empty + DQ_STAGES;
  int* kseg_s = reinterpret_cast<int*>(full + 2 * DQ_STAGES + 2);
  __nv_bfloat16* stage_out = reinterpret_cast<__nv_bfloat16*>(kseg_s + DQ_STAGES * 68);
  if (tid == 0) {
    for (int s = 0; s < DQ_STAGES; ++s) {
      tc::mbar_init(&full[s], 1);
      tc::mbar_init(&empty[s], DQ_CONSUMERS);
    }
    tc::mbar_init(qdo_full, 1);
    tc::mbar_fence_init();
  }
  __syncthreads();

  if (warp == DQ_CONSUMERS / 32) {  // the producer
    if (lane == 0) {
      tc::mbar_expect_tx(qdo_full, 2 * TILE);
#pragma unroll
      for (int x = 0; x < BOXES; ++x) {
        tc::tma_load_4d(qdo + x * BOX_BYTES, &qmap, qdo_full, 64 * x, h, i0, b);
        tc::tma_load_4d(qdo + TILE + x * BOX_BYTES, &domap, qdo_full, 64 * x, h, i0, b);
      }
    }
    for (int tile = 0; tile < ntiles; ++tile) {
      const int s = tile % DQ_STAGES, use = tile / DQ_STAGES, j0 = tile * 64;
      if (use > 0) tc::mbar_wait(&empty[s], (use - 1) & 1);
      if (seg) {  // the tile's key ids, and the id if the tile holds one
        int* ks = kseg_s + s * 68;
        int mn = INT_MAX, mx = INT_MIN;
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int j = j0 + lane + 32 * x;
          const int id = j < Lk ? p.kseg[(int64_t)b * Lk + j] : 0;
          ks[lane + 32 * x] = id;
          mn = min(mn, id);
          mx = max(mx, id);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
          mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        }
        if (lane == 0) ks[64] = (mn == mx && mn != 0) ? mn : -1;
      }
      __syncwarp();
      if (lane == 0) {
        tc::mbar_expect_tx(&full[s], 2 * TILE);
        uint8_t* Ks = ring + s * 2 * TILE;
#pragma unroll
        for (int x = 0; x < BOXES; ++x) {
          tc::tma_load_4d(Ks + x * BOX_BYTES, &kmap, &full[s], 64 * x, h, j0, b);
          tc::tma_load_4d(Ks + TILE + x * BOX_BYTES, &vmap, &full[s], 64 * x, h, j0, b);
        }
      }
    }
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  const int row0 = i0 + warp * 16;  // the warp's first query
  float lse2[2], dlt[2];            // the thread's rows' lse (log2 units) and delta
  int qs[2] = {0, 0}, wseg = -1;    // the rows' ids; the warp's one id or -1
  int mn = INT_MAX, mx = INT_MIN;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int i = row0 + g + 8 * hf;
    const int64_t row = ((int64_t)b * H + h) * Lq + i;
    lse2[hf] = i < Lq ? p.lse[row] * tc::LOG2E : 0.f;
    dlt[hf] = i < Lq ? p.delta[row] : 0.f;
    if (seg && i < Lq) {
      qs[hf] = p.qseg[(int64_t)b * Lq + i];
      mn = min(mn, qs[hf]);
      mx = max(mx, qs[hf]);
    }
  }
  if (seg) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
    wseg = (mn == mx && mn != 0) ? mn : -1;
  }
  const float* bias_row[2] = {nullptr, nullptr};  // bias[b, h, i, :] of the thread's rows
  if constexpr (BIAS)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      bias_row[hf] = p.bias + b * p.bias_sb + h * p.bias_sh +
                     (int64_t)min(row0 + g + 8 * hf, Lq - 1) * p.bias_si;

  const uint8_t* Qs = qdo;
  const uint8_t* dOs = qdo + TILE;
  float dq[NO * 4];
#pragma unroll
  for (int x = 0; x < NO * 4; ++x) dq[x] = 0.f;
  float s[32] = {}, dp[32] = {};
  const float scale_log2 = p.scale * tc::LOG2E;
  tc::mbar_wait(qdo_full, 0);
  for (int tile = 0; tile < ntiles; ++tile) {
    const int st = tile % DQ_STAGES, j0 = tile * 64;
    tc::mbar_wait(&full[st], (tile / DQ_STAGES) & 1);
    const uint8_t* Ks = ring + st * 2 * TILE;
    const uint8_t* Vs = Ks + TILE;
    tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int o = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
      tc::wgmma_ss_n64(s, tc::wg_desc_sw128(Qs + o, 16, 1024),
                       tc::wg_desc_sw128(Ks + o, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int o = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
      tc::wgmma_ss_n64(dp, tc::wg_desc_sw128(dOs + o, 16, 1024),
                       tc::wg_desc_sw128(Vs + o, 16, 1024), kk > 0);
    }
    tc::wg_commit();
    tc::wg_wait<0>();
    tc::wg_hold(s);
    tc::wg_hold(dp);

    const int* ks = kseg_s + st * 68;
    const bool mask = j0 + 64 > Lk || row0 + 16 > Lq || (p.causal && j0 + 63 > row0 + off) ||
                      (seg && (wseg < 0 || ks[64] != wseg));
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1, jj = n * 8 + 2 * t + (e & 1), j = j0 + jj;
        bool vis = true;
        if (mask) {
          const int i = row0 + g + 8 * hf;
          vis = j < Lk && i < Lq && (!p.causal || j <= i + off) &&
                (!seg || (ks[jj] == qs[hf] && qs[hf] != 0));
        }
        float x = fmaf(s[4 * n + e], scale_log2, -lse2[hf]);
        if constexpr (BIAS)
          if (vis) x = fmaf(bias_row[hf][(int64_t)j * p.bias_sj], tc::LOG2E, x);
        const float pr = vis ? tc::exp2_approx(x) : 0.f;
        s[4 * n + e] = pr * (dp[4 * n + e] - dlt[hf]) * p.scale;  // dS
      }
    uint32_t dhi[4][4], dlo[4][4];
#pragma unroll
    for (int k4 = 0; k4 < 4; ++k4)
      tc::split_p(reinterpret_cast<const float(&)[8][4]>(s), k4, dhi[k4], dlo[k4]);
    tc::wg_fence();
#pragma unroll
    for (int k4 = 0; k4 < 4; ++k4) {
      const uint64_t dk = tc::wg_desc_sw128(Ks + k4 * 2048, BOX_BYTES, 1024);
      if constexpr (DP == 128) {
        tc::wgmma_n128<1>(dq, dhi[k4], dk, 1);
        tc::wgmma_n128<1>(dq, dlo[k4], dk, 1);
      } else {
        tc::wgmma_n64<1>(dq, dhi[k4], dk, 1);
        tc::wgmma_n64<1>(dq, dlo[k4], dk, 1);
      }
    }
    tc::wg_commit();
    tc::wg_wait<0>();
    tc::wg_hold(dq);
    tc::wg_hold(dhi);
    tc::wg_hold(dlo);
    tc::mbar_arrive(&empty[st]);  // this thread is done with the stage
  }

  const float one[2] = {1.f, 1.f};
  if (p.f32_out) {
    tc::store_acc_f32<NO>(dq, one,
                          static_cast<float*>(p.dq) + ((int64_t)b * Lq * H + h) * D,
                          (long long)H * D, row0, Lq, D / 8, lane);
    return;
  }
  tc::store_acc_staged<NO, SDS>(
      dq, one, static_cast<__nv_bfloat16*>(p.dq) + ((int64_t)b * Lq * H + h) * D,
      (long long)H * D, row0, Lq, D / 8, stage_out + warp * 8 * SDS, lane);
}

template <int DP, bool BIAS>
cudaError_t launch_dq_wg_as(const Params& p, cudaStream_t stream) {
  namespace tc = haff::tc;
  CUtensorMap qmap, kmap, vmap, domap;
  if (!tc::bhld_map_sw128(&qmap, p.q, p.D, p.H, p.Lq, p.B) ||
      !tc::bhld_map_sw128(&kmap, p.k, p.D, p.H, p.Lk, p.B) ||
      !tc::bhld_map_sw128(&vmap, p.v, p.D, p.H, p.Lk, p.B) ||
      !tc::bhld_map_sw128(&domap, p.dout, p.D, p.H, p.Lq, p.B))
    return cudaErrorInvalidValue;
  const size_t smem = dq_wg_smem_bytes(DP);
  cudaError_t e = haff::allow_smem(flash_bwd_dq_wg_kernel<DP, BIAS>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(p.B * p.H, (p.Lq + 63) / 64);
  flash_bwd_dq_wg_kernel<DP, BIAS>
      <<<grid, DQ_CONSUMERS + 32, smem, stream>>>(qmap, kmap, vmap, domap, p);
  return cudaGetLastError();
}

cudaError_t launch_dq_wg(const Params& p, cudaStream_t stream) {
  if (p.D % 16 || p.D > 128) return cudaErrorInvalidValue;
  if (p.D > 64)
    return p.bias ? launch_dq_wg_as<128, true>(p, stream)
                  : launch_dq_wg_as<128, false>(p, stream);
  return p.bias ? launch_dq_wg_as<64, true>(p, stream) : launch_dq_wg_as<64, false>(p, stream);
}

Params make_params(const void* q, const void* k, const void* v, const void* bias,
                   int64_t bias_sb, int64_t bias_sh, int64_t bias_si, int64_t bias_sj,
                   const void* qseg, const void* kseg, const void* dout, const void* lse,
                   const void* delta, int B, int Lq, int Lk, int H, int D, float scale,
                   int causal) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = static_cast<const float*>(bias);
  p.qseg = static_cast<const int32_t*>(qseg);
  p.kseg = static_cast<const int32_t*>(kseg);
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = p.dk = p.dv = nullptr;
  p.bias_sb = bias_sb;
  p.bias_sh = bias_sh;
  p.bias_si = bias_si;
  p.bias_sj = bias_sj;
  p.B = B;
  p.Lq = Lq;
  p.Lk = Lk;
  p.H = H;
  p.D = D;
  p.scale = scale;
  p.causal = causal;
  p.f32_out = 0;
  return p;
}

}  // namespace

// q/dout (B, Lq, H, D), k/v (B, Lk, H, D), one dtype (bf16 or f32); lse
// and delta (B, H, Lq) f32; bias f32 addressed as
// bias[b*sb + h*sh + i*si + j*sj] or null; qseg (B, Lq), kseg (B, Lk)
// int32, both null or both given. D <= 128. Writes dq (like q, or float32
// with f32_out).
// Paths (the wrapper's kernel_path): 0 scalar (bf16 or f32), 1 warpgroup
// MMA (bf16, D % 16 == 0, 16-byte aligned q, k, v, dout and dq).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* bias,
                            int64_t bias_sb, int64_t bias_sh, int64_t bias_si,
                            int64_t bias_sj, const void* qseg, const void* kseg,
                            const void* dout, const void* lse, const void* delta, void* dq,
                            int B, int Lq, int Lk, int H, int D, float scale, int causal,
                            int is_bf16, int path, int f32_out, void* stream) {
  Params p = make_params(q, k, v, bias, bias_sb, bias_sh, bias_si, bias_sj, qseg, kseg, dout,
                         lse, delta, B, Lq, Lk, H, D, scale, causal);
  p.dq = dq;
  p.f32_out = f32_out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 1) return is_bf16 ? (int)launch_dq_wg(p, s) : (int)cudaErrorInvalidValue;
  if (path != 0) return (int)cudaErrorInvalidValue;
  if (is_bf16) return (int)launch_dq<__nv_bfloat16>(p, s);
  return (int)launch_dq<float>(p, s);
}

// Same operands as flash_bwd_dq; writes dk (like k) and dv (like v), or
// both as float32 with f32_out.
// Paths (the wrapper's kernel_path): 0 scalar (bf16 or f32), 1 warpgroup
// MMA (bf16, D % 16 == 0, 16-byte aligned q, k, v, dout, dk and dv).
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* bias,
                             int64_t bias_sb, int64_t bias_sh, int64_t bias_si,
                             int64_t bias_sj, const void* qseg, const void* kseg,
                             const void* dout, const void* lse, const void* delta, void* dk,
                             void* dv, int B, int Lq, int Lk, int H, int D, float scale,
                             int causal, int is_bf16, int path, int f32_out,
                             void* stream) {
  Params p = make_params(q, k, v, bias, bias_sb, bias_sh, bias_si, bias_sj, qseg, kseg, dout,
                         lse, delta, B, Lq, Lk, H, D, scale, causal);
  p.dk = dk;
  p.dv = dv;
  p.f32_out = f32_out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 1) return is_bf16 ? (int)launch_dkv_wg(p, s) : (int)cudaErrorInvalidValue;
  if (path != 0) return (int)cudaErrorInvalidValue;
  if (is_bf16) return (int)launch_dkv<__nv_bfloat16>(p, s);
  return (int)launch_dkv<float>(p, s);
}

// Dynamic shared memory one block of the dq path needs at head dim D.
extern "C" size_t flash_bwd_dq_smem(int D, int path) {
  return path == 1 ? dq_wg_smem_bytes(D > 64 ? 128 : 64) : dq_smem_bytes(D);
}
// Dynamic shared memory one block of the dk/dv path needs at head dim D.
extern "C" size_t flash_bwd_dkv_smem(int D, int path) {
  return path == 1 ? dkv_wg_smem_bytes(D > 64 ? 128 : 64) : dkv_smem_bytes(D);
}
