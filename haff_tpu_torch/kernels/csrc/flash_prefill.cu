// flash_prefill_fwd: flash-attention forward for the LLaMA prefill.
//
// Replaces haff_tpu/kernels/flash_attention.py::_fwd_kernel (launched by
// _fwd_impl through flash_attention).
//
// What it computes, per batch b, head h and query i (q, k, v in the
// (B, L, H, D) layout of the JAX package, read in place):
//   s[i, j] = scale * q_i . k_j + bias[b, h, i, j]
//   masked where causal and j > i + (Lk - Lq), or where segment ids are
//   given and (qseg[i] != kseg[j] or kseg[j] == 0)
//   o_i     = softmax_j(s[i, :]) @ V,   lse_i = log sum_j exp(s[i, j])
// A fully-masked row gives o = 0 and lse = 0, as the TPU kernel does.
// Blocks walk the key tiles with an online softmax; key tiles wholly
// above the causal diagonal are never loaded. Any Lq, Lk >= 1 is taken:
// the ragged edge is masked here, not padded by the caller. The bias is
// optional (a null pointer means none) and is read through four strides,
// so a bias broadcast over batch, heads or rows is never materialised.
//
// What bounds it on Hopper: at the prefill shapes (B=2, L=575, 32 heads,
// D=128, causal) ~4*D*H*pairs = 5.5 GFLOP against 4 (B, L, H, D) tensors
// of 9.4 MB: 0.0113 ms of bytes against 0.0055 ms of bf16 tensor-core
// operations, both far below a launch's fixed costs, so the design aims
// at keeping the tensor cores fed. Two paths, chosen by the wrapper
// (kernel_path) before the launch:
//
// * warpgroup MMA (bf16, D % 16 == 0, D <= 128, 16-byte aligned
//   operands). A block owns 128 query rows of one (batch, head): two
//   consumer warpgroups of 64 rows and a producer warp. The producer
//   streams the head's 64-key K and V tiles by TMA through a ring of
//   STAGES stages (full / empty mbarrier pairs) from 4-d tensor maps of
//   the operands read in place, and stages each tile's key segment ids
//   (and whether they are one id) in shared memory. The tiles use the
//   128-byte swizzle, two 64-column boxes at D = 128: a box row is 128
//   contiguous bytes, so each TMA request moves whole 32-byte sectors,
//   where the unswizzled core-matrix layout of sam_global_attn.cu would
//   take 16 boxes of 16-byte rows a tile at D = 128. TMA zero-fills
//   columns past D and keys past Lk (575 = 4 * 128 + 63). Each consumer
//   loads its q fragments once from device memory (registers, the A
//   operand), runs S = Q K^T as a wgmma m64n64k16 chain over D, and the
//   online softmax in registers with exp2 and log2 e folded into the
//   scale; a tile is masked element by element only where a warp's 16
//   rows straddle the diagonal, the ragged edge (keys or queries) or a
//   segment boundary; a tile entirely visible takes no per-element test.
//   The bias, when given (a template flag), is read from device memory
//   into the score fragment. P V is a wgmma m64n128k16 (n64 at D <= 64)
//   with P from registers and the V tile as the transposed operand. P
//   enters as bf16 hi + lo halves (tc::split_p, two products a k-step):
//   P rounded to bf16 alone, as the JAX kernel does (`p.astype`), put 23
//   outputs outside the bf16 tolerance |err| <= 1e-3 + 2^-7 |ref| at the
//   prefill shape in a CPU emulation of the rounding
//   (tests/test_torch_flash_paths.py), worst at 1.8x the tolerance; hi +
//   lo gave 0.45x, and on the card the largest error against the float32
//   plain version at that shape is 0.0077 (chip_smoke.py). The consumers
//   never meet at a block barrier. O is
//   normalised, rounded to bf16 and stored through shared memory in
//   16-byte chunks; lse as f32. Query tiles are launched longest first
//   (the causal diagonal makes the last tiles the longest).
// * scalar (float32, and bf16 operands the tensor-core path cannot
//   read): every product an f32 FMA from shared memory, one block a 64
//   query rows, load, S, softmax and P V apart at block barriers.
#include <limits.h>
#include <stdint.h>

#include "common.cuh"
#include "tc.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int MAXD = 128;
constexpr int ACC = BQ * MAXD / THREADS;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;      // may be null
  const int32_t* qseg;    // may be null (then kseg is null too)
  const int32_t* kseg;
  void* out;
  float* lse;             // (B, H, Lq)
  int64_t bias_sb, bias_sh, bias_si, bias_sj;
  int B, Lq, Lk, H, D;
  float scale;
  int causal;
  int f32_out;            // write out as float32 (ring attention's partials)
};

template <typename T>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(Params p) {
  using haff::from_f;
  using haff::to_f;
  const int Lq = p.Lq, Lk = p.Lk, H = p.H, D = p.D;
  const int i0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int dp = D + 1;
  const int sp = BQ + 1;
  const int q_offset = Lk - Lq;
  const bool seg = p.kseg != nullptr;

  extern __shared__ float smem[];
  float* Qs = smem;               // BQ * dp
  float* Ks = Qs + BQ * dp;       // BK * D
  float* Vs = Ks + BK * D;        // BK * D
  float* S = Vs + BK * D;         // BK * sp, S[j * sp + i]
  float* m_s = S + BK * sp;       // BQ
  float* l_s = m_s + BQ;          // BQ
  float* a_s = l_s + BQ;          // BQ
  int* qs_s = reinterpret_cast<int*>(a_s + BQ);  // BQ
  int* ks_s = qs_s + BQ;                         // BK

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  for (int o = tid; o < BQ * D; o += THREADS) {
    const int i = o / D, c = o - i * D;
    const int ia = i0 + i;
    Qs[i * dp + c] = (ia < Lq) ? to_f(q[(((int64_t)b * Lq + ia) * H + h) * D + c]) : 0.f;
  }
  for (int i = tid; i < BQ; i += THREADS) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
    qs_s[i] = (seg && i0 + i < Lq) ? p.qseg[(int64_t)b * Lq + i0 + i] : 0;
  }
  float acc[ACC];
#pragma unroll
  for (int r = 0; r < ACC; ++r) acc[r] = 0.f;

  // Last key any row of this block may see under the causal mask.
  const int k_end = p.causal ? min(Lk, q_offset + i0 + BQ) : Lk;
  for (int j0 = 0; j0 < k_end; j0 += BK) {
    __syncthreads();
    for (int o = tid; o < BK * D; o += THREADS) {
      const int j = o / D, c = o - j * D;
      const int ja = j0 + j;
      const bool ok = ja < Lk;
      const int64_t off = (((int64_t)b * Lk + ja) * H + h) * D + c;
      Ks[o] = ok ? to_f(k[off]) : 0.f;
      Vs[o] = ok ? to_f(v[off]) : 0.f;
    }
    for (int j = tid; j < BK; j += THREADS)
      ks_s[j] = (seg && j0 + j < Lk) ? p.kseg[(int64_t)b * Lk + j0 + j] : 0;
    __syncthreads();

    for (int o = tid; o < BQ * BK; o += THREADS) {
      const int j = o / BQ, i = o - j * BQ;
      const int ia = i0 + i, ja = j0 + j;
      bool ok = ia < Lq && ja < Lk;
      if (p.causal) ok = ok && ja <= ia + q_offset;
      if (seg) ok = ok && qs_s[i] == ks_s[j] && ks_s[j] != 0;
      float s = -INFINITY;
      if (ok) {
        const float* qi = Qs + i * dp;
        const float* kj = Ks + j * D;
        float dot = 0.f;
        for (int c = 0; c < D; ++c) dot = fmaf(qi[c], kj[c], dot);
        s = dot * p.scale;
        if (p.bias)
          s += p.bias[b * p.bias_sb + h * p.bias_sh + ia * p.bias_si + ja * p.bias_sj];
      }
      S[j * sp + i] = s;
    }
    __syncthreads();

    for (int i = warp; i < BQ; i += THREADS / 32) {
      float mx = -INFINITY;
      for (int j = lane; j < BK; j += 32) mx = fmaxf(mx, S[j * sp + i]);
      mx = haff::warp_max(mx);
      const float m_old = m_s[i];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < BK; j += 32) {
        const float e = (m_new == -INFINITY) ? 0.f : expf(S[j * sp + i] - m_new);
        S[j * sp + i] = e;
        sum += e;
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
      if (o < BQ * D) {
        const int i = o / D, c = o - i * D;
        float a = acc[r] * a_s[i];
        for (int j = 0; j < BK; ++j) a = fmaf(S[j * sp + i], Vs[j * D + c], a);
        acc[r] = a;
      }
    }
  }
  __syncthreads();

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int r = 0; r < ACC; ++r) {
    const int o = tid + r * THREADS;
    if (o < BQ * D) {
      const int i = o / D, c = o - i * D;
      const int ia = i0 + i;
      if (ia < Lq) {
        const float l = l_s[i];
        const int64_t off = (((int64_t)b * Lq + ia) * H + h) * D + c;
        const float val = l == 0.f ? 0.f : acc[r] / l;
        if (p.f32_out)
          static_cast<float*>(p.out)[off] = val;
        else
          out[off] = from_f<T>(val);
      }
    }
  }
  for (int i = tid; i < BQ; i += THREADS) {
    const int ia = i0 + i;
    if (ia < Lq) {
      const float l = l_s[i];
      p.lse[((int64_t)b * H + h) * Lq + ia] = (l == 0.f) ? 0.f : m_s[i] + logf(l);
    }
  }
}

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)BQ * (D + 1) + 2 * (size_t)BK * D +
                          (size_t)BK * (BQ + 1) + 4 * BQ + BK);
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.D);
  cudaError_t e = haff::allow_smem(flash_fwd_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((p.Lq + BQ - 1) / BQ, p.B * p.H);
  flash_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---- bf16 warpgroup-MMA path ----

constexpr int WG_BQ = 128;                     // query rows a block
constexpr int WG_BK = 64;                      // keys a tile
constexpr int STAGES = 4;
constexpr int WG_CONSUMERS = 256;              // two warpgroups
constexpr int WG_THREADS = WG_CONSUMERS + 32;  // and the producer warp
constexpr int BOX_BYTES = WG_BK * 128;         // one 64-column box of a tile

// Dynamic shared memory of the path (DP = D rounded up to 64): the ring
// (K and V tiles, key segment ids and their flag a stage), mbarriers,
// output staging; 1 KB of slack to align the ring to the swizzle atom.
size_t wg_smem_bytes(int DP) {
  return 1024 + STAGES * (2 * (size_t)WG_BK * DP * 2 + (WG_BK + 4) * sizeof(int)) +
         2 * STAGES * sizeof(uint64_t) + 8 * 8 * (DP + 8) * sizeof(__nv_bfloat16);
}

template <int DP, bool BIAS>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_fwd_wg_kernel(const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, Params p) {
  namespace tc = haff::tc;
  constexpr int KS = DP / 16, NO = DP / 8, BOXES = DP / 64, SDS = DP + 8;
  constexpr int TILE_BYTES = BOXES * BOX_BYTES;  // one K or V tile
  const int Lq = p.Lq, Lk = p.Lk, H = p.H, D = p.D;
  const int off = Lk - Lq;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int i0 = (gridDim.y - 1 - blockIdx.y) * WG_BQ;  // longest first
  const bool seg = p.kseg != nullptr;
  const int k_end = p.causal ? min(Lk, off + i0 + WG_BQ) : Lk;
  const int ntiles = k_end > 0 ? (k_end + WG_BK - 1) / WG_BK : 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ uint4 smem_wg[];
  uint8_t* smem_raw = reinterpret_cast<uint8_t*>(smem_wg);
  uint8_t* ring = smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  int* kseg_s = reinterpret_cast<int*>(ring + STAGES * 2 * TILE_BYTES);  // [stage][64 + 4]
  uint64_t* full = reinterpret_cast<uint64_t*>(kseg_s + STAGES * (WG_BK + 4));
  uint64_t* empty = full + STAGES;
  __nv_bfloat16* stage_out = reinterpret_cast<__nv_bfloat16*>(empty + STAGES);
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      tc::mbar_init(&full[s], 1);
      tc::mbar_init(&empty[s], WG_CONSUMERS);
    }
    tc::mbar_fence_init();
  }
  __syncthreads();

  if (warp == WG_CONSUMERS / 32) {  // the producer
    for (int tile = 0; tile < ntiles; ++tile) {
      const int s = tile % STAGES, use = tile / STAGES, j0 = tile * WG_BK;
      if (use > 0) tc::mbar_wait(&empty[s], (use - 1) & 1);
      if (seg) {  // the tile's key ids, and the id if the tile holds one
        int* ks = kseg_s + s * (WG_BK + 4);
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
        if (lane == 0) ks[WG_BK] = (mn == mx && mn != 0) ? mn : -1;
      }
      __syncwarp();
      if (lane == 0) {
        tc::mbar_expect_tx(&full[s], 2 * TILE_BYTES);
        uint8_t* Ks = ring + s * 2 * TILE_BYTES;
#pragma unroll
        for (int x = 0; x < BOXES; ++x) {
          tc::tma_load_4d(Ks + x * BOX_BYTES, &kmap, &full[s], 64 * x, h, j0, b);
          tc::tma_load_4d(Ks + TILE_BYTES + x * BOX_BYTES, &vmap, &full[s], 64 * x, h, j0, b);
        }
      }
    }
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2;
  const int row0 = i0 + warp * 16;  // the warp's first query row
  // Key tiles this warpgroup's 64 rows can see (the block loads the
  // other warpgroup's extra tile; this one only releases it).
  const int wg_end = p.causal ? min(Lk, off + i0 + 64 * wg + 64) : Lk;
  const int wg_tiles = wg_end > 0 ? (wg_end + WG_BK - 1) / WG_BK : 0;
  uint32_t qf[KS][4];
  tc::load_q<KS>(qf, static_cast<const __nv_bfloat16*>(p.q) + ((int64_t)b * Lq * H + h) * D,
                 (long long)H * D, row0, Lq, D, lane);
  int qs[2] = {0, 0}, wseg = -1;  // the rows' ids; the warp's one id or -1
  if (seg) {
    int mn = INT_MAX, mx = INT_MIN;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = row0 + g + 8 * hf;
      if (i < Lq) {
        qs[hf] = p.qseg[(int64_t)b * Lq + i];
        mn = min(mn, qs[hf]);
        mx = max(mx, qs[hf]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
    wseg = (mn == mx && mn != 0) ? mn : -1;
  }
  const float* bias_row[2] = {nullptr, nullptr};
  if constexpr (BIAS)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      bias_row[hf] = p.bias + b * p.bias_sb + h * p.bias_sh +
                     (int64_t)min(row0 + g + 8 * hf, Lq - 1) * p.bias_si;

  float o[NO * 4];
#pragma unroll
  for (int x = 0; x < NO * 4; ++x) o[x] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float s[32] = {};
  const float scale_log2 = p.scale * tc::LOG2E;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int st = tile % STAGES, j0 = tile * WG_BK;
    tc::mbar_wait(&full[st], (tile / STAGES) & 1);
    if (tile < wg_tiles) {  // uniform over the warpgroup
      const uint8_t* Ks = ring + st * 2 * TILE_BYTES;
      const uint8_t* Vs = Ks + TILE_BYTES;
      tc::wg_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        tc::wgmma_n64<0>(s, qf[kk],
                         tc::wg_desc_sw128(Ks + (kk / 4) * BOX_BYTES + (kk % 4) * 32, 16, 1024),
                         kk > 0);
      tc::wg_commit();
      tc::wg_wait<0>();
      tc::wg_hold(s);

      const int* ks = kseg_s + st * (WG_BK + 4);
      const bool mask = j0 + WG_BK > Lk || row0 + 16 > Lq ||
                        (p.causal && j0 + WG_BK - 1 > row0 + off) ||
                        (seg && (wseg < 0 || ks[WG_BK] != wseg));
      float mx[2] = {-INFINITY, -INFINITY};
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
          float x = s[4 * n + e] * scale_log2;
          if constexpr (BIAS)
            if (vis) x = fmaf(bias_row[hf][(int64_t)j * p.bias_sj], tc::LOG2E, x);
          x = vis ? x : -INFINITY;
          s[4 * n + e] = x;
          mx[hf] = fmaxf(mx[hf], x);
        }
      float use[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
        mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
        const float m_new = fmaxf(m[hf], mx[hf]);
        use[hf] = m_new == -INFINITY ? 0.f : m_new;  // a row with nothing visible yet
        const float alpha = tc::exp2_approx(m[hf] - use[hf]);
        m[hf] = m_new;
        l[hf] *= alpha;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          o[4 * n + 2 * hf] *= alpha;
          o[4 * n + 2 * hf + 1] *= alpha;
        }
      }
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const float pr = tc::exp2_approx(s[x] - use[(x >> 1) & 1]);
        s[x] = pr;
        l[(x >> 1) & 1] += pr;
      }
      uint32_t phi[4][4], plo[4][4];
#pragma unroll
      for (int ks4 = 0; ks4 < 4; ++ks4)
        tc::split_p(reinterpret_cast<const float(&)[8][4]>(s), ks4, phi[ks4], plo[ks4]);
      tc::wg_fence();
#pragma unroll
      for (int ks4 = 0; ks4 < 4; ++ks4) {
        const uint64_t dv = tc::wg_desc_sw128(Vs + ks4 * 2048, BOX_BYTES, 1024);
        if constexpr (DP == 128) {
          tc::wgmma_n128<1>(o, phi[ks4], dv, 1);
          tc::wgmma_n128<1>(o, plo[ks4], dv, 1);
        } else {
          tc::wgmma_n64<1>(o, phi[ks4], dv, 1);
          tc::wgmma_n64<1>(o, plo[ks4], dv, 1);
        }
      }
      tc::wg_commit();
      tc::wg_wait<0>();
      tc::wg_hold(o);
      tc::wg_hold(phi);
      tc::wg_hold(plo);
    }
    tc::mbar_arrive(&empty[st]);  // this thread is done with the stage
  }

  float inv[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
    inv[hf] = l[hf] > 0.f ? 1.f / l[hf] : 0.f;
    const int i = row0 + g + 8 * hf;
    if (t == 0 && i < Lq)
      p.lse[((int64_t)b * H + h) * Lq + i] =
          l[hf] > 0.f ? (m[hf] + __log2f(l[hf])) * 0.6931471805599453f : 0.f;
  }
  if (p.f32_out) {
    tc::store_acc_f32<NO>(o, inv, static_cast<float*>(p.out) + ((int64_t)b * Lq * H + h) * D,
                          (long long)H * D, row0, Lq, D / 8, lane);
    return;
  }
  tc::store_acc_staged<NO, SDS>(
      o, inv, static_cast<__nv_bfloat16*>(p.out) + ((int64_t)b * Lq * H + h) * D,
      (long long)H * D, row0, Lq, D / 8, stage_out + warp * 8 * SDS, lane);
}

template <int DP, bool BIAS>
cudaError_t launch_wg_as(const Params& p, cudaStream_t stream) {
  CUtensorMap kmap, vmap;
  if (!haff::tc::bhld_map_sw128(&kmap, p.k, p.D, p.H, p.Lk, p.B) ||
      !haff::tc::bhld_map_sw128(&vmap, p.v, p.D, p.H, p.Lk, p.B))
    return cudaErrorInvalidValue;
  const size_t smem = wg_smem_bytes(DP);
  cudaError_t e = haff::allow_smem(flash_fwd_wg_kernel<DP, BIAS>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(p.B * p.H, (p.Lq + WG_BQ - 1) / WG_BQ);
  flash_fwd_wg_kernel<DP, BIAS><<<grid, WG_THREADS, smem, stream>>>(kmap, vmap, p);
  return cudaGetLastError();
}

cudaError_t launch_wg(const Params& p, cudaStream_t stream) {
  if (p.D % 16 || p.D > 128) return cudaErrorInvalidValue;
  if (p.D > 64)
    return p.bias ? launch_wg_as<128, true>(p, stream) : launch_wg_as<128, false>(p, stream);
  return p.bias ? launch_wg_as<64, true>(p, stream) : launch_wg_as<64, false>(p, stream);
}

}  // namespace

// Paths (the wrapper's kernel_path): 0 scalar (bf16 or f32), 1 warpgroup
// MMA (bf16, D % 16 == 0, 16-byte aligned q, k, v and out).
// q (B, Lq, H, D), k/v (B, Lk, H, D), out like q (float32 with f32_out),
// lse (B, H, Lq) f32;
// bias f32 addressed as bias[b*sb + h*sh + i*si + j*sj] or null; qseg
// (B, Lq), kseg (B, Lk) int32, both null or both given. D <= 128.
extern "C" int flash_prefill_fwd(const void* q, const void* k, const void* v,
                                 const void* bias, int64_t bias_sb, int64_t bias_sh,
                                 int64_t bias_si, int64_t bias_sj, const void* qseg,
                                 const void* kseg, void* out, void* lse, int B, int Lq,
                                 int Lk, int H, int D, float scale, int causal,
                                 int is_bf16, int path, int f32_out, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = static_cast<const float*>(bias);
  p.qseg = static_cast<const int32_t*>(qseg);
  p.kseg = static_cast<const int32_t*>(kseg);
  p.out = out;
  p.lse = static_cast<float*>(lse);
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
  p.f32_out = f32_out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 1) return is_bf16 ? (int)launch_wg(p, s) : (int)cudaErrorInvalidValue;
  if (path != 0) return (int)cudaErrorInvalidValue;
  if (is_bf16) return (int)launch<__nv_bfloat16>(p, s);
  return (int)launch<float>(p, s);
}

// Dynamic shared memory one block of the path needs at head dim D.
extern "C" size_t flash_prefill_fwd_smem(int D, int path) {
  return path == 1 ? wg_smem_bytes(D > 64 ? 128 : 64) : smem_bytes(D);
}
