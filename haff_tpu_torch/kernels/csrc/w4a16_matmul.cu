// w4a16_matmul: float activations times a packed-int4 weight with group
// scales, for the decode steps of a 4-bit model (small M).
//
// Replaces haff_tpu/nn/quant.py::_w4a16_kernel (launched by
// pallas_int4_matmul).
//
// What it computes:
//   out[m, n] = round_T(sum_k x[m, k] * W[n, k])
//   W[n, k]   = round_T(f32(nibble(n, k)) * scale[n, k / group])
// with x (M, K) in T (bf16 or f32), packed (N, K/2) uint8 where byte r of
// row n holds input 2r in its low nibble and 2r+1 in its high nibble, each
// a signed 4-bit value (v > 7 means v - 16), and scale (N, K/group) f32.
// The dequantized weight is rounded to T (round to nearest even) before
// the multiply, products accumulate in f32, the sum is rounded to T once.
// The nibbles are unpacked in registers: the weight crosses device memory
// packed, half a byte an element, and no float copy of it ever exists.
//
// What bounds it on Hopper: at decode (M = 2) the weight's bytes, 0.5625
// an element with the f32 scale of each 64 (11008 x 4096: 25.4 MB, 7.6 us
// at 3.35 TB/s). At 1.75-1.98 GHz the card issues about 5 lane-
// instructions in the time it streams one element, so the instructions
// an element decide whether the bytes bound. Two kernels on two paths,
// chosen by the wrapper (nn/quant.py w4a16_path) before the launch:
//   * mma (bf16 x, 1 <= M <= 256, group % 16 == 0, K % 32 == 0,
//     K / group % 4 == 0 and <= 1024, 16-byte aligned bases; every 4-bit
//     product of LLaMA-7B): bf16 mma.sync.m16n8k16 with the weight as
//     the A operand. A block owns 16 output columns (the 16 A rows), so
//     ceil(N / 16) blocks (256 at 4096, 2001 at lm_head), and up to 8 or
//     16 activation rows (B is x^T, (K, 8) column-major); for M > 16 the
//     grid's fastest axis walks M tiles of 16, so the blocks that share
//     weight rows run together and re-read them from L2. The block's 16
//     scale rows are copied whole once (pitch an odd multiple of 4
//     words: a warp's 8 row groups read distinct banks). A ring of 4
//     stages, three in flight, streams 512 K of the 16 packed rows (256
//     bytes each, pitch 320, so a warp's 16-byte reads are conflict-free)
//     and of the activation rows (pitch 1056, 16-byte chunks swizzled by
//     bit 3 of their index) by 16-byte cp.async, as the W8A8 skinny path
//     does: no tensor map, each thread's sources fixed once. Rows past N
//     or M are zero fill; rows a lane never holds (g >= M for M < 8) are
//     zero registers. Each of the 4 warps takes one 128-K super-span a
//     stage; at the end the warps add their 16 x 8 f32 tiles through
//     shared memory in warp order. The launch is programmatic (it may
//     start while the previous kernel ends), and the kernel reads nothing
//     before that kernel has finished.
//     K permutation: a dot product does not care about the order of K
//     if A and B agree. Lane (g, t) = (lane / 4, lane % 4) reads 16 bytes
//     of packed rows g and g + 8: words j = 0..3 hold the super-span's
//     physical K 32t + 8j .. 32t + 8j + 7. Word j feeds two k16 steps:
//     its bytes 0 and 1 (k +0,1 and +2,3 of the word, standing for the
//     mma's logical k 2t, 2t+1 and 2t+8, 2t+9) give a0/a1 and a2/a3 of
//     the first, bytes 2 and 3 those of the second; the matching x values
//     are one 16-byte read of x row g. No shuffles, no ldmatrix. The mma
//     chain alternates between two accumulator sets (even and odd words).
//     Exact dequantization, 31 instructions a word of 8 elements: lo =
//     (w & 0x0F0F0F0F) ^ 0x08080808 and hi = ((w >> 4) & ..) ^ .. (one
//     LOP3 each and a shift: each byte is v + 8), then for each element a
//     PRMT that builds 0x4B0000vv, an FADD of -8388616 (exactly v; no
//     quarter-rate I2F), the f32 multiply by the group scale as the plain
//     version does it, and half a cvt.rn.bf16x2.f32 (RNE, as torch
//     rounds). cuobjdump -sass of the built library (M <= 8): 3.9 lane-
//     instructions an element for the dequantization, 5.7 for the whole
//     stage loop (364 a stage, 64 elements a lane), once per element per
//     M tile; ptxas -v: 96 registers at M <= 4, 95 at M <= 8, 112 at
//     M <= 16, no spills. So the loop is bound by issue (5.7 against the
//     ~5 the bytes allow), not by bytes; the products run on the tensor
//     cores, exact in f32.
//   * scalar (path 0: f32 activations and what the mma kernel cannot
//     read; the first port's kernel): a block owns 8 output columns, one
//     a warp; the warp streams its weight row once over all of K, 4 bytes
//     (8 inputs) a lane a step, coalesced, while the block stages the
//     activations' matching K chunk in shared memory as f32 for all its
//     warps. A lane holds one f32 accumulator for each of up to MT
//     activation rows; a warp reduction ends the column. For M > MT the
//     grid's second axis walks row groups. group % 8 == 0 keeps a lane's
//     8 inputs inside one scale group (the wrapper asks for group % 16 ==
//     0, as the JAX package does).
#include <stdint.h>

#include "common.cuh"
#include "tc.cuh"

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


// ---- the mma path; the header has the design ----

constexpr int MM_COLS = 16;            // output columns (weight rows) a block
constexpr int MM_WARPS = 4;            // each a 128-K super-span of a stage
constexpr int MM_THREADS = 32 * MM_WARPS;
constexpr int MM_KC = 128 * MM_WARPS;  // K a stage
constexpr int MM_STAGES = 4;
constexpr int MM_WP = MM_KC / 2 + 64;         // packed row pitch in bytes
constexpr int MM_XP = 2 * MM_KC + 32;         // activation row pitch in bytes

__host__ __device__ constexpr int mm_stage_bytes(int mr) {
  return MM_COLS * MM_WP + mr * MM_XP;
}

// Scale row pitch in floats: ng + 4, or ng + 8, so that the pitch is an odd
// multiple of 4 words and the 8 row groups of a warp read distinct banks.
__host__ __device__ constexpr int mm_scale_pitch(int ng) {
  return ((ng + 4) / 4) % 2 ? ng + 4 : ng + 8;
}

// k / group for k % 16 == 0 and k < 2^24: (k + 8) / group lies at least
// 8 / group away from an integer, far above the float error.
__device__ __forceinline__ int group_of(int k, float inv_group) {
  return (int)__fmul_rn(__fadd_rn((float)k, 8.f), inv_group);
}

__device__ __forceinline__ uint32_t and_xor(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;  // (a & b) ^ c in one LOP3; plain C gives an AND and an XOR
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// The 8 signed nibbles of a packed word times `sc` in f32, rounded to
// bf16 pairs: d[b] holds elements 2b (low half) and 2b + 1 (byte b).
__device__ __forceinline__ void dequant8(uint32_t w, float sc, uint32_t (&d)[4]) {
  const uint32_t lo = and_xor(w, 0x0F0F0F0Fu, 0x08080808u);  // v + 8, even elements
  const uint32_t hi = and_xor(w >> 4, 0x0F0F0F0Fu, 0x08080808u);
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    // 0x4B0000vv is the float 2^23 + vv; minus 2^23 + 8 it is exactly v.
    const float e = __int_as_float(__byte_perm(lo, 0x4B000000u, 0x7540 | b)) - 8388616.f;
    const float o = __int_as_float(__byte_perm(hi, 0x4B000000u, 0x7540 | b)) - 8388616.f;
    d[b] = haff::tc::pack_bf16(__fmul_rn(e, sc), __fmul_rn(o, sc));
  }
}

__device__ __forceinline__ uint4 lds128(const uint8_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

template <int MR>
__global__ void __launch_bounds__(MM_THREADS, 4)
w4a16_mma_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ packed,
                 const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, int M,
                 int N, int K, int group, float inv_group, int lg_group) {
  namespace tc = haff::tc;
  constexpr int NT = (MR + 7) / 8;  // n8 tiles of activation rows
  constexpr int SB = mm_stage_bytes(MR);
  constexpr int XA = MM_COLS * MM_WP;                 // a stage's activation area
  constexpr int WCPR = MM_KC / 32, XCPR = MM_KC / 8;  // 16-byte chunks of a stage row
  constexpr int WU = MM_COLS * WCPR / MM_THREADS;     // packed chunks a thread a stage
  constexpr int XU = (MR * XCPR + MM_THREADS - 1) / MM_THREADS;
  extern __shared__ uint4 mm_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * MR;
  const long n0 = (long)blockIdx.y * MM_COLS;
  const int ng = K / group, nch = (K + MM_KC - 1) / MM_KC, half = K / 2;
  const int spitch = mm_scale_pitch(ng);
  float* scs = reinterpret_cast<float*>(mm_smem);  // the block's 16 scale rows, whole
  uint8_t* ring = reinterpret_cast<uint8_t*>(mm_smem) + 4 * MM_COLS * spitch;
  // k / group for k % 16 == 0: a shift where the group is a power of two.
  auto grp = [&](int k) { return lg_group >= 0 ? k >> lg_group : group_of(k, inv_group); };

  // Launched early (programmatic dependent launch): the launch overlaps
  // the previous kernel's end, and nothing is read before it has finished
  // and its writes (x, or a new weight) are visible.
  asm volatile("griddepcontrol.wait;" ::: "memory");
  // The scale rows, once, with the first stage; rows past N are zeros.
  for (int i = tid, cpr = ng / 4; i < MM_COLS * cpr; i += MM_THREADS) {
    const int r = i / cpr, c = i - r * cpr;
    const bool ok = n0 + r < N;
    tc::cp_async16(scs + r * spitch + 4 * c, scale + (ok ? (n0 + r) * ng + 4 * c : 0),
                   ok ? 16 : 0);
  }
  // Each thread's share of a stage's copies, the same at every stage: WU
  // chunks of packed rows and XU of activation rows; sources and
  // destinations are fixed once, a stage adds its K. Rows past N or M copy
  // nothing (zero fill) from a valid address.
  const int wr = tid / WCPR, wc = 16 * (tid % WCPR), xr = tid / XCPR, xc = tid % XCPR;
  const uint8_t* wsrc[WU];
  bool w_ok[WU];
#pragma unroll
  for (int u = 0; u < WU; ++u) {
    const long n = n0 + wr + u * (MM_THREADS / WCPR);
    w_ok[u] = n < N;
    wsrc[u] = packed + (w_ok[u] ? n : 0) * half + wc;
  }
  const __nv_bfloat16* xsrc[XU];
  bool x_ok[XU];
#pragma unroll
  for (int u = 0; u < XU; ++u) {
    const int r = xr + u * (MM_THREADS / XCPR);
    x_ok[u] = r < MR && m0 + r < M;
    xsrc[u] = x + (long)(x_ok[u] ? m0 + r : 0) * K + 8 * xc;
  }
  const int wdst = wr * MM_WP + wc, xdst = XA + xr * MM_XP + 16 * (xc ^ ((xc >> 3) & 1));
  auto load = [&](int c) {
    uint8_t* st = ring + (c % MM_STAGES) * SB;
    const int kc = c * MM_KC;
    const bool wk = wc + kc / 2 < half, xk = kc + 8 * xc < K;
#pragma unroll
    for (int u = 0; u < WU; ++u)
      tc::cp_async16(st + wdst + u * (MM_THREADS / WCPR) * MM_WP, wsrc[u] + (wk ? kc / 2 : 0),
                     w_ok[u] && wk ? 16 : 0);
#pragma unroll
    for (int u = 0; u < XU; ++u)
      if (MR * XCPR % MM_THREADS == 0 || xr + u * (MM_THREADS / XCPR) < MR)
        tc::cp_async16(st + xdst + u * (MM_THREADS / XCPR) * MM_XP, xsrc[u] + (xk ? kc : 0),
                       x_ok[u] && xk ? 16 : 0);
  };

  float acc[2][NT][4];  // two chains of mma, even and odd words
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[h][j][0] = acc[h][j][1] = acc[h][j][2] = acc[h][j][3] = 0.f;

#pragma unroll
  for (int c = 0; c < MM_STAGES - 1; ++c) {
    if (c < nch) load(c);
    tc::cp_async_commit();
  }
  const float* sg = scs + g * spitch;  // the lane's scale rows g and g + 8
  for (int c = 0; c < nch; ++c) {
    tc::cp_async_wait<MM_STAGES - 2>();  // stage c has landed (this thread's copies)
    __syncthreads();                     // everyone's; and slot c - 1 is free
    if (c + MM_STAGES - 1 < nch) load(c + MM_STAGES - 1);
    tc::cp_async_commit();
    const int kc = c * MM_KC;
    const uint8_t* st = ring + (c % MM_STAGES) * SB;
    const uint8_t* xs = st + XA;
    const int so = 128 * warp;   // the warp's super-span in the stage
    if (kc + so >= K) continue;  // past K (the last stage)
    const uint4 wa = lds128(st + g * MM_WP + so / 2 + 16 * t);
    const uint4 wb = lds128(st + (g + 8) * MM_WP + so / 2 + 16 * t);
    // Words 0-1 and 2-3 each lie in one 16-K block, so in one group.
    const int kl = kc + so + 32 * t;
    const int s0 = min(grp(kl), ng - 1), s1 = min(grp(kl + 16), ng - 1);
    const float sa0 = sg[s0], sa1 = sg[s1];
    const float sb0 = sg[8 * spitch + s0], sb1 = sg[8 * spitch + s1];
    uint4 xv[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int row = 8 * j + g;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int ch = so / 8 + 4 * t + q;
        xv[j][q] = row < MR ? lds128(xs + row * MM_XP + 16 * (ch ^ ((ch >> 3) & 1)))
                            : make_uint4(0, 0, 0, 0);
      }
    }
    const uint32_t wsa[4] = {wa.x, wa.y, wa.z, wa.w}, wsb[4] = {wb.x, wb.y, wb.z, wb.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t da[4], db[4];
      dequant8(wsa[q], q < 2 ? sa0 : sa1, da);
      dequant8(wsb[q], q < 2 ? sb0 : sb1, db);
      const uint32_t a0[4] = {da[0], db[0], da[1], db[1]};
      const uint32_t a1[4] = {da[2], db[2], da[3], db[3]};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        tc::mma(acc[q & 1][j], a0, xv[j][q].x, xv[j][q].y);
        tc::mma(acc[q & 1][j], a1, xv[j][q].z, xv[j][q].w);
      }
    }
  }

  // The warps' tiles meet in shared memory, added in warp order.
  tc::cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      red[((warp * NT + j) * 4 + i) * 32 + lane] = acc[0][j][i] + acc[1][j][i];
  __syncthreads();
  for (int e = tid; e < NT * 128; e += MM_THREADS) {
    const int j = e >> 7, i = (e >> 5) & 3, l = e & 31;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < MM_WARPS; ++w) v += red[((w * NT + j) * 4 + i) * 32 + l];
    const long n = n0 + (l >> 2) + 8 * (i >> 1);  // C rows are weight rows
    const int m = m0 + 8 * j + 2 * (l & 3) + (i & 1);
    if (m < M && n < N) out[(long)m * N + n] = __float2bfloat16(v);
  }
}

template <int MR>
cudaError_t launch_mma_mr(const __nv_bfloat16* x, const uint8_t* packed, const float* scale,
                          __nv_bfloat16* out, int M, int N, int K, int group,
                          cudaStream_t stream) {
  const size_t smem =
      (size_t)MM_STAGES * mm_stage_bytes(MR) + 4 * MM_COLS * mm_scale_pitch(K / group);
  static size_t allowed = 0;  // raised as far as a launch needed
  if (smem > allowed) {
    const cudaError_t e = haff::allow_smem(w4a16_mma_kernel<MR>, smem);
    if (e != cudaSuccess) return e;
    allowed = smem;
  }
  int lg = -1;
  for (int b = 0; b < 30; ++b)
    if (group == 1 << b) lg = b;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((M + MR - 1) / MR, (N + MM_COLS - 1) / MM_COLS);
  cfg.blockDim = dim3(MM_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, w4a16_mma_kernel<MR>, x, packed, scale, out, M, N,
                                     K, group, 1.f / (float)group, lg);
  return e != cudaSuccess ? e : cudaGetLastError();
}

cudaError_t launch_mma(const void* xv, const void* pv, const void* sv, void* ov, int M, int N,
                       int K, int group, cudaStream_t stream) {
  const auto* x = static_cast<const __nv_bfloat16*>(xv);
  const auto* packed = static_cast<const uint8_t*>(pv);
  const auto* scale = static_cast<const float*>(sv);
  auto* out = static_cast<__nv_bfloat16*>(ov);
  if (M < 1 || K % 32 || group % 16 || K % group || (K / group) % 4 || K / group > 1024 ||
      K >= (1 << 24) ||
      (N + MM_COLS - 1) / MM_COLS > 65535 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(packed) % 16 || reinterpret_cast<uintptr_t>(scale) % 16)
    return cudaErrorInvalidValue;
  if (M <= 1) return launch_mma_mr<1>(x, packed, scale, out, M, N, K, group, stream);
  if (M <= 2) return launch_mma_mr<2>(x, packed, scale, out, M, N, K, group, stream);
  if (M <= 4) return launch_mma_mr<4>(x, packed, scale, out, M, N, K, group, stream);
  if (M <= 8) return launch_mma_mr<8>(x, packed, scale, out, M, N, K, group, stream);
  return launch_mma_mr<16>(x, packed, scale, out, M, N, K, group, stream);
}
}  // namespace

// Paths (the wrapper's w4a16_path): 0 the scalar kernel (bf16 or f32 x),
// 1 the bf16 mma kernel (the header lists what it reads). x (M, K) in the
// output type (out_bf16: bf16, else f32), packed (N, K/2) uint8, scale
// (N, K/group) f32, out (M, N), all row-major.
extern "C" int w4a16_matmul(const void* x, const void* packed, const void* scale, void* out,
                            int M, int N, int K, int group, int is_bf16, int path,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    if (!is_bf16) return (int)cudaErrorInvalidValue;
    return (int)launch_mma(x, packed, scale, out, M, N, K, group, s);
  }
  if (path != 0) return (int)cudaErrorInvalidValue;
  if (is_bf16) return (int)launch<__nv_bfloat16>(x, packed, scale, out, M, N, K, group, s);
  return (int)launch<float>(x, packed, scale, out, M, N, K, group, s);
}
