// sam_window_relpos_attn: windowed ViT attention with the decomposed
// relative-position bias, for the windowed blocks of every SAM ViT
// (ViT-H 16 heads x 80, ViT-L 16 x 64, ViT-B 12 x 64, the small preset
// 8 x 32 at 8 x 8 windows) and any window (wh, ww), square or not.
//
// Replaces the windowed Pallas kernels of haff_tpu/kernels/sam_attention.py,
// which compute one function under different operand layouts:
//   _window_qkv_kernel_db_iband  (band in-kernel, split or fused operands)
//   _window_qkv_kernel_db        (band table from HBM, fused or split)
//   _window_qkv_kernel           (head loop, geometries the two above refuse)
//   _window_kernel               (per-head q, k, v)
// The TPU variants exist because of lane blocking (128-lane head halves,
// tile-pad rows, group sizes dividing the window count); none of that
// constrains this kernel, so one kernel serves all four.
//
// What it computes, per window w, head h and query i of the window:
//   Bh[i, r] = q_i . rel_h[row(i) - r + wh - 1]     (r < wh)
//   Bw[i, c] = q_i . rel_w[col(i) - c + ww - 1]     (c < ww)
//   s[i, j]  = scale * q_i . k_j + Bh[i, row(j)] + Bw[i, col(j)]
//   o_i      = softmax_j(s[i, :]) @ V
// The band (Bh, Bw) is built inside the kernel from the raw (2w-1, d)
// rel-pos tables, as the TPU kernel builds it from q @ Rall in its body;
// the (L, L) bias never exists in device memory.
//
// Operands: q, k and v are three base pointers, each with a window stride
// and a row stride in elements; element (window, row i, head h, k) lies at
// base + window * ws + i * rs + h * d + k. That reads in place, with no
// copy: the column-split projection (q3 (nwin, L, C), kv3 (nwin, L, 2C):
// k = kv3, v = kv3 + C, row stride 2C), the fused projection (nwin, L, 3C)
// (k = qkv + C, v = qkv + 2C, row stride 3C) and separate per-head
// (nwin, L, nh, d) tensors (row stride C). The output is (nwin, L, C)
// contiguous, the same memory as (nwin, L, nh, d). There are no tile-pad
// rows: L is the window area (196 at ViT-H), the ragged tail is masked
// here, and any window count is a grid dimension.
//
// What bounds it on Hopper: one window-head is tiny (196 x 80), so the
// work is ~4*L*L*d FLOPs per window-head against ~4*L*d*2 bytes; at
// ViT-H that is ~130 FLOP/byte, under the card's ~295 bf16 ridge: bytes,
// if the operands are read once and everything else stays on chip; in
// practice latency, since a block's phases (loads, band, S, softmax, P V,
// stores) run one after another. The bf16 path: one block of 8 warps owns
// a whole window-head (no query-chunk grid axis), so q, k and v are read
// from device memory once. K and V are staged by 16-byte cp.async (2 x 36
// KB at ViT-H, rows padded by 16 bytes so ldmatrix is conflict-free; two
// blocks, 16 warps, share an SM, which registers and shared memory cap).
// Each warp takes 16-query m-tiles in turn (13 cover 196 rows), its q
// fragments loaded straight into registers, and runs S = Q K^T and
// O += P V on the tensor cores (mma.sync m16n8k16, f32 sums) over 64-key
// slices of the resident K and V with an online softmax; S and P never
// leave registers. V is converted to fp16 in shared memory once a block
// when every value fits (|v| <= 65504: exact for |v| >= 2^-14, below
// that fp16 is subnormal and the error is at most 2^-25 absolute), and
// P V takes fp16 P (the same bounds); a block whose V does not fit keeps
// bf16 and P's hi + lo halves (tc.cuh says why P cannot be rounded to
// bf16 alone). The band runs on the
// tensor cores too (tc::band_rows: q @ rel^T over the table rows the
// warp's queries use, the f32 tables staged as bf16 hi + lo halves, each
// sum stored where its offset lands: JAX's b_all = q @ Rall and select)
// into a per-warp table [16][wh + ww + 1]; a score looks up its key's two
// cells in a per-block table (keys past the end hit a -inf column, so
// every slice runs one code path). O leaves through the warp's table area
// eight rows at a time, as whole 16-byte chunks of rows.
//
// The tensor-core path needs bf16 operands with 16-byte aligned bases,
// window and row strides that are multiples of 8 elements and d % 8 == 0
// (the wrapper's `_tensor_core_ok`). Everything else (float32 operands,
// which the card's float32 checks hold to 1e-4, and bf16 views a 16-byte
// copy cannot read) takes the scalar path below: f32 FMAs out of shared
// memory, every load of one element (any alignment, any row stride), one
// block per (window, head, 32-query chunk) with the window's K and V as
// f32 in shared memory.
#include "common.cuh"
#include "tc.cuh"

namespace {

constexpr int QC = 32;        // query rows per block
constexpr int THREADS = 256;  // 8 warps

// Window and row strides of q, k and v, in elements.
struct Strides {
  long long q_win, q_row, k_win, k_row, v_win, v_row;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
window_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ rel_h,
                   const float* __restrict__ rel_w, T* __restrict__ out, int wh, int ww,
                   int nh, int d, Strides st, float scale) {
  using haff::from_f;
  using haff::to_f;
  const int L = wh * ww;
  const int C = nh * d;
  const int i0 = blockIdx.z * QC;
  const int h = blockIdx.y;
  const long long win = blockIdx.x;  // windows on x: no 65535 limit
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int dp = d + 1;     // padded Q row: conflict-free column reads
  const int sp = QC + 1;    // padded score column

  extern __shared__ float smem[];
  float* Ks = smem;                       // L * d
  float* Vs = Ks + L * d;                 // L * d
  float* Qs = Vs + L * d;                 // QC * dp
  float* S = Qs + QC * dp;                // L * sp, S[j * sp + i]
  float* Bh = S + L * sp;                 // QC * wh
  float* Bw = Bh + QC * wh;               // QC * ww
  float* inv_l = Bw + QC * ww;            // QC
  float* Rh = inv_l + QC;                 // (2wh-1) * d
  float* Rw = Rh + (2 * wh - 1) * d;      // (2ww-1) * d

  const T* qbase = q + win * st.q_win + (long long)h * d;
  const T* kbase = k + win * st.k_win + (long long)h * d;
  const T* vbase = v + win * st.v_win + (long long)h * d;

  for (int o = tid; o < L * d; o += THREADS) {
    const int j = o / d, c = o - j * d;
    Ks[o] = to_f(kbase[j * st.k_row + c]);
    Vs[o] = to_f(vbase[j * st.v_row + c]);
  }
  for (int o = tid; o < QC * d; o += THREADS) {
    const int i = o / d, c = o - i * d;
    Qs[i * dp + c] = (i0 + i < L) ? to_f(qbase[(i0 + i) * st.q_row + c]) : 0.f;
  }
  for (int o = tid; o < (2 * wh - 1) * d; o += THREADS) Rh[o] = rel_h[o];
  for (int o = tid; o < (2 * ww - 1) * d; o += THREADS) Rw[o] = rel_w[o];
  __syncthreads();

  // Band of the chunk's queries: QC x (wh + ww) dot products.
  const int nb = wh + ww;
  for (int o = tid; o < QC * nb; o += THREADS) {
    const int i = o / nb, r = o - i * nb;
    const int ia = min(i0 + i, L - 1);
    const float* rel = (r < wh) ? Rh + ((ia / ww) - r + wh - 1) * d
                                : Rw + ((ia % ww) - (r - wh) + ww - 1) * d;
    const float* qi = Qs + i * dp;
    float acc = 0.f;
    for (int c = 0; c < d; ++c) acc = fmaf(qi[c], rel[c], acc);
    if (r < wh) Bh[i * wh + r] = acc;
    else Bw[i * ww + (r - wh)] = acc;
  }
  __syncthreads();

  // Scores: a warp holds one key j and 32 consecutive queries i.
  for (int o = tid; o < QC * L; o += THREADS) {
    const int j = o / QC, i = o - j * QC;
    const float* qi = Qs + i * dp;
    const float* kj = Ks + j * d;
    float acc = 0.f;
    for (int c = 0; c < d; ++c) acc = fmaf(qi[c], kj[c], acc);
    S[j * sp + i] = acc * scale + Bh[i * wh + j / ww] + Bw[i * ww + j % ww];
  }
  __syncthreads();

  // Softmax over keys: one warp per query row.
  for (int i = warp; i < QC; i += THREADS / 32) {
    float mx = -INFINITY;
    for (int j = lane; j < L; j += 32) mx = fmaxf(mx, S[j * sp + i]);
    mx = haff::warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float p = expf(S[j * sp + i] - mx);
      S[j * sp + i] = p;
      sum += p;
    }
    sum = haff::warp_sum(sum);
    if (lane == 0) inv_l[i] = 1.f / sum;
  }
  __syncthreads();

  T* obase = out + win * L * C + (long)h * d;
  for (int o = tid; o < QC * d; o += THREADS) {
    const int i = o / d, c = o - i * d;
    if (i0 + i >= L) continue;
    float acc = 0.f;
    for (int j = 0; j < L; ++j) acc = fmaf(S[j * sp + i], Vs[j * d + c], acc);
    obase[(long)(i0 + i) * C + c] = from_f<T>(acc * inv_l[i]);
  }
}

size_t smem_bytes(int wh, int ww, int d) {
  const size_t L = (size_t)wh * ww;
  return sizeof(float) * (2 * L * d + QC * (d + 1) + L * (QC + 1) + QC * (wh + ww) +
                          QC + (2 * wh - 1) * d + (2 * ww - 1) * d);
}

// ---- bf16 tensor-core path ----

constexpr int TC_WARPS = 8;
constexpr int TC_SLICE = 64;  // keys per online-softmax step

// Rows of each staged rel-pos table: 2n - 1 rounded up to 8.
inline __host__ __device__ int rel_rows(int wh, int ww) {
  return (2 * (wh > ww ? wh : ww) - 1 + 7) / 8 * 8;
}

// Floats of a warp's area: its band table [16][wh + ww + 1] (the last
// column -inf), which also stages 8 rows of O ((dp + 8) bf16 each) on the
// way out. A multiple of 4 (16-byte aligned areas).
inline __host__ __device__ int warp_area(int wh, int ww, int dp) {
  const int band = 16 * (wh + ww + 1), rows = 8 * (dp + 8) / 2;
  return ((band > rows ? band : rows) + 3) / 4 * 4;
}

// Shared memory: K and V of the whole window (lp = L rounded up to 16
// rows, row stride dp + 8 elements), the rel-pos tables as bf16 hi and lo
// halves (4 x rel_rows x (dp + 8)), the band-table cells of every key of
// the slices (L rounded up to 64), and an area per warp.
size_t tc_smem_bytes(int wh, int ww, int dp) {
  const size_t lp = ((size_t)wh * ww + 15) / 16 * 16;
  const size_t ls = ((size_t)wh * ww + TC_SLICE - 1) / TC_SLICE * TC_SLICE;
  return (2 * lp + 4 * (size_t)rel_rows(wh, ww)) * (dp + 8) * sizeof(__nv_bfloat16) +
         ls * sizeof(int) + (size_t)TC_WARPS * warp_area(wh, ww, dp) * sizeof(float);
}

template <int DP>
__global__ void __launch_bounds__(TC_WARPS * 32, 2)
window_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const float* __restrict__ rel_h,
                 const float* __restrict__ rel_w, __nv_bfloat16* __restrict__ out, int wh,
                 int ww, int nh, int d, Strides st, float scale) {
  namespace tc = haff::tc;
  constexpr int KS = DP / 16, NO = DP / 8, DS = DP + 8;
  constexpr int CHUNKS = DP / 8;  // 16-byte chunks of a staged row
  const int L = wh * ww, C = nh * d, HW = wh + ww + 1;
  const int lp = (L + 15) / 16 * 16, ls = (L + TC_SLICE - 1) / TC_SLICE * TC_SLICE;
  const int h = blockIdx.y;
  const long long win = blockIdx.x;  // windows on x: no 65535 limit
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3, g = lane >> 2;
  const int nd = d / 8;

  extern __shared__ uint4 smem_tc[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_tc);  // [lp][DS]
  __nv_bfloat16* Vs = Ks + lp * DS;                                // [lp][DS]
  __nv_bfloat16* Rs = Vs + lp * DS;  // [h hi, h lo, w hi, w lo][rr][DS]
  const int rr = rel_rows(wh, ww);
  // Band-table cells of each key: Bh at cell & 0xffff, Bw at cell >> 16.
  int* rc = reinterpret_cast<int*>(Rs + 4 * rr * DS);
  float* tab = reinterpret_cast<float*>(rc + ls) + warp * warp_area(wh, ww, DP);
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(tab);

  const __nv_bfloat16* kbase = k + win * st.k_win + (long long)h * d;
  const __nv_bfloat16* vbase = v + win * st.v_win + (long long)h * d;
  for (int o = tid; o < lp * CHUNKS; o += TC_WARPS * 32) {
    const int j = o / CHUNKS, c = (o - j * CHUNKS) * 8;
    const bool ok = j < L && c < d;
    const long long jj = ok ? j : 0;
    tc::cp_async16(Ks + j * DS + c, kbase + jj * st.k_row + (ok ? c : 0), ok ? 16 : 0);
    tc::cp_async16(Vs + j * DS + c, vbase + jj * st.v_row + (ok ? c : 0), ok ? 16 : 0);
  }
  tc::cp_async_commit();
  for (int j = tid; j < ls; j += TC_WARPS * 32) {
    const int r = j / ww;
    // Keys past the end read the -inf column twice.
    rc[j] = j < L ? r | ((wh + j - r * ww) << 16) : (HW - 1) | ((HW - 1) << 16);
  }
  // The rel-pos tables as bf16 hi + lo pairs (band_rows' B operand), zero
  // past row 2n - 1 and column d.
  // (The wrapper passes 16-byte aligned tables; d % 8 == 0 keeps rows so.)
#pragma unroll 4
  for (int o = tid; o < 2 * rr * (DP / 4); o += TC_WARPS * 32) {
    const int part = o / (rr * (DP / 4)), rem = o - part * rr * (DP / 4);
    const int m = rem / (DP / 4), c = (rem - m * (DP / 4)) * 4;
    const float* rel = part ? rel_w : rel_h;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m < 2 * (part ? ww : wh) - 1 && c < d)
      x = *reinterpret_cast<const float4*>(rel + m * d + c);
    uint2 hi, lo;
    tc::split_bf16(x.x, x.y, hi.x, lo.x);
    tc::split_bf16(x.z, x.w, hi.y, lo.y);
    *reinterpret_cast<uint2*>(Rs + ((2 * part) * rr + m) * DS + c) = hi;
    *reinterpret_cast<uint2*>(Rs + ((2 * part + 1) * rr + m) * DS + c) = lo;
  }
  tc::cp_async_wait<0>();
  __syncthreads();
  // V in fp16 when every value fits (|v| <= 65504), so P V is one fp16
  // product a k-step: exact for 2^-14 <= |v| (bf16's 8 significant bits
  // fit fp16's 11); below 2^-14 fp16 is subnormal and rounds to 2^-24
  // steps, an error of at most 2^-25 absolute. A block whose V does not
  // fit keeps bf16 and P's hi + lo halves.
  bool big = false;
  for (int o = tid; o < lp * (DP / 2); o += TC_WARPS * 32) {
    const int j = o / (DP / 2), c = (o - j * (DP / 2)) * 2;
    const float2 x =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(Vs + j * DS + c));
    big |= !(fabsf(x.x) <= 65504.f && fabsf(x.y) <= 65504.f);
  }
  const bool v16 = !__syncthreads_or(big);
  if (v16) {
    for (int o = tid; o < lp * (DP / 2); o += TC_WARPS * 32) {
      const int j = o / (DP / 2), c = (o - j * (DP / 2)) * 2;
      uint32_t* cell = reinterpret_cast<uint32_t*>(Vs + j * DS + c);
      const __half2 y = __float22half2_rn(
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(cell)));
      *cell = *reinterpret_cast<const uint32_t*>(&y);
    }
    __syncthreads();
  }

  const float scale_log2 = scale * tc::LOG2E;
  const __nv_bfloat16* qbase = q + win * st.q_win + (long long)h * d;
  __nv_bfloat16* obase = out + win * L * (long long)C + (long long)h * d;
  for (int row0 = warp * 16; row0 < L; row0 += TC_WARPS * 16) {
    uint32_t qf[KS][4];
    __syncwarp();  // the previous m-tile is done with the area
    tc::load_q<KS>(qf, qbase, st.q_row, row0, L, d, lane);
    if (lane < 16) tab[lane * HW + HW - 1] = -INFINITY;
    tc::band_rows<KS>(qf, wh, ww, row0, tab, HW, lane,
                      [&](int part, int m0, int kk, uint32_t (&hi)[2], uint32_t (&lo)[2]) {
                        const __nv_bfloat16* r =
                            Rs + (2 * part * rr + m0 + g) * DS + kk * 16 + 2 * t;
#pragma unroll
                        for (int y = 0; y < 2; ++y) {
                          hi[y] = *reinterpret_cast<const uint32_t*>(r + y * 8);
                          lo[y] = *reinterpret_cast<const uint32_t*>(r + rr * DS + y * 8);
                        }
                      });
    __syncwarp();
    tc::RowState<NO> rs;
    rs.init();
    const float rb[2] = {0.f, 0.f};
    // Every slice runs one code path: keys past L score -inf through the
    // band table, and only the 16-key steps up to lp are multiplied.
    for (int j0 = 0; j0 < lp; j0 += TC_SLICE) {
      float s[8][4];
      const int npairs = min(TC_SLICE, lp - j0) / 16;
      tc::qk_mma<KS, DS>(s, qf, Ks + j0 * DS, npairs, lane);
      tc::softmax_tile<false>(
          s, rb,
          [&](int hf, int n, int e, float x) {
            const int cell = rc[j0 + n * 8 + 2 * t + e];
            const float* row = tab + (g + hf * 8) * HW;
            return fmaf(x, scale_log2, row[cell & 0xffff] + row[cell >> 16]);
          },
          TC_SLICE, rs, lane);
      if (v16)
        tc::pv_mma_f16<NO, DS>(rs, s, Vs + j0 * DS, npairs, nd, lane);
      else
        tc::pv_mma<NO, DS>(rs, s, Vs + j0 * DS, npairs, nd, lane);
    }
    tc::store_rows_staged<NO, DS>(rs, obase, C, row0, L, nd, stage, lane);
  }
}

template <int DP>
cudaError_t launch_tc_as(const void* q, const void* k, const void* v, const float* rel_h,
                         const float* rel_w, void* out, int nwin, int wh, int ww, int nh,
                         int d, Strides st, float scale, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes(wh, ww, DP);
  cudaError_t e = haff::allow_smem(window_tc_kernel<DP>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(nwin, nh);
  window_tc_kernel<DP><<<grid, TC_WARPS * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), rel_h, rel_w,
      static_cast<__nv_bfloat16*>(out), wh, ww, nh, d, st, scale);
  return cudaGetLastError();
}

cudaError_t launch_tc(const void* q, const void* k, const void* v, const float* rel_h,
                      const float* rel_w, void* out, int nwin, int wh, int ww, int nh, int d,
                      Strides st, float scale, cudaStream_t s) {
  switch ((d + 15) / 16) {
#define HAFF_TC_CASE(n) \
  case n:               \
    return launch_tc_as<16 * n>(q, k, v, rel_h, rel_w, out, nwin, wh, ww, nh, d, st, scale, s);
    HAFF_TC_CASE(1)
    HAFF_TC_CASE(2)
    HAFF_TC_CASE(3)
    HAFF_TC_CASE(4)
    HAFF_TC_CASE(5)
    HAFF_TC_CASE(6)
    HAFF_TC_CASE(7)
    HAFF_TC_CASE(8)
#undef HAFF_TC_CASE
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const float* rel_h,
                   const float* rel_w, void* out, int nwin, int wh, int ww, int nh, int d,
                   Strides st, float scale, cudaStream_t stream) {
  const int L = wh * ww;
  const size_t smem = smem_bytes(wh, ww, d);
  cudaError_t e = haff::allow_smem(window_attn_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(nwin, nh, (L + QC - 1) / QC);
  window_attn_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      rel_h, rel_w, static_cast<T*>(out), wh, ww, nh, d, st, scale);
  return cudaGetLastError();
}

}  // namespace

// Paths (the wrapper's kernel_path): 0 scalar; 1 mma.sync, bf16 operands
// the tensor-core path can read (see the header). Head dim d <= 128; the
// wrapper checks it.
extern "C" int sam_window_relpos_attn(const void* q, const void* k, const void* v,
                                      const void* rel_h, const void* rel_w, void* out,
                                      int nwin, int wh, int ww, int nh, int d,
                                      long long q_win, long long q_row, long long k_win,
                                      long long k_row, long long v_win, long long v_row,
                                      float scale, int is_bf16, int path, void* stream) {
  const Strides st{q_win, q_row, k_win, k_row, v_win, v_row};
  const float* rh = static_cast<const float*>(rel_h);
  const float* rw = static_cast<const float*>(rel_w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    if (!is_bf16 || d % 8 || d > 128) return (int)cudaErrorInvalidValue;
    return (int)launch_tc(q, k, v, rh, rw, out, nwin, wh, ww, nh, d, st, scale, s);
  }
  if (path != 0) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(q, k, v, rh, rw, out, nwin, wh, ww, nh, d, st, scale,
                                      s);
  return (int)launch<float>(q, k, v, rh, rw, out, nwin, wh, ww, nh, d, st, scale, s);
}

// Dynamic shared memory one block of the path needs; the wrapper sends a
// window above the card's 227 KB per block to the global kernel.
extern "C" size_t sam_window_relpos_attn_smem(int wh, int ww, int d, int path) {
  return path == 1 ? tc_smem_bytes(wh, ww, (d + 15) / 16 * 16) : smem_bytes(wh, ww, d);
}
