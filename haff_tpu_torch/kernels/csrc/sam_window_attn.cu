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
// contiguous, the same memory as (nwin, L, nh, d). Every load and store
// is of one element, consecutive threads on consecutive k, so a pointer
// needs the alignment of its element type only and any row stride is
// valid; there are no vector loads to misalign. There are no tile-pad
// rows: L is the window area (196 at ViT-H), the ragged query chunk is
// masked here, and any window count is a grid dimension.
//
// What bounds it on Hopper: one window-head is tiny (196 x 80), so the
// work is ~2*L*L*d FLOPs per window-head against ~3*L*d*2 bytes; at
// ViT-H that is ~130 FLOP/byte, under the card's ~295 bf16 ridge, but
// this first version runs the products as f32 FMAs from shared memory,
// so shared-memory bandwidth (two loads per FMA) bounds it. The design
// keeps the whole window's K and V and the chunk's scores in shared
// memory (one block per (query chunk, head, window)), so device memory
// sees each operand once per block and the output once. Tensor-core
// products (mma.sync / wgmma) are later work.
#include "common.cuh"

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

extern "C" int sam_window_relpos_attn(const void* q, const void* k, const void* v,
                                      const void* rel_h, const void* rel_w, void* out,
                                      int nwin, int wh, int ww, int nh, int d,
                                      long long q_win, long long q_row, long long k_win,
                                      long long k_row, long long v_win, long long v_row,
                                      float scale, int is_bf16, void* stream) {
  const Strides st{q_win, q_row, k_win, k_row, v_win, v_row};
  const float* rh = static_cast<const float*>(rel_h);
  const float* rw = static_cast<const float*>(rel_w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(q, k, v, rh, rw, out, nwin, wh, ww, nh, d, st, scale,
                                      s);
  return (int)launch<float>(q, k, v, rh, rw, out, nwin, wh, ww, nh, d, st, scale, s);
}

// Dynamic shared memory one block needs; the wrapper refuses shapes
// above the card's 227 KB per block.
extern "C" size_t sam_window_relpos_attn_smem(int wh, int ww, int d) {
  return smem_bytes(wh, ww, d);
}
