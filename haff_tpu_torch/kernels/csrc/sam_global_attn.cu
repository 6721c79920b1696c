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
// with row(j) = j / W, col(j) = j % W. Bh (B, L, nh, H) and Bw
// (B, L, nh, W) are the band tables q . Rh and q . Rw, computed outside
// the kernel by the wrapper, as the JAX package computes them outside its
// kernel (_natural_band_tables_cat, an XLA einsum). Inside, one block
// owns BQ query rows of one (batch, head) and walks the key tiles with an
// online softmax (running max m, sum l, f32 accumulator), the loop that
// replaces the TPU kernel's sequential key-block grid axis. The (L, L)
// scores and bias never reach device memory; the block's band rows sit
// in shared memory.
//
// Operands: q, k and v are three base pointers, each with a batch stride
// and a row stride in elements; element (b, row i, head h, k) lies at
// base + b * bs + i * rs + h * d + k. The fused projection (B, L, 3C) is
// read in place (k = qkv + C, v = qkv + 2C, row stride 3C), as are
// separate per-head (B, L, nh, d) tensors (row stride C). Loads and stores
// are of one element each, so a pointer needs its element type's alignment
// only and any row stride is valid. The ragged last query tile and key
// tile (L not a multiple of 64) are masked.
//
// What bounds it on Hopper: ~4*L*L*d FLOPs per (batch, head) against
// ~4*L*d*2 bytes, i.e. operations by a wide margin (~2000 FLOP/byte).
// This first version runs the products as f32 FMAs from shared memory,
// so shared-memory bandwidth and the f32 FMA rate bound it, far above the
// tensor-core bound; tensor-core tiles (mma.sync / wgmma) are later work.
#include "common.cuh"

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

// Head dim d <= 128 (MAXD); the wrapper checks it.
extern "C" int sam_global_relpos_attn(const void* q, const void* k, const void* v,
                                      const void* band_h, const void* band_w, void* out,
                                      int B, int H, int W, int nh, int d, long long q_b,
                                      long long q_row, long long k_b, long long k_row,
                                      long long v_b, long long v_row, float scale,
                                      int is_bf16, void* stream) {
  const Strides st{q_b, q_row, k_b, k_row, v_b, v_row};
  const float* bh = static_cast<const float*>(band_h);
  const float* bw = static_cast<const float*>(band_w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(q, k, v, bh, bw, out, B, H, W, nh, d, st, scale, s);
  return (int)launch<float>(q, k, v, bh, bw, out, B, H, W, nh, d, st, scale, s);
}

extern "C" size_t sam_global_relpos_attn_smem(int H, int W, int d) {
  return smem_bytes(H, W, d);
}
