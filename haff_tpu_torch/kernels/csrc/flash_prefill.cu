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
// One block owns BQ query rows of one (batch, head) and walks the key
// tiles with an online softmax; key tiles wholly above the causal
// diagonal are skipped. Any Lq, Lk >= 1 is taken: the ragged edge is
// masked here, not padded by the caller. The bias is optional (a null
// pointer means none) and is read through four strides, so a bias
// broadcast over batch, heads or rows is never materialised.
//
// What bounds it on Hopper: at the prefill shapes (B=2, L=575, 32 heads,
// D=128) the work is ~2*B*H*L*L*D FLOPs (causal) against ~4*B*L*H*D*2
// bytes, ~300 FLOP/byte, near the bf16 ridge. This first version runs the
// products as f32 FMAs from shared memory, so shared-memory bandwidth
// and the f32 FMA rate bound it; tensor-core tiles are later work.
#include <stdint.h>

#include "common.cuh"

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
        out[(((int64_t)b * Lq + ia) * H + h) * D + c] =
            from_f<T>(l == 0.f ? 0.f : acc[r] / l);
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

}  // namespace

// q (B, Lq, H, D), k/v (B, Lk, H, D), out like q, lse (B, H, Lq) f32;
// bias f32 addressed as bias[b*sb + h*sh + i*si + j*sj] or null; qseg
// (B, Lq), kseg (B, Lk) int32, both null or both given. D <= 128.
extern "C" int flash_prefill_fwd(const void* q, const void* k, const void* v,
                                 const void* bias, int64_t bias_sb, int64_t bias_sh,
                                 int64_t bias_si, int64_t bias_sj, const void* qseg,
                                 const void* kseg, void* out, void* lse, int B, int Lq,
                                 int Lk, int H, int D, float scale, int causal,
                                 int is_bf16, void* stream) {
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return (int)launch<__nv_bfloat16>(p, s);
  return (int)launch<float>(p, s);
}

extern "C" size_t flash_prefill_fwd_smem(int D) { return smem_bytes(D); }
