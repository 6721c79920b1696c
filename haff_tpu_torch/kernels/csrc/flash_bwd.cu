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
// flash_bwd_dq: one block per (64-query tile, head, batch row); it loops
// over the 64-key tiles up to the causal diagonal, keeping the tile's dq in
// registers (32 f32 a thread). flash_bwd_dkv: one block per (64-key tile,
// head, batch row); it loops over the query tiles at or below the diagonal,
// keeping dk and dv in registers (64 f32 a thread). Any Lq, Lk >= 1 is
// taken: ragged edges are masked here, not padded by the caller.
//
// What bounds them on Hopper: at the train shapes (B=2, L=575, 32 heads,
// D=128, causal) the work is 6*D*H*pairs FLOPs (dq) and 8*D*H*pairs (dk/dv)
// against ~4 (B, L, H, D) tensors of bytes, past the bf16 ridge, so the
// tensor cores would bound them. This first version runs every product as
// f32 FMAs out of shared memory (inputs widened to f32 once per tile), so
// the f32 FMA rate and shared-memory bandwidth bound it; mma.sync / wgmma
// tiles are later work.
#include <stdint.h>

#include "common.cuh"

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
      if (ia < Lq) dq[(((int64_t)b * Lq + ia) * H + h) * D + c] = haff::from_f<T>(acc[r]);
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
        dk[off] = haff::from_f<T>(acc_k[r]);
        dv[off] = haff::from_f<T>(acc_v[r]);
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
  return p;
}

}  // namespace

// q/dout (B, Lq, H, D), k/v (B, Lk, H, D), one dtype (bf16 or f32); lse
// and delta (B, H, Lq) f32; bias f32 addressed as
// bias[b*sb + h*sh + i*si + j*sj] or null; qseg (B, Lq), kseg (B, Lk)
// int32, both null or both given. D <= 128. Writes dq (like q).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* bias,
                            int64_t bias_sb, int64_t bias_sh, int64_t bias_si,
                            int64_t bias_sj, const void* qseg, const void* kseg,
                            const void* dout, const void* lse, const void* delta, void* dq,
                            int B, int Lq, int Lk, int H, int D, float scale, int causal,
                            int is_bf16, void* stream) {
  Params p = make_params(q, k, v, bias, bias_sb, bias_sh, bias_si, bias_sj, qseg, kseg, dout,
                         lse, delta, B, Lq, Lk, H, D, scale, causal);
  p.dq = dq;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return (int)launch_dq<__nv_bfloat16>(p, s);
  return (int)launch_dq<float>(p, s);
}

// Same operands as flash_bwd_dq; writes dk (like k) and dv (like v).
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* bias,
                             int64_t bias_sb, int64_t bias_sh, int64_t bias_si,
                             int64_t bias_sj, const void* qseg, const void* kseg,
                             const void* dout, const void* lse, const void* delta, void* dk,
                             void* dv, int B, int Lq, int Lk, int H, int D, float scale,
                             int causal, int is_bf16, void* stream) {
  Params p = make_params(q, k, v, bias, bias_sb, bias_sh, bias_si, bias_sj, qseg, kseg, dout,
                         lse, delta, B, Lq, Lk, H, D, scale, causal);
  p.dk = dk;
  p.dv = dv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return (int)launch_dkv<__nv_bfloat16>(p, s);
  return (int)launch_dkv<float>(p, s);
}

extern "C" size_t flash_bwd_dq_smem(int D) { return dq_smem_bytes(D); }
extern "C" size_t flash_bwd_dkv_smem(int D) { return dkv_smem_bytes(D); }
