// decode_attn: one decode step of attention over a ragged KV cache that
// is float (f32 or bf16) or int8 with per token-head scales.
//
// Replaces haff_tpu/kernels/decode_attention.py::_make_kernel (launched by
// _kernel_path through flash_decode_attention).
//
// What it computes, per batch row b and query head h (kv head h / (nh/nkv)):
//   s[j]  = scale * q[b, h] . K[b, j, kvh]          for live slots j
//   o     = softmax_j(s) @ V[b, :, kvh]
// over the slots with mask[b, j] > 0 only; a row with no live slot gives
// 0. An int8 cache is dequantized in registers, value times the f32 scale
// of its token-head with no rounding, so no float copy of the cache ever
// exists in device memory. Softmax and both products run in f32.
//
// What bounds it on Hopper: the bytes of the live part of the cache, each
// read once (one query row a head: about one multiply-add a byte). The
// design: one block a (query head, batch row); its 8 warps take the slots
// round-robin, a warp reading one slot's K row then V row coalesced (lane
// l holds elements l, l + 32, ...; head_dim <= 128), skipping dead slots
// before any load; each warp keeps its own running max, sum and output
// (online softmax), and the 8 partial states are merged through shared
// memory. Query heads sharing a kv head (GQA) are separate blocks and
// share the cache rows through L2. Any cache length, no padding. Splitting
// one head's slots over several blocks (to fill the card at small batch)
// is later work.
#include "common.cuh"

#include <stdint.h>

namespace haff {
template <>
__device__ __forceinline__ float to_f<int8_t>(int8_t x) { return (float)x; }
}  // namespace haff

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int EPL = 4;  // elements a lane: head_dim <= 32 * EPL

template <typename TQ, typename TKV, bool QUANT>
__global__ void __launch_bounds__(THREADS)
decode_attn_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kc,
                   const TKV* __restrict__ vc, const float* __restrict__ ks,
                   const float* __restrict__ vs, const int* __restrict__ mask,
                   TQ* __restrict__ out, int lmax, int nh, int nkv, int hd, float scale) {
  using haff::to_f;
  const int h = blockIdx.x;
  const long b = blockIdx.y;
  const int kvh = h / (nh / nkv);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float qv[EPL];
#pragma unroll
  for (int i = 0; i < EPL; ++i) {
    const int e = lane + 32 * i;
    qv[i] = e < hd ? to_f(q[(b * nh + h) * hd + e]) * scale : 0.f;
  }

  float m = -INFINITY, l = 0.f, acc[EPL];
#pragma unroll
  for (int i = 0; i < EPL; ++i) acc[i] = 0.f;

  const int* mrow = mask + b * lmax;
  for (int j = warp; j < lmax; j += WARPS) {
    if (mrow[j] <= 0) continue;  // warp-uniform: dead slots cost no cache read
    const long slot = (b * lmax + j) * nkv + kvh;
    const TKV* kp = kc + slot * hd;
    const TKV* vp = vc + slot * hd;
    float dot = 0.f, vv[EPL];
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      const int e = lane + 32 * i;
      const bool ok = e < hd;
      dot = fmaf(qv[i], ok ? to_f(kp[e]) : 0.f, dot);
      vv[i] = ok ? to_f(vp[e]) : 0.f;
    }
    float s = haff::warp_sum(dot);
    float vscale = 1.f;
    if (QUANT) {
      s *= ks[slot];
      vscale = vs[slot];
    }
    const float m_new = fmaxf(m, s);
    const float alpha = expf(m - m_new);  // m = -inf at first: alpha = 0
    const float p = expf(s - m_new);
    l = l * alpha + p;
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[i] = acc[i] * alpha + p * (vv[i] * vscale);
    m = m_new;
  }

  __shared__ float sm_m[WARPS], sm_l[WARPS], sm_acc[WARPS][32 * EPL];
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < EPL; ++i) sm_acc[warp][lane + 32 * i] = acc[i];
  __syncthreads();

  for (int e = threadIdx.x; e < hd; e += THREADS) {
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      // A warp that saw no live slot (m = -inf) carries no weight.
      const float wgt = sm_m[w] == -INFINITY ? 0.f : expf(sm_m[w] - mx);
      num += sm_acc[w][e] * wgt;
      den += sm_l[w] * wgt;
    }
    out[(b * nh + h) * hd + e] = haff::from_f<TQ>(num / fmaxf(den, 1e-30f));
  }
}

template <typename TQ, typename TKV, bool QUANT>
cudaError_t launch(const void* q, const void* kc, const void* vc, const void* ks,
                   const void* vs, const void* mask, void* out, int B, int lmax, int nh,
                   int nkv, int hd, float scale, cudaStream_t stream) {
  dim3 grid(nh, B);
  decode_attn_kernel<TQ, TKV, QUANT><<<grid, THREADS, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kc), static_cast<const TKV*>(vc),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(mask), static_cast<TQ*>(out), lmax, nh, nkv, hd, scale);
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t dispatch(int kv_kind, const void* q, const void* kc, const void* vc,
                     const void* ks, const void* vs, const void* mask, void* out, int B,
                     int lmax, int nh, int nkv, int hd, float scale, cudaStream_t s) {
  switch (kv_kind) {
    case 0:
      return launch<TQ, float, false>(q, kc, vc, ks, vs, mask, out, B, lmax, nh, nkv, hd,
                                      scale, s);
    case 1:
      return launch<TQ, __nv_bfloat16, false>(q, kc, vc, ks, vs, mask, out, B, lmax, nh,
                                              nkv, hd, scale, s);
    case 2:
      if (ks == nullptr || vs == nullptr) return cudaErrorInvalidValue;
      return launch<TQ, int8_t, true>(q, kc, vc, ks, vs, mask, out, B, lmax, nh, nkv, hd,
                                      scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// kv_kind: 0 f32 cache, 1 bf16 cache, 2 int8 cache with f32 scales ks, vs
// (B, lmax, nkv). q and out are bf16 (q_bf16) or f32.
extern "C" int decode_attn(const void* q, const void* kc, const void* vc, const void* ks,
                           const void* vs, const void* mask, void* out, int B, int lmax,
                           int nh, int nkv, int hd, float scale, int q_bf16, int kv_kind,
                           void* stream) {
  if (hd > 32 * EPL || nkv <= 0 || nh % nkv) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_bf16)
    return (int)dispatch<__nv_bfloat16>(kv_kind, q, kc, vc, ks, vs, mask, out, B, lmax, nh,
                                        nkv, hd, scale, s);
  return (int)dispatch<float>(kv_kind, q, kc, vc, ks, vs, mask, out, B, lmax, nh, nkv, hd,
                              scale, s);
}
