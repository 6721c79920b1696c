// moe_decode: the routed experts of one decode step of the deepseek_v3
// decoder (Moonlight-16B-A3B: 64 experts of width 1408 at hidden 2048,
// 6 a token), for B tokens:
//
//   y[b] = sum_k w[b, k] * down_e (silu(gate_e x[b]) * up_e x[b]),  e = idx[b, k]
//
// New kernel (no TPU counterpart: the JAX package's MoE is a one-hot
// einsum that streams every expert). Wrapper: kernels/moe_decode.py.
//
// What bounds it: the chosen experts' weight bytes, each read once a
// step (3 * F * d bf16 an expert: 17.3 MB at Moonlight's widths, 6
// experts a layer at batch 1, a 31 us bound at 3.35 TB/s); a row of x
// is 4 KB and stays in L1. So the design streams weights:
//   * Slots are (row, k) pairs, B * k of them. The block of slot s takes
//     expert e = idx[s]; if an earlier slot holds e it leaves at once, so
//     an expert chosen by several rows is read by one set of blocks,
//     which computes every row that chose it (a row chooses an expert at
//     most once: the router's top-k is of distinct experts).
//   * gate/up: a warp a row f of F; each lane loads 8 16-byte pieces of
//     gate_e[f] and 8 of up_e[f] (the whole 4 KB rows at d = 2048) before
//     it uses any, so 256 bytes a lane are in flight; the x pieces come
//     from L1. Sums in f32, shuffle-reduced; h = silu(g) * u is written
//     in f32 for each (row, k) that chose e.
//   * down: a warp 4 rows of down_e (F = 1408 values, 5.5 16-byte pieces
//     a lane a row: 22 in flight), against each chosen (row, k)'s h,
//     read once for the 4; the f32 dots go to a (row, k, d) scratch.
//   * combine: y[b, j] = sum_k w[b, k] * part[b, k, j] in the order
//     k = 0, 1, ... in f32, rounded to bf16 once: deterministic.
// The shared experts ride along: S more slots, each one F-wide part of
// their SwiGLU (a SwiGLU of width S F is the sum of its S parts' SwiGLUs)
// serving every row with weight 1, added after the routed terms.
// The three kernels are launched from the one C entry on the caller's
// stream (one launch count), so the call needs no host sync and is
// captured whole in the decode graph.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 8;        // rows of x a warp sums against at once
constexpr int PIECES = 8;      // 16-byte weight pieces a lane loads at once
constexpr int SLOTS_MAX = 64;  // rows that may choose one expert
constexpr int DOWN_OUT = 4;     // down: output rows a warp
constexpr int DOWN_PIECES = 6;  // down: 16-byte pieces a lane loads a row at once
constexpr int DOWN_ROWS = 4;    // down: rows of h a warp sums against at once

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void unpack8(const uint4 v, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

struct Args {
  const bf16* x;
  const long long* idx;
  const float* w;
  const bf16 *gate, *up, *down;           // routed: (E, F, d), (E, F, d), (E, d, F)
  const bf16 *sgate, *sup, *sdown;        // shared: (S F, d), (S F, d), (d, S F)
  float* h;                               // (B K + B S, F)
  float* part;                            // (B K + B S, d)
  bf16* out;
  int B, K, S, F, d;
};

// The work of block slot `s`: its weights (gate / up rows of F x d, down
// rows of F at a row stride) and the rows of x it serves, each with the
// row of h and part it writes, into rows_s (x row) and hrow_s. Routed
// slot s < B K takes expert idx[s] and every (row, k) that chose it, or
// nothing where an earlier slot holds the same expert (that slot's blocks
// compute them); shared slot B K + j takes the j-th F-wide part of the
// shared experts for every row. Every thread returns the same count.
__device__ int slot_work(const Args& a, int s, const bf16** g, const bf16** u,
                         const bf16** dn, long* dn_ld, int* rows_s, int* hrow_s) {
  __shared__ int n_s;
  const int routed = a.B * a.K;
  if (s >= routed) {
    const int j = s - routed;
    *g = a.sgate + (long)j * a.F * a.d;
    *u = a.sup + (long)j * a.F * a.d;
    *dn = a.sdown + (long)j * a.F;
    *dn_ld = (long)a.S * a.F;
    if (threadIdx.x < a.B) {
      rows_s[threadIdx.x] = threadIdx.x;
      hrow_s[threadIdx.x] = routed + threadIdx.x * a.S + j;
    }
    __syncthreads();
    return a.B;
  }
  const long long e = a.idx[s];
  *g = a.gate + e * a.F * a.d;
  *u = a.up + e * a.F * a.d;
  *dn = a.down + e * a.d * a.F;
  *dn_ld = a.F;
  if (threadIdx.x == 0) {
    int n = 0;
    for (int t = 0; t < routed; ++t) {
      if (a.idx[t] != e) continue;
      if (t < s) {
        n = 0;
        break;
      }
      if (n < SLOTS_MAX) {
        rows_s[n] = t / a.K;
        hrow_s[n++] = t;
      }
    }
    n_s = n;
  }
  __syncthreads();
  return n_s;
}

__global__ void __launch_bounds__(THREADS) moe_decode_gate_up(const Args a) {
  __shared__ int rows_s[SLOTS_MAX], hrow_s[SLOTS_MAX];
  const bf16 *g0, *u0, *d0;
  long ld;
  const int n = slot_work(a, blockIdx.x, &g0, &u0, &d0, &ld, rows_s, hrow_s);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int f = blockIdx.y * WARPS + warp;
  const int F = a.F, d = a.d;
  if (n == 0 || f >= F) return;
  const uint4* wg = reinterpret_cast<const uint4*>(g0 + (long)f * d);
  const uint4* wu = reinterpret_cast<const uint4*>(u0 + (long)f * d);
  const int pieces = d / 8;
  for (int r0 = 0; r0 < n; r0 += ROWS) {
    const int nr = min(ROWS, n - r0);
    float ag[ROWS], au[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) ag[r] = au[r] = 0.f;
    for (int c0 = lane; c0 < pieces; c0 += 32 * PIECES) {
      uint4 g[PIECES], u[PIECES];
#pragma unroll
      for (int i = 0; i < PIECES; ++i) {
        const int c = c0 + 32 * i;
        if (c < pieces) {
          g[i] = __ldcs(wg + c);
          u[i] = __ldcs(wu + c);
        }
      }
#pragma unroll
      for (int i = 0; i < PIECES; ++i) {
        const int c = c0 + 32 * i;
        if (c >= pieces) break;
        float gf[8], uf[8];
        unpack8(g[i], gf);
        unpack8(u[i], uf);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          if (r >= nr) break;
          float xf[8];
          unpack8(__ldg(reinterpret_cast<const uint4*>(a.x + (long)rows_s[r0 + r] * d) + c), xf);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            ag[r] = fmaf(gf[j], xf[j], ag[r]);
            au[r] = fmaf(uf[j], xf[j], au[r]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r >= nr) break;
      const float gs = haff::warp_sum(ag[r]);
      const float us = haff::warp_sum(au[r]);
      if (lane == 0) a.h[(long)hrow_s[r0 + r] * F + f] = gs / (1.f + __expf(-gs)) * us;
    }
  }
}

__global__ void __launch_bounds__(THREADS) moe_decode_down(const Args a) {
  __shared__ int rows_s[SLOTS_MAX], hrow_s[SLOTS_MAX];
  const bf16 *g0, *u0, *d0;
  long ld;
  const int n = slot_work(a, blockIdx.x, &g0, &u0, &d0, &ld, rows_s, hrow_s);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j0 = (blockIdx.y * WARPS + warp) * DOWN_OUT;
  const int F = a.F, d = a.d;
  if (n == 0 || j0 >= d) return;
  const bf16* wd = d0 + (long)j0 * ld;
  const int pieces = F / 8;
  const int nq = min(DOWN_OUT, d - j0);
  for (int r0 = 0; r0 < n; r0 += DOWN_ROWS) {
    const int nr = min(DOWN_ROWS, n - r0);
    float acc[DOWN_ROWS][DOWN_OUT];
#pragma unroll
    for (int r = 0; r < DOWN_ROWS; ++r)
#pragma unroll
      for (int q = 0; q < DOWN_OUT; ++q) acc[r][q] = 0.f;
    for (int c0 = lane; c0 < pieces; c0 += 32 * DOWN_PIECES) {
      uint4 w[DOWN_OUT][DOWN_PIECES];
#pragma unroll
      for (int q = 0; q < DOWN_OUT; ++q)
#pragma unroll
        for (int i = 0; i < DOWN_PIECES; ++i) {
          const int c = c0 + 32 * i;
          if (q < nq && c < pieces)
            w[q][i] = __ldcs(reinterpret_cast<const uint4*>(wd + (long)q * ld) + c);
        }
#pragma unroll
      for (int i = 0; i < DOWN_PIECES; ++i) {
        const int c = c0 + 32 * i;
        if (c >= pieces) break;
#pragma unroll
        for (int r = 0; r < DOWN_ROWS; ++r) {
          if (r >= nr) break;
          const float4* hr =
              reinterpret_cast<const float4*>(a.h + (long)hrow_s[r0 + r] * F) + 2 * c;
          const float4 a = __ldcg(hr), b = __ldcg(hr + 1);
          const float hf[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
          for (int q = 0; q < DOWN_OUT; ++q) {
            float wf[8];
            unpack8(w[q][i], wf);
#pragma unroll
            for (int t = 0; t < 8; ++t) acc[r][q] = fmaf(wf[t], hf[t], acc[r][q]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < DOWN_ROWS; ++r) {
      if (r >= nr) break;
#pragma unroll
      for (int q = 0; q < DOWN_OUT; ++q) {
        const float v = haff::warp_sum(acc[r][q]);
        if (lane == 0 && q < nq) a.part[(long)hrow_s[r0 + r] * d + j0 + q] = v;
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS) moe_decode_combine(const Args a) {
  const long i = (long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (long)a.B * a.d) return;
  const long b = i / a.d, j = i % a.d;
  float y = 0.f;
  for (int k = 0; k < a.K; ++k) y += a.w[b * a.K + k] * __ldcg(a.part + (b * a.K + k) * a.d + j);
  const long sh = (long)a.B * a.K + b * a.S;
  for (int t = 0; t < a.S; ++t) y += __ldcg(a.part + (sh + t) * a.d + j);
  a.out[i] = __float2bfloat16(y);
}

}  // namespace

// x (B, d) bf16; idx (B, K) int64 expert ids; w (B, K) f32; gate, up
// (E, F, d) and down (E, d, F) bf16; sgate, sup (S F, d) and sdown
// (d, S F) bf16, the shared experts as S >= 1 parts of width F; h:
// (B K + B S) F f32 scratch; part: (B K + B S) d f32 scratch; out (B, d)
// bf16. Needs d % 8 == 0, F % 8 == 0, 16-byte
// aligned operands (torch's allocations are) and B <= 64.
extern "C" int moe_decode(const void* x, const void* idx, const void* w, const void* gate,
                          const void* up, const void* down, const void* sgate, const void* sup,
                          const void* sdown, void* h, void* part, void* out, int B, int K, int E,
                          int S, int F, int d, void* stream) {
  if (B <= 0 || K <= 0 || E <= 0 || S <= 0 || d % 8 || F % 8 || B > SLOTS_MAX ||
      sgate == nullptr || sup == nullptr || sdown == nullptr)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const bf16*>(x);
  a.idx = static_cast<const long long*>(idx);
  a.w = static_cast<const float*>(w);
  a.gate = static_cast<const bf16*>(gate);
  a.up = static_cast<const bf16*>(up);
  a.down = static_cast<const bf16*>(down);
  a.sgate = static_cast<const bf16*>(sgate);
  a.sup = static_cast<const bf16*>(sup);
  a.sdown = static_cast<const bf16*>(sdown);
  a.h = static_cast<float*>(h);
  a.part = static_cast<float*>(part);
  a.out = static_cast<bf16*>(out);
  a.B = B;
  a.K = K;
  a.S = S;
  a.F = F;
  a.d = d;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int slots = B * K + S;
  moe_decode_gate_up<<<dim3(slots, (F + WARPS - 1) / WARPS), THREADS, 0, st>>>(a);
  moe_decode_down<<<dim3(slots, (d + WARPS * DOWN_OUT - 1) / (WARPS * DOWN_OUT)), THREADS, 0,
                    st>>>(a);
  moe_decode_combine<<<(int)(((long)B * d + THREADS - 1) / THREADS), THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}
