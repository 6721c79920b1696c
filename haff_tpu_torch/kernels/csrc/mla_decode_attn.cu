// mla_decode_attn: one decode step of multi-head latent attention (the
// deepseek_v3 decoder, Moonlight-16B-A3B: 16 heads over a latent cache of
// R = 512 + P = 64 values a token) in its absorbed form, with the new
// token's cache row written in the same launch.
//
// New kernel (no TPU counterpart). Wrapper: kernels/mla_decode_attention.py.
//
// What it computes, per batch row b and head h:
//   cache[b, index[b]] = new[b]                  (where index[b] is a slot)
//   s[j] = scale * q[b, h] . cache[b, j]         (all R + P values)
//   o[b, h] = softmax_j(s) @ cache[b, :, :R]     over the slots with mask > 0
// a row with no live slot gives 0. Softmax and both products in f32.
//
// What bounds it: the slots' bytes (1152 a slot) and the latency of a
// chain of dependent steps; at Moonlight's prefill of 575 the whole cache
// of a layer is ~0.7 MB, 0.2 us at 3.35 TB/s, so the design is about
// parallelism and round trips:
//   * Each row's slots are cut into `splits` runs of `chunk`
//     (mla_plan: shapes only, so no host sync); a block takes one run of
//     one row for `hpb` of its heads, which share each slot read (4 at
//     Moonlight's 16: the scores and sums, not the bytes, set a block's
//     time, so four blocks share a run's slots, read once from memory
//     and three times more from L2).
//   * A block stages the row's bf16 queries in shared memory, then walks
//     its run in tiles of 16 slots: the tile's mask and the 16-byte
//     pieces of every slot's row in one round trip (dead slots' rows are
//     read and skipped; the slot index[b] is taken from `new` and written
//     to the cache by the thread that would read it, so no block reads a
//     slot another is writing); a warp a slot computes its scores against
//     the block's heads (each lane 1/32 of the width, shuffle sums); an
//     online softmax a head; then P V with each thread owning value
//     columns.
//   * One run writes the output directly. Otherwise each run writes its
//     (m, l, acc) to f32 scratch and a second kernel, launched from the
//     same C entry, merges them (max, rescaled sums, acc / l; an empty run
//     carries no weight) with a block a (row, head, 64 columns). One
//     launch count.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 16;    // slots staged at once
constexpr int NH_MAX = 16;  // heads a block
constexpr int VPT = 2;      // value columns a thread: R <= THREADS * VPT
constexpr int SPLITS_MAX = 1024;
constexpr int D_MAX = 640;
constexpr int D_PER_LANE = D_MAX / 32;  // a row's values a lane holds
constexpr int Q_ITERS = (NH_MAX * D_MAX / 8 + THREADS - 1) / THREADS;
constexpr int K_ITERS = (TILE * D_MAX / 8 + THREADS - 1) / THREADS;

typedef __nv_bfloat16 bf16;

struct Args {
  const bf16* q;
  const bf16* nw;
  bf16* cache;
  const int* mask;
  const long long* index;
  bf16* out;
  float* part;
  int B, lmax, nh, R, D, splits, chunk, hpb;
  float scale;
};

__global__ void __launch_bounds__(THREADS) mla_decode_attn_split(const Args a) {
  extern __shared__ uint4 smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);                // hpb * D
  bf16* k_s = q_s + a.hpb * a.D;                            // TILE * D
  float* s_s = reinterpret_cast<float*>(k_s + TILE * a.D);  // NH_MAX * TILE
  __shared__ float m_s[NH_MAX], l_s[NH_MAX], al_s[NH_MAX];
  __shared__ int live_s[TILE];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, split = blockIdx.x;
  const int lo = split * a.chunk, hi = min(lo + a.chunk, a.lmax);
  const int D = a.D, h0 = blockIdx.y * a.hpb;
  const int nh = min(a.hpb, a.nh - h0);  // this block's heads: h0, h0 + 1, ...

  const int cpr = D / 8;  // 16-byte pieces a row
  {  // the row's queries, every 16-byte load issued before any is stored
    const uint4* qg = reinterpret_cast<const uint4*>(a.q + ((long)b * a.nh + h0) * D);
    uint4 v[Q_ITERS];
#pragma unroll
    for (int it = 0; it < Q_ITERS; ++it) {
      const int i = tid + it * THREADS;
      if (i < nh * cpr) v[it] = qg[i];
    }
#pragma unroll
    for (int it = 0; it < Q_ITERS; ++it) {
      const int i = tid + it * THREADS;
      if (i < nh * cpr) reinterpret_cast<uint4*>(q_s)[i] = v[it];
    }
  }
  if (tid < NH_MAX) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[NH_MAX][VPT];
#pragma unroll
  for (int h = 0; h < NH_MAX; ++h)
#pragma unroll
    for (int v = 0; v < VPT; ++v) acc[h][v] = 0.f;

  const long long at = a.index[b];
  const int* mk = a.mask + (long)b * a.lmax;
  bf16* cb = a.cache + (long)b * a.lmax * D;
  const uint4* nb = reinterpret_cast<const uint4*>(a.nw + (long)b * D);

  for (int t0 = lo; t0 < hi; t0 += TILE) {
    const int n = min(TILE, hi - t0);
    __syncthreads();  // the previous tile is used up; q_s and m_s are set
    // The tile's mask and rows in one round trip: every 16-byte load
    // issued before any is stored, the rows of dead slots too (skipped
    // below), the new slot taken from `new` and written to the cache here.
    if (tid < TILE) live_s[tid] = tid < n && mk[t0 + tid] > 0;
    uint4 v[K_ITERS];
#pragma unroll
    for (int it = 0; it < K_ITERS; ++it) {
      const int i = tid + it * THREADS;
      const int j = i / cpr, c = i - j * cpr;
      const long slot = t0 + j;
      if (j < n) {
        if (slot == at) {
          v[it] = nb[c];
          reinterpret_cast<uint4*>(cb + slot * D)[c] = v[it];
        } else {
          v[it] = reinterpret_cast<const uint4*>(cb + slot * D)[c];
        }
      }
    }
#pragma unroll
    for (int it = 0; it < K_ITERS; ++it) {
      const int i = tid + it * THREADS;
      if (i / cpr < n) reinterpret_cast<uint4*>(k_s)[i] = v[it];
    }
    __syncthreads();
    // Scores: a warp a slot, against every head.
    for (int j = warp; j < n; j += WARPS) {
      if (!live_s[j]) {
        if (lane < nh) s_s[lane * TILE + j] = -INFINITY;
        continue;
      }
      const bf16* kr = k_s + j * D;
      float kv[D_PER_LANE];
#pragma unroll
      for (int c = 0; c < D_PER_LANE; ++c) {
        const int e = lane + 32 * c;
        kv[c] = e < D ? __bfloat162float(kr[e]) : 0.f;
      }
      for (int h = 0; h < nh; ++h) {
        const bf16* qh = q_s + h * D;
        float sum = 0.f;
#pragma unroll
        for (int c = 0; c < D_PER_LANE; ++c) {
          const int e = lane + 32 * c;
          if (e < D) sum = fmaf(__bfloat162float(qh[e]), kv[c], sum);
        }
        sum = haff::warp_sum(sum);
        if (lane == 0) s_s[h * TILE + j] = sum * a.scale;
      }
    }
    __syncthreads();
    // Online softmax, a warp a head.
    for (int h = warp; h < nh; h += WARPS) {
      const float s = lane < n ? s_s[h * TILE + lane] : -INFINITY;
      const float m_old = m_s[h];
      const float m_new = fmaxf(m_old, haff::warp_max(s));
      const float p = (s == -INFINITY) ? 0.f : __expf(s - m_new);
      const float ps = haff::warp_sum(p);
      if (lane < TILE) s_s[h * TILE + lane] = p;
      if (lane == 0) {
        const float alpha = (m_old == -INFINITY) ? 0.f : __expf(m_old - m_new);
        m_s[h] = m_new;
        l_s[h] = l_s[h] * alpha + ps;
        al_s[h] = alpha;
      }
    }
    __syncthreads();
    // P V: thread tid owns value columns tid + THREADS * v.
#pragma unroll
    for (int h = 0; h < NH_MAX; ++h) {
      if (h < nh) {
        const float al = al_s[h];
#pragma unroll
        for (int v = 0; v < VPT; ++v) acc[h][v] *= al;
      }
    }
    for (int j = 0; j < n; ++j) {
      if (!live_s[j]) continue;
      float kv[VPT];
#pragma unroll
      for (int v = 0; v < VPT; ++v) {
        const int col = tid + THREADS * v;
        kv[v] = col < a.R ? __bfloat162float(k_s[j * D + col]) : 0.f;
      }
#pragma unroll
      for (int h = 0; h < NH_MAX; ++h) {
        if (h < nh) {
          const float p = s_s[h * TILE + j];
#pragma unroll
          for (int v = 0; v < VPT; ++v) acc[h][v] = fmaf(p, kv[v], acc[h][v]);
        }
      }
    }
  }
  __syncthreads();

  if (a.splits == 1) {
#pragma unroll
    for (int h = 0; h < NH_MAX; ++h) {
      if (h < nh) {
        const float inv = l_s[h] > 0.f ? 1.f / l_s[h] : 0.f;
#pragma unroll
        for (int v = 0; v < VPT; ++v) {
          const int col = tid + THREADS * v;
          if (col < a.R)
            a.out[((long)b * a.nh + h0 + h) * a.R + col] = __float2bfloat16(acc[h][v] * inv);
        }
      }
    }
    return;
  }
  float* pacc = a.part;
  float* pml = a.part + (long)a.B * a.nh * a.splits * a.R;
#pragma unroll
  for (int h = 0; h < NH_MAX; ++h) {
    if (h < nh) {
      const long r = ((long)b * a.nh + h0 + h) * a.splits + split;
#pragma unroll
      for (int v = 0; v < VPT; ++v) {
        const int col = tid + THREADS * v;
        if (col < a.R) pacc[r * a.R + col] = acc[h][v];
      }
    }
  }
  if (tid < nh) {
    const long r = ((long)b * a.nh + h0 + tid) * a.splits + split;
    pml[2 * r] = m_s[tid];
    pml[2 * r + 1] = l_s[tid];
  }
}

// A block a (head, row, 64 value columns): the runs' states merged as the
// online softmax does, four threads a column each summing a quarter of
// the runs (their loads in flight together), then summed in order.
__global__ void __launch_bounds__(THREADS) mla_decode_attn_merge(const Args a) {
  constexpr int COLS = 64, PARTS = THREADS / COLS;
  __shared__ float w_s[SPLITS_MAX];
  __shared__ float sum_s[PARTS][COLS];
  __shared__ float den_s;
  const int tid = threadIdx.x, lane = tid & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  const long r0 = ((long)b * a.nh + h) * a.splits;
  const float* pml = a.part + (long)a.B * a.nh * a.splits * a.R + 2 * r0;
  const float* pacc = a.part + r0 * a.R;
  if (tid < 32) {
    float mx = -INFINITY;
    for (int s = lane; s < a.splits; s += 32) mx = fmaxf(mx, __ldcg(pml + 2 * s));
    mx = haff::warp_max(mx);
    float den = 0.f;
    for (int s = lane; s < a.splits; s += 32) {
      const float m = __ldcg(pml + 2 * s);
      const float w = (m == -INFINITY) ? 0.f : __expf(m - mx);
      w_s[s] = w;
      den += __ldcg(pml + 2 * s + 1) * w;
    }
    den = haff::warp_sum(den);
    if (lane == 0) den_s = den;
  }
  __syncthreads();
  const int part = tid / COLS, col = blockIdx.z * COLS + tid % COLS;
  float o = 0.f;
  if (col < a.R) {
#pragma unroll 8
    for (int s = part; s < a.splits; s += PARTS)
      o = fmaf(w_s[s], __ldcg(pacc + (long)s * a.R + col), o);
  }
  sum_s[part][tid % COLS] = o;
  __syncthreads();
  if (part == 0 && col < a.R) {
    float t = 0.f;
#pragma unroll
    for (int p = 0; p < PARTS; ++p) t += sum_s[p][tid];
    const float inv = den_s > 0.f ? 1.f / den_s : 0.f;
    a.out[((long)b * a.nh + h) * a.R + col] = __float2bfloat16(t * inv);
  }
}

}  // namespace

// q (B, nh, D) bf16 with D = R + P; nw (B, D) bf16, the new rows, written
// at slot index[b] (int64; nothing where it lies outside [0, lmax)) of
// cache (B, lmax, D) bf16; mask (B, lmax) int32; out (B, nh, R) bf16.
// With splits > 1, part is f32 scratch of B * nh * splits * (R + 2)
// values. A block takes `hpb` heads (<= 16) of one run. Needs R <= 512,
// R % 8 == 0, D <= 640, D % 8 == 0 and 16-byte aligned rows.
extern "C" int mla_decode_attn_write(const void* q, const void* nw, void* cache,
                                     const void* mask, const void* index, void* out, void* part,
                                     int B, int lmax, int nh, int R, int D, float scale,
                                     int splits, int chunk, int hpb, void* stream) {
  if (B <= 0 || lmax <= 0 || nh <= 0 || hpb <= 0 || hpb > NH_MAX || R <= 0 || R > THREADS * VPT ||
      R % 8 || D % 8 || D <= R || D > D_MAX || splits <= 0 || splits > SPLITS_MAX || chunk <= 0 ||
      (long)splits * chunk < lmax || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.nw = static_cast<const bf16*>(nw);
  a.cache = static_cast<bf16*>(cache);
  a.mask = static_cast<const int*>(mask);
  a.index = static_cast<const long long*>(index);
  a.out = static_cast<bf16*>(out);
  a.part = static_cast<float*>(part);
  a.B = B;
  a.lmax = lmax;
  a.nh = nh;
  a.R = R;
  a.D = D;
  a.splits = splits;
  a.chunk = chunk;
  a.hpb = hpb;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)(hpb + TILE) * D * 2 + (size_t)NH_MAX * TILE * 4;
  cudaError_t err = haff::allow_smem(mla_decode_attn_split, smem);
  if (err != cudaSuccess) return (int)err;
  mla_decode_attn_split<<<dim3(splits, (nh + hpb - 1) / hpb, B), THREADS, smem, st>>>(a);
  if (splits > 1) mla_decode_attn_merge<<<dim3(nh, B, (R + 63) / 64), THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}
