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
// exactly 0. With ALiBi (the MPT decoder: per-head slopes, nh floats),
// s[j] also gains slopes[h] * j, the column form of the ALiBi bias, exact
// under softmax; it is a template flag, so the kernel without slopes is
// compiled without the term. An int8 cache is dequantized in registers, value times the
// f32 scale of its token-head with no rounding, so no float copy of the
// cache ever exists in device memory. Softmax and both products run in f32.
//
// What bounds it on Hopper: the bytes of the live part of the cache, each
// read once (one query row a head: about one multiply-add a byte, far
// below the ~295 operations a byte where tensor cores would matter; no
// MMA here). At LLaMA-7B's decode (batch 2, 32 heads, 591 slots) that is
// 5 MB of int8 cache, 1.5 us at 3.35 TB/s, so the kernel is bound by how
// many of those bytes are in flight at once and by its latency. The
// design (flash-decoding):
//   * The slots of each (batch row, kv head) are split over `splits`
//     blocks of `chunk` slots (<= 64). decode_plan in decode_attention.py
//     chooses both from the shapes alone (several blocks an SM at batch 2),
//     never from the mask, so a decode step needs no host sync. The query
//     heads sharing a kv head (GQA), up to 8, share one block, so the
//     cache is read once; more than 8 take several head blocks.
//   * A block reads its slots' mask first. A split with no live slot
//     writes an empty partial (m = -inf, l = 0) and leaves: dead slots
//     cost no cache read. Otherwise it issues 16-byte cp.async copies of
//     every live slot's K row, then V row (two commit groups), so the
//     whole split's cache bytes are in flight at once; neighbouring lanes
//     copy neighbouring 16 bytes of a row.
//   * Scores start when K has landed, while V is still in flight: 8 lanes
//     a slot (an int8 row is 8 x 16 bytes, a bf16 row 16 x 16), a warp 4
//     slots at a time, each lane 16 elements against the query (staged
//     in shared memory, held in registers a head at a time), a 3-step
//     shuffle sum. Then the split's softmax in f32 (max,
//     exp, sum) per head, and P V with the same lane layout; the 4 lane
//     groups and 4 warps are summed through shuffles and shared memory.
//   * The partials (m, l, acc[hd]) go to float32 scratch that the wrapper
//     allocates; a second kernel, launched from the same C entry by
//     programmatic dependent launch (it is scheduled while the first runs
//     and waits for its end), merges the splits exactly as the online
//     softmax does (max, rescaled sums, acc / l; empty splits carry no
//     weight, an all-dead row gives 0). One split writes the output
//     directly. Either way the wrapper counts one launch of `decode_attn`
//     a call.
// Operands the 16-byte copies cannot read (a row of hd * itemsize bytes
// not a multiple of 16, or an unaligned cache base) are copied byte by
// byte by the same kernel; any cache length, no padding.
//
// The write variant (`decode_attn_write`, template flag WRITE; the MPT
// decode step, nn/mpt.py) is the same kernel with the step's two
// neighbours taken in: it reads q and the new token's k and v straight
// from the fused Wqkv output by strides (no copy of q), and the split
// that holds row b's slot `index[b]` writes the new k/v into the f32 or
// bf16 cache there (the first head block of that split, converted to the
// cache's type as torch's copy rounds) and uses those fresh values for
// that slot itself, so no block reads a slot another block is writing.
// Each split counts itself done on a counter of its (batch row, head
// block) after its partial state is visible; the last one merges the
// splits' states exactly as decode_merge_kernel does (same order, same
// reductions) and sets the counter back to 0 for the next launch. One
// launch replaces the cache write's index kernels, the copy of q and the
// separate merge pass. It is a plain launch: as a programmatic dependent
// of the Wqkv product MPT-7B's graphed decode step ran 0.04-0.05 ms
// slower on an H100, though the kernel alone ran 0.25-0.5 us faster by
// graph.
#include <stdint.h>

#include "tc.cuh"

namespace haff {
template <>
__device__ __forceinline__ float to_f<int8_t>(int8_t x) { return (float)x; }
}  // namespace haff

namespace {

namespace tc = haff::tc;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int HD_MAX = 128;     // 8 lanes x 16 elements
constexpr int CHUNK_MAX = 64;   // slots a split (decode_plan keeps to it)
constexpr int HEADS_MAX = 8;    // query heads a block

struct Args {
  const void* q;
  const void* kn;  // WRITE: the new token's k and v, (B, nkv, hd) at q's row stride
  const void* vn;
  const long long* index;  // WRITE: (B,) the slot of row b's new k/v
  unsigned* counters;      // WRITE with splits > 1: a zero a (b, head block), left zero
  const uint8_t* kc;
  const uint8_t* vc;
  const float* ks;
  const float* vs;
  const float* slopes;  // (nh,) ALiBi slopes; read only by the ALIBI variant
  const int* mask;
  void* out;
  float* part_acc;  // (B, nh, splits, hd)
  float* part_ml;   // (B, nh, splits, 2): m, l
  int lmax, nh, nkv, hd, chunk, splits, vec;
  long q_row;  // elements from one batch row of q (and kn, vn) to the next
  float scale;
};

// A lane's 16 elements of a cache row in shared memory: 16-byte chunks
// sub + 8 i of the row (i < 16 / elements-a-chunk), zeros past the row.
template <typename T>
__device__ __forceinline__ void load_row(const uint8_t* row, int sub, int pitch, bool ok,
                                         float (&f)[16]) {
  constexpr int EPC = 16 / (int)sizeof(T);
#pragma unroll
  for (int ci = 0; ci < 16 / EPC; ++ci) {
    const int c = sub + 8 * ci;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (ok && 16 * c < pitch) v = *reinterpret_cast<const uint4*>(row + 16 * c);
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int t = 0; t < EPC; ++t) f[ci * EPC + t] = haff::to_f<T>(e[t]);
  }
}

// The head-dim index of a lane's element i (load_row's order).
template <typename T>
__device__ __forceinline__ int elem(int sub, int i) {
  constexpr int EPC = 16 / (int)sizeof(T);
  return (sub + 8 * (i / EPC)) * EPC + i % EPC;
}

// Copy the live rows of one split (K or V) into shared memory, `pitch`
// bytes a row: 16-byte cp.async where `vec`, else bytes (zero padded).
// Row `skip` (the write variant's new token; -1 for none) is not read.
__device__ __forceinline__ void copy_rows(uint8_t* dst, const uint8_t* src, long slot0,
                                          int nkv, int row_bytes, int pitch, int n,
                                          const int* live, int vec, int skip) {
  if (vec) {
    // A thread keeps one 16-byte column c of rows j0, j0 + step, ...: one
    // division a thread, not one a copy.
    const int cpr = pitch / 16, step = THREADS / cpr;
    const int j0 = threadIdx.x / cpr, c = threadIdx.x - j0 * cpr;
    if (j0 < step) {
      for (int j = j0; j < n; j += step) {
        if (live[j] && j != skip)
          tc::cp_async16(dst + j * pitch + 16 * c,
                         src + (slot0 + (long)j * nkv) * row_bytes + 16 * c, 16);
      }
    }
  } else {
    for (int i = threadIdx.x; i < n * pitch; i += THREADS) {
      const int j = i / pitch, c = i - j * pitch;
      if (live[j] && j != skip)
        dst[i] = c < row_bytes ? src[(slot0 + (long)j * nkv) * row_bytes + c] : 0;
    }
  }
  tc::cp_async_commit();
}

// The write variant's end of a split: count this block done on the
// counter of its (batch row, head block); the last of the `splits` blocks
// merges the gn rows from row0 as decode_merge_kernel does (its thread
// layout, reductions and order, so the output is the same to the bit)
// and leaves the counter 0. The partials are read past L1 (__ldcg): other
// blocks wrote them.
template <typename TQ>
__device__ __forceinline__ void merge_if_last(const Args& a, long row0, int gn) {
  __shared__ int last_s;
  __shared__ float red_s[WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned* counter = a.counters + (long)blockIdx.y * gridDim.x + blockIdx.x;
  __threadfence();  // this block's partials are visible before its count
  __syncthreads();
  if (tid == 0) {
    last_s = atomicAdd(counter, 1u) == (unsigned)a.splits - 1;
    if (last_s) *counter = 0u;
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  for (int g = 0; g < gn; ++g) {
    const long r = row0 + g;
    const float* m = a.part_ml + r * a.splits * 2;
    // This thread's first split's (m, l), read once (more splits than
    // threads are read again below).
    const bool own = tid < a.splits;
    const float om = own ? __ldcg(m + 2 * tid) : -INFINITY;
    const float ol = own ? __ldcg(m + 2 * tid + 1) : 0.f;
    float mx = om;
    for (int s = tid + THREADS; s < a.splits; s += THREADS) mx = fmaxf(mx, __ldcg(m + 2 * s));
    mx = haff::warp_max(mx);
    if (lane == 0) red_s[warp] = mx;
    __syncthreads();
    mx = fmaxf(fmaxf(red_s[0], red_s[1]), fmaxf(red_s[2], red_s[3]));
    __syncthreads();  // red_s is reused
    float den = 0.f;
    for (int s = tid; s < a.splits; s += THREADS) {
      const float ms = s == tid ? om : __ldcg(m + 2 * s);
      const float ls = s == tid ? ol : __ldcg(m + 2 * s + 1);
      const float w = ms == -INFINITY ? 0.f : expf(ms - mx);
      den = fmaf(ls, w, den);
    }
    den = haff::warp_sum(den);
    if (lane == 0) red_s[warp] = den;
    __syncthreads();
    den = red_s[0] + red_s[1] + red_s[2] + red_s[3];
    if (tid < a.hd) {
      const float* acc = a.part_acc + r * a.splits * a.hd + tid;
      float num = 0.f;
      // Both loads unconditional, so a group's are in flight together; an
      // empty split's acc (never written) is loaded and not used.
#pragma unroll 8
      for (int s = 0; s < a.splits; ++s) {
        const float ms = __ldcg(m + 2 * s);
        const float as = __ldcg(acc + (long)s * a.hd);
        const float w = ms == -INFINITY ? 0.f : expf(ms - mx);
        if (w != 0.f) num = fmaf(as, w, num);
      }
      static_cast<TQ*>(a.out)[r * a.hd + tid] = haff::from_f<TQ>(den > 0.f ? num / den : 0.f);
    }
    __syncthreads();  // red_s is reused by the next row
  }
}

// Six blocks an SM by registers (<= 85 a thread): LLaMA-7B's 640 blocks
// at batch 2 run in one wave on 132 SMs.
template <typename TQ, typename TKV, bool QUANT, bool ALIBI, bool WRITE>
__global__ void __launch_bounds__(THREADS, 6) decode_split_kernel(const Args a) {
  const int hblocks = (a.nh / a.nkv + HEADS_MAX - 1) / HEADS_MAX;
  const int kvh = blockIdx.x / hblocks, hb = blockIdx.x - kvh * hblocks;
  const int b = blockIdx.y, split = blockIdx.z;
  const int group = a.nh / a.nkv;
  const int h0 = kvh * group + hb * HEADS_MAX;
  const int gn = min(HEADS_MAX, group - hb * HEADS_MAX);
  const int j0 = split * a.chunk;
  const int n = min(a.chunk, a.lmax - j0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 3, sub = lane & 7;
  const int row_bytes = a.hd * (int)sizeof(TKV);
  const int pitch = (row_bytes + 15) & ~15;

  __shared__ float q_s[HEADS_MAX][HD_MAX];
  __shared__ float s_s[HEADS_MAX][CHUNK_MAX];
  __shared__ float red[WARPS][HD_MAX];
  __shared__ float ksc[CHUNK_MAX], vsc[CHUNK_MAX];
  __shared__ float m_s[HEADS_MAX], l_s[HEADS_MAX];
  __shared__ int live_s[CHUNK_MAX];
  extern __shared__ uint4 kv_smem[];
  uint8_t* Ks = reinterpret_cast<uint8_t*>(kv_smem);
  uint8_t* Vs = Ks + a.chunk * pitch;

  // The merge kernel may launch now; it waits for this grid to finish.
  asm volatile("griddepcontrol.launch_dependents;");
  int live = 0;
  if (tid < n) live = a.mask[(long)b * a.lmax + j0 + tid] > 0;
  if (tid < CHUNK_MAX) live_s[tid] = live;
  const long row0 = (long)b * a.nh + h0;  // (b, h0) as a row of out
  const long qrow0 = (long)b * a.q_row + (long)h0 * a.hd;  // and of q
  // Slot j of this split is slot0 + j * nkv of the (B, Lmax, nkv) cache.
  const long slot0 = ((long)b * a.lmax + j0) * a.nkv + kvh;
  // The write variant: row jf of this split takes the new token (-1: no
  // row does), written to the cache by the first head block.
  int jf = -1;
  const TQ* kn = nullptr;
  const TQ* vn = nullptr;
  if constexpr (WRITE) {
    const long long p = a.index[b];
    if (p >= j0 && p < j0 + n) jf = (int)(p - j0);
    kn = static_cast<const TQ*>(a.kn) + (long)b * a.q_row + (long)kvh * a.hd;
    vn = static_cast<const TQ*>(a.vn) + (long)b * a.q_row + (long)kvh * a.hd;
    if (jf >= 0 && hb == 0) {
      const long at = (slot0 + (long)jf * a.nkv) * row_bytes;
      TKV* kd = reinterpret_cast<TKV*>(const_cast<uint8_t*>(a.kc) + at);
      TKV* vd = reinterpret_cast<TKV*>(const_cast<uint8_t*>(a.vc) + at);
      for (int e = tid; e < a.hd; e += THREADS) {
        kd[e] = haff::from_f<TKV>(haff::to_f<TQ>(kn[e]));
        vd[e] = haff::from_f<TKV>(haff::to_f<TQ>(vn[e]));
      }
    }
  }
  if (!__syncthreads_or(live)) {  // no live slot: no cache read
    if (a.splits > 1) {
      for (int g = tid; g < gn; g += THREADS) {
        float* ml = a.part_ml + ((row0 + g) * a.splits + split) * 2;
        ml[0] = -INFINITY;
        ml[1] = 0.f;
      }
    } else {
      TQ* out = static_cast<TQ*>(a.out);
      for (int i = tid; i < gn * a.hd; i += THREADS) out[row0 * a.hd + i] = haff::from_f<TQ>(0.f);
    }
    if constexpr (WRITE) {
      if (a.splits > 1) merge_if_last<TQ>(a, row0, gn);
    }
    return;
  }

  copy_rows(Ks, a.kc, slot0, a.nkv, row_bytes, pitch, n, live_s, a.vec, jf);
  copy_rows(Vs, a.vc, slot0, a.nkv, row_bytes, pitch, n, live_s, a.vec, jf);
  if constexpr (WRITE) {
    if (jf >= 0 && live_s[jf]) {
      // The new token's row as the cache holds it, zero padded to the pitch.
      TKV* kr = reinterpret_cast<TKV*>(Ks + jf * pitch);
      TKV* vr = reinterpret_cast<TKV*>(Vs + jf * pitch);
      for (int e = tid; e < pitch / (int)sizeof(TKV); e += THREADS) {
        kr[e] = haff::from_f<TKV>(e < a.hd ? haff::to_f<TQ>(kn[e]) : 0.f);
        vr[e] = haff::from_f<TKV>(e < a.hd ? haff::to_f<TQ>(vn[e]) : 0.f);
      }
    }
  }
  if (QUANT) {
    for (int j = tid; j < n; j += THREADS) {
      ksc[j] = live_s[j] ? a.ks[slot0 + (long)j * a.nkv] : 0.f;
      vsc[j] = live_s[j] ? a.vs[slot0 + (long)j * a.nkv] : 0.f;
    }
  }
  const TQ* q = static_cast<const TQ*>(a.q);
  for (int i = tid; i < gn * HD_MAX; i += THREADS) {
    const int g = i / HD_MAX, e = i - g * HD_MAX;
    q_s[g][e] = e < a.hd ? haff::to_f<TQ>(q[qrow0 + (long)g * a.hd + e]) * a.scale : 0.f;
  }
  tc::cp_async_wait<1>();  // this thread's K copies have landed
  __syncthreads();         // and everyone's; q, scales, flags too

  // Scores: 8 lanes a slot, 4 slots a warp step; the loop is warp-uniform
  // (the shuffles need every lane).
  for (int g = 0; g < gn; ++g) {
    float qf[16];  // the lane's 16 query elements of head g
#pragma unroll
    for (int i = 0; i < 16; ++i) qf[i] = q_s[g][elem<TKV>(sub, i)];
    const float slope = ALIBI ? a.slopes[h0 + g] : 0.f;
#pragma unroll 4
    for (int jw = warp * 4; jw < n; jw += WARPS * 4) {
      const int j = jw + grp;
      const bool ok = j < n && live_s[j];
      float kf[16];
      load_row<TKV>(Ks + j * pitch, sub, pitch, ok, kf);
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) d = fmaf(qf[i], kf[i], d);
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      d += __shfl_xor_sync(0xffffffffu, d, 4);
      if (sub == 0 && j < n) {
        float sj = QUANT ? d * ksc[j] : d;
        if (ALIBI) sj += slope * (float)(j0 + j);  // slot j0 + j of the cache
        s_s[g][j] = ok ? sj : -INFINITY;
      }
    }
  }
  __syncthreads();

  // The split's softmax, a warp a head: dead slots have s = -inf, p = 0.
  for (int g = warp; g < gn; g += WARPS) {
    const float s0 = lane < n ? s_s[g][lane] : -INFINITY;
    const float s1 = lane + 32 < n ? s_s[g][lane + 32] : -INFINITY;
    const float mx = haff::warp_max(fmaxf(s0, s1));  // finite: a slot is live
    const float p0 = expf(s0 - mx), p1 = expf(s1 - mx);
    const float l = haff::warp_sum(p0 + p1);
    if (lane < n) s_s[g][lane] = p0;
    if (lane + 32 < n) s_s[g][lane + 32] = p1;
    if (lane == 0) {
      m_s[g] = mx;
      l_s[g] = l;
    }
  }
  tc::cp_async_wait<0>();  // V has landed
  __syncthreads();

  // P V, a head at a time: the lane groups' sums by shuffle, the warps'
  // through shared memory.
  for (int g = 0; g < gn; ++g) {
    float acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.f;
#pragma unroll 4
    for (int jw = warp * 4; jw < n; jw += WARPS * 4) {
      const int j = jw + grp;
      if (j < n && live_s[j]) {
        float vf[16];
        load_row<TKV>(Vs + j * pitch, sub, pitch, true, vf);
        const float p = QUANT ? s_s[g][j] * vsc[j] : s_s[g][j];
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[i] = fmaf(p, vf[i], acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 8);
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 16);
    }
    if (grp == 0) {
#pragma unroll
      for (int i = 0; i < 16; ++i) red[warp][elem<TKV>(sub, i)] = acc[i];
    }
    __syncthreads();
    if (tid < a.hd) {
      float o = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) o += red[w][tid];
      if (a.splits > 1) {
        a.part_acc[((row0 + g) * a.splits + split) * a.hd + tid] = o;
      } else {
        static_cast<TQ*>(a.out)[(row0 + g) * a.hd + tid] = haff::from_f<TQ>(o / l_s[g]);
      }
    }
    if (a.splits > 1 && tid == 0) {
      float* ml = a.part_ml + ((row0 + g) * a.splits + split) * 2;
      ml[0] = m_s[g];
      ml[1] = l_s[g];
    }
    __syncthreads();  // red is reused by the next head
  }
  if constexpr (WRITE) {
    if (a.splits > 1) merge_if_last<TQ>(a, row0, gn);
  }
}

// Merge the splits of one (b, h) row as the online softmax does; splits
// without a live slot (m = -inf) carry no weight, and a row with none
// gives 0. A thread a split reads the (m, l) pairs at once, the block
// takes their max, each split's weight exp(m - max) and the weighted sum
// of l; then a thread an element sums the weighted acc rows, 8 loads in
// flight at a time (a loop of dependent loads would wait on the cache
// once a split).
template <typename TQ>
__global__ void __launch_bounds__(HD_MAX)
decode_merge_kernel(const float* __restrict__ acc, const float* __restrict__ ml,
                    TQ* __restrict__ out, int splits, int hd) {
  extern __shared__ float w_s[];  // a weight a split
  __shared__ float red_s[HD_MAX / 32];
  // Launched early (programmatic dependent launch): wait until the split
  // kernel has finished and its partials are visible.
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const long r = blockIdx.x;
  const float* m = ml + r * splits * 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float mx = -INFINITY;
  for (int s = tid; s < splits; s += HD_MAX) {
    w_s[s] = m[2 * s];
    mx = fmaxf(mx, w_s[s]);
  }
  mx = haff::warp_max(mx);
  if (lane == 0) red_s[warp] = mx;
  __syncthreads();
  mx = fmaxf(fmaxf(red_s[0], red_s[1]), fmaxf(red_s[2], red_s[3]));
  __syncthreads();  // red_s is reused
  float den = 0.f;
  for (int s = tid; s < splits; s += HD_MAX) {
    const float w = w_s[s] == -INFINITY ? 0.f : expf(w_s[s] - mx);
    w_s[s] = w;
    den = fmaf(m[2 * s + 1], w, den);
  }
  den = haff::warp_sum(den);
  if (lane == 0) red_s[warp] = den;
  __syncthreads();
  den = red_s[0] + red_s[1] + red_s[2] + red_s[3];
  const int e = tid;
  if (e >= hd) return;
  const float* a = acc + r * splits * hd + e;
  float num = 0.f;
  // An empty split never wrote its acc row: weight 0, and not read.
#pragma unroll 8
  for (int s = 0; s < splits; ++s) {
    const float w = w_s[s];
    if (w != 0.f) num = fmaf(a[(long)s * hd], w, num);
  }
  out[r * hd + e] = haff::from_f<TQ>(den > 0.f ? num / den : 0.f);
}

template <typename TQ, typename TKV, bool QUANT, bool ALIBI, bool WRITE>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const int pitch = (a.hd * (int)sizeof(TKV) + 15) & ~15;
  const size_t smem = 2 * (size_t)a.chunk * pitch;
  cudaError_t e = haff::allow_smem(decode_split_kernel<TQ, TKV, QUANT, ALIBI, WRITE>, smem);
  if (e != cudaSuccess) return e;
  const int hblocks = (a.nh / a.nkv + HEADS_MAX - 1) / HEADS_MAX;
  dim3 grid(a.nkv * hblocks, B, a.splits);
  decode_split_kernel<TQ, TKV, QUANT, ALIBI, WRITE><<<grid, THREADS, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1 || WRITE) return e;  // WRITE merged in place
  const size_t wsmem = (size_t)a.splits * sizeof(float);
  e = haff::allow_smem(decode_merge_kernel<TQ>, wsmem);
  if (e != cudaSuccess) return e;
  // Programmatic dependent launch: the merge's launch overlaps the split
  // kernel's run instead of following its end.
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * a.nh);
  cfg.blockDim = dim3(HD_MAX);
  cfg.dynamicSmemBytes = wsmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, decode_merge_kernel<TQ>, (const float*)a.part_acc,
                         (const float*)a.part_ml, static_cast<TQ*>(a.out), a.splits, a.hd);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename TQ, bool ALIBI, bool WRITE>
cudaError_t dispatch_kv(int kv_kind, Args& a, int B, cudaStream_t s) {
  switch (kv_kind) {
    case 0:
      return launch<TQ, float, false, ALIBI, WRITE>(a, B, s);
    case 1:
      return launch<TQ, __nv_bfloat16, false, ALIBI, WRITE>(a, B, s);
    case 2:
      if constexpr (WRITE) {
        return cudaErrorInvalidValue;  // the int8 cache is written by quantize_activation
      } else {
        if (a.ks == nullptr || a.vs == nullptr) return cudaErrorInvalidValue;
        return launch<TQ, int8_t, true, ALIBI, false>(a, B, s);
      }
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TQ, bool WRITE>
cudaError_t dispatch(int kv_kind, Args& a, int B, cudaStream_t s) {
  const int item = kv_kind == 1 ? 2 : kv_kind == 2 ? 1 : 4;
  a.vec = (a.hd * item) % 16 == 0 && reinterpret_cast<uintptr_t>(a.kc) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(a.vc) % 16 == 0;
  if (a.slopes != nullptr) return dispatch_kv<TQ, true, WRITE>(kv_kind, a, B, s);
  return dispatch_kv<TQ, false, WRITE>(kv_kind, a, B, s);
}

// The checks and the Args both entries share.
bool valid(int lmax, int nh, int nkv, int hd, int splits, int chunk, const void* part) {
  return !(hd > HD_MAX || hd <= 0 || nkv <= 0 || nh % nkv || chunk < 1 || chunk > CHUNK_MAX ||
           splits < 1 || (long)splits * chunk < lmax ||
           (splits > 1 && (long)(splits - 1) * chunk >= lmax) ||
           (splits > 1 && part == nullptr));
}

Args make_args(const void* q, long q_row, const void* kc, const void* vc, const void* slopes,
               const void* mask, void* out, void* part, int B, int lmax, int nh, int nkv,
               int hd, float scale, int splits, int chunk) {
  Args a = {};
  a.q = q;
  a.q_row = q_row;
  a.kc = static_cast<const uint8_t*>(kc);
  a.vc = static_cast<const uint8_t*>(vc);
  a.slopes = static_cast<const float*>(slopes);
  a.mask = static_cast<const int*>(mask);
  a.out = out;
  a.part_acc = static_cast<float*>(part);
  a.part_ml = a.part_acc == nullptr ? nullptr : a.part_acc + (long)B * nh * splits * hd;
  a.lmax = lmax;
  a.nh = nh;
  a.nkv = nkv;
  a.hd = hd;
  a.chunk = chunk;
  a.splits = splits;
  a.vec = 0;
  a.scale = scale;
  return a;
}

}  // namespace

// kv_kind: 0 f32 cache, 1 bf16 cache, 2 int8 cache with f32 scales ks, vs
// (B, lmax, nkv). q and out are bf16 (q_bf16) or f32. `slopes`: nh f32
// ALiBi slopes, or null for none. The slots are cut into `splits` blocks
// of `chunk` (decode_plan); with splits > 1, `part` is float32 scratch of
// B * nh * splits * (hd + 2) values.
extern "C" int decode_attn(const void* q, const void* kc, const void* vc, const void* ks,
                           const void* vs, const void* slopes, const void* mask, void* out,
                           void* part, int B,
                           int lmax, int nh, int nkv, int hd, float scale, int q_bf16,
                           int kv_kind, int splits, int chunk, void* stream) {
  if (!valid(lmax, nh, nkv, hd, splits, chunk, part)) return (int)cudaErrorInvalidValue;
  Args a = make_args(q, (long)nh * hd, kc, vc, slopes, mask, out, part, B, lmax, nh, nkv, hd,
                     scale, splits, chunk);
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_bf16) return (int)dispatch<__nv_bfloat16, false>(kv_kind, a, B, s);
  return (int)dispatch<float, false>(kv_kind, a, B, s);
}

// The write variant. qkv: (B, nh * hd + 2 * nkv * hd) with rows q_row
// elements apart, bf16 (q_bf16) or f32: q, then the new token's k, then
// its v. kc, vc: f32 (kv_kind 0) or bf16 (1) caches, row b's new k/v
// written at slot index[b] (int64; nothing is written where it lies
// outside [0, lmax)). counters: with splits > 1, B * nkv * head blocks
// unsigned zeros, left zero. Otherwise as decode_attn.
extern "C" int decode_attn_write(const void* qkv, long q_row, void* kc, void* vc,
                                 const void* slopes, const void* mask, const void* index,
                                 void* out, void* part, void* counters, int B, int lmax, int nh,
                                 int nkv, int hd, float scale, int q_bf16, int kv_kind,
                                 int splits, int chunk, void* stream) {
  if (!valid(lmax, nh, nkv, hd, splits, chunk, part) || index == nullptr ||
      (splits > 1 && counters == nullptr) || (kv_kind != 0 && kv_kind != 1) ||
      q_row < (long)(nh + 2 * nkv) * hd)
    return (int)cudaErrorInvalidValue;
  Args a = make_args(qkv, q_row, kc, vc, slopes, mask, out, part, B, lmax, nh, nkv, hd, scale,
                     splits, chunk);
  const long item = q_bf16 ? 2 : 4;
  a.kn = static_cast<const uint8_t*>(qkv) + (long)nh * hd * item;
  a.vn = static_cast<const uint8_t*>(a.kn) + (long)nkv * hd * item;
  a.index = static_cast<const long long*>(index);
  a.counters = static_cast<unsigned*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_bf16) return (int)dispatch<__nv_bfloat16, true>(kv_kind, a, B, s);
  return (int)dispatch<float, true>(kv_kind, a, B, s);
}
