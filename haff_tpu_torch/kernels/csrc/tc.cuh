// Tensor-core building blocks of the bf16 attention kernels
// (sam_window_attn.cu, sam_global_attn.cu, flash_prefill.cu,
// flash_bwd.cu): 16-byte cp.async with zero
// fill, ldmatrix, mma.sync m16n8k16 (bf16 or fp16 operands, f32 sums), the
// band of the decomposed relative-position bias on the tensor cores, the
// online softmax of a warp's 16 query rows over a tile of keys, and the
// pieces of the warpgroup-MMA path: wgmma with register A operands,
// matrix descriptors (unswizzled and 128-byte swizzled), mbarriers, TMA
// loads and the (B, L, H, D) tensor map; and for w8a8_matmul.cu the s8
// wgmma with int32 sums, the 2-d TMA load and the (rows, K) int8 map.
//
// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major): a0 = A[g][2t..2t+1],   a1 = A[g+8][2t..],
//                           a2 = A[g][2t+8..],     a3 = A[g+8][2t+8..]
//   B (16 x 8, k x n):      b0 = B[2t..2t+1][g],   b1 = B[2t+8..][g]
//   C (16 x 8, f32):        c0, c1 = C[g][2t..],   c2, c3 = C[g+8][2t..]
// so a warp owns 16 query rows, and each thread two of them (g, g + 8).
#pragma once

#include <cuda.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "common.cuh"

namespace haff {
namespace tc {

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; `bytes` 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Four 8 x 8 bf16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a @ b, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as a bf16 pair, the first in the low half (round to nearest).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x0, x1 as bf16 pairs hi = bf16(x) and lo = bf16(x - hi): hi + lo
// carries ~16 significant bits.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h2);
  lo = pack_bf16(x0 - __low2float(h2), x1 - __high2float(h2));
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A fragments of 16 rows of q (rows >= L and columns >= d read as 0),
// straight from device memory: element (i, c) at q[i * row + c]. Needs a
// 4-byte aligned base and an even row stride.
template <int KS>
__device__ __forceinline__ void load_q(uint32_t (&qf)[KS][4], const __nv_bfloat16* q,
                                       long long row, int row0, int L, int d, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = row0 + g + (x & 1) * 8;
      const int c = kk * 16 + (x >> 1) * 8 + 2 * t;
      qf[kk][x] = (i < L && c < d)
                      ? *reinterpret_cast<const uint32_t*>(q + i * row + c)
                      : 0u;
    }
}

// The band of 16 query rows row0.. of a grid (H, W), into a warp's table
// tab[16][H + W] (times log2 e): tab[r][y] = Bh[i, y] = q_i . rel_h[ri - y
// + H - 1] and tab[r][H + x] = Bw[i, x] = q_i . rel_w[ci - x + W - 1], for
// query i = row0 + r at grid cell (ri, ci). The rows of each table that
// the warp's queries use run through the tensor cores in slices of 8,
// A = q_i . rel[m], and each sum is stored where its offset m lands. The rel-pos tables
// are float32; they enter as bf16 hi + lo halves (split_bf16) and both are
// multiplied, which keeps the products exact to ~2^-16 relative (q is
// bf16 already). `frag(part, m0, kk, hi, lo)` gives the B fragments of
// table part (0: h, 1: w), rows m0.., columns 16 kk..; `ldt` is the
// table's row stride. The caller syncs the warp before reading the table.
template <int KS, class Frag>
__device__ __forceinline__ void band_rows(const uint32_t (&qf)[KS][4], int H, int W,
                                          int row0, float* tab, int ldt, int lane,
                                          Frag frag) {
  const int g = lane >> 2, t = lane & 3;
  int cell[2][2];  // [row half][0: grid row, 1: grid column]
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int i = row0 + g + hf * 8;
    cell[hf][0] = i / W;
    cell[hf][1] = i - cell[hf][0] * W;
  }
#pragma unroll
  for (int part = 0; part < 2; ++part) {
    const int n = part ? W : H;
    // Table rows the 16 queries use: cell - y + n - 1 for y < n, i.e. the
    // span [min cell, max cell + n - 1] of the warp's cells.
    int lo = min(cell[0][part], cell[1][part]), hi = max(cell[0][part], cell[1][part]);
#pragma unroll
    for (int o = 4; o <= 16; o <<= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    const int m_end = min(hi + n - 1, 2 * n - 2) + 1;
    // Two slices of 8 table rows at a time: independent product chains.
    for (int m0 = lo & ~7; m0 < m_end; m0 += 16) {
      float acc[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          uint32_t fh[2], fl[2];
          frag(part, m0 + 8 * x, kk, fh, fl);
          mma(acc[x], qf[kk], fh[0], fh[1]);
          mma(acc[x], qf[kk], fl[0], fl[1]);
        }
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hf = e >> 1;
          const int y = cell[hf][part] + n - 1 - (m0 + 8 * x + 2 * t + (e & 1));
          if (y >= 0 && y < n) tab[(g + hf * 8) * ldt + part * H + y] = acc[x][e] * LOG2E;
        }
    }
  }
}

// band_rows' B fragments read from the f32 tables in device memory (rows
// >= 2n - 1 and columns >= d as zeros), split on the fly.
struct RelFromGlobal {
  const float* rel_h;
  const float* rel_w;
  int H, W, d, lane;
  __device__ __forceinline__ void operator()(int part, int m0, int kk, uint32_t (&hi)[2],
                                             uint32_t (&lo)[2]) const {
    const float* rel = part ? rel_w : rel_h;
    const int rows = 2 * (part ? W : H) - 1;
    const int m = m0 + (lane >> 2);
#pragma unroll
    for (int y = 0; y < 2; ++y) {
      const int c = kk * 16 + y * 8 + 2 * (lane & 3);
      const bool ok = m < rows && c < d;
      split_bf16(ok ? rel[m * d + c] : 0.f, ok ? rel[m * d + c + 1] : 0.f, hi[y], lo[y]);
    }
  }
};

// Running state of a warp's 16 query rows: output sums, row max and
// (per-thread partial) row sum, both in log2 units.
template <int NO>
struct RowState {
  float o[NO][4];
  float m[2];
  float l[2];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
  }
};

// S = Q K^T for a warp's 16 rows over `npairs` (1..4) pairs of 8-key
// columns of a key tile in shared memory (row stride DS elements):
// ldmatrix of K rows gives the column-major B. s[n][e] is accumulator
// element e of key column block n.
template <int KS, int DS>
__device__ __forceinline__ void qk_mma(float (&s)[8][4], const uint32_t (&qf)[KS][4],
                                       const __nv_bfloat16* Ks, int npairs, int lane) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
  const int krow = (lane & 7) + (lane >> 4) * 8;
  const int kcol = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    if (np < npairs) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t b[4];
        ldsm_x4(b, Ks + (np * 16 + krow) * DS + kk * 16 + kcol);
        mma(s[2 * np], qf[kk], b[0], b[1]);
        mma(s[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }
  }
}

// The online-softmax update of one key tile, in place: s goes in as raw
// scores and comes out as p = exp2(logit - running max). `logit(hf, n, e,
// x)` turns the raw score x of element (n, e) in row half hf into its
// log2-unit logit less the row's term rb[hf] (a bias constant over the
// tile, added to the max and taken out of the exponent instead of added per
// score); with MASK, keys at or past `live` in the tile get -inf and logit
// is not called for them. The row sums take the f32 p.
template <bool MASK, int NO, class Logit>
__device__ __forceinline__ void softmax_tile(float (&s)[8][4], const float (&rb)[2],
                                             Logit logit, int live, RowState<NO>& st,
                                             int lane) {
  const int t = lane & 3;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = (!MASK || n * 8 + 2 * t + (e & 1) < live)
                          ? logit(e >> 1, n, e & 1, s[n][e])
                          : -INFINITY;
      s[n][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float off[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
    const float m_new = fmaxf(st.m[hf], mx[hf] + rb[hf]);
    const float alpha = exp2_approx(st.m[hf] - m_new);
    st.m[hf] = m_new;
    st.l[hf] *= alpha;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      st.o[n][2 * hf] *= alpha;
      st.o[n][2 * hf + 1] *= alpha;
    }
    off[hf] = m_new - rb[hf];
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2_approx(s[n][e] - off[e >> 1]);
      s[n][e] = p;
      st.l[e >> 1] += p;
    }
}

// The A fragments of P for the P @ V k-step ks (keys 16 ks ..), twice:
// hi = bf16(p) and lo = bf16(p - hi). P rounded to bf16 alone (as the JAX
// kernels do, `p.astype(v.dtype)`) puts outputs outside the bf16
// tolerance against the float32 function at ViT-H shapes; hi + lo keeps
// p to ~2^-16 relative.
__device__ __forceinline__ void split_p(const float (&p)[8][4], int ks, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const float* pp = &p[2 * ks + (x >> 1)][(x & 1) * 2];
    split_bf16(pp[0], pp[1], hi[x], lo[x]);
  }
}

// O += P V over `npairs` 16-key k-steps of a tile in shared memory (row
// stride DS): P's accumulator layout is the A layout (split_p), and
// ldmatrix.trans of V rows gives the column-major B. Only the first nd
// column blocks of 8 of O are live.
template <int NO, int DS>
__device__ __forceinline__ void pv_mma(RowState<NO>& st, const float (&p)[8][4],
                                       const __nv_bfloat16* Vs, int npairs, int nd,
                                       int lane) {
  const int vrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int vcol = (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    if (ks < npairs) {
      uint32_t hi[4], lo[4];
      split_p(p, ks, hi, lo);
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        if (2 * np < nd) {
          uint32_t b[4];
          ldsm_x4_t(b, Vs + (ks * 16 + vrow) * DS + np * 16 + vcol);
          mma(st.o[2 * np], hi, b[0], b[1]);
          mma(st.o[2 * np], lo, b[0], b[1]);
          if (2 * np + 1 < nd) {
            mma(st.o[2 * np + 1], hi, b[2], b[3]);
            mma(st.o[2 * np + 1], lo, b[2], b[3]);
          }
        }
      }
    }
  }
}

// c += a @ b with fp16 operands, f32 accumulators.
__device__ __forceinline__ void mma_f16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// pv_mma with P and V in fp16 (V converted in shared memory beforehand):
// p in [0, 1] rounds to 11 significant bits (to 2^-24 steps below 2^-14,
// fp16's subnormals: at most 2^-25 absolute), and one product per k-step
// replaces the bf16 hi + lo pair.
template <int NO, int DS>
__device__ __forceinline__ void pv_mma_f16(RowState<NO>& st, const float (&p)[8][4],
                                           const __nv_bfloat16* Vs, int npairs, int nd,
                                           int lane) {
  const int vrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int vcol = (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    if (ks < npairs) {
      uint32_t a[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float* pp = &p[2 * ks + (x >> 1)][(x & 1) * 2];
        const __half2 h2 = __floats2half2_rn(pp[0], pp[1]);
        a[x] = *reinterpret_cast<const uint32_t*>(&h2);
      }
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        if (2 * np < nd) {
          uint32_t b[4];
          ldsm_x4_t(b, Vs + (ks * 16 + vrow) * DS + np * 16 + vcol);
          mma_f16(st.o[2 * np], a, b[0], b[1]);
          if (2 * np + 1 < nd) mma_f16(st.o[2 * np + 1], a, b[2], b[3]);
        }
      }
    }
  }
}

// ---- Warpgroup MMA (wgmma), for the kernels that feed it ----
//
// Operands in shared memory use the layout without swizzle: 8 x 8 core
// matrices of 128 contiguous bytes (8 rows of 16 bytes). A key tile of 64
// rows x dp columns is stored column block by column block: element
// (r, c) at (c / 8) * 512 + r * 8 + c % 8, so a column block of 8 is 64
// rows x 16 bytes = 1024 bytes. As the B operand of S = Q K^T (K-major:
// k = head dim, n = key) the leading byte offset (next 8 columns of k) is
// 1024 and the stride byte offset (next 8 keys) 128; as the B operand of
// O += P V (n = head dim contiguous, transposed) the k direction (keys)
// steps 128 bytes per 8 rows and the n direction 1024 per 8 columns.

__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);  // layout type 0: no swizzle
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of products are still running.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Ties registers to the point after a wg_wait, so no read of an
// accumulator moves above the wait.
template <int N>
__device__ __forceinline__ void wg_hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// Keeps A-operand registers alive (unreused) up to the point after the
// wait that retires the products reading them.
__device__ __forceinline__ void wg_hold(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// ---- mbarriers and TMA ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Waits for the phase of parity `parity` to complete. A wait that lasts
// about two seconds traps (the launch fails) rather than hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  long long start = 0;
  for (int i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if ((i & 1023) == 0) {
      const long long now = clock64();
      if (i == 0) start = now;
      else if (now - start > 4000000000LL) __trap();
    }
  }
}
// A 4-d box of a tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const void* tmap, uint64_t* bar, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}


// d (m64 x n64, f32) {+}= a (m64 x k16, bf16 registers) @ B (k16 x n64, bf16
// in shared memory, `desc`); trans_b = 1 when B's n index is contiguous.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                        int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate), "n"(TRANS_B));
}

// d (m64 x n16, f32) {+}= a (m64 x k16, bf16 registers) @ B (k16 x n16, bf16
// in shared memory, `desc`); trans_b = 1 when B's n index is contiguous.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t desc,
                                        int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate), "n"(TRANS_B));
}

// d (m64 x n80, f32) {+}= a (m64 x k16, bf16 registers) @ B (k16 x n80, bf16
// in shared memory, `desc`); trans_b = 1 when B's n index is contiguous.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_n80(float (&d)[40], const uint32_t (&a)[4], uint64_t desc,
                                        int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, %46;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate), "n"(TRANS_B));
}


// d (m64 x n128, f32) {+}= a (m64 x k16, bf16 registers) @ B (k16 x n128, bf16
// in shared memory, `desc`); trans_b = 1 when B's n index is contiguous.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate), "n"(TRANS_B));
}

// d (m64 x n64, f32) {+}= A (m64 x k16) @ B (k16 x n64), both bf16 in shared
// memory (`da`, `db`), both with k contiguous (K-major).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// ---- 128-byte swizzled operands (the flash kernels) ----
//
// A tile of rows of 64 bf16 columns (128 bytes a row), as TMA writes it
// with CU_TENSOR_MAP_SWIZZLE_128B: 16-byte chunk c of row r lands at
// r * 128 + (c ^ r % 8) * 16, in 1 KB atoms of 8 rows; tiles start on
// 1 KB boundaries, so the swizzle's base offset is 0. A 64-row tile is 8
// KB. K-major operand (k contiguous: K in S = Q K^T, Q in S^T = K Q^T):
// stride byte offset 1024 (next 8 rows), leading byte offset unused; the
// k-step of 16 columns adds 32 bytes to the start address, and columns
// 64.. are the next tile. MN-major operand (n contiguous: V in O += P V):
// stride byte offset 1024 (next 8 rows of k), leading byte offset the
// distance from one 64-column tile to the next; the k-step of 16 rows
// adds 2048 bytes.
__device__ __forceinline__ uint64_t wg_desc_sw128(const void* p, uint32_t lbo, uint32_t sbo) {
  return wg_desc(p, lbo, sbo) | (1ull << 62);  // layout type 1: 128-byte swizzle
}

// Rows of a warp's 16-row f32 accumulator block (wgmma / mma layout, NO
// column blocks of 8), each row half hf times inv[hf], as bf16 into
// out[i * row + c] for rows i = row0 + r < L and the first `nchunk`
// 16-byte chunks of each row, through the warp's staging area (8 rows,
// stride SDS elements, 16-byte aligned): each store instruction writes
// whole 16-byte chunks. Needs a 16-byte aligned `out` and row stride.
template <int NO, int SDS>
__device__ __forceinline__ void store_acc_staged(const float (&acc)[NO * 4], const float (&inv)[2],
                                                 __nv_bfloat16* out, long long row, int row0,
                                                 int L, int nchunk, __nv_bfloat16* stage,
                                                 int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    __syncwarp();  // the area's last readers are done
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(stage + g * SDS + n * 8 + 2 * t) =
          pack_bf16(acc[4 * n + 2 * hf] * inv[hf], acc[4 * n + 2 * hf + 1] * inv[hf]);
    __syncwarp();
    for (int o = lane; o < 8 * nchunk; o += 32) {
      const int r = o / nchunk, c = (o - r * nchunk) * 8, i = row0 + hf * 8 + r;
      if (i < L)
        *reinterpret_cast<uint4*>(out + i * row + c) =
            *reinterpret_cast<const uint4*>(stage + r * SDS + c);
    }
  }
}

// The fragment store_acc_staged takes (rows row0 + 8 hf + g, columns
// 8 n + 2 t + {0, 1}), each row half hf times inv[hf], as float32 into
// out[i * row + c] for rows i < L and the nchunk 8-column groups n <
// nchunk (the head dim, which may be narrower than the padded NO * 8):
// the unrounded values a caller sums (ring attention's partials). Needs
// an 8-byte aligned `out` and an even row stride.
template <int NO>
__device__ __forceinline__ void store_acc_f32(const float (&acc)[NO * 4], const float (&inv)[2],
                                              float* out, long long row, int row0, int L,
                                              int nchunk, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int i = row0 + hf * 8 + g;
    if (i >= L) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      if (n < nchunk)
        *reinterpret_cast<float2*>(out + i * row + n * 8 + 2 * t) =
            make_float2(acc[4 * n + 2 * hf] * inv[hf], acc[4 * n + 2 * hf + 1] * inv[hf]);
  }
}

// store_rows through a warp's staging area (8 rows, row stride DS): each
// store instruction writes whole 16-byte chunks of rows (needs a 16-byte
// aligned base and row stride).
template <int NO, int DS>
__device__ __forceinline__ void store_rows_staged(RowState<NO>& st, __nv_bfloat16* out,
                                                  long long C, int row0, int L, int nd,
                                                  __nv_bfloat16* stage, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float inv[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float l = st.l[hf];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[hf] = 1.f / l;
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    __syncwarp();  // the area's last readers are done
#pragma unroll
    for (int n = 0; n < NO; ++n)
      if (n < nd)
        *reinterpret_cast<uint32_t*>(stage + g * DS + n * 8 + 2 * t) =
            pack_bf16(st.o[n][2 * hf] * inv[hf], st.o[n][2 * hf + 1] * inv[hf]);
    __syncwarp();
    for (int o = lane; o < 8 * nd; o += 32) {
      const int r = o / nd, c = (o - r * nd) * 8, i = row0 + hf * 8 + r;
      if (i < L)
        *reinterpret_cast<uint4*>(out + i * C + c) =
            *reinterpret_cast<const uint4*>(stage + r * DS + c);
    }
  }
}

// o / l as bf16 into rows row0.. of out (row stride C elements), the
// first nd column blocks of 8; rows >= L are not stored.
template <int NO>
__device__ __forceinline__ void store_rows(RowState<NO>& st, __nv_bfloat16* out,
                                           long long C, int row0, int L, int nd,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
  float inv[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float l = st.l[hf];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[hf] = 1.f / l;
  }
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    if (n < nd) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = row0 + g + hf * 8;
        if (i < L)
          *reinterpret_cast<uint32_t*>(out + i * C + n * 8 + 2 * t) =
              pack_bf16(st.o[n][2 * hf] * inv[hf], st.o[n][2 * hf + 1] * inv[hf]);
      }
    }
  }
}

// ---- int8 operands (w8a8_matmul.cu) ----
//
// A (rows, K) int8 matrix in shared memory as TMA writes a box of 128
// bytes of K x rows with the 128-byte swizzle: the same 1 KB atoms of 8
// rows x 128 bytes as the bf16 tiles above. One k32 step of an s8 wgmma
// reads 32 bytes of each row, as a bf16 k16 step does, so a K-major
// operand's descriptor is built and stepped exactly as Q's or K's are:
// stride byte offset 1024 (next 8 rows), +32 bytes a k-step, the next
// 128 bytes of K in the next box.
__device__ __forceinline__ uint64_t kmajor_desc_sw128(const void* p) {
  return wg_desc_sw128(p, 16, 1024);
}

// d (m64 x n128, s32) {+}= A (m64 x k32) @ B (k32 x n128), both int8 in
// shared memory (`da`, `db`), both K-major (8-bit operands have no
// transposed form). The int32 sums are exact (no saturation below 2^31).
__device__ __forceinline__ void wgmma_s8_n128(int32_t (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (m64 x n256, f32) {+}= A (m64 x k16) @ B (k16 x n256), both bf16 in
// shared memory (`da`, `db`), both K-major (the matmul probe).
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (m64 x n256, s32) {+}= A (m64 x k32) @ B (k32 x n256), both int8 in
// shared memory, both K-major (the matmul probe); exact int32 sums.
__device__ __forceinline__ void wgmma_s8_n256(int32_t (&d)[128], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wg_hold(int32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// A 2-d box of a tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const void* tmap, uint64_t* bar, int c0,
                                            int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// ---- host side: tensor maps ----

// cuTensorMapEncodeTiled, a driver function, through the runtime's entry
// point table (no link against libcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A contiguous bf16 (B, L, H, D) tensor as the 4-d map (D, H, L, B) with
// boxes of 64 columns x 1 head x 64 rows, 128-byte swizzle (the layout
// wg_desc_sw128 reads). Columns past D and rows past L read as zeros, so
// D < 64 and the ragged last tile need no masking of the copy. Needs a
// 16-byte aligned base and D % 8 == 0.
inline bool bhld_map_sw128(CUtensorMap* map, const void* base, int D, int H, int L, int B) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (!encode) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)L * H * D * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A contiguous row-major int8 (rows, K) matrix as the 2-d map (K, rows)
// with boxes of 128 bytes of K x `box_rows` rows, 128-byte swizzle (the
// layout kmajor_desc_sw128 reads). Rows past `rows` and bytes past K read
// as zeros. Needs a 16-byte aligned base and K % 16 == 0 (TMA's stride
// rule).
inline bool rows_map_sw128(CUtensorMap* map, const void* base, int rows, int K, int box_rows) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {128, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tc
}  // namespace haff
