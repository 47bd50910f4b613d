// Pieces shared by window_attn_fwd.cu and window_attn_bwd.cu: the level
// table, the window-to-raster mapping, shared-memory staging, and the warp
// products on tensor cores (mma.sync: m16n8k8 TF32 in the 3xTF32 split for
// float32, m16n8k16 bf16 for bfloat16).
//
// One block handles one (window, head), heads fastest in the grid so that
// the blocks that run together read whole token rows: 8 warps, each owning
// 16 rows (query rows in the row-major products, key rows in the transposed
// ones) of the 128-token window.  Fragment layouts are those of the PTX ISA for
// mma.m16n8k8 (.tf32) and mma.m16n8k16 (.bf16): with g = lane / 4 and
// t = lane % 4, a thread holds accumulator rows g and g + 8, columns 2t and
// 2t + 1 of each 8-column tile.
//
// Shared-memory row strides are chosen so that every fragment read is free
// of bank conflicts (32 banks of 4 bytes):
//   k, v (read as B of q k^T / dO v^T: word g * s + t, t < 4, g < 8),
//   and q in the forward (read as A, the same words):
//       s = 4 (mod 8) words -> f32 D + 4, bf16 D / 2 + pad words;
//       the same rows read down a column (f32 P V: word 2t * s + g) then
//       need 2s = 8 or 24 (mod 32), which D + 4 also gives for D = 8, 16,
//       32, 64;
//       bf16 reads those with ldmatrix.trans, rows 16-byte aligned.
//   q, dO in the backward (B of P^T dO, dS^T q: word t * s + g):
//       f32 s = 8 or 24 (mod 32); bf16 as k, v (ldmatrix.trans).  Their
//       reads as A of q k^T and dO v^T (word g * s + t) then meet two-way
//       conflicts in f32, once per k step.
//   P, dS in the backward (read transposed: word t * s + g):
//       f32 136 floats; bf16 136 elements (68 words, ldmatrix.trans).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace wattn {

constexpr int kTokens = 128;   // wh * ww of the (8, 16) window
constexpr int kWarps = 8;      // 16 rows each
constexpr int kThreads = kWarps * 32;
constexpr int kMaxLevels = 8;
constexpr int kScoreStride = 136;   // P and dS rows in the backward
constexpr float kMasked = -1e9f;

// One level raster of a launch.  in: q, k, v and (backward) g; out: the
// output, or dq, dk, dv.  first: the launch-wide index of its first window.
struct Level {
  const void* in[4];
  const float* keep;
  void* out[3];
  int Hp, Wp, first;
};

// Passed by value as the kernel's argument: no copy to the device.
struct LevelTable {
  Level lv[kMaxLevels];
  int n, C, heads, wh, ww;
  float scale, scale2;   // 1 / sqrt(D), and log2(e) / sqrt(D)
};

template <typename T, int D>
struct Strides {
  static constexpr bool kF32 = sizeof(T) == 4;
  // k, v rows (and q, dO rows in bf16)
  static constexpr int kv = kF32 ? D + 4 : D + 2 * ((4 - D / 2) & 7);
  // q, dO rows in the f32 backward: D + 8 or D + 16, whichever is 8 or
  // 24 (mod 32) words
  static constexpr int qg = kF32 ? ((D + 8) % 16 == 8 ? D + 8 : D + 16) : kv;
  static_assert((kv * sizeof(T)) % 16 == 0 && (qg * sizeof(T)) % 16 == 0,
                "rows must stay 16-byte aligned");
};

// The level, window and head of this block (static indices only: the
// table stays in the parameter space) and the raster index of its window's
// token 0.
struct Window {
  Level L;
  int64_t origin;
  int Wp, ww, head;
  __device__ __forceinline__ int64_t token(int t) const {
    return origin + (int64_t)(t / ww) * Wp + t % ww;
  }
};

__device__ __forceinline__ Window find_window(const LevelTable& tab) {
  Window w;
  const int win = (int)blockIdx.x / tab.heads;
  w.head = (int)blockIdx.x - win * tab.heads;
  w.L = tab.lv[0];
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i)
    if (i < tab.n && win >= tab.lv[i].first) w.L = tab.lv[i];
  const int idx = win - w.L.first;
  const int nww = w.L.Wp / tab.ww;
  const int per_b = (w.L.Hp / tab.wh) * nww;
  const int b = idx / per_b, rem = idx - b * per_b;
  const int wi = rem / nww, wj = rem - wi * nww;
  w.origin = ((int64_t)b * w.L.Hp + (int64_t)wi * tab.wh) * w.L.Wp
             + (int64_t)wj * tab.ww;
  w.Wp = w.L.Wp;
  w.ww = tab.ww;
  return w;
}

// ---------------------------------------------------------------------
// staging: 16-byte cp.async of the head slice of every token of the window
// ---------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

template <typename T, int D>
__device__ __forceinline__ void stage(T* dst, int stride, const void* src,
                                      const Window& w, int C) {
  constexpr int kVec = 16 / sizeof(T), kChunks = D / kVec;
  const T* base = static_cast<const T*>(src) + w.head * D;
  for (int i = threadIdx.x; i < kTokens * kChunks; i += kThreads) {
    const int t = i / kChunks, c = i - t * kChunks;
    cp_async16(dst + t * stride + c * kVec, base + w.token(t) * C + c * kVec);
  }
}

__device__ __forceinline__ void stage_keep(float* dst, const Window& w) {
  for (int t = threadIdx.x; t < kTokens; t += kThreads)
    dst[t] = w.L.keep[w.token(t)];
}

// ---------------------------------------------------------------------
// tensor-core products
// ---------------------------------------------------------------------
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, big rounded to TF32: the 3xTF32 product big*big +
// big*small + small*big keeps about f32 accuracy (small*small is below
// f32's ulp).  small goes to the tensor core as it is, which reads its top
// 19 bits: what that drops is under 2^-22 of x.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

struct FragA { uint32_t big[4], small[4]; };
struct FragB { uint32_t big[2], small[2]; };

__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2,
                                        float a3) {
  FragA f;
  split(a0, f.big[0], f.small[0]);
  split(a1, f.big[1], f.small[1]);
  split(a2, f.big[2], f.small[2]);
  split(a3, f.big[3], f.small[3]);
  return f;
}

__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  split(b0, f.big[0], f.small[0]);
  split(b1, f.big[1], f.small[1]);
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(d, a.small, b.big);
  mma_tf32(d, a.big, b.small);
  mma_tf32(d, a.big, b.big);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2],
                                              const void* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// acc[j] (16 rows x keys 8j..8j+7) += A . M^T, with A the staged rows r
// and r + 8 of q or dO (a0, a1) and M the (128, D) rows of k or v, all in
// shared memory (M with stride Strides::kv).  f32: 3xTF32.
template <int D>
__device__ __forceinline__ void rows_by_rows(float (&acc)[16][4],
                                             const float* a0, const float* a1,
                                             const float* m) {
  constexpr int kS = Strides<float, D>::kv;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const FragA a = frag_a(a0[kk * 8 + t], a1[kk * 8 + t],
                           a0[kk * 8 + t + 4], a1[kk * 8 + t + 4]);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float* mr = m + (j * 8 + g) * kS + kk * 8;
      mma3(acc[j], a, frag_b(mr[t], mr[t + 4]));
    }
  }
}

template <int D>
__device__ __forceinline__ void rows_by_rows(float (&acc)[16][4],
                                             const __nv_bfloat16* a0,
                                             const __nv_bfloat16* a1,
                                             const __nv_bfloat16* m) {
  constexpr int kS = Strides<__nv_bfloat16, D>::kv;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < (D + 15) / 16; ++kk) {
    uint32_t a[4] = {ld32(a0 + kk * 16 + 2 * t), ld32(a1 + kk * 16 + 2 * t),
                     0u, 0u};
    if constexpr (D >= 16) {   // D = 8 pads the k16 step with zeros
      a[2] = ld32(a0 + kk * 16 + 8 + 2 * t);
      a[3] = ld32(a1 + kk * 16 + 8 + 2 * t);
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const __nv_bfloat16* mr = m + (j * 8 + g) * kS + kk * 16;
      uint32_t b[2] = {ld32(mr + 2 * t), 0u};
      if constexpr (D >= 16) b[1] = ld32(mr + 8 + 2 * t);
      mma_bf16(acc[j], a, b);
    }
  }
}

// out[n] (16 rows x channels 8n..8n+7) += P . M, with P (16 x 128) the
// accumulator fragments of rows_by_rows and M the (128, D) rows of v or k
// in shared memory (stride Strides::kv).  f32: the k index of step j is
// permuted (k = t <-> key 8j + 2t, k = t + 4 <-> key 8j + 2t + 1) so that
// the accumulator registers are the A fragment as they stand; M is read
// down the same keys.  bf16: P is rounded to bf16 (the contract's cast of
// the weights to the value's dtype), the fragments are the standard
// accumulator-to-A reuse, and M comes through ldmatrix.trans.
template <int D>
__device__ __forceinline__ void scores_by_rows(float (&out)[D / 8][4],
                                               const float (&p)[16][4],
                                               const float* m) {
  constexpr int kS = Strides<float, D>::kv;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const FragA a = frag_a(p[j][0], p[j][2], p[j][1], p[j][3]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float* mr = m + (j * 8 + 2 * t) * kS + n * 8 + g;
      mma3(out[n], a, frag_b(mr[0], mr[kS]));
    }
  }
}

template <int D>
__device__ __forceinline__ void scores_by_rows(float (&out)[D / 8][4],
                                               const float (&p)[16][4],
                                               const __nv_bfloat16* m) {
  constexpr int kS = Strides<__nv_bfloat16, D>::kv;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const uint32_t a[4] = {pack_bf16(p[2 * jj][0], p[2 * jj][1]),
                           pack_bf16(p[2 * jj][2], p[2 * jj][3]),
                           pack_bf16(p[2 * jj + 1][0], p[2 * jj + 1][1]),
                           pack_bf16(p[2 * jj + 1][2], p[2 * jj + 1][3])};
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      uint32_t b[2];
      ldsm_x2_trans(b, m + (jj * 16 + (lane & 15)) * kS + n * 8);
      mma_bf16(out[n], a, b);
    }
  }
}

// out[n] (key rows 16w..16w+15 x channels 8n..) += P^T . M, with P the
// (128 queries, 128 keys) scores in shared memory (stride kScoreStride)
// and M the (128, D) query rows of dO or q (stride Strides::qg).
template <int D>
__device__ __forceinline__ void transposed_by_rows(float (&out)[D / 8][4],
                                                   const float* p,
                                                   const float* m) {
  constexpr int kS = Strides<float, D>::qg;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int kk = 0; kk < 16; ++kk) {
    const float* pr = p + (kk * 8 + t) * kScoreStride + warp * 16 + g;
    const FragA a = frag_a(pr[0], pr[8], pr[4 * kScoreStride],
                           pr[4 * kScoreStride + 8]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float* mr = m + (kk * 8 + t) * kS + n * 8 + g;
      mma3(out[n], a, frag_b(mr[0], mr[4 * kS]));
    }
  }
}

template <int D>
__device__ __forceinline__ void transposed_by_rows(
    float (&out)[D / 8][4], const __nv_bfloat16* p, const __nv_bfloat16* m) {
  constexpr int kS = Strides<__nv_bfloat16, D>::qg;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // ldmatrix x4: lanes 8i..8i+7 give the rows of matrix i; matrices
  // (queries +0, keys +0), (+0, +8), (+8, +0), (+8, +8) are A's registers
  const int prow = (lane & 7) + ((lane >> 4) << 3);
  const int pcol = warp * 16 + (((lane >> 3) & 1) << 3);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    uint32_t a[4];
    ldsm_x4_trans(a, p + (kk * 16 + prow) * kScoreStride + pcol);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      uint32_t b[2];
      ldsm_x2_trans(b, m + (kk * 16 + (lane & 15)) * kS + n * 8);
      mma_bf16(out[n], a, b);
    }
  }
}

// Scale, mask and softmax the raw q.k accumulators of rows g and g + 8 in
// place: -1e9 at masked keys (a fully masked row gives 1/128 everywhere),
// max and sum over the quad of lanes that share the rows.  Exponentials in
// base 2: scale2 = log2(e) / sqrt(D) folds the change of base into the
// scale, so each is one exp2 (rounding the folded argument costs under
// 1e-6 relative at the score ranges of a window); a masked score stays
// -1e9, which is as far below any kept one in either base.
// stats returns each row's max and 1 / sum: (m0, m1, 1/l0, 1/l1).
__device__ __forceinline__ void masked_softmax(float (&s)[16][4],
                                               const float* keep,
                                               float scale2,
                                               float (&stats)[4]) {
  const int t = threadIdx.x & 3;
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool kept = keep[j * 8 + 2 * t + e] > 0.5f;
      s[j][e] = kept ? s[j][e] * scale2 : kMasked;
      s[j][2 + e] = kept ? s[j][2 + e] * scale2 : kMasked;
      m0 = fmaxf(m0, s[j][e]);
      m1 = fmaxf(m1, s[j][2 + e]);
    }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[j][e] = exp2f(s[j][e] - m0);
      s[j][2 + e] = exp2f(s[j][2 + e] - m1);
      l0 += s[j][e];
      l1 += s[j][2 + e];
    }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  const float i0 = 1.f / l0, i1 = 1.f / l1;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    s[j][0] *= i0;
    s[j][1] *= i0;
    s[j][2] *= i1;
    s[j][3] *= i1;
  }
  stats[0] = m0;
  stats[1] = m1;
  stats[2] = i0;
  stats[3] = i1;
}

__device__ __forceinline__ void masked_softmax(float (&s)[16][4],
                                               const float* keep,
                                               float scale2) {
  float stats[4];
  masked_softmax(s, keep, scale2, stats);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Write the (16, D) result fragments of rows r and r + 8 of the window,
// times mul, into the head slice of a raster.
template <typename T, int D>
__device__ __forceinline__ void store_rows(void* dst, const Window& w, int C,
                                           int r, const float (&o)[D / 8][4],
                                           float mul) {
  const int t = threadIdx.x & 3;
  T* p0 = static_cast<T*>(dst) + w.token(r) * C + w.head * D + 2 * t;
  T* p1 = static_cast<T*>(dst) + w.token(r + 8) * C + w.head * D + 2 * t;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    store2(p0 + n * 8, o[n][0] * mul, o[n][1] * mul);
    store2(p1 + n * 8, o[n][2] * mul, o[n][3] * mul);
  }
}

// Fill the level table from the host arrays of the C entry points: per
// level `nin` input pointers, keep, `nout` output pointers, and (Hp, Wp,
// first window).  Returns false on a table it cannot take.
inline bool fill_table(LevelTable& tab, int n_levels, void* const* ptrs,
                       int nin, int nout, const int* dims, int C,
                       int num_heads, int wh, int ww) {
  if (n_levels < 1 || n_levels > kMaxLevels || wh * ww != kTokens ||
      num_heads < 1 || C % num_heads)
    return false;
  tab = LevelTable{};
  tab.n = n_levels;
  tab.C = C;
  tab.heads = num_heads;
  tab.wh = wh;
  tab.ww = ww;
  tab.scale = (float)(1.0 / sqrt((double)(C / num_heads)));
  tab.scale2 = (float)(1.4426950408889634 / sqrt((double)(C / num_heads)));
  const int per = nin + 1 + nout;
  for (int l = 0; l < n_levels; ++l) {
    Level& L = tab.lv[l];
    for (int i = 0; i < nin; ++i) L.in[i] = ptrs[l * per + i];
    L.keep = static_cast<const float*>(ptrs[l * per + nin]);
    for (int i = 0; i < nout; ++i) L.out[i] = ptrs[l * per + nin + 1 + i];
    L.Hp = dims[3 * l];
    L.Wp = dims[3 * l + 1];
    L.first = dims[3 * l + 2];
    if (L.Hp % wh || L.Wp % ww) return false;
  }
  return true;
}

}  // namespace wattn
