// Window attention, backward, for Hopper (sm_90a), on tensor cores; one
// launch takes every level raster of an encoder layer.
//
// Replaces the TPU Pallas kernel
// pavenet_tpu/ops/pallas/window_attn.py:193 (_bwd_vjp, body _bwd_kernel
// :84).  Per (window, head), with the forward's
// s[i,j] = keep[j] ? (q_i . k_j) * scale : -1e9, a = softmax_j(s) and the
// output gradient g:
//
//   dp[i,j] = g_i . v_j          delta_i = sum_j a[i,j] dp[i,j]
//   ds[i,j] = keep[j] ? a[i,j] (dp[i,j] - delta_i) : 0
//   dq_i = scale sum_j ds[i,j] k_j
//   dk_j = scale sum_i ds[i,j] q_i
//   dv_j = sum_i a[i,j] g_i
//
// ds is zero at masked keys, as autograd of the masked softmax gives; keep
// gets no gradient.  No atomics: the result is deterministic.
//
// What bounds it on an H100: bytes.  One flagship layer (603 windows of
// 128 tokens, 8 heads, D = 32, f32) moves 553 MB of q, k, v, g, keep, dq,
// dk and dv: 0.165 ms at 3.35 TB/s, against 25.3 GFLOP of the five
// products, 0.153 ms at the 3xTF32 rate (495 / 3 TFLOP/s).  In bf16 0.083
// ms of bytes against 0.026 ms at 989 TFLOP/s.
//
// What the design does about it: one block per (window, head), 8 warps;
// the five products on tensor cores (float32 as 3xTF32, bf16 as m16n8k16
// with f32 sums, see window_attn_fwd.cu and window_attn_common.cuh), each
// computed once.  Of the two layouts for the transposed products this is
// the one that stages P and dS in shared memory:
//   pass 1, warp w owns query rows 16w..16w+15: s = q k^T and dp = g v^T
//   in registers (16 x 128 each), the exact softmax, delta and ds in
//   registers, dq = ds k; P and ds go to shared memory;
//   pass 2, warp w owns key rows 16w..16w+15: dv = P^T g and dk = ds^T q
//   read P and ds transposed from shared memory.
// This one costs shared memory: 213 KB a block in f32 at D = 32 (one block
// an SM), 109 KB in bf16 (two).  In f32 at D = 64 it would need 276 KB,
// over the 227 KB a block may use, so that case takes the other layout,
// a key-major second pass that recomputes s^T and dp^T (7 products
// instead of 5) and stages no P or dS:
//   pass 1, query rows as above: each row's max, 1/sum and delta go to
//   shared memory beside q, k, v and g (138 KB at D = 64), and dq;
//   pass 2, warp w owns key rows 16w..16w+15: s^T = k q^T and
//   dp^T = v g^T in registers, P^T and dS^T from the rows' statistics,
//   then dv = P^T g and dk = dS^T q as row-major products.
// Row max and 1/sum stay apart, never folded into a log-sum-exp: in a
// fully masked row every score is -1e9, and -1e9 + log(128) rounds to
// -1e9 in f32.
// q, k, v and g head slices are staged once with 16-byte cp.async, heads
// of a window next to each other in the grid as in the forward.
// Left to later PRs: wgmma, TMA, several heads per block, and a layout
// that fits two f32 blocks per SM at every head size so that one block's
// loads overlap another's math.
#include "window_attn_common.cuh"

namespace {

using namespace wattn;

template <typename T, int D>
constexpr size_t bwd_smem() {
  using St = Strides<T, D>;
  return (size_t)kTokens * (2 * St::kv + 2 * St::qg + 2 * kScoreStride)
             * sizeof(T)
         + kTokens * sizeof(float);
}

template <typename T>
__device__ __forceinline__ void store_scores(T* dst, int r,
                                             const float (&x)[16][4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    store2(dst + r * kScoreStride + j * 8 + 2 * t, x[j][0], x[j][1]);
    store2(dst + (r + 8) * kScoreStride + j * 8 + 2 * t, x[j][2], x[j][3]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    window_attn_bwd_kernel(const __grid_constant__ LevelTable tab) {
  using St = Strides<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + kTokens * St::kv;
  T* qs = vs + kTokens * St::kv;
  T* gs = qs + kTokens * St::qg;
  T* ps = gs + kTokens * St::qg;
  T* dss = ps + kTokens * kScoreStride;
  float* kp = reinterpret_cast<float*>(dss + kTokens * kScoreStride);

  const Window w = find_window(tab);
  const int C = tab.C;
  stage<T, D>(ks, St::kv, w.L.in[1], w, C);
  stage<T, D>(vs, St::kv, w.L.in[2], w, C);
  stage<T, D>(qs, St::qg, w.L.in[0], w, C);
  stage<T, D>(gs, St::qg, w.L.in[3], w, C);
  stage_keep(kp, w);
  cp_async_wait_all();
  __syncthreads();

  const int t = threadIdx.x & 3;
  const int r = (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
  // pass 1: query rows r and r + 8
  {
    float p[16][4] = {};
    rows_by_rows<D>(p, qs + r * St::qg, qs + (r + 8) * St::qg, ks);
    masked_softmax(p, kp, tab.scale2);
    float dp[16][4] = {};
    rows_by_rows<D>(dp, gs + r * St::qg, gs + (r + 8) * St::qg, vs);
    float d0 = 0.f, d1 = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      d0 += p[j][0] * dp[j][0] + p[j][1] * dp[j][1];
      d1 += p[j][2] * dp[j][2] + p[j][3] * dp[j][3];
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      d0 += __shfl_xor_sync(0xffffffffu, d0, o);
      d1 += __shfl_xor_sync(0xffffffffu, d1, o);
    }
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool kept = kp[j * 8 + 2 * t + e] > 0.5f;
        dp[j][e] = kept ? p[j][e] * (dp[j][e] - d0) : 0.f;
        dp[j][2 + e] = kept ? p[j][2 + e] * (dp[j][2 + e] - d1) : 0.f;
      }
    store_scores(ps, r, p);
    store_scores(dss, r, dp);
    float dq[D / 8][4] = {};
    scores_by_rows<D>(dq, dp, ks);
    store_rows<T, D>(w.L.out[0], w, C, r, dq, tab.scale);
  }
  __syncthreads();

  // pass 2: key rows r and r + 8
  float dv[D / 8][4] = {};
  transposed_by_rows<D>(dv, ps, gs);
  store_rows<T, D>(w.L.out[2], w, C, r, dv, 1.f);
  float dk[D / 8][4] = {};
  transposed_by_rows<D>(dk, dss, qs);
  store_rows<T, D>(w.L.out[1], w, C, r, dk, tab.scale);
}

// The recomputing layout, float32: q, k, v and g all with the k, v row
// stride (their fragment reads as A and as B, row-major and down a column,
// are then free of bank conflicts), keep, and each query row's max, 1/sum
// and delta.
template <int D>
constexpr size_t bwd_recompute_smem() {
  return (size_t)kTokens * 4 * Strides<float, D>::kv * sizeof(float)
         + 4 * kTokens * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    window_attn_bwd_recompute_kernel(const __grid_constant__ LevelTable tab) {
  constexpr int S = Strides<float, D>::kv;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + kTokens * S;
  float* qs = vs + kTokens * S;
  float* gs = qs + kTokens * S;
  float* kp = gs + kTokens * S;
  float* row_max = kp + kTokens;
  float* row_inv = row_max + kTokens;
  float* row_delta = row_inv + kTokens;

  const Window w = find_window(tab);
  const int C = tab.C;
  stage<float, D>(ks, S, w.L.in[1], w, C);
  stage<float, D>(vs, S, w.L.in[2], w, C);
  stage<float, D>(qs, S, w.L.in[0], w, C);
  stage<float, D>(gs, S, w.L.in[3], w, C);
  stage_keep(kp, w);
  cp_async_wait_all();
  __syncthreads();

  const int t = threadIdx.x & 3;
  const int r = (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
  // pass 1: query rows r and r + 8; their statistics, and dq
  {
    float p[16][4] = {};
    rows_by_rows<D>(p, qs + r * S, qs + (r + 8) * S, ks);
    float stats[4];
    masked_softmax(p, kp, tab.scale2, stats);
    float dp[16][4] = {};
    rows_by_rows<D>(dp, gs + r * S, gs + (r + 8) * S, vs);
    float d0 = 0.f, d1 = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      d0 += p[j][0] * dp[j][0] + p[j][1] * dp[j][1];
      d1 += p[j][2] * dp[j][2] + p[j][3] * dp[j][3];
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      d0 += __shfl_xor_sync(0xffffffffu, d0, o);
      d1 += __shfl_xor_sync(0xffffffffu, d1, o);
    }
    if (t == 0) {
      row_max[r] = stats[0];
      row_max[r + 8] = stats[1];
      row_inv[r] = stats[2];
      row_inv[r + 8] = stats[3];
      row_delta[r] = d0;
      row_delta[r + 8] = d1;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool kept = kp[j * 8 + 2 * t + e] > 0.5f;
        dp[j][e] = kept ? p[j][e] * (dp[j][e] - d0) : 0.f;
        dp[j][2 + e] = kept ? p[j][2 + e] * (dp[j][2 + e] - d1) : 0.f;
      }
    float dq[D / 8][4] = {};
    scores_by_rows<D>(dq, dp, ks);
    store_rows<float, D>(w.L.out[0], w, C, r, dq, tab.scale);
  }
  __syncthreads();

  // pass 2: key rows r and r + 8 against every query column i; p^T[j][i]
  // as pass 1 computed p[i][j], from row i's max and 1/sum
  const bool kept0 = kp[r] > 0.5f, kept1 = kp[r + 8] > 0.5f;
  float p[16][4] = {};
  rows_by_rows<D>(p, ks + r * S, ks + (r + 8) * S, qs);
  float ds[16][4] = {};
  rows_by_rows<D>(ds, vs + r * S, vs + (r + 8) * S, gs);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = j * 8 + 2 * t + e;
      const float m = row_max[i], inv = row_inv[i], delta = row_delta[i];
      p[j][e] = exp2f((kept0 ? p[j][e] * tab.scale2 : kMasked) - m) * inv;
      p[j][2 + e] =
          exp2f((kept1 ? p[j][2 + e] * tab.scale2 : kMasked) - m) * inv;
      ds[j][e] = kept0 ? p[j][e] * (ds[j][e] - delta) : 0.f;
      ds[j][2 + e] = kept1 ? p[j][2 + e] * (ds[j][2 + e] - delta) : 0.f;
    }
  float dv[D / 8][4] = {};
  scores_by_rows<D>(dv, p, gs);
  store_rows<float, D>(w.L.out[2], w, C, r, dv, 1.f);
  float dk[D / 8][4] = {};
  scores_by_rows<D>(dk, ds, qs);
  store_rows<float, D>(w.L.out[1], w, C, r, dk, tab.scale);
}

template <int D>
cudaError_t launch_recompute(const LevelTable& tab, int windows, int heads,
                             cudaStream_t stream) {
  constexpr size_t smem = bwd_recompute_smem<D>();
  static_assert(smem <= 232448, "over the 227 KB a block may use");
  auto kernel = window_attn_bwd_recompute_kernel<D>;
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (configured != cudaSuccess) return configured;
  kernel<<<(unsigned)(windows * heads), kThreads, smem, stream>>>(tab);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const LevelTable& tab, int windows, int heads,
                   cudaStream_t stream) {
  constexpr size_t smem = bwd_smem<T, D>();
  static_assert(smem <= 232448, "over the 227 KB a block may use");
  auto kernel = window_attn_bwd_kernel<T, D>;
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (configured != cudaSuccess) return configured;
  kernel<<<(unsigned)(windows * heads), kThreads, smem, stream>>>(tab);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const LevelTable& tab, int windows, int heads,
                     cudaStream_t stream) {
  switch (tab.C / heads) {
    case 8:
      return launch<T, 8>(tab, windows, heads, stream);
    case 16:
      return launch<T, 16>(tab, windows, heads, stream);
    case 32:
      return launch<T, 32>(tab, windows, heads, stream);
    case 64:
      // in float32, P and dS beside q, k, v and g would need 276 KB
      if constexpr (sizeof(T) == 2)
        return launch<T, 64>(tab, windows, heads, stream);
      else
        return launch_recompute<64>(tab, windows, heads, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point, bound with ctypes.  For each of n_levels levels,
// ptrs holds q, k, v, g, keep, dq, dk, dv (8 device pointers) and dims
// holds (Hp, Wp, first window); windows is the total over the levels.
// dtype: 0 = float32, 1 = bfloat16 (every tensor but keep, which is
// float32 0/1).  Rasters are (B, Hp, Wp, C), contiguous, 16-byte aligned;
// wh * ww = 128, C / num_heads in {8, 16, 32, 64}, at most 8 levels.
// Returns the
// CUDA error of the launch (0 = success).
extern "C" int window_attn_bwd(int n_levels, void* const* ptrs,
                               const int* dims, int windows, int dtype,
                               int C, int num_heads, int wh, int ww,
                               void* stream) {
  LevelTable tab;
  if (!fill_table(tab, n_levels, ptrs, 4, 3, dims, C, num_heads, wh, ww) ||
      windows < 1 || (long long)windows * num_heads > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(tab, windows, num_heads, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(tab, windows, num_heads, s);
  return (int)cudaErrorInvalidValue;
}
