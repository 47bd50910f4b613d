// Window attention, backward, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel
// pavenet_tpu/ops/pallas/window_attn.py::window_attention's backward
// (_bwd_vjp, body _bwd_kernel).  Per (window, head), with the forward's
// s[i,j] = keep[j] ? (q_i . k_j) * scale : -1e9, a = softmax_j(s) and the
// output gradient g:
//
//   dp[i,j] = g_i . v_j          delta_i = sum_j a[i,j] dp[i,j]
//   ds[i,j] = keep[j] ? a[i,j] (dp[i,j] - delta_i) : 0
//   dq_i = scale sum_j ds[i,j] k_j
//   dk_j = scale sum_i ds[i,j] q_i
//   dv_j = sum_i a[i,j] g_i
//
// ds is zero at masked keys, as autograd of the masked softmax gives; the
// TPU kernel leaves it to a == 0 there, which is the same wherever a window
// has a real key or its values are zero (the model zeroes v at padded keys).
// keep gets no gradient.
//
// What bounds it: arithmetic.  One flagship call (603 windows of 128 tokens,
// 8 heads, D=32, f32) needs five 128x128x32 products per (window, head),
// 25.3 GFLOP, against 553 MB of q/k/v/g/dq/dk/dv traffic: 0.377 ms at the
// H100's 67 TFLOP/s f32 rate against 0.165 ms at 3.35 TB/s.  This kernel
// runs plain f32 FMAs outside the tensor cores and recomputes the scores in
// each pass (about 1.8x the five products' FMAs).
//
// What this design does about it: one block per (window, head), no atomics,
// so the result is deterministic.  q, k, v and g head slices of the window
// are staged once in shared memory, and every thread walks them in the same
// order, so each shared-memory read is a broadcast.
//   Pass 1, one thread per query i: the row's softmax max and sum and
//   delta_i by an online softmax, then dq_i from a second walk over the
//   keys; the row statistics go to shared memory.
//   Pass 2, one thread per key j: dv_j and dk_j, with a[i,j] recomputed from
//   the stored row statistics.
// Left to later PRs: tensor cores (mma/wgmma in TF32 or bf16), keeping s and
// dp of pass 1 instead of recomputing them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMasked = -1e9f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Raster index (b, y, x) of token t of window w; windows are numbered
// (b, window row, window column) in raster order.
__device__ __forceinline__ int64_t token_index(int w, int t, int Hp, int Wp,
                                               int wh, int ww) {
  const int nww = Wp / ww, nwh = Hp / wh;
  const int b = w / (nwh * nww);
  const int rem = w - b * nwh * nww;
  const int wi = rem / nww, wj = rem - wi * nww;
  const int r = t / ww, c = t - r * ww;
  return ((int64_t)b * Hp + wi * wh + r) * Wp + wj * ww + c;
}

template <int D>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

template <typename T, int D>
__global__ void window_attn_bwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ keep,
    const T* __restrict__ g, T* __restrict__ dq, T* __restrict__ dk,
    T* __restrict__ dv, int Hp, int Wp, int C, int wh, int ww, float scale) {
  extern __shared__ float smem[];
  const int S = wh * ww;
  float* qs = smem;           // (S, D) each
  float* ks = qs + S * D;
  float* vs = ks + S * D;
  float* gs = vs + S * D;
  float* kp = gs + S * D;     // (S,) keep
  float* rmax = kp + S;       // (S,) max score of each query row
  float* rinv = rmax + S;     // (S,) 1 / sum_j e^(s - max) of each row
  float* dl = rinv + S;       // (S,) delta of each query row
  const int w = blockIdx.x, h = blockIdx.y;

  for (int idx = threadIdx.x; idx < S * D; idx += blockDim.x) {
    const int t = idx / D, d = idx - t * D;
    const int64_t off = token_index(w, t, Hp, Wp, wh, ww) * C + h * D + d;
    qs[idx] = to_float(q[off]);
    ks[idx] = to_float(k[off]);
    vs[idx] = to_float(v[off]);
    gs[idx] = to_float(g[off]);
  }
  for (int t = threadIdx.x; t < S; t += blockDim.x)
    kp[t] = keep[token_index(w, t, Hp, Wp, wh, ww)];
  __syncthreads();

  // pass 1: one thread per query row i -> softmax statistics, delta_i, dq_i
  // (max and sum are kept apart, not as one log-sum-exp: in a fully masked
  // row every score is -1e9, where log(S) is below float's resolution)
  const int i = threadIdx.x;
  if (i < S) {
    float qi[D], gi[D], acc[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qi[d] = qs[i * D + d];
      gi[d] = gs[i * D + d];
      acc[d] = 0.f;
    }
    float m = -INFINITY, l = 0.f, t = 0.f;   // t = sum_j e^(s-m) dp
    for (int j = 0; j < S; ++j) {
      const float s = kp[j] > 0.5f ? dot<D>(qi, ks + j * D) * scale
                                   : kMasked;
      const float dp = dot<D>(gi, vs + j * D);
      if (s > m) {
        const float c = expf(m - s);
        l *= c;
        t *= c;
        m = s;
      }
      const float p = expf(s - m);
      l += p;
      t = fmaf(p, dp, t);
    }
    const float inv = 1.f / l;
    const float delta = t * inv;
    rmax[i] = m;
    rinv[i] = inv;
    dl[i] = delta;
    for (int j = 0; j < S; ++j) {
      if (kp[j] <= 0.5f) continue;           // ds = 0 at masked keys
      const float* kj = ks + j * D;
      const float a = expf(dot<D>(qi, kj) * scale - m) * inv;
      const float ds = a * (dot<D>(gi, vs + j * D) - delta);
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, kj[d], acc[d]);
    }
    const int64_t off = token_index(w, i, Hp, Wp, wh, ww) * C + h * D;
#pragma unroll
    for (int d = 0; d < D; ++d) dq[off + d] = from_float<T>(acc[d] * scale);
  }
  __syncthreads();

  // pass 2: one thread per key j -> dk_j, dv_j
  const int j = threadIdx.x;
  if (j < S) {
    float kj[D], vj[D], dka[D], dva[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      kj[d] = ks[j * D + d];
      vj[d] = vs[j * D + d];
      dka[d] = 0.f;
      dva[d] = 0.f;
    }
    const bool kept = kp[j] > 0.5f;
    for (int r = 0; r < S; ++r) {
      const float* qr = qs + r * D;
      const float* gr = gs + r * D;
      const float s = kept ? dot<D>(kj, qr) * scale : kMasked;
      const float a = expf(s - rmax[r]) * rinv[r];
#pragma unroll
      for (int d = 0; d < D; ++d) dva[d] = fmaf(a, gr[d], dva[d]);
      if (kept) {
        const float ds = a * (dot<D>(vj, gr) - dl[r]);
#pragma unroll
        for (int d = 0; d < D; ++d) dka[d] = fmaf(ds, qr[d], dka[d]);
      }
    }
    const int64_t off = token_index(w, j, Hp, Wp, wh, ww) * C + h * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dk[off + d] = from_float<T>(dka[d] * scale);
      dv[off + d] = from_float<T>(dva[d]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* keep, const void* g, void* dq, void* dk,
                   void* dv, int B, int Hp, int Wp, int C, int num_heads,
                   int wh, int ww, cudaStream_t stream) {
  const int S = wh * ww;
  const size_t smem = (size_t)(4 * S * D + 4 * S) * sizeof(float);
  auto kernel = window_attn_bwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(B * (Hp / wh) * (Wp / ww)), (unsigned)num_heads);
  const int threads = (S + 31) / 32 * 32;
  const float scale = (float)(1.0 / sqrt((double)D));
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(keep),
      static_cast<const T*>(g), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), Hp, Wp, C, wh, ww, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* keep, const void* g, void* dq, void* dk,
                     void* dv, int B, int Hp, int Wp, int C, int num_heads,
                     int wh, int ww, cudaStream_t stream) {
  switch (C / num_heads) {
    case 8:
      return launch<T, 8>(q, k, v, keep, g, dq, dk, dv, B, Hp, Wp, C,
                          num_heads, wh, ww, stream);
    case 32:
      return launch<T, 32>(q, k, v, keep, g, dq, dk, dv, B, Hp, Wp, C,
                           num_heads, wh, ww, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point, bound with ctypes.  dtype: 0 = float32, 1 = bfloat16
// (q, k, v, g and the three gradients).  Every tensor but keep is a
// (B, Hp, Wp, C) raster, keep is (B, Hp, Wp) float32 0/1; all on the device,
// contiguous.  Hp % wh == 0, Wp % ww == 0, wh * ww <= 1024 and
// C / num_heads in {8, 32}.  Returns the CUDA error of the launch
// (0 = success).
extern "C" int window_attn_bwd(const void* q, const void* k, const void* v,
                               const void* keep, const void* g, void* dq,
                               void* dk, void* dv, int dtype, int B, int Hp,
                               int Wp, int C, int num_heads, int wh, int ww,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, keep, g, dq, dk, dv, B, Hp, Wp, C,
                                num_heads, wh, ww, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, keep, g, dq, dk, dv, B, Hp,
                                        Wp, C, num_heads, wh, ww, s);
  return (int)cudaErrorInvalidValue;
}
