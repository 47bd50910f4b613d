// Window attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel
// pavenet_tpu/ops/pallas/window_attn.py::window_attention (_fwd, body
// _fwd_kernel).  For every (wh, ww) window of a (B, Hp, Wp, C) raster and
// every head h (D = C / num_heads channels):
//
//   s[i,j] = keep[j] ? (q_i . k_j) / sqrt(D) : -1e9
//   out_i  = sum_j softmax_j(s[i,:]) v_j
//
// Masked keys get exactly -1e9, not -inf: a fully masked window gives the
// uniform average of its values (zero in the model, whose caller zeroes v at
// padded keys), as the TPU kernel does.
//
// What bounds it: arithmetic.  One flagship call (603 windows of 128 tokens,
// 8 heads, D=32, f32) does 10.1 GFLOP of score and value products against
// 316 MB of q/k/v/out traffic: 0.151 ms at the H100's 67 TFLOP/s f32 rate
// against 0.094 ms at 3.35 TB/s.  This kernel runs plain f32 FMAs outside
// the tensor cores, so the f32 rate is its bound.
//
// What this design does about it: one block per (window, head), one thread
// per query row.  The window's k and v head slices are staged once in
// shared memory (read row by row with neighbouring threads on neighbouring
// channels); every thread then walks the keys in the same order, so each
// shared-memory read is a broadcast, and keeps an online softmax (running
// max, running sum, a D-wide accumulator) in registers.  Scores never leave
// the SM and no window-partition copy is made: offsets come from blockIdx
// and the raster strides.  Sums are f32; bf16 inputs are widened on load.
// Left to later PRs: tensor cores (mma/wgmma in TF32 or bf16) for the two
// products, several query rows per thread.
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

template <typename T, int D>
__global__ void window_attn_fwd_kernel(const T* __restrict__ q,
                                       const T* __restrict__ k,
                                       const T* __restrict__ v,
                                       const float* __restrict__ keep,
                                       T* __restrict__ out, int Hp, int Wp,
                                       int C, int wh, int ww, float scale) {
  extern __shared__ float smem[];
  const int S = wh * ww;
  float* ks = smem;           // (S, D)
  float* vs = ks + S * D;     // (S, D)
  float* kp = vs + S * D;     // (S,)
  const int w = blockIdx.x, h = blockIdx.y;

  for (int idx = threadIdx.x; idx < S * D; idx += blockDim.x) {
    const int t = idx / D, d = idx - t * D;
    const int64_t off = token_index(w, t, Hp, Wp, wh, ww) * C + h * D + d;
    ks[idx] = to_float(k[off]);
    vs[idx] = to_float(v[off]);
  }
  for (int t = threadIdx.x; t < S; t += blockDim.x)
    kp[t] = keep[token_index(w, t, Hp, Wp, wh, ww)];
  __syncthreads();

  const int i = threadIdx.x;
  if (i >= S) return;
  const int64_t qoff = token_index(w, i, Hp, Wp, wh, ww) * C + h * D;
  float qi[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qi[d] = to_float(q[qoff + d]);
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  for (int j = 0; j < S; ++j) {
    const float* kj = ks + j * D;
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) s = fmaf(qi[d], kj[d], s);
    s = kp[j] > 0.5f ? s * scale : kMasked;
    if (s > m) {                      // rescale what was summed so far
      const float c = expf(m - s);
      l *= c;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= c;
      m = s;
    }
    const float p = expf(s - m);
    l += p;
    const float* vj = vs + j * D;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vj[d], acc[d]);
  }
  const float inv = 1.f / l;
#pragma unroll
  for (int d = 0; d < D; ++d) out[qoff + d] = from_float<T>(acc[d] * inv);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* keep, void* out, int B, int Hp, int Wp, int C,
                   int num_heads, int wh, int ww, cudaStream_t stream) {
  const int S = wh * ww;
  const size_t smem = (size_t)(2 * S * D + S) * sizeof(float);
  auto kernel = window_attn_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(B * (Hp / wh) * (Wp / ww)), (unsigned)num_heads);
  const int threads = (S + 31) / 32 * 32;
  const float scale = (float)(1.0 / sqrt((double)D));
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(keep),
      static_cast<T*>(out), Hp, Wp, C, wh, ww, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* keep, void* out, int B, int Hp, int Wp,
                     int C, int num_heads, int wh, int ww,
                     cudaStream_t stream) {
  switch (C / num_heads) {
    case 8:
      return launch<T, 8>(q, k, v, keep, out, B, Hp, Wp, C, num_heads, wh,
                          ww, stream);
    case 32:
      return launch<T, 32>(q, k, v, keep, out, B, Hp, Wp, C, num_heads, wh,
                           ww, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point, bound with ctypes.  dtype: 0 = float32, 1 = bfloat16
// (q, k, v and out).  q, k, v, out are (B, Hp, Wp, C) rasters, keep is
// (B, Hp, Wp) float32 0/1; all on the device, contiguous.  Hp % wh == 0,
// Wp % ww == 0, wh * ww <= 1024 and C / num_heads in {8, 32}.
// Returns the CUDA error of the launch (0 = success).
extern "C" int window_attn_fwd(const void* q, const void* k, const void* v,
                               const void* keep, void* out, int dtype, int B,
                               int Hp, int Wp, int C, int num_heads, int wh,
                               int ww, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, keep, out, B, Hp, Wp, C, num_heads,
                                wh, ww, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, keep, out, B, Hp, Wp, C,
                                        num_heads, wh, ww, s);
  return (int)cudaErrorInvalidValue;
}
