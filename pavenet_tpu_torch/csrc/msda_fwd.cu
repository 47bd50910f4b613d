// Multi-scale deformable attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU corner-stream Pallas kernel
// pavenet_tpu/ops/pallas/msda_cs.py::ms_deform_attn_cs (_forward, bodies
// _msda_cs_kernel / _msda_cs_kernel_packed) and, because L and P are runtime
// arguments here, also the XLA gather ms_deform_attn_xla that the TPU used
// for the P=15 pose-decoder calls.
//
//   out[b,q,h,d] = sum_l sum_p a[b,q,h,l,p] *
//                  bilinear(V_l[b,:,h,d], loc[b,q,h,l,p] * (W_l, H_l) - 0.5)
//
// with zero padding: a bilinear corner outside [0,W_l) x [0,H_l) counts zero.
// The softmax over (l, p) is the caller's.
//
// What bounds it: a data-dependent gather.  One flagship encoder call
// (B*T=3, Q=N=22323, H=8, L=4, P=4, D=32) reads about 8.6 M taps x 4 corners
// x 32 channels from a 68 MB (f32) value table that does not fit the 50 MB
// L2, so it is bound by L2/HBM traffic, not arithmetic.
//
// What this design does about it: one thread per output element (b,q,h,d);
// the 32 threads of a warp take neighbouring d of one (b,q,h), so each
// corner read is one coalesced 64/128-byte row of value[b, tok, h, :], and the
// location and weight loads are warp-wide broadcasts.  Sums are f32 in
// registers; the output is written once in the value's type.
// Left to later PRs: staging each query tile's level windows in shared
// memory, 16-byte vector loads (several d per thread), bf16 pairs
// (__nv_bfloat162) and sorting queries for L2 locality.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <typename T>
__global__ void msda_fwd_kernel(const T* __restrict__ value,
                                const int32_t* __restrict__ shapes,
                                const int32_t* __restrict__ level_start,
                                const float* __restrict__ loc,
                                const float* __restrict__ attn,
                                T* __restrict__ out, int B, int N, int Q,
                                int H, int D, int L, int P) {
  const int64_t total = (int64_t)B * Q * H * D;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int d = (int)(idx % D);
  int64_t r = idx / D;
  const int h = (int)(r % H);
  r /= H;  // r = b * Q + q
  const int b = (int)(r / Q);

  const int64_t row = (int64_t)H * D;  // stride between tokens
  const T* vb = value + (int64_t)b * N * row + (int64_t)h * D + d;
  const int64_t bqh = r * H + h;
  const float* lp = loc + bqh * L * P * 2;
  const float* ap = attn + bqh * L * P;

  float acc = 0.f;
  for (int l = 0; l < L; ++l) {
    const int hl = shapes[2 * l];
    const int wl = shapes[2 * l + 1];
    const T* vl = vb + (int64_t)level_start[l] * row;
    for (int p = 0; p < P; ++p) {
      const int t = l * P + p;
      const float x = lp[2 * t] * wl - 0.5f;
      const float y = lp[2 * t + 1] * hl - 0.5f;
      // every corner lies outside the map (also rejects NaN and values too
      // large for an int)
      if (!(x > -1.f && y > -1.f && x < (float)wl && y < (float)hl)) continue;
      const float a = ap[t];
      const float xf = floorf(x), yf = floorf(y);
      const int x0 = (int)xf, y0 = (int)yf;
      const float lx = x - xf, ly = y - yf;
      const float hx = 1.f - lx, hy = 1.f - ly;
      const bool x0_in = x0 >= 0, x1_in = x0 + 1 < wl;
      float s = 0.f;
      if (y0 >= 0) {
        const T* vr = vl + (int64_t)y0 * wl * row;
        if (x0_in) s += hy * hx * to_float(vr[(int64_t)x0 * row]);
        if (x1_in) s += hy * lx * to_float(vr[(int64_t)(x0 + 1) * row]);
      }
      if (y0 + 1 < hl) {
        const T* vr = vl + (int64_t)(y0 + 1) * wl * row;
        if (x0_in) s += ly * hx * to_float(vr[(int64_t)x0 * row]);
        if (x1_in) s += ly * lx * to_float(vr[(int64_t)(x0 + 1) * row]);
      }
      acc += a * s;
    }
  }
  out[idx] = from_float<T>(acc);
}

template <typename T>
cudaError_t launch(const void* value, const void* shapes,
                   const void* level_start, const void* loc, const void* attn,
                   void* out, int B, int N, int Q, int H, int D, int L, int P,
                   cudaStream_t stream) {
  const int64_t total = (int64_t)B * Q * H * D;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  msda_fwd_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(value), static_cast<const int32_t*>(shapes),
      static_cast<const int32_t*>(level_start),
      static_cast<const float*>(loc), static_cast<const float*>(attn),
      static_cast<T*>(out), B, N, Q, H, D, L, P);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes.  dtype: 0 = float32, 1 = bfloat16
// (value and out).  loc and attn are float32; shapes (L, 2) and level_start
// (L,) are int32; all on the device, contiguous.  Returns cudaGetLastError()
// after the launch (0 = success).
extern "C" int msda_fwd(const void* value, const void* shapes,
                        const void* level_start, const void* loc,
                        const void* attn, void* out, int dtype, int B, int N,
                        int Q, int H, int D, int L, int P, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(value, shapes, level_start, loc, attn, out, B,
                              N, Q, H, D, L, P, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(value, shapes, level_start, loc, attn,
                                      out, B, N, Q, H, D, L, P, s);
  return (int)cudaErrorInvalidValue;
}
