// Multi-scale deformable attention, backward, for Hopper (sm_90a).
//
// Replaces the TPU corner-stream Pallas backward
// pavenet_tpu/ops/pallas/msda_cs.py::_backward (bodies _msda_cs_bwd_kernel /
// _msda_cs_bwd_kernel_packed, loc/attn grads) and, because L and P are
// runtime arguments here, also the XLA custom VJP
// pavenet_tpu/ops/ms_deform_attn.py::_msda_xla_bwd that the TPU used for the
// P=15 pose-decoder calls.  For the forward
//
//   out[b,q,h,d] = sum_{l,p} a * bilinear(V_l[b,:,h,d], (x, y)),
//   x = loc_x * W_l - 0.5,  y = loc_y * H_l - 0.5,
//
// with zero padding (a corner outside [0,W_l) x [0,H_l) counts zero), and the
// output gradient g[b,q,h*D+d], it computes
//
//   grad_value[b,corner,h,d] += a * w_corner * g[d]          (f32 atomics)
//   grad_attn[b,q,h,l,p]      = sum_d g[d] * bilinear[d]
//   grad_loc[b,q,h,l,p,0]     = a * W_l * sum_d g[d] * dbilinear/dx[d]
//   grad_loc[b,q,h,l,p,1]     = a * H_l * sum_d g[d] * dbilinear/dy[d]
//
// Zeroing the outside corners gives, for every location, the derivative of
// the JAX package's clamped-block form (weights relu(1 - |c - tap|)),
// 1-row and 1-column levels and locations in (-1, 0) or (H_l - 1, H_l)
// included.
//
// What bounds it: memory.  One flagship encoder call (B*T=3, Q=N=22323,
// H=8, L=4, P=4, D=32) must read value, locations, weights and g and write
// grad_value, grad_loc and grad_attn: about 411 MB in f32, 123 us at
// 3.35 TB/s; its arithmetic (about 32 flops per in-range tap and channel)
// is of the same order at the f32 rate.  What bounds this design: the f32
// atomicAdd traffic on grad_value (four corner rows per tap, with many taps
// of neighbouring queries landing on the same rows).
//
// Design: one warp per (b, q, h), lanes along d (D < 32 leaves lanes idle,
// D > 32 loops), so each corner read and each corner atomic is one coalesced
// row; the three per-tap sums are warp reductions written by lane 0, so
// grad_loc and grad_attn need no atomics and no zeroing.  grad_value is an
// f32 scratch that the wrapper zeroes and casts to the value's type.
// Left to later PRs: staging level tiles in shared memory, sorting taps by
// level tile to cut atomic contention, bf16 pairs (__nv_bfloat162).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void msda_bwd_kernel(const T* __restrict__ value,
                                const int32_t* __restrict__ shapes,
                                const int32_t* __restrict__ level_start,
                                const float* __restrict__ loc,
                                const float* __restrict__ attn,
                                const float* __restrict__ grad_out,
                                float* __restrict__ grad_value,
                                float* __restrict__ grad_loc,
                                float* __restrict__ grad_attn, int B, int N,
                                int Q, int H, int D, int L, int P) {
  // warp-uniform: every lane of a warp shares one (b, q, h)
  const int64_t bqh = (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (bqh >= (int64_t)B * Q * H) return;
  const int lane = threadIdx.x % 32;
  const int h = (int)(bqh % H);
  const int b = (int)(bqh / ((int64_t)Q * H));

  const int64_t row = (int64_t)H * D;  // stride between tokens
  const int64_t vb = (int64_t)b * N * row + (int64_t)h * D;
  const float* lp = loc + bqh * L * P * 2;
  const float* ap = attn + bqh * L * P;
  const float* gp = grad_out + bqh * D;
  float* glp = grad_loc + bqh * L * P * 2;
  float* gap = grad_attn + bqh * L * P;

  for (int l = 0; l < L; ++l) {
    const int hl = shapes[2 * l];
    const int wl = shapes[2 * l + 1];
    const int64_t vl = vb + (int64_t)level_start[l] * row;
    for (int p = 0; p < P; ++p) {
      const int t = l * P + p;
      const float x = lp[2 * t] * wl - 0.5f;
      const float y = lp[2 * t + 1] * hl - 0.5f;
      float s_attn = 0.f, s_x = 0.f, s_y = 0.f;
      const float a = ap[t];
      // at least one corner inside (also rejects NaN and huge values)
      if (x > -1.f && y > -1.f && x < (float)wl && y < (float)hl) {
        const float xf = floorf(x), yf = floorf(y);
        const int x0 = (int)xf, y0 = (int)yf;
        const float lx = x - xf, ly = y - yf;
        const float hx = 1.f - lx, hy = 1.f - ly;
        const bool in_x0 = x0 >= 0, in_x1 = x0 + 1 < wl;
        const bool in_y0 = y0 >= 0, in_y1 = y0 + 1 < hl;
        const int64_t r0 = vl + ((int64_t)y0 * wl + x0) * row;  // (y0, x0)
        const int64_t r1 = r0 + (int64_t)wl * row;              // (y0+1, x0)
        const bool c00 = in_y0 && in_x0, c01 = in_y0 && in_x1;
        const bool c10 = in_y1 && in_x0, c11 = in_y1 && in_x1;
        for (int d = lane; d < D; d += 32) {
          const float g = gp[d];
          const float v00 = c00 ? to_float(value[r0 + d]) : 0.f;
          const float v01 = c01 ? to_float(value[r0 + row + d]) : 0.f;
          const float v10 = c10 ? to_float(value[r1 + d]) : 0.f;
          const float v11 = c11 ? to_float(value[r1 + row + d]) : 0.f;
          s_attn += g * (hy * (hx * v00 + lx * v01) +
                         ly * (hx * v10 + lx * v11));
          s_x += g * (hy * (v01 - v00) + ly * (v11 - v10));
          s_y += g * (hx * (v10 - v00) + lx * (v11 - v01));
          const float ag = a * g;
          if (c00) atomicAdd(grad_value + r0 + d, hy * hx * ag);
          if (c01) atomicAdd(grad_value + r0 + row + d, hy * lx * ag);
          if (c10) atomicAdd(grad_value + r1 + d, ly * hx * ag);
          if (c11) atomicAdd(grad_value + r1 + row + d, ly * lx * ag);
        }
        s_attn = warp_sum(s_attn);
        s_x = warp_sum(s_x);
        s_y = warp_sum(s_y);
      }
      if (lane == 0) {
        gap[t] = s_attn;
        glp[2 * t] = a * s_x * (float)wl;
        glp[2 * t + 1] = a * s_y * (float)hl;
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* value, const void* shapes,
                   const void* level_start, const void* loc, const void* attn,
                   const void* grad_out, void* grad_value, void* grad_loc,
                   void* grad_attn, int B, int N, int Q, int H, int D, int L,
                   int P, cudaStream_t stream) {
  const int64_t warps = (int64_t)B * Q * H;
  const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  msda_bwd_kernel<T><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(value), static_cast<const int32_t*>(shapes),
      static_cast<const int32_t*>(level_start),
      static_cast<const float*>(loc), static_cast<const float*>(attn),
      static_cast<const float*>(grad_out), static_cast<float*>(grad_value),
      static_cast<float*>(grad_loc), static_cast<float*>(grad_attn), B, N, Q,
      H, D, L, P);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes.  dtype: 0 = float32, 1 = bfloat16
// (value only).  loc, attn and grad_out are float32; grad_value (B,N,H,D)
// is a zeroed float32 scratch; grad_loc (B,Q,H,L,P,2) and grad_attn
// (B,Q,H,L,P) are float32 and fully written; shapes (L, 2) and level_start
// (L,) are int32; all on the device, contiguous.  Returns cudaGetLastError()
// after the launch (0 = success).
extern "C" int msda_bwd(const void* value, const void* shapes,
                        const void* level_start, const void* loc,
                        const void* attn, const void* grad_out,
                        void* grad_value, void* grad_loc, void* grad_attn,
                        int dtype, int B, int N, int Q, int H, int D, int L,
                        int P, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(value, shapes, level_start, loc, attn,
                              grad_out, grad_value, grad_loc, grad_attn, B, N,
                              Q, H, D, L, P, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(value, shapes, level_start, loc, attn,
                                      grad_out, grad_value, grad_loc,
                                      grad_attn, B, N, Q, H, D, L, P, s);
  return (int)cudaErrorInvalidValue;
}
