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
//   grad_value[b,corner,h,d] += a * w_corner * g[d]          (f32 sums)
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
// 3.35 TB/s.  What bounds a design: the grad_value scatter, 4 corner rows
// per tap, many taps on the same rows (level 3 takes about 1300 corner hits
// per row per call), applied by the L2 one add at a time per address.
//
// Design (the partition of csrc/msda_common.cuh, as the forward): one
// (b, h) and a chunk of queries per block, an item's g row loaded once
// into registers, each tap's geometry computed once per item and shuffled
// to its lanes.  Per corner a lane reads its 4 channels of value (16 bytes
// in f32, 8 in bf16), forms its part of g . v (one dot per corner gives
// grad_attn and both location derivatives) and adds a * w_corner * g,
// unless that is exactly zero (a tap on an integer coordinate: adding 0
// changes nothing):
// - into an f32 table in shared memory for the levels the plan stages
//   (TPU design: grad_value resident in VMEM), shared atomics with the
//   channel order rotated by the item's place in the warp so that the
//   warp's items hit distinct banks (Hopper has no shared f32 atomic add:
//   each is a compare-and-swap loop, which the rotation lets succeed at
//   the first try); the block then flushes the table once, 16-byte vector
//   reductions, skipping vectors that stayed zero;
// - directly with 16-byte vector reductions (red.global.add.v4.f32) for the
//   other levels, one per 4 channels instead of four scalar atomics.
// The three per-tap sums reduce over the item's lanes once per round of
// kGroup taps (a reduce-scatter: lane g ends with the sums of tap g, the
// tap it owns) and that lane writes them, so grad_loc and grad_attn need
// no atomics and no zeroing.  grad_value is an f32 scratch that the wrapper
// zeroes and casts to the value's type.
// Heads wider than 32 channels (D = 64, 128, 256) run in passes of 32: an
// item's 8 lanes take channels 32p..32p+31 in pass p, so the registers a
// lane holds (g, the per-tap sums) stay those of D = 32; each pass
// recomputes the taps' geometry, and the lane that owns a tap writes its
// sums in pass 0 and adds the later passes' to them (the same thread, so
// no atomics).
// At D = 2 (the dynamic mask call of SOIT and DK-DETR) an item is one lane
// of 2 channels: the per-corner dot g . v is two multiply-adds, and every
// vector the lane moves (g, value, a reduction, the shared table's rows
// and their flush) is 8 bytes, 8-byte reductions (red.global.add.v2.f32)
// where wider heads take 16; the plan stages every level that fits.  Its
// lane loads the geometry (locations and weights) of four taps at once
// instead of waiting for each tap's in turn.
#include "msda_common.cuh"

namespace {

using namespace msda;

// x added into global memory at p: one vector reduction (kW = 2 or 4
// floats, p aligned to the vector)
template <int kW>
__device__ __forceinline__ void red_add_vec(float* p, const float (&x)[kW]) {
  static_assert(kW == 2 || kW == 4, "reduction width");
  if constexpr (kW == 4)
    red_add_v4(p, x[0], x[1], x[2], x[3]);
  else
    red_add_v2(p, x[0], x[1]);
}

// s * gr, this lane's kVec channels of one corner row, added into
// grad_value at p (global: one vector reduction) or into the shared
// table (one atomic per channel, the channel order rotated by ``rot``)
template <int kVec>
__device__ __forceinline__ void scatter_global(float* p, float s,
                                               const float (&gr)[kVec]) {
  float x[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) x[e] = s * gr[e];
  red_add_vec<kVec>(p, x);
}
template <int kVec>
__device__ __forceinline__ void scatter_shared(float* p, float s,
                                               const float (&gr)[kVec],
                                               int rot) {
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    const int k = (e + rot) & (kVec - 1);
    float x = gr[0];
#pragma unroll
    for (int i = 1; i < kVec; ++i) x = i == k ? gr[i] : x;
    atomicAdd(p + k, s * x);
  }
}

// a[j] summed over the item's kGroup lanes, for j = this lane's index g:
// halving exchanges, kGroup - 1 shuffles in all (a butterfly per value
// would take kGroup * log2(kGroup))
template <int kGroup>
__device__ __forceinline__ float reduce_scatter(float (&a)[kGroup], int g) {
#pragma unroll
  for (int half = kGroup / 2; half > 0; half /= 2) {
    const bool upper = g & half;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = upper ? a[i] : a[i + half];
      const float keep = upper ? a[i + half] : a[i];
      a[i] = keep + __shfl_xor_sync(0xffffffffu, send, half, kGroup);
    }
  }
  return a[0];
}

template <typename T, int D, int kMode>
__global__ void __launch_bounds__(kMaxThreads)
    msda_bwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                    const float* __restrict__ attn,
                    const float* __restrict__ grad_out,
                    float* __restrict__ grad_value,
                    float* __restrict__ grad_loc,
                    float* __restrict__ grad_attn, const Table tb) {
  constexpr int kPassD = D < 32 ? D : 32;  // channels of one pass
  constexpr int kPasses = D / kPassD;
  constexpr int kVec = Lanes<kPassD, 4>::kVec;
  constexpr int kGroup = Lanes<kPassD, 4>::kGroup;
  // taps whose geometry a lane loads at once: at D = 2 a lane alone on
  // its item would otherwise wait for each tap's loads in turn
  constexpr int kAhead = D == 2 ? 4 : 1;
  constexpr bool kSums = kMode != kNoSums;
  constexpr bool kShared = kMode != kNoScatter && kMode != kNoShared;
  constexpr bool kDirect = kMode != kNoScatter && kMode != kNoDirect;
  // the shared table is zeroed and flushed kW floats at a time (D = 2:
  // one 8-byte row)
  constexpr int kW = D < 4 ? D : 4;
  extern __shared__ __align__(16) float gtab[];
  __shared__ Level lvs[kMaxLevels];
  if (kMode == kEmpty) return;

  const int bh = blockIdx.y, b = bh / tb.H, h = bh - b * tb.H;
  const int q_begin = blockIdx.x * tb.chunk;
  const int q_end = min(q_begin + tb.chunk, tb.Q);
  const int64_t row = (int64_t)tb.H * D;  // stride between tokens
  const int64_t base = (int64_t)b * tb.N * row + (int64_t)h * D;
  const T* vb = value + base;
  float* gvb = grad_value + base;
  load_levels(tb, lvs);
  if (kShared) {
    const float zero[kW] = {};
    for (int i = threadIdx.x; i < tb.staged_rows * D / kW; i += blockDim.x)
      store_vec(gtab + i * kW, zero);
  }
  __syncthreads();

  const int g = threadIdx.x & (kGroup - 1);  // lane within the item
  const int slot = threadIdx.x / kGroup;
  const int slots = blockDim.x / kGroup;
  const int rot = ((threadIdx.x & 31) / kGroup) & (kVec - 1);  // item in warp
  const int LP = tb.L * tb.P;
  for (int q0 = q_begin; q0 < q_end; q0 += slots)  // block-uniform
  for (int pass = 0; pass < kPasses; ++pass) {
    const int q = q0 + slot;
    const bool active = q < q_end;
    const int64_t bqh = ((int64_t)b * tb.Q + (active ? q : q0)) * tb.H + h;
    const float* lp = loc + bqh * LP * 2;
    const float* ap = attn + bqh * LP;
    const int ch = pass * kPassD + g * kVec;  // this lane's first channel
    float gr[kVec] = {};
    if (active) load_vec<true>(grad_out + bqh * D + ch, gr);
    // one round of kGroup taps from tap t0, lane g holding tap t0 + g's
    // geometry in ``mine``
    auto one_round = [&](const Tap& mine, const int t0) {
      // this lane's part of each tap's three sums, reduced per round
      float s_attn[kGroup], s_x[kGroup], s_y[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) s_attn[j] = s_x[j] = s_y[j] = 0.f;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (t0 + j >= LP) break;  // uniform over the warp
        const Tap tp = shfl_tap<kGroup>(mine, j);
        const int m = tp.mask();
        const Level lv = lvs[tp.level()];
        const float lx = tp.lx, ly = tp.ly, hx = 1.f - lx, hy = 1.f - ly;
        float dot[4] = {0.f, 0.f, 0.f, 0.f};
        if (m) {
          const float cw[4] = {hy * hx, hy * lx, ly * hx, ly * lx};
          const int off[4] = {0, 1, lv.w, lv.w + 1};
          if (kSums) {
            float v[4][kVec];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              if (m >> c & 1) {
                load_vec<true>(vb + (tp.corner() + off[c]) * row + ch, v[c]);
              } else {
#pragma unroll
                for (int e = 0; e < kVec; ++e) v[c][e] = 0.f;
              }
            }
#pragma unroll
            for (int c = 0; c < 4; ++c)
#pragma unroll
              for (int e = 0; e < kVec; ++e)
                dot[c] = fmaf(gr[e], v[c][e], dot[c]);
          }
          if (staged(lv) ? kShared : kDirect) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int tok = tp.corner() + off[c];
              const float s = tp.a * cw[c];
              // a corner outside the map, or one that adds exactly zero
              if (!(m >> c & 1) || s == 0.f) continue;
              if (staged(lv))
                scatter_shared<kVec>(gtab + (int64_t)(tok - lv.delta) * D + ch,
                                     s, gr, rot);
              else
                scatter_global<kVec>(gvb + tok * row + ch, s, gr);
            }
          }
        }
        s_attn[j] = hy * (hx * dot[0] + lx * dot[1]) +
                    ly * (hx * dot[2] + lx * dot[3]);
        s_x[j] = hy * (dot[1] - dot[0]) + ly * (dot[3] - dot[2]);
        s_y[j] = hx * (dot[2] - dot[0]) + lx * (dot[3] - dot[1]);
      }
      // lane g ends with the sums of tap t0 + g, its own tap
      float o_attn = 0.f, o_x = 0.f, o_y = 0.f;
      if (kSums) {
        const Level lv = lvs[mine.level()];
        o_attn = reduce_scatter<kGroup>(s_attn, g);
        o_x = mine.a * reduce_scatter<kGroup>(s_x, g) * (float)lv.w;
        o_y = mine.a * reduce_scatter<kGroup>(s_y, g) * (float)lv.h;
      }
      const int t = t0 + g;
      if (active && t < LP) {
        float2* gl = reinterpret_cast<float2*>(grad_loc + (bqh * LP + t) * 2);
        if (pass == 0) {
          grad_attn[bqh * LP + t] = o_attn;
          *gl = make_float2(o_x, o_y);
        } else {
          grad_attn[bqh * LP + t] += o_attn;
          const float2 prev = *gl;
          *gl = make_float2(prev.x + o_x, prev.y + o_y);
        }
      }
    };
    if constexpr (kAhead == 1) {
      for (int t0 = 0; t0 < LP; t0 += kGroup) {
        Tap mine{0, 0.f, 0.f, 0.f};
        if (active && t0 + g < LP)
          mine = tap_geometry(lvs, t0 + g, tb.P, lp, ap);
        one_round(mine, t0);
      }
    } else {  // D = 2: one lane an item, kAhead taps' loads issued together
      for (int t0 = 0; t0 < LP; t0 += kAhead) {
        Tap ahead[kAhead];
#pragma unroll
        for (int k = 0; k < kAhead; ++k) {
          ahead[k] = Tap{0, 0.f, 0.f, 0.f};
          if (active && t0 + k < LP)
            ahead[k] = tap_geometry<true>(lvs, t0 + k, tb.P, lp, ap);
        }
#pragma unroll
        for (int k = 0; k < kAhead; ++k) one_round(ahead[k], t0 + k);
      }
    }
  }

  if (!kShared || tb.staged_rows == 0) return;
  __syncthreads();
  // flush the shared table: one vector reduction per kW channels of a row
  // that any tap of the block reached
  constexpr int kPerRow = D / kW;
  for (int l = 0; l < tb.L; ++l) {
    const Level lv = lvs[l];
    if (!staged(lv)) continue;
    const float* src = gtab + (int64_t)(lv.start - lv.delta) * D;
    const int n = lv.h * lv.w * kPerRow;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      float x[kW];
      load_vec<false>(src + i * kW, x);
      bool zero = true;
#pragma unroll
      for (int e = 0; e < kW; ++e) zero = zero && x[e] == 0.f;
      if (zero) continue;
      const int r = i / kPerRow, c = (i - r * kPerRow) * kW;
      red_add_vec<kW>(gvb + (lv.start + r) * row + c, x);
    }
  }
}

template <typename T, int D, int kMode>
cudaError_t launch_typed(const void* value, const void* loc, const void* attn,
                         const void* grad_out, void* grad_value,
                         void* grad_loc, void* grad_attn, const Table& tb,
                         int rows, int chunks, int threads,
                         cudaStream_t stream) {
  auto kernel = msda_bwd_kernel<T, D, kMode>;
  static bool attr_set = false;  // once per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const size_t smem = (size_t)rows * D * sizeof(float);
  kernel<<<dim3(chunks, tb.B * tb.H), threads, smem, stream>>>(
      static_cast<const T*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(attn), static_cast<const float*>(grad_out),
      static_cast<float*>(grad_value), static_cast<float*>(grad_loc),
      static_cast<float*>(grad_attn), tb);
  return cudaGetLastError();
}

template <int kMode>
int launch(const void* value, const void* loc, const void* attn,
           const void* grad_out, void* grad_value, void* grad_loc,
           void* grad_attn, const int* levels, int L, int dtype, int B, int N,
           int Q, int H, int D, int P, int chunk, int threads, void* stream) {
  if (L < 1 || L > kMaxLevels || chunk < 1 || threads < 32 ||
      threads > kMaxThreads || threads % 32)
    return (int)cudaErrorInvalidValue;
  Table tb;
  const int rows = make_table(tb, levels, L, B, N, Q, H, P, chunk);
  if ((size_t)rows * D * sizeof(float) > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const int chunks = (Q + chunk - 1) / chunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MSDA_CASE(DD)                                                       \
  if (D == DD)                                                             \
    return dtype == 0 ? (int)launch_typed<float, DD, kMode>(               \
                            value, loc, attn, grad_out, grad_value,        \
                            grad_loc, grad_attn, tb, rows, chunks,         \
                            threads, s)                                    \
                      : (int)launch_typed<__nv_bfloat16, DD, kMode>(       \
                            value, loc, attn, grad_out, grad_value,        \
                            grad_loc, grad_attn, tb, rows, chunks,         \
                            threads, s);
  if (dtype == 0 || dtype == 1) {
    MSDA_FOR_EACH_HEAD_DIM(MSDA_CASE)
  }
#undef MSDA_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point, bound with ctypes.  dtype: 0 = float32, 1 = bfloat16
// (value only); D in {2, 4, 8, 16, 32, 64, 128, 256}.  loc, attn and
// grad_out (B,Q,H*D) are float32; grad_value (B,N,H,D) is a zeroed float32
// scratch; grad_loc (B,Q,H,L,P,2) and grad_attn (B,Q,H,L,P) are float32
// and fully written; all on the device, contiguous, 16-byte aligned.
// levels, chunk and threads as msda_fwd (from ops/_ext.py::msda_plan with
// backward=True: the shared table holds f32 gradient rows).  Returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int msda_bwd(const void* value, const void* loc, const void* attn,
                        const void* grad_out, void* grad_value, void* grad_loc,
                        void* grad_attn, const int* levels, int L, int dtype,
                        int B, int N, int Q, int H, int D, int P, int chunk,
                        int threads, void* stream) {
  return launch<kFull>(value, loc, attn, grad_out, grad_value, grad_loc,
                       grad_attn, levels, L, dtype, B, N, Q, H, D, P, chunk,
                       threads, stream);
}

// The same launch with a part of the work removed (mode: 1 = empty body,
// 3 = no grad_value reductions, 4 = no per-tap sums, 5 = none into the
// shared table, 6 = none made directly to global memory).  Wrong on purpose:
// chip_smoke.py times it to see what bounds msda_bwd; no module of the
// package calls it.
extern "C" int msda_bwd_ablate(const void* value, const void* loc,
                               const void* attn, const void* grad_out,
                               void* grad_value, void* grad_loc,
                               void* grad_attn, const int* levels, int L,
                               int dtype, int B, int N, int Q, int H, int D,
                               int P, int chunk, int threads, int mode,
                               void* stream) {
#define MSDA_MODE(M)                                                       \
  if (mode == M)                                                           \
    return launch<M>(value, loc, attn, grad_out, grad_value, grad_loc,     \
                     grad_attn, levels, L, dtype, B, N, Q, H, D, P, chunk, \
                     threads, stream);
  MSDA_MODE(kEmpty)
  MSDA_MODE(kNoScatter)
  MSDA_MODE(kNoSums)
  MSDA_MODE(kNoShared)
  MSDA_MODE(kNoDirect)
#undef MSDA_MODE
  return (int)cudaErrorInvalidValue;
}
