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
// (B*T=3, Q=N=22323, H=8, L=4, P=4, D=32) reads about 8.6 M taps x 4 corner
// rows of 128 bytes (f32) from a 68 MB value table: about 4.4 GB of row
// reads against 0.24 GB that must move, so what bounds a design is where
// those row reads are served (shared memory, L1, L2) and how many
// instructions they take.
//
// What this design does about it (csrc/msda_common.cuh has the partition):
// one (b, h) per block, so L1 holds one head's rows and neighbouring
// queries, which sample neighbouring rows in the model, share them; each
// lane owns 8 channels of a corner row (two 16-byte loads in f32, one in
// bf16), so at D=32 an item takes 4 lanes and a warp 8 queries; a tap's
// geometry is computed once per item and broadcast by shuffles; the coarse
// levels that the plan stages (each hit many times per block: level 3 of
// the encoder takes about 1300 corner hits per row) are copied once per
// block into shared memory in the value's dtype and gathered from there.
// Sums are f32 in registers; the output is written once, 8 channels a
// lane, in the value's dtype.  At D = 2 (SOIT's and DK-DETR's dynamic
// mask call: 4 heads of 2 channels, one level, 4 points, the instances on
// the query axis) an item is one lane, 2 channels a corner (8 bytes in
// f32, 4 in bf16), and the plan stages nothing.  Its weights fill half a
// 32-byte sector and its output a quarter (the other heads' channels lie
// between), so this partition moves there about 1.7 times the bytes the
// bound counts.
#include "msda_common.cuh"

namespace {

using namespace msda;

template <typename T, int D, int kMode>
__global__ void __launch_bounds__(kMaxThreads)
    msda_fwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                    const float* __restrict__ attn, T* __restrict__ out,
                    const Table tb) {
  constexpr int kVec = Lanes<D, 8>::kVec, kGroup = Lanes<D, 8>::kGroup;
  extern __shared__ __align__(16) unsigned char smem[];
  T* stage = reinterpret_cast<T*>(smem);
  __shared__ Level lvs[kMaxLevels];
  if (kMode == kEmpty) return;

  const int bh = blockIdx.y, b = bh / tb.H, h = bh - b * tb.H;
  const int q_begin = blockIdx.x * tb.chunk;
  const int q_end = min(q_begin + tb.chunk, tb.Q);
  const int64_t row = (int64_t)tb.H * D;  // stride between tokens
  const T* vb = value + (int64_t)b * tb.N * row + (int64_t)h * D;
  load_levels(tb, lvs);
  __syncthreads();

  // stage the planned levels of head h, one lane's vector (at most 16
  // bytes) a thread per step
  for (int l = 0; l < tb.L; ++l) {
    const Level lv = lvs[l];
    if (!staged(lv)) continue;
    const int n = lv.h * lv.w * kGroup;
    const T* src = vb + (int64_t)lv.start * row;
    T* dst = stage + (int64_t)(lv.start - lv.delta) * D;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int r = i / kGroup, c = (i - r * kGroup) * kVec;
      float v[kVec];
      load_vec<true>(src + r * row + c, v);
      store_vec(dst + r * D + c, v);
    }
  }
  __syncthreads();

  const int g = threadIdx.x & (kGroup - 1);  // lane within the item
  const int slot = threadIdx.x / kGroup;
  const int slots = blockDim.x / kGroup;
  const int LP = tb.L * tb.P;
  for (int q0 = q_begin; q0 < q_end; q0 += slots) {  // block-uniform
    const int q = q0 + slot;
    const bool active = q < q_end;
    const int64_t bqh = ((int64_t)b * tb.Q + (active ? q : q0)) * tb.H + h;
    // the probe kMerged: the locations of the block's first query
    const int64_t geo =
        kMode == kMerged ? ((int64_t)b * tb.Q + q_begin) * tb.H + h : bqh;
    const float* lp = loc + geo * LP * 2;
    const float* ap = attn + bqh * LP;
    float acc[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
    for (int t0 = 0; t0 < LP; t0 += kGroup) {
      Tap mine{0, 0.f, 0.f, 0.f};
      if (active && t0 + g < LP)
        mine = tap_geometry(lvs, t0 + g, tb.P, lp, ap);
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (t0 + j >= LP) break;  // uniform over the warp
        const Tap tp = shfl_tap<kGroup>(mine, j);
        const int m = tp.mask();
        if (!m) continue;
        const Level lv = lvs[tp.level()];
        const float hx = 1.f - tp.lx, hy = 1.f - tp.ly;
        const float cw[4] = {tp.a * hy * hx, tp.a * hy * tp.lx,
                             tp.a * tp.ly * hx, tp.a * tp.ly * tp.lx};
        const int off[4] = {0, 1, lv.w, lv.w + 1};
        float v[4][kVec];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int tok = tp.corner() + off[c];
          if (kMode == kNoLoads || !(m >> c & 1)) {
#pragma unroll
            for (int e = 0; e < kVec; ++e) v[c][e] = (m >> c & 1) ? 1.f : 0.f;
          } else if (staged(lv)) {
            load_vec<false>(stage + (int64_t)(tok - lv.delta) * D + g * kVec,
                            v[c]);
          } else {
            load_vec<true>(vb + tok * row + g * kVec, v[c]);
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[e] = fmaf(cw[c], v[c][e], acc[e]);
      }
    }
    if (active) store_vec(out + bqh * D + g * kVec, acc);
  }
}

template <typename T, int D, int kMode>
cudaError_t launch_typed(const void* value, const void* loc, const void* attn,
                         void* out, const Table& tb, int rows, int chunks,
                         int threads, cudaStream_t stream) {
  auto kernel = msda_fwd_kernel<T, D, kMode>;
  static bool attr_set = false;  // once per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const size_t smem = (size_t)rows * D * sizeof(T);
  kernel<<<dim3(chunks, tb.B * tb.H), threads, smem, stream>>>(
      static_cast<const T*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(attn), static_cast<T*>(out), tb);
  return cudaGetLastError();
}

template <int kMode>
int launch(const void* value, const void* loc, const void* attn, void* out,
           const int* levels, int L, int dtype, int B, int N, int Q, int H,
           int D, int P, int chunk, int threads, void* stream) {
  if (L < 1 || L > kMaxLevels || chunk < 1 || threads < 32 ||
      threads > kMaxThreads || threads % 32)
    return (int)cudaErrorInvalidValue;
  Table tb;
  const int rows = make_table(tb, levels, L, B, N, Q, H, P, chunk);
  const size_t elt = dtype == 0 ? 4 : 2;
  if ((size_t)rows * D * elt > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const int chunks = (Q + chunk - 1) / chunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MSDA_CASE(DD)                                                        \
  if (D == DD)                                                              \
    return dtype == 0                                                       \
               ? (int)launch_typed<float, DD, kMode>(                       \
                     value, loc, attn, out, tb, rows, chunks, threads, s)   \
               : (int)launch_typed<__nv_bfloat16, DD, kMode>(               \
                     value, loc, attn, out, tb, rows, chunks, threads, s);
  if (dtype == 0 || dtype == 1) {
    MSDA_FOR_EACH_HEAD_DIM(MSDA_CASE)
  }
#undef MSDA_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point, bound with ctypes.  dtype: 0 = float32, 1 = bfloat16
// (value and out); D in {2, 4, 8, 16, 32, 64, 128, 256}.  loc
// (B,Q,H,L,P,2) and attn (B,Q,H,L,P) are float32; value, loc, attn and out
// on the device, contiguous, 16-byte aligned.  levels is a host array of L
// triples (H_l, W_l, first row of the level in the block's shared table or
// -1), chunk the queries per block and threads the block size, both from
// ops/_ext.py::msda_plan.  Returns cudaGetLastError() after the launch (0 =
// success).
extern "C" int msda_fwd(const void* value, const void* loc, const void* attn,
                        void* out, const int* levels, int L, int dtype, int B,
                        int N, int Q, int H, int D, int P, int chunk,
                        int threads, void* stream) {
  return launch<kFull>(value, loc, attn, out, levels, L, dtype, B, N, Q, H, D,
                       P, chunk, threads, stream);
}

// The same launch with a part of the work removed or changed (mode: 1 =
// empty body, 2 = every corner value taken as 1, no corner loads, 7 = every
// item takes the locations of its block's first query: perfect row
// sharing, the counterpart of the TPU merged-window probe
// tools/perf/merged_window_ablate.py:39 _merged_kernel).  Wrong on purpose:
// chip_smoke.py times it to see what bounds msda_fwd; no module of the
// package calls it.
extern "C" int msda_fwd_ablate(const void* value, const void* loc,
                               const void* attn, void* out, const int* levels,
                               int L, int dtype, int B, int N, int Q, int H,
                               int D, int P, int chunk, int threads, int mode,
                               void* stream) {
  if (mode == kEmpty)
    return launch<kEmpty>(value, loc, attn, out, levels, L, dtype, B, N, Q, H,
                          D, P, chunk, threads, stream);
  if (mode == kNoLoads)
    return launch<kNoLoads>(value, loc, attn, out, levels, L, dtype, B, N, Q,
                            H, D, P, chunk, threads, stream);
  if (mode == kMerged)
    return launch<kMerged>(value, loc, attn, out, levels, L, dtype, B, N, Q,
                           H, D, P, chunk, threads, stream);
  return (int)cudaErrorInvalidValue;
}
