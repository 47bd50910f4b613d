// Window attention, forward, for Hopper (sm_90a), on tensor cores; one
// launch takes every level raster of an encoder layer.
//
// Replaces the TPU Pallas kernel
// pavenet_tpu/ops/pallas/window_attn.py:173 (_fwd, body _fwd_kernel :47).
// For every (8, 16) window of each (B, Hp, Wp, C) level raster and every
// head h (D = C / num_heads channels):
//
//   s[i,j] = keep[j] ? (q_i . k_j) / sqrt(D) : -1e9        (f32)
//   out_i  = sum_j cast_v(softmax_j(s[i,:])) v_j            (summed in f32)
//
// Masked keys get exactly -1e9, not -inf: a fully masked window gives the
// mean of its values (zero in the model, whose caller zeroes v at padded
// keys), as the TPU kernel does.
//
// What bounds it on an H100: bytes.  One flagship layer (603 windows of
// 128 tokens over four levels, 8 heads, D = 32, f32) moves 316 MB of q, k,
// v, keep and out: 0.094 ms at 3.35 TB/s, against 10.1 GFLOP of the two
// products, 0.061 ms at the 3xTF32 rate (495 / 3 TFLOP/s).  In bf16 0.047
// ms of bytes against 0.010 ms at 989 TFLOP/s.
//
// What the design does about it:
// - one block per (window, head), 8 warps of 16 query rows; the whole
//   16 x 128 score tile of a warp stays in registers, so the softmax is
//   exact (no online rescale): row max and sum come from quad shuffles;
// - both products on tensor cores through mma.sync: float32 as 3xTF32
//   (big = tf32(x), small = tf32(x - big), big*big + big*small +
//   small*big, f32 sums), which keeps the f32 tolerance where one TF32
//   product would not; bf16 as m16n8k16 with f32 sums, the weights rounded
//   to bf16 before P V as the contract says;
// - q, k and v head slices are staged together with 16-byte cp.async (one
//   round trip to device memory) into rows padded so that every fragment
//   read is free of bank conflicts (window_attn_common.cuh); the grid runs
//   the heads of a window next to each other, so the blocks in flight read
//   whole token rows;
// - the level table (pointers, raster sizes, each level's first window)
//   is the kernel's by-value argument; blockIdx.x finds its level by the
//   prefix of first windows, so one launch covers a layer's four levels and
//   the small levels no longer each pay a launch.
// Left to later PRs: wgmma (64-row tiles across warps), TMA loads, several
// heads per block to reuse the window's offsets, and double buffering
// across windows of a persistent block.
#include "window_attn_common.cuh"

namespace {

using namespace wattn;

template <typename T, int D>
constexpr size_t fwd_smem() {
  return 3 * (size_t)kTokens * Strides<T, D>::kv * sizeof(T)
         + kTokens * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    window_attn_fwd_kernel(const __grid_constant__ LevelTable tab) {
  constexpr int kS = Strides<T, D>::kv;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + kTokens * kS;
  T* vs = ks + kTokens * kS;
  float* kp = reinterpret_cast<float*>(vs + kTokens * kS);

  const Window w = find_window(tab);
  const int C = tab.C;
  stage<T, D>(qs, kS, w.L.in[0], w, C);
  stage<T, D>(ks, kS, w.L.in[1], w, C);
  stage<T, D>(vs, kS, w.L.in[2], w, C);
  stage_keep(kp, w);
  cp_async_wait_all();
  __syncthreads();

  const int r = (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
  float s[16][4] = {};                          // rows r and r + 8
  rows_by_rows<D>(s, qs + r * kS, qs + (r + 8) * kS, ks);
  masked_softmax(s, kp, tab.scale2);
  float o[D / 8][4] = {};
  scores_by_rows<D>(o, s, vs);
  store_rows<T, D>(w.L.out[0], w, C, r, o, 1.f);
}

template <typename T, int D>
cudaError_t launch(const LevelTable& tab, int windows, int heads,
                   cudaStream_t stream) {
  constexpr size_t smem = fwd_smem<T, D>();
  auto kernel = window_attn_fwd_kernel<T, D>;
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
      return launch<T, 64>(tab, windows, heads, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point, bound with ctypes.  For each of n_levels levels,
// ptrs holds q, k, v, keep, out (5 device pointers) and dims holds
// (Hp, Wp, first window); windows is the total over the levels.
// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out); keep is float32 0/1.
// Rasters are (B, Hp, Wp, C), contiguous, 16-byte aligned; wh * ww = 128,
// C / num_heads in {8, 16, 32, 64}, at most 8 levels.  Returns the CUDA error of
// the launch (0 = success).
extern "C" int window_attn_fwd(int n_levels, void* const* ptrs,
                               const int* dims, int windows, int dtype,
                               int C, int num_heads, int wh, int ww,
                               void* stream) {
  LevelTable tab;
  if (!fill_table(tab, n_levels, ptrs, 3, 1, dims, C, num_heads, wh, ww) ||
      windows < 1 || (long long)windows * num_heads > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(tab, windows, num_heads, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(tab, windows, num_heads, s);
  return (int)cudaErrorInvalidValue;
}
