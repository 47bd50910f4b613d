// Shared code of the msda kernels (csrc/msda_fwd.cu, csrc/msda_bwd.cu).
//
// Work partition, the same in both directions: one block takes one (b, h)
// and a chunk of consecutive queries (blockIdx.x the chunk, blockIdx.y
// b * H + h, chunks fastest, so the blocks on one SM share a head and the
// L1 holds that head's rows only).  An item is one (b, q, h); it takes
// kGroup lanes, each owning kVec consecutive channels (``Lanes``: 8 forward,
// 4 backward), so at D=32 a warp serves 8 (forward) or 4 (backward)
// queries of one head.  A tap's geometry (top-left corner, in-range corner
// mask, attention weight, fractional offsets) is computed once per item,
// one tap per lane, and broadcast to the item's lanes with __shfl_sync.
//
// The plan (``ops/_ext.py::msda_plan``) picks the chunk and the levels,
// coarsest first, that a block stages in shared memory: the value rows of
// head h (forward) or an f32 gradient table (backward).  It travels with
// the level table by value, as the kernel argument ``Table``.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace msda {

constexpr int kMaxLevels = 8;
constexpr int kMaxThreads = 1024;

// ablation modes of the probe entry points (wrong on purpose; only
// chip_smoke.py calls them): kEmpty returns at once (launch and operand
// floor), kNoLoads (forward) takes every corner value as 1, kNoScatter
// (backward) drops every grad_value reduction, kNoSums (backward) drops the
// per-tap dot products, their shuffles and the value loads they need,
// kNoShared and kNoDirect (backward) drop the reductions into the shared
// table (and its zeroing and flush) or those made directly to global
// memory, kMerged (forward) gives every item of a block the geometry of
// the block's first query: the same corner rows and level windows, as
// perfect row sharing between neighbouring queries would.
enum Mode {
  kFull = 0, kEmpty = 1, kNoLoads = 2, kNoScatter = 3, kNoSums = 4,
  kNoShared = 5, kNoDirect = 6, kMerged = 7
};

// The call's level table and plan, by value.
struct Table {
  int h[kMaxLevels], w[kMaxLevels];
  int start[kMaxLevels];     // first token of each level
  int smem_row[kMaxLevels];  // first row in the shared table, -1: not staged
  int B, N, Q, H, L, P;
  int chunk;                 // queries per block
  int staged_rows;           // rows of the shared table
};

// One level as a block reads it from shared memory (one broadcast load).
struct __align__(16) Level {
  int h, w, start, delta;  // delta = start - shared row; INT32_MIN: direct
};

// the dynamic shared memory a block may use on Hopper: 227 KB of the SM's
// 256 KB less the static level table
constexpr int kMaxSmem = 232448 - kMaxLevels * (int)sizeof(Level);

__device__ __forceinline__ bool staged(const Level& lv) {
  return lv.delta != INT32_MIN;
}

// Copies the table's levels into shared memory; callers sync before use.
__device__ __forceinline__ void load_levels(const Table& tb, Level* lv) {
  if (threadIdx.x < tb.L) {
    const int l = threadIdx.x;
    lv[l] = Level{tb.h[l], tb.w[l], tb.start[l],
                  tb.smem_row[l] < 0 ? INT32_MIN
                                     : tb.start[l] - tb.smem_row[l]};
  }
}

// An item's lanes: each owns kVec = min(kMaxVec, D) consecutive channels
// and there are kGroup = D / kVec of them.  The forward takes kMaxVec = 8
// (32 bytes a lane in f32, 16 in bf16), the backward 4 (16 bytes of its
// f32 gradient rows; bf16 values load 8 bytes a lane).  D is a power of
// two from 2: the forward's items take up to a warp (D = 256), the
// backward's at most 8 lanes (D = 32), wider heads running in passes of 32
// channels (msda_bwd.cu).  At D = 2 (SOIT's dynamic mask heads, 4 heads of
// 2 channels) an item is one lane of 2 channels in both directions: 8
// bytes of a row in f32, 4 in bf16, which is also the alignment a row of
// head h has (h * 2 elements from a 16-byte aligned base).
template <int D, int kMaxVec>
struct Lanes {
  static constexpr int kVec = kMaxVec < D ? kMaxVec : D;
  static constexpr int kGroup = D / kVec;
  static_assert(kVec * kGroup == D && (kGroup & (kGroup - 1)) == 0 &&
                    kGroup <= 32, "head size");
};

// The head sizes both kernels are compiled for (ops/_ext.py::
// MSDA_HEAD_DIMS lists the same): SOIT's and DK-DETR's dynamic mask heads
// (2), the edge case, the tiny configs and the flagship (4, 8, 32), the
// other powers of two up to SOIT's one 256-channel head.
#define MSDA_FOR_EACH_HEAD_DIM(X) \
  X(2) X(4) X(8) X(16) X(32) X(64) X(128) X(256)

// ---- vector loads and stores, f32 in registers --------------------------

__device__ __forceinline__ void unpack(float4 r, float (&v)[4]) {
  v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
}
__device__ __forceinline__ void unpack_bf16(uint32_t r, float* v) {
  __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&r);
  const float2 f = __bfloat1622float2(b);
  v[0] = f.x; v[1] = f.y;
}
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

// kVec elements at p (8 f32: two 16-byte loads; 8 bf16: one; 4 f32: one;
// 4 bf16: one 8-byte load; 2 f32: one 8-byte load; 2 bf16: one 4-byte
// load) as floats; kGlobal reads through the read-only path (value is not
// written during a call).  p is aligned to the whole vector.
template <bool kGlobal>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[2]) {
  const float2* q = reinterpret_cast<const float2*>(p);
  const float2 r = kGlobal ? __ldg(q) : *q;
  v[0] = r.x; v[1] = r.y;
}
template <bool kGlobal>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&v)[2]) {
  const unsigned int* q = reinterpret_cast<const unsigned int*>(p);
  unpack_bf16(kGlobal ? __ldg(q) : *q, v);
}
template <bool kGlobal>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4* q = reinterpret_cast<const float4*>(p);
  unpack(kGlobal ? __ldg(q) : *q, v);
}
template <bool kGlobal>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[8]) {
  const float4* q = reinterpret_cast<const float4*>(p);
  const float4 a = kGlobal ? __ldg(q) : q[0];
  const float4 b = kGlobal ? __ldg(q + 1) : q[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
template <bool kGlobal>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&v)[8]) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  const uint4 r = kGlobal ? __ldg(q) : *q;
  unpack_bf16(r.x, v); unpack_bf16(r.y, v + 2);
  unpack_bf16(r.z, v + 4); unpack_bf16(r.w, v + 6);
}
template <bool kGlobal>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&v)[4]) {
  const uint2* q = reinterpret_cast<const uint2*>(p);
  const uint2 r = kGlobal ? __ldg(q) : *q;
  unpack_bf16(r.x, v); unpack_bf16(r.y, v + 2);
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&v)[2]) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(v[0], v[1]);
}
__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_vec(float* p, const float (&v)[8]) {
  float4* q = reinterpret_cast<float4*>(p);
  q[0] = make_float4(v[0], v[1], v[2], v[3]);
  q[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                 pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
}

// one 16-byte vector reduction into global memory (sm_90)
__device__ __forceinline__ void red_add_v4(float* p, float a, float b,
                                           float c, float d) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}
// one 8-byte vector reduction into global memory (sm_90; p 8-byte aligned)
__device__ __forceinline__ void red_add_v2(float* p, float a, float b) {
  asm volatile("red.global.add.v2.f32 [%0], {%1, %2};" ::"l"(p), "f"(a),
               "f"(b)
               : "memory");
}

// ---- taps ---------------------------------------------------------------

// One tap, packed for a 4-shuffle broadcast: ``code`` = token of its
// top-left corner (y0, x0) within the (b, h) value table << 7 | level << 4
// | in-range corner mask (bit 0: (y0, x0), 1: (y0, x0+1), 2: (y0+1, x0),
// 3: (y0+1, x0+1)); the attention weight a; the fractional offsets lx, ly.
// A tap with no corner in range has mask 0 (also a NaN location: every
// comparison fails).  The token may be negative (x0 or y0 = -1); the
// wrapper keeps N below 2^24.
struct Tap {
  int code;
  float a, lx, ly;
  __device__ __forceinline__ int corner() const { return code >> 7; }
  __device__ __forceinline__ int level() const { return (code >> 4) & 7; }
  __device__ __forceinline__ int mask() const { return code & 15; }
};

// kEarly issues the weight's load beside the location's, for every tap
// (the D = 2 backward, whose lane loads four taps' geometry at once);
// otherwise only an in-range tap loads its weight.
template <bool kEarly = false>
__device__ __forceinline__ Tap tap_geometry(const Level* lvs, int t, int P,
                                            const float* lp,
                                            const float* ap) {
  const int l = t / P;
  const Level lv = lvs[l];
  const float2 xy = *reinterpret_cast<const float2*>(lp + 2 * t);
  const float a = kEarly ? __ldg(ap + t) : 0.f;
  const float x = xy.x * lv.w - 0.5f;
  const float y = xy.y * lv.h - 0.5f;
  Tap tp{l << 4, 0.f, 0.f, 0.f};
  if (x > -1.f && y > -1.f && x < (float)lv.w && y < (float)lv.h) {
    const float xf = floorf(x), yf = floorf(y);
    const int x0 = (int)xf, y0 = (int)yf;
    const bool in_x0 = x0 >= 0, in_x1 = x0 + 1 < lv.w;
    const bool in_y0 = y0 >= 0, in_y1 = y0 + 1 < lv.h;
    tp.code = (lv.start + y0 * lv.w + x0) * 128 | l << 4 |
              (in_y0 && in_x0) | (in_y0 && in_x1) << 1 |
              (in_y1 && in_x0) << 2 | (in_y1 && in_x1) << 3;
    tp.a = kEarly ? a : __ldg(ap + t);
    tp.lx = x - xf;
    tp.ly = y - yf;
  }
  return tp;
}

// the tap owned by lane ``src`` of this lane's item
template <int kGroup>
__device__ __forceinline__ Tap shfl_tap(const Tap& tp, int src) {
  if (kGroup == 1) return tp;
  const unsigned all = 0xffffffffu;
  return Tap{__shfl_sync(all, tp.code, src, kGroup),
             __shfl_sync(all, tp.a, src, kGroup),
             __shfl_sync(all, tp.lx, src, kGroup),
             __shfl_sync(all, tp.ly, src, kGroup)};
}

// Host side: the Table of a call from the per-level (h, w, shared row or
// -1) host array; returns the shared-memory rows.
inline int make_table(Table& tb, const int* levels, int L, int B, int N,
                      int Q, int H, int P, int chunk) {
  int start = 0, rows = 0;
  for (int l = 0; l < kMaxLevels; ++l) {
    const bool in = l < L;
    tb.h[l] = in ? levels[3 * l] : 0;
    tb.w[l] = in ? levels[3 * l + 1] : 0;
    tb.smem_row[l] = in ? levels[3 * l + 2] : -1;
    tb.start[l] = start;
    start += tb.h[l] * tb.w[l];
    if (tb.smem_row[l] >= 0 && tb.smem_row[l] + tb.h[l] * tb.w[l] > rows)
      rows = tb.smem_row[l] + tb.h[l] * tb.w[l];
  }
  tb.B = B; tb.N = N; tb.Q = Q; tb.H = H; tb.L = L; tb.P = P;
  tb.chunk = chunk;
  tb.staged_rows = rows;
  return rows;
}

}  // namespace msda
