// Bilinear backward warp with border clamp, for sm_90a (H100).
//
// Four kernels. The sample coordinate is built in float32 exactly as the
// exact path builds it, in one of two conventions:
// - normalized grid (fastvideocodec_tpu/ops/warp.py:_xla_flow_warp,
//   mirrored by fastvideocodec_torch/ops/warp.py:plain_flow_warp): the
//   linspace(-1,1) grid plus flow*2/(size-1);
// - pixel displacement (_xla_pixel_warp, mirrored by plain_pixel_warp):
//   source = output + flow, normalized as (2*s + 1)/size - 1 with an IEEE
//   division, as the exact path does (the round trip is not the identity
//   in float32, so it is kept);
// then unnormalized with align_corners=False and clamped to the border.
// The four taps are read, lerped in float32 and rounded once to the output
// type. Every float operation goes through a round-to-nearest intrinsic,
// so nvcc contracts nothing into an FMA and the result equals the plain
// PyTorch version's bit for bit.
//
// There is no displacement bound: the TPU kernel's clamp to R pixels and
// its +-11-row window were limits of the TPU's VMEM halo, not semantics.
//
// All are bound by bytes: a few flops per byte moved. The two normalized-
// grid warps of the LSVC-TPU main path (flow_warp_kernel,
// flow_warp_s2d_kernel) are tiled: a block owns a tile of outputs, a warp
// one row of it and a thread pairs of neighbouring outputs; the s2d warp's
// block also stages the tile's source footprint in shared memory when it
// fits. The two pixel warps of SSF-TPU are still plain gathers: one thread
// per output position on a 1-D grid. The pixel-convention kernels take a
// float32 flow with a float32 or bfloat16 image: a bfloat16 flow would be
// pixels coarse at 2048 wide.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Tap {
  int i0, i1;  // border-clamped source indices
  float t;     // weight of i1
};

// The taps of normalized coordinate g along an axis of n: unnormalized
// with align_corners=False, clamped to the border. Monotone in g: a larger
// g never gives a smaller i0 or i1.
__device__ __forceinline__ Tap border_tap(float g, int n) {
  float u = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(g, 1.0f), (float)n), 1.0f), 0.5f);
  u = fminf(fmaxf(u, 0.0f), (float)(n - 1));
  float u0 = floorf(u);
  Tap tap;
  tap.t = __fsub_rn(u, u0);
  tap.i0 = min(max((int)u0, 0), n - 1);
  tap.i1 = min(tap.i0 + 1, n - 1);
  return tap;
}

// jnp.linspace(-1, 1, n)[i] = -1*(1-s) + 1*s with s = i/(n-1).
__device__ __forceinline__ float linspace_at(int i, int n) {
  if (n <= 1) return -1.0f;
  float s = __fdiv_rn((float)i, (float)(n - 1));
  return __fadd_rn(-__fsub_rn(1.0f, s), s);
}

// The normalized-grid coordinate: lin (the output's linspace value) plus
// the flow f in pixels times norm = 2/max(n-1,1) rounded to float32 on the
// host.
__device__ __forceinline__ float grid_coord(float lin, float f, float norm) {
  return __fadd_rn(lin, __fmul_rn(f, norm));
}

// Pixel convention: source = i + f, normalized as (2*s + 1)/n - 1.
__device__ __forceinline__ Tap pixel_tap(float f, int i, int n) {
  float s = __fadd_rn((float)i, f);
  float g = __fsub_rn(__fdiv_rn(__fadd_rn(__fmul_rn(2.0f, s), 1.0f), (float)n), 1.0f);
  return border_tap(g, n);
}

__device__ __forceinline__ float lerp2(float v00, float v01, float v10, float v11,
                                       float tx, float ty) {
  float sx = __fsub_rn(1.0f, tx), sy = __fsub_rn(1.0f, ty);
  float top = __fadd_rn(__fmul_rn(v00, sx), __fmul_rn(v01, tx));
  float bot = __fadd_rn(__fmul_rn(v10, sx), __fmul_rn(v11, tx));
  return __fadd_rn(__fmul_rn(top, sy), __fmul_rn(bot, ty));
}

// Lerp the taps (tx, ty) of each of C planes of W-wide rows (plane
// elements apart) from ib into ob[c * plane].
template <typename T>
__device__ __forceinline__ void lerp_planes(const T* ib, T* ob, int C, int64_t plane, int W,
                                            Tap tx, Tap ty) {
  int64_t o00 = (int64_t)ty.i0 * W + tx.i0, o01 = (int64_t)ty.i0 * W + tx.i1;
  int64_t o10 = (int64_t)ty.i1 * W + tx.i0, o11 = (int64_t)ty.i1 * W + tx.i1;
  for (int c = 0; c < C; ++c) {
    const T* ic = ib + c * plane;
    float v = lerp2(to_f32(ic[o00]), to_f32(ic[o01]), to_f32(ic[o10]),
                    to_f32(ic[o11]), tx.t, ty.t);
    ob[c * plane] = from_f32<T>(v);
  }
}

// The same for full-res taps of an image in s2d form [4C, Hs, Ws]: full-res
// pixel (y, x) lies in s2d channel ((y%2)*2 + x%2)*C + c at (y/2, x/2).
// Writes the C channels of one output phase, oc[c * splane].
template <typename T>
__device__ __forceinline__ void lerp_s2d(const T* ib, T* oc, int C, int64_t splane, int Ws,
                                         Tap tx, Tap ty) {
  int64_t s00 = (int64_t)((ty.i0 & 1) * 2 + (tx.i0 & 1)) * C * splane
                + (int64_t)(ty.i0 >> 1) * Ws + (tx.i0 >> 1);
  int64_t s01 = (int64_t)((ty.i0 & 1) * 2 + (tx.i1 & 1)) * C * splane
                + (int64_t)(ty.i0 >> 1) * Ws + (tx.i1 >> 1);
  int64_t s10 = (int64_t)((ty.i1 & 1) * 2 + (tx.i0 & 1)) * C * splane
                + (int64_t)(ty.i1 >> 1) * Ws + (tx.i0 >> 1);
  int64_t s11 = (int64_t)((ty.i1 & 1) * 2 + (tx.i1 & 1)) * C * splane
                + (int64_t)(ty.i1 >> 1) * Ws + (tx.i1 >> 1);
  for (int c = 0; c < C; ++c) {
    const T* ic = ib + (int64_t)c * splane;
    float v = lerp2(to_f32(ic[s00]), to_f32(ic[s01]), to_f32(ic[s10]),
                    to_f32(ic[s11]), tx.t, ty.t);
    oc[(int64_t)c * splane] = from_f32<T>(v);
  }
}

// ---------------------------------------------------------------------------
// The tiled normalized-grid warps
// ---------------------------------------------------------------------------

constexpr int kPairCols = 64;  // columns of one pair step of a warp: 32 lanes x 2
constexpr int kAlign = 8;      // staged columns start and end on multiples of 8

// Launch flags, from the entry points' alignment checks.
constexpr int kVecPairs = 1;  // rows even, pointers aligned: a pair is one vector
constexpr int kVec16 = 2;     // rows a multiple of kAlign, image 16-byte aligned: cp.async

// A thread owns pairs of neighbouring outputs of one row: pair m of lane l
// covers columns pair_col(m, l) and pair_col(m, l) + 1 of its warp's, so
// each load, store and gather instruction of a warp touches kPairCols
// neighbouring elements (128 bytes of bf16), and the gathers of a smooth
// flow fall on 32 different shared-memory banks.
__device__ __forceinline__ int pair_col(int m, int lane) { return kPairCols * m + 2 * lane; }

// N consecutive elements, loaded as one vector.
template <typename T, int N>
struct alignas(N * sizeof(T)) Vec {
  T v[N];
};

// The n (0..N) elements at p, zero past them: one N-element vector load
// (4 or 8 bytes of bf16, 8 or 16 of f32) when vec and all are in range.
template <int N, typename T>
__device__ __forceinline__ Vec<T, N> load_vec(const T* p, bool vec, int n) {
  if (vec && n == N) return *reinterpret_cast<const Vec<T, N>*>(p);
  Vec<T, N> r;
#pragma unroll
  for (int k = 0; k < N; ++k) r.v[k] = k < n ? p[k] : from_f32<T>(0.0f);
  return r;
}

// a and b rounded to T at p[0] and p[1], the first n (0..2) of them: one
// vector store when vec and both are in range.
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, bool vec, int n, float a, float b) {
  if (vec && n == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    if (n > 0) p[0] = __float2bfloat16_rn(a);
    if (n > 1) p[1] = __float2bfloat16_rn(b);
  }
}

__device__ __forceinline__ void store_pair(float* p, bool vec, int n, float a, float b) {
  if (vec && n == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    if (n > 0) p[0] = a;
    if (n > 1) p[1] = b;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The tile's source footprint: rows [r0, r1] and columns [c0, c1] of the
// planes it reads, inclusive.
struct Box {
  int r0, r1, c0, c1;
};

__device__ __forceinline__ void empty_box(Box* box) {
  box->r0 = INT_MAX;
  box->r1 = INT_MIN;
  box->c0 = INT_MAX;
  box->c1 = INT_MIN;
}

// Reduce each thread's box over the block (warp reductions, then shared
// atomics on *box, which thread 0 emptied before a __syncthreads that
// precedes this call). Every thread of the block must call it.
__device__ __forceinline__ Box block_box(Box mine, Box* box) {
  const unsigned all = 0xffffffffu;
  const int r0 = __reduce_min_sync(all, mine.r0), r1 = __reduce_max_sync(all, mine.r1);
  const int c0 = __reduce_min_sync(all, mine.c0), c1 = __reduce_max_sync(all, mine.c1);
  if ((threadIdx.x & 31) == 0) {
    atomicMin(&box->r0, r0);
    atomicMax(&box->r1, r1);
    atomicMin(&box->c0, c0);
    atomicMax(&box->c1, c1);
  }
  __syncthreads();
  return *box;
}

// Where a block reads its taps from: the staged footprint in shared memory
// (plane p row r at (p*rows + r)*pitch, row r0 and column c0 of the image
// at row and column 0) or the image in global memory (origin 0, pitch its
// row width, cstride its plane).
struct Source {
  int r0, c0, pitch, cstride;
};

// The footprint box widened to whole multiples of kAlign columns when
// vec16, and whether P planes of it fit budget elements of shared memory.
__device__ __forceinline__ bool fits_stage(Box box, int P, bool vec16, int budget, Source* s) {
  s->r0 = box.r0;
  s->c0 = vec16 ? (box.c0 & ~(kAlign - 1)) : box.c0;
  const int ce = vec16 ? ((box.c1 + kAlign) & ~(kAlign - 1)) : box.c1 + 1;
  s->pitch = ce - s->c0;
  s->cstride = (box.r1 - box.r0 + 1) * s->pitch;
  return (int64_t)P * s->cstride <= budget;
}

// Start copying rows [s.r0, s.r0 + rows) and columns [s.c0, s.c0 + s.pitch)
// of each of P planes (plane elements apart, W-wide rows) of ib into
// stage. One warp copies one row at a time: 16-byte cp.async chunks when
// vec16, else element by element. The caller then waits
// (cp_async_wait_all) and syncs.
template <typename T>
__device__ __forceinline__ void stage_footprint(T* stage, const T* ib, int P, int plane, int W,
                                                const Source& s, int rows, bool vec16) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  constexpr int kChunk = 16 / sizeof(T);
  for (int line = warp; line < P * rows; line += nwarps) {
    const int p = line / rows, r = line - p * rows;
    const T* src = ib + p * plane + (s.r0 + r) * W + s.c0;
    T* dst = stage + line * s.pitch;
    if (vec16) {
      for (int e = lane * kChunk; e < s.pitch; e += 32 * kChunk) cp_async16(dst + e, src + e);
    } else {
      for (int e = lane; e < s.pitch; e += 32) dst[e] = src[e];
    }
  }
  cp_async_commit();
}

// One output's four source offsets (from its channel's base) and weights.
struct Taps4 {
  int o00, o01, o10, o11;
  float wx, wy;
};

template <typename T>
__device__ __forceinline__ float lerp_at(const T* sc, const Taps4& t) {
  return lerp2(to_f32(sc[t.o00]), to_f32(sc[t.o01]), to_f32(sc[t.o10]), to_f32(sc[t.o11]),
               t.wx, t.wy);
}

// Gather, lerp and store one pair of outputs in each of C channels: output
// e of channel c reads src + c*cstride at its taps t[e] and goes to
// out[c*ostride + e], the first n of the two.
template <typename T>
__device__ __forceinline__ void lerp_pair(const T* src, int cstride, const Taps4 (&t)[2], int C,
                                          T* out, int ostride, bool vec, int n) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const T* sc = src + c * cstride;
    store_pair(out + c * ostride, vec, n, lerp_at(sc, t[0]), lerp_at(sc, t[1]));
  }
}

// Extreme coordinates of a thread's pixels, and the footprint box of their
// taps: border_tap is monotone, so the taps of the extremes bound all.
struct Extremes {
  float x_lo = FLT_MAX, x_hi = -FLT_MAX, y_lo = FLT_MAX, y_hi = -FLT_MAX;

  __device__ __forceinline__ void add(float gx, float gy) {
    // a NaN coordinate (a NaN flow) samples index 0, where border_tap's
    // fmaxf clamps it; fminf would drop it, so count it as the lowest
    gx = gx == gx ? gx : -FLT_MAX, gy = gy == gy ? gy : -FLT_MAX;
    x_lo = fminf(x_lo, gx), x_hi = fmaxf(x_hi, gx);
    y_lo = fminf(y_lo, gy), y_hi = fmaxf(y_hi, gy);
  }

  // The box of the taps (empty if no pixel was added), in rows and columns
  // of an H x W image shifted right by shift (1: in s2d rows and columns).
  __device__ __forceinline__ Box box(int H, int W, int shift) const {
    if (x_lo > x_hi) return Box{INT_MAX, INT_MIN, INT_MAX, INT_MIN};
    return Box{border_tap(y_lo, H).i0 >> shift, border_tap(y_hi, H).i1 >> shift,
               border_tap(x_lo, W).i0 >> shift, border_tap(x_hi, W).i1 >> shift};
  }
};

constexpr int kFwPairs = 4;                  // pairs of outputs a thread owns
constexpr int kFwCols = kPairCols * kFwPairs;  // 256 columns a warp covers
constexpr int kFwRows = 8;                   // warps of a block, one output row each
constexpr int kFwThreads = 32 * kFwRows;     // 256: a tile of kFwRows x kFwCols outputs

// Replaces pallas_flow_warp (fastvideocodec_tpu/ops/pallas/warp_kernel.py:501),
// the SpyNet level warp. img [B,C,H,W], flow [B,2,H,W], out [B,C,H,W].
//
// Bound by bytes: it must read the flow and the image once and write the
// output (C=3 on the main path: ~167 MB per GOP at 1024x2048, ~0.05 ms at
// 3.35 TB/s). What the tiling does about the plain gather's costs:
// - grid (column tiles, row tiles, B): a block owns kFwRows x kFwCols
//   outputs, a warp one row of them and a thread kFwPairs pairs of
//   neighbouring outputs; all indexing is 32-bit from blockIdx and
//   tile-local offsets (no 64-bit division);
// - the linspace values of the tile's columns and rows are computed once
//   per block into shared memory (the same __fdiv_rn expression), so a
//   pixel costs one multiply and one add per axis before border_tap;
// - the flow and every output channel move as 2-element vectors, each
//   warp access 128 contiguous bytes in bf16 (a masked scalar edge where W
//   is odd or a pointer unaligned); runs of 8 outputs a thread with
//   16-byte vectors were tried first and lost (PERF.md);
// - the gathers read global memory, through L1: staging the tile's
//   footprint in shared memory, as flow_warp_s2d_kernel does, measured
//   slower here on the path's flows and on random ones (warp_ab.py,
//   PERF.md).
template <typename T>
__global__ void __launch_bounds__(kFwThreads)
flow_warp_kernel(const T* __restrict__ img, const T* __restrict__ flow, T* __restrict__ out,
                 int C, int H, int W, float norm_x, float norm_y, int flags) {
  __shared__ float lin_x[kFwCols], lin_y[kFwRows];

  const int tid = threadIdx.x, lane = tid & 31, row = tid >> 5, b = blockIdx.z;
  const int tx0 = blockIdx.x * kFwCols, ty0 = blockIdx.y * kFwRows;
  for (int t = tid; t < kFwCols; t += kFwThreads) lin_x[t] = linspace_at(tx0 + t, W);
  if (tid < kFwRows) lin_y[tid] = linspace_at(ty0 + tid, H);
  __syncthreads();

  const int y = ty0 + row, plane = H * W;
  if (y >= H) return;
  const bool vec = flags & kVecPairs;
  const int pix = y * W + tx0;  // the warp's first output
  const T* fb = flow + (int64_t)b * 2 * plane + pix;
  const T* ib = img + (int64_t)b * C * plane;
  T* ob = out + (int64_t)b * C * plane + pix;
  const float ly = lin_y[row];
#pragma unroll
  for (int m = 0; m < kFwPairs; ++m) {
    const int col = pair_col(m, lane), n = min(2, W - tx0 - col);
    if (n <= 0) break;  // never grows with m
    const Vec<T, 2> fx = load_vec<2>(fb + col, vec, n), fy = load_vec<2>(fb + plane + col, vec, n);
    // the taps of the pair; past the edge the pair's first output's, never stored
    Taps4 t[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool in = e < n;
      const float ux = to_f32(in ? fx.v[e] : fx.v[0]), uy = to_f32(in ? fy.v[e] : fy.v[0]);
      const Tap a = border_tap(grid_coord(lin_x[col + (in ? e : 0)], ux, norm_x), W);
      const Tap c = border_tap(grid_coord(ly, uy, norm_y), H);
      const int r0 = c.i0 * W, r1 = c.i1 * W;
      t[e] = Taps4{r0 + a.i0, r0 + a.i1, r1 + a.i0, r1 + a.i1, a.t, c.t};
    }
    lerp_pair(ib, plane, t, C, ob + col, plane, vec, n);
  }
}

// The tile and the budget in plain numbers: ops/warp.py:staged_tiles reads
// them (and kAlign) from this file.
constexpr int kS2dCols = 128;                   // s2d columns a warp covers
constexpr int kS2dRows = 8;                     // warps of a block, one s2d row each
constexpr int kS2dStageElems = 20480;           // footprint budget: 40 KB of bf16, 80 KB of f32
constexpr int kS2dPairs = kS2dCols / kPairCols;  // 2 pairs of s2d positions a thread owns
constexpr int kS2dThreads = 32 * kS2dRows;      // 256: a tile of kS2dRows x kS2dCols positions
constexpr int kS2dBlocksPerSM = 4;  // bf16: 4 x 40 KB of shared memory, <= 64 registers

// Replaces pallas_flow_warp_s2d (fastvideocodec_tpu/ops/pallas/warp_kernel.py:547),
// the LSVC-TPU motion-compensation warp. img [B,4C,Hs,Ws] is a full-res
// [B,C,2Hs,2Ws] image in space-to-depth form, channel (ry*2 + rx)*C + c;
// flow [B,2,2Hs,2Ws] is full-res; out has img's s2d form. Full-res source
// pixel (y, x) is read from s2d channel ((y%2)*2 + x%2)*C + c at
// (y/2, x/2), so the depth-to-space / space-to-depth round trip folds into
// the loads and stores and nothing full-res is materialized.
//
// Bound by bytes: ~33.6 MB per 1024x2048 frame in bf16 (image, flow,
// output), ~0.15 ms per GOP at 3.35 TB/s. The tiling, as in
// flow_warp_kernel, plus a shared-memory stage:
// - grid (column tiles, row tiles, B) over s2d positions; a block owns
//   kS2dRows x kS2dCols of them, a warp one s2d row and a thread
//   kS2dPairs pairs of neighbouring positions (2 x 4 full-res pixels
//   each); 32-bit indexing;
// - the linspace values of the tile's 2*kS2dCols full-res columns and
//   2*kS2dRows rows once per block in shared memory;
// - the flow of a pair is read as one 4-element vector per full-res row
//   and component (both rows: no stride-2 waste), each output phase
//   plane's pair written as one 2-element vector;
// - a first pass over the flow reduces the tile's extreme coordinates to
//   the box of its taps in s2d rows and columns (exact: the taps are
//   border-clamped and monotone); if the 4C phase planes of it fit
//   kS2dStageElems the block copies them into shared memory with 16-byte
//   cp.async, overlapped with computing the first taps, so the phase
//   planes a warp's taps alternate between are read from shared memory;
//   a larger footprint (large or scattered flows) gathers from global
//   memory in the same kernel, so there is no displacement limit; on the
//   path's flows staging beat gathering every tile from global memory,
//   unlike in flow_warp_kernel (warp_ab.py, PERF.md);
// - the second pass reads each pair's flow again (from L1) and computes
//   its taps just before its gathers: holding them all cost more
//   occupancy than the reads;
// - occupancy: kS2dBlocksPerSM blocks of 256 threads an SM (registers
//   capped at 64) and a budget that leaves the L1 cache room: with 48 KB
//   a block, four blocks left the global path's gathers too little L1 and
//   random flows ran 24% slower than the plain gather of the first port.
template <typename T>
__global__ void __launch_bounds__(kS2dThreads, kS2dBlocksPerSM)
flow_warp_s2d_kernel(const T* __restrict__ img, const T* __restrict__ flow,
                     T* __restrict__ out, int C, int Hs, int Ws, float norm_x, float norm_y,
                     int flags) {
  extern __shared__ __align__(16) unsigned char stage_bytes[];
  T* stage = reinterpret_cast<T*>(stage_bytes);
  __shared__ float lin_x[2 * kS2dCols], lin_y[2 * kS2dRows];
  __shared__ Box box;

  const int tid = threadIdx.x, lane = tid & 31, row = tid >> 5, b = blockIdx.z;
  const int H = 2 * Hs, W = 2 * Ws;
  const int j0 = blockIdx.x * kS2dCols, i0 = blockIdx.y * kS2dRows;
  for (int t = tid; t < 2 * kS2dCols; t += kS2dThreads) lin_x[t] = linspace_at(2 * j0 + t, W);
  if (tid < 2 * kS2dRows) lin_y[tid] = linspace_at(2 * i0 + tid, H);
  if (tid == 0) empty_box(&box);
  __syncthreads();

  const bool vec = flags & kVecPairs, vec16 = flags & kVec16;
  const int i = i0 + row, fplane = H * W, splane = Hs * Ws;
  int n[kS2dPairs];  // s2d positions of pair m in the image; never grows with m
#pragma unroll
  for (int m = 0; m < kS2dPairs; ++m)
    n[m] = i < Hs ? max(0, min(2, Ws - j0 - pair_col(m, lane))) : 0;
  // full-res row 2i, column 2*j0
  const T* fb = flow + (int64_t)b * 2 * fplane + (i < Hs ? 2 * i * W + 2 * j0 : 0);
  // the flow of pair m in full-res row 2i + ry, columns 2*pair_col(m) .. +3
  // (read again for its taps: holding it costs occupancy)
  auto load_flow = [&](int ry, int m, Vec<T, 4>& fx, Vec<T, 4>& fy) {
    const T* f = fb + ry * W + 2 * pair_col(m, lane);
    fx = load_vec<4>(f, vec, 2 * n[m]);
    fy = load_vec<4>(f + fplane, vec, 2 * n[m]);
  };
  Extremes ext;
#pragma unroll
  for (int ry = 0; ry < 2; ++ry) {
#pragma unroll
    for (int m = 0; m < kS2dPairs; ++m) {
      Vec<T, 4> fx, fy;
      load_flow(ry, m, fx, fy);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (e < 2 * n[m])
          ext.add(grid_coord(lin_x[2 * pair_col(m, lane) + e], to_f32(fx.v[e]), norm_x),
                  grid_coord(lin_y[2 * row + ry], to_f32(fy.v[e]), norm_y));
    }
  }
  const Box fp = block_box(ext.box(H, W, 1), &box);

  const T* ib = img + (int64_t)b * 4 * C * splane;
  Source s;
  const bool staged = fits_stage(fp, 4 * C, vec16, kS2dStageElems, &s);
  if (staged) {
    stage_footprint(stage, ib, 4 * C, splane, Ws, s, fp.r1 - fp.r0 + 1, vec16);
  } else {
    s = Source{0, 0, Ws, splane};
  }
  // The taps of pair m in full-res row 2i + ry, phase rx: t[rx][e] for its
  // position e (past the edge: position 0's, never stored). Full-res tap
  // (yy, xx) lies in phase plane ((yy&1)*2 + (xx&1))*C at (yy/2, xx/2).
  const int xphase = C * s.cstride, yphase = 2 * C * s.cstride;
  auto quad_taps = [&](int ry, int m, Taps4 (&t)[2][2]) {
    Vec<T, 4> qx, qy;
    load_flow(ry, m, qx, qy);
#pragma unroll
    for (int rx = 0; rx < 2; ++rx) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = e < n[m];
        const int px = (in ? 2 * e : 0) + rx;  // full-res pixel of the quad
        const float ux = to_f32(in ? qx.v[2 * e + rx] : qx.v[rx]);
        const float uy = to_f32(in ? qy.v[2 * e + rx] : qy.v[rx]);
        const Tap a = border_tap(grid_coord(lin_x[2 * pair_col(m, lane) + px], ux, norm_x), W);
        const Tap c = border_tap(grid_coord(lin_y[2 * row + ry], uy, norm_y), H);
        const int x0 = (a.i0 & 1) * xphase + (a.i0 >> 1) - s.c0;
        const int x1 = (a.i1 & 1) * xphase + (a.i1 >> 1) - s.c0;
        const int y0 = (c.i0 & 1) * yphase + ((c.i0 >> 1) - s.r0) * s.pitch;
        const int y1 = (c.i1 & 1) * yphase + ((c.i1 >> 1) - s.r0) * s.pitch;
        t[rx][e] = Taps4{y0 + x0, y0 + x1, y1 + x0, y1 + x1, a.t, c.t};
      }
    }
  };
  Taps4 first[2][2];
  quad_taps(0, 0, first);
  if (staged) {
    cp_async_wait_all();
    __syncthreads();
  }
  if (n[0] == 0) return;  // no output of this thread in the image
  T* ob = out + (int64_t)b * 4 * C * splane + i * Ws + j0;
  auto gather = [&](const T* src) {  // inlined at each call: shared or global loads
#pragma unroll
    for (int ry = 0; ry < 2; ++ry) {
#pragma unroll
      for (int m = 0; m < kS2dPairs; ++m) {
        if (n[m] == 0) break;
        Taps4 t[2][2];
        if (ry == 0 && m == 0) {
#pragma unroll
          for (int rx = 0; rx < 2; ++rx) t[rx][0] = first[rx][0], t[rx][1] = first[rx][1];
        } else {
          quad_taps(ry, m, t);
        }
#pragma unroll
        for (int rx = 0; rx < 2; ++rx) {
          T* oc = ob + (ry * 2 + rx) * C * splane + pair_col(m, lane);
          lerp_pair(src, s.cstride, t[rx], C, oc, splane, vec, n[m]);
        }
      }
    }
  };
  if (staged) {
    gather(stage);
  } else {
    gather(ib);
  }
}

// Replaces pallas_pixel_warp (fastvideocodec_tpu/ops/pallas/warp_kernel.py:577),
// the SSF-TPU half-resolution blurred-stack sample and the volume warp of
// stock SSF, ELFVC and MCVC. img [B,C,H,W] (float32 or bfloat16), flow
// [B,2,H,W] float32 pixel displacements, out [B,C,H,W]. One thread per
// output pixel computes its coordinate once and loops over the C
// channels. Bound by bytes: on the SSF-TPU path (C = 15 in bf16 at
// 512x1024, flow f32) 35.7 MB a launch, ~0.16 ms per GOP at 3.35 TB/s.
template <typename T>
__global__ void pixel_warp_kernel(const T* __restrict__ img, const float* __restrict__ flow,
                                  T* __restrict__ out, int B, int C, int H, int W) {
  int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t plane = (int64_t)H * W;
  if (p >= (int64_t)B * plane) return;
  int64_t b = p / plane;
  int64_t yx = p - b * plane;
  int y = (int)(yx / W), x = (int)(yx - (int64_t)y * W);
  const float* fb = flow + b * 2 * plane;
  Tap tx = pixel_tap(fb[yx], x, W);
  Tap ty = pixel_tap(fb[plane + yx], y, H);
  lerp_planes(img + b * C * plane, out + b * C * plane + yx, C, plane, W, tx, ty);
}

// Replaces pallas_pixel_warp_s2d_sflow (warp_kernel.py:673, kPhaseFlow) and
// pallas_pixel_warp_s2d (warp_kernel.py:618, !kPhaseFlow): the SSF-TPU
// level-0 sample. img [B,4C,Hs,Ws] is a full-res [B,C,2Hs,2Ws] image in
// s2d form, channel (ry*2 + rx)*C + c; out has its form. The float32 pixel
// flow is either in c-major s2d phase form [B,8,Hs,Ws], channel
// comp*4 + 2*ry + rx (kPhaseFlow: the JAX code's order, whatever the
// docstring of pallas_pixel_warp_s2d_sflow says), or full-res [B,2,2Hs,2Ws].
// One thread per s2d position reads its four flow phases at the same
// (i, j) (coalesced in the phase form), and for each phase gathers the
// four taps straight from their phase planes and writes all C channels:
// nothing full-res is materialized. Bound by bytes: on the SSF-TPU path
// (C = 3 in bf16 at 1024x2048, phase flow f32) 42.0 MB a launch, ~0.19 ms
// per GOP at 3.35 TB/s.
template <typename T, bool kPhaseFlow>
__global__ void pixel_warp_s2d_kernel(const T* __restrict__ img,
                                      const float* __restrict__ flow, T* __restrict__ out,
                                      int B, int C, int Hs, int Ws) {
  int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t splane = (int64_t)Hs * Ws;
  if (p >= (int64_t)B * splane) return;
  int64_t b = p / splane;
  int64_t ij = p - b * splane;
  int i = (int)(ij / Ws), j = (int)(ij - (int64_t)i * Ws);
  int H = 2 * Hs, W = 2 * Ws;
  const T* ib = img + b * 4 * C * splane;
  T* ob = out + b * 4 * C * splane + ij;
  for (int ry = 0; ry < 2; ++ry) {
    for (int rx = 0; rx < 2; ++rx) {
      int y = 2 * i + ry, x = 2 * j + rx;
      float fx, fy;
      if (kPhaseFlow) {
        const float* fb = flow + b * 8 * splane + ij;
        fx = fb[(int64_t)(ry * 2 + rx) * splane];
        fy = fb[(int64_t)(4 + ry * 2 + rx) * splane];
      } else {
        int64_t fplane = (int64_t)H * W;
        const float* fb = flow + b * 2 * fplane + (int64_t)y * W + x;
        fx = fb[0];
        fy = fb[fplane];
      }
      Tap tx = pixel_tap(fx, x, W);
      Tap ty = pixel_tap(fy, y, H);
      lerp_s2d(ib, ob + (int64_t)(ry * 2 + rx) * C * splane, C, splane, Ws, tx, ty);
    }
  }
}

constexpr int kThreads = 256;

inline unsigned blocks_for(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

inline bool aligned(const void* p, int bytes) { return (uintptr_t)p % bytes == 0; }

template <typename T>
int launch_flow_warp(const void* img, const void* flow, void* out, int B, int C, int H, int W,
                     float norm_x, float norm_y, cudaStream_t s) {
  constexpr int kPair = 2 * sizeof(T);
  int flags = 0;
  if (W % 2 == 0 && aligned(img, kPair) && aligned(flow, kPair) && aligned(out, kPair))
    flags |= kVecPairs;
  dim3 grid((W + kFwCols - 1) / kFwCols, (H + kFwRows - 1) / kFwRows, B);
  flow_warp_kernel<T><<<grid, kFwThreads, 0, s>>>(
      (const T*)img, (const T*)flow, (T*)out, C, H, W, norm_x, norm_y, flags);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_flow_warp_s2d(const void* img, const void* flow, void* out, int B, int C, int Hs,
                         int Ws, float norm_x, float norm_y, cudaStream_t s) {
  // The stage's dynamic shared memory (above 48 KB with the static only
  // after this opt-in, which holds for the current device alone: so at
  // every launch).
  constexpr int kBytes = kS2dStageElems * sizeof(T);
  const cudaError_t allowed = cudaFuncSetAttribute(
      flow_warp_s2d_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (allowed != cudaSuccess) return (int)allowed;
  constexpr int kPair = 2 * sizeof(T);
  int flags = 0;
  if (Ws % 2 == 0 && aligned(img, kPair) && aligned(flow, 2 * kPair) && aligned(out, kPair))
    flags |= kVecPairs;
  if (Ws % kAlign == 0 && aligned(img, 16)) flags |= kVec16;
  dim3 grid((Ws + kS2dCols - 1) / kS2dCols, (Hs + kS2dRows - 1) / kS2dRows, B);
  flow_warp_s2d_kernel<T><<<grid, kS2dThreads, kBytes, s>>>(
      (const T*)img, (const T*)flow, (T*)out, C, Hs, Ws, norm_x, norm_y, flags);
  return (int)cudaGetLastError();
}

// The tiled kernels index one image of the batch in 32 bits.
inline bool fits_int32(int64_t elements) { return elements < (int64_t)INT_MAX; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int fvc_flow_warp(const void* img, const void* flow, void* out, int B, int C,
                             int H, int W, float norm_x, float norm_y, int dtype,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || B > 65535 || !fits_int32((int64_t)max(C, 2) * H * W))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_flow_warp<float>(img, flow, out, B, C, H, W, norm_x, norm_y, s);
  if (dtype == 1) {
    return launch_flow_warp<__nv_bfloat16>(img, flow, out, B, C, H, W, norm_x, norm_y, s);
  }
  return (int)cudaErrorInvalidValue;
}

// img/out [B,4C,Hs,Ws], flow [B,2,2Hs,2Ws]; C is the full-res channel count.
extern "C" int fvc_flow_warp_s2d(const void* img, const void* flow, void* out, int B,
                                 int C, int Hs, int Ws, float norm_x, float norm_y,
                                 int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || B > 65535 || !fits_int32((int64_t)max(4 * C, 8) * Hs * Ws))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    return launch_flow_warp_s2d<float>(img, flow, out, B, C, Hs, Ws, norm_x, norm_y, s);
  }
  if (dtype == 1) {
    return launch_flow_warp_s2d<__nv_bfloat16>(img, flow, out, B, C, Hs, Ws, norm_x, norm_y,
                                               s);
  }
  return (int)cudaErrorInvalidValue;
}

// img/out [B,C,H,W] of dtype, flow [B,2,H,W] float32.
extern "C" int fvc_pixel_warp(const void* img, const void* flow, void* out, int B, int C,
                              int H, int W, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  unsigned grid = blocks_for((int64_t)B * H * W);
  if (dtype == 0) {
    pixel_warp_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)img, (const float*)flow, (float*)out, B, C, H, W);
  } else if (dtype == 1) {
    pixel_warp_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)img, (const float*)flow, (__nv_bfloat16*)out, B, C, H, W);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <bool kPhaseFlow>
static void launch_pixel_warp_s2d(const void* img, const void* flow, void* out, int B,
                                  int C, int Hs, int Ws, int dtype, cudaStream_t s) {
  unsigned grid = blocks_for((int64_t)B * Hs * Ws);
  if (dtype == 0) {
    pixel_warp_s2d_kernel<float, kPhaseFlow><<<grid, kThreads, 0, s>>>(
        (const float*)img, (const float*)flow, (float*)out, B, C, Hs, Ws);
  } else {
    pixel_warp_s2d_kernel<__nv_bfloat16, kPhaseFlow><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)img, (const float*)flow, (__nv_bfloat16*)out, B, C, Hs, Ws);
  }
}

// img/out [B,4C,Hs,Ws] of dtype; flow float32, [B,8,Hs,Ws] in c-major phase
// form when phase_flow is 1, else full-res [B,2,2Hs,2Ws]. C is the
// full-res channel count.
extern "C" int fvc_pixel_warp_s2d(const void* img, const void* flow, void* out, int B,
                                  int C, int Hs, int Ws, int phase_flow, int dtype,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (phase_flow) {
    launch_pixel_warp_s2d<true>(img, flow, out, B, C, Hs, Ws, dtype, s);
  } else {
    launch_pixel_warp_s2d<false>(img, flow, out, B, C, Hs, Ws, dtype, s);
  }
  return (int)cudaGetLastError();
}
