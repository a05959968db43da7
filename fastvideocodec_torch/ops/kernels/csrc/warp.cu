// Bilinear backward warp with border clamp, for sm_90a (H100).
//
// Three kernels, five entry points. The sample coordinate is built in
// float32 exactly as the exact path builds it, in one of two conventions:
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
// PyTorch version's bit for bit. A NaN flow gives NaN at its output pixel
// in every channel, as the plain version does.
//
// There is no displacement bound: the TPU kernel's clamp to R pixels and
// its +-11-row window were limits of the TPU's VMEM halo, not semantics.
//
// All are bound by bytes: a few flops per byte moved. All are tiled: a
// block owns a tile of outputs, a warp one row of it and a thread pairs of
// neighbouring outputs. One s2d body (warp_s2d_kernel) serves the
// normalized-grid s2d warp and the two pixel s2d entry points; only the
// grid warp stages the tile's source footprint in shared memory when it
// fits, the others gather from global memory through L1. The pixel-convention kernels take a float32 flow with a float32 or
// bfloat16 image: a bfloat16 flow would be pixels coarse at 2048 wide.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

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
// g never gives a smaller i0 or i1. A NaN g (a NaN flow) reads index 0
// with a NaN weight, so the lerp gives NaN, as the plain version's clamp
// does; fmaxf alone would make it 0.
__device__ __forceinline__ Tap border_tap(float g, int n) {
  const float u = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(g, 1.0f), (float)n), 1.0f), 0.5f);
  const float uc = fminf(fmaxf(u, 0.0f), (float)(n - 1));
  const float u0 = floorf(uc);
  Tap tap;
  tap.t = u == u ? __fsub_rn(uc, u0) : u;
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

// Pixel convention: source s = i + f along an axis of n, normalized as
// (2*s + 1)/n - 1. Monotone in s.
__device__ __forceinline__ float pixel_norm(float s, int n) {
  return __fsub_rn(__fdiv_rn(__fadd_rn(__fmul_rn(2.0f, s), 1.0f), (float)n), 1.0f);
}

__device__ __forceinline__ Tap pixel_tap(float f, int i, int n) {
  return border_tap(pixel_norm(__fadd_rn((float)i, f), n), n);
}

__device__ __forceinline__ float lerp2(float v00, float v01, float v10, float v11,
                                       float tx, float ty) {
  float sx = __fsub_rn(1.0f, tx), sy = __fsub_rn(1.0f, ty);
  float top = __fadd_rn(__fmul_rn(v00, sx), __fmul_rn(v01, tx));
  float bot = __fadd_rn(__fmul_rn(v10, sx), __fmul_rn(v11, tx));
  return __fadd_rn(__fmul_rn(top, sy), __fmul_rn(bot, ty));
}

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

// The same for exactly K channels, with all 8*K gathers issued before the
// first lerp: the loads a thread keeps in flight.
template <int K, typename T>
__device__ __forceinline__ void lerp_pair_chunk(const T* src, int cstride, const Taps4 (&t)[2],
                                                T* out, int ostride, bool vec, int n) {
  T v[K][2][4];
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const T* sc = src + c * cstride;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      v[c][e][0] = sc[t[e].o00];
      v[c][e][1] = sc[t[e].o01];
      v[c][e][2] = sc[t[e].o10];
      v[c][e][3] = sc[t[e].o11];
    }
  }
#pragma unroll
  for (int c = 0; c < K; ++c) {
    float r[2];
#pragma unroll
    for (int e = 0; e < 2; ++e)
      r[e] = lerp2(to_f32(v[c][e][0]), to_f32(v[c][e][1]), to_f32(v[c][e][2]),
                   to_f32(v[c][e][3]), t[e].wx, t[e].wy);
    store_pair(out + c * ostride, vec, n, r[0], r[1]);
  }
}

// Extreme coordinates of a thread's pixels, and the footprint box of their
// taps: border_tap is monotone, so the taps of the extremes bound all.
struct Extremes {
  float x_lo = FLT_MAX, x_hi = -FLT_MAX, y_lo = FLT_MAX, y_hi = -FLT_MAX;

  __device__ __forceinline__ void add(float gx, float gy) {
    // a NaN coordinate (a NaN flow) samples index 0 (with a NaN weight),
    // where border_tap's fmaxf clamps it; fminf would drop it, so count it
    // as the lowest
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

// ---------------------------------------------------------------------------
// The NCHW warps
// ---------------------------------------------------------------------------

constexpr int kFwPairs = 4;                  // pairs of outputs a thread owns
constexpr int kFwCols = kPairCols * kFwPairs;  // 256 columns a warp covers
constexpr int kFwRows = 8;                   // warps of a block, one output row each
constexpr int kFwThreads = 32 * kFwRows;     // 256: a tile of kFwRows x kFwCols outputs

// Replaces pallas_flow_warp (fastvideocodec_tpu/ops/pallas/warp_kernel.py:502),
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
//   footprint in shared memory, as warp_s2d_kernel does, measured slower
//   here on the path's flows and on random ones (warp_ab.py, PERF.md).
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

constexpr int kPwRows = 8;                 // warps of a block, one output row each
constexpr int kPwThreads = 32 * kPwRows;   // 256: a tile of kPwRows x kPairCols outputs
constexpr int kPwChunk = 3;                // channels whose gathers a thread issues together

// Replaces pallas_pixel_warp (fastvideocodec_tpu/ops/pallas/warp_kernel.py:577),
// the SSF-TPU half-resolution blurred-stack sample and the volume warp of
// stock SSF, ELFVC and MCVC. img [B,C,H,W] (float32 or bfloat16), flow
// [B,2,H,W] float32 pixel displacements, out [B,C,H,W].
//
// Bound by bytes: on the SSF-TPU path (C = 15 in bf16 at 512x1024, flow
// f32) 35.7 MB a launch, ~0.16 ms per GOP at 3.35 TB/s. flow_warp_kernel's
// tiling, with what the many channels change:
// - a thread owns one pair of neighbouring outputs (a tile of kPwRows x
//   kPairCols): with 15 channels a pair is 120 gathers, and a thread of
//   several pairs would leave too few blocks to fill the card at 512x1024;
// - the pair's coordinates and taps are computed once (one f32 pair load
//   per flow component) and serve every channel;
// - the channels go kPwChunk at a time, all their gathers issued before
//   their lerps (lerp_pair_chunk), then the remainder one by one: the
//   loads in flight are the lever, and holding more costs occupancy (one
//   channel at a time was 17% slower on the path; five at a time, at 75
//   registers, as fast on the path and 9% slower on random flows:
//   warp_ab.py, PERF.md);
// - each channel's output pair is one 2-element store;
// - no shared-memory stage: a tile's footprint over 15 planes would not
//   leave L1 room, and staging did not pay in flow_warp_kernel.
template <typename T>
__global__ void __launch_bounds__(kPwThreads)
pixel_warp_kernel(const T* __restrict__ img, const float* __restrict__ flow,
                  T* __restrict__ out, int C, int H, int W, int flags) {
  const int lane = threadIdx.x & 31, b = blockIdx.z;
  const int tx0 = blockIdx.x * kPairCols, y = blockIdx.y * kPwRows + (threadIdx.x >> 5);
  const int col = pair_col(0, lane), n = min(2, W - tx0 - col);
  if (y >= H || n <= 0) return;
  const bool vec = flags & kVecPairs;
  const int plane = H * W, pix = y * W + tx0 + col;  // the pair's first output
  const float* fb = flow + (int64_t)b * 2 * plane + pix;
  const Vec<float, 2> fx = load_vec<2>(fb, vec, n), fy = load_vec<2>(fb + plane, vec, n);
  // the taps of the pair; past the edge the pair's first output's, never stored
  Taps4 t[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const bool in = e < n;
    const Tap a = pixel_tap(in ? fx.v[e] : fx.v[0], tx0 + col + (in ? e : 0), W);
    const Tap c = pixel_tap(in ? fy.v[e] : fy.v[0], y, H);
    const int r0 = c.i0 * W, r1 = c.i1 * W;
    t[e] = Taps4{r0 + a.i0, r0 + a.i1, r1 + a.i0, r1 + a.i1, a.t, c.t};
  }
  const T* ib = img + (int64_t)b * C * plane;
  T* ob = out + (int64_t)b * C * plane + pix;
  int c = 0;
  for (; c + kPwChunk <= C; c += kPwChunk)
    lerp_pair_chunk<kPwChunk>(ib + c * plane, plane, t, ob + c * plane, plane, vec, n);
  for (; c < C; ++c) lerp_pair_chunk<1>(ib + c * plane, plane, t, ob + c * plane, plane, vec, n);
}

// ---------------------------------------------------------------------------
// The s2d warps
// ---------------------------------------------------------------------------

// The tile and the budget in plain numbers: ops/warp.py:staged_tiles reads
// them (and kAlign) from this file.
constexpr int kS2dCols = 128;                   // s2d columns a warp covers
constexpr int kS2dRows = 8;                     // warps of a block, one s2d row each
constexpr int kS2dStageElems = 20480;           // footprint budget: 40 KB of bf16, 80 KB of f32
constexpr int kS2dPairs = kS2dCols / kPairCols;  // 2 pairs of s2d positions a thread owns
constexpr int kS2dThreads = 32 * kS2dRows;      // 256: a tile of kS2dRows x kS2dCols positions
constexpr int kS2dBlocksPerSM = 4;  // bf16: 4 x 40 KB of shared memory, <= 64 registers

// The flow of an s2d warp and the convention of its coordinates.
enum S2dFlow {
  kGridFlow,   // full-res [B,2,H,W] of the image's type, normalized grid: flow_warp_s2d
  kPixelFlow,  // full-res [B,2,H,W] float32, pixel convention: pixel_warp_s2d
  kPhaseFlow,  // c-major s2d phase form [B,8,Hs,Ws] float32, pixel convention: the sflow
};

template <typename T, int kFlow>
using FlowT = typename std::conditional<kFlow == kGridFlow, T, float>::type;

// Replaces pallas_flow_warp_s2d (fastvideocodec_tpu/ops/pallas/warp_kernel.py:548,
// kGridFlow), the LSVC-TPU motion-compensation warp, and the SSF-TPU level-0
// sample pallas_pixel_warp_s2d_sflow (:673, kPhaseFlow) with its full-res
// flow sibling pallas_pixel_warp_s2d (:618, kPixelFlow). img [B,4C,Hs,Ws]
// is a full-res [B,C,2Hs,2Ws] image in space-to-depth form, channel
// (ry*2 + rx)*C + c; out has img's s2d form. The flow is full-res
// [B,2,2Hs,2Ws], or in c-major phase form [B,8,Hs,Ws] with channel
// comp*4 + 2*ry + rx (the JAX code's order, whatever the docstring of
// pallas_pixel_warp_s2d_sflow says). Full-res source pixel (y, x) is read
// from s2d channel ((y%2)*2 + x%2)*C + c at (y/2, x/2), so the
// depth-to-space / space-to-depth round trip folds into the loads and
// stores and nothing full-res is materialized.
//
// Bound by bytes: ~33.6 MB per 1024x2048 frame in bf16 for the grid warp
// (image, flow, output), ~0.15 ms per GOP at 3.35 TB/s; 42.0 MB a launch
// for the SSF-TPU level-0 sample (f32 phase flow), ~0.19 ms per GOP. The
// tiling, as in flow_warp_kernel, plus a shared-memory stage:
// - grid (column tiles, row tiles, B) over s2d positions; a block owns
//   kS2dRows x kS2dCols of them, a warp one s2d row and a thread
//   kS2dPairs pairs of neighbouring positions (2 x 4 full-res pixels
//   each); 32-bit indexing;
// - for the grid, the linspace values of the tile's 2*kS2dCols full-res
//   columns and 2*kS2dRows rows once per block in shared memory;
// - the flow of a pair is read as one 4-element vector per full-res row
//   and component (both rows: no stride-2 waste), or in phase form as one
//   2-element vector per phase plane; each output phase plane's pair is
//   written as one 2-element vector;
// - the grid warp's stage: a first pass over the flow reduces
//   the tile's extreme coordinates to the box of its taps in s2d rows and
//   columns (exact: the taps are border-clamped and monotone); if the 4C
//   phase planes of it fit kS2dStageElems the block copies them into
//   shared memory with 16-byte cp.async, overlapped with computing the
//   first taps, so the phase planes a warp's taps alternate between are
//   read from shared memory; a larger footprint (large or scattered
//   flows) gathers from global memory in the same kernel, so there is no
//   displacement limit; on the LSVC path's flows staging beat gathering
//   every tile from global memory, unlike in flow_warp_kernel (warp_ab.py,
//   PERF.md); the pixel warps do not stage: their stage measured slower on
//   every flow (smooth, the SSF-TPU path's noisy ones, random), its first
//   pass and its registers (spills at the cap) costing more than it saved;
// - the second pass reads each pair's flow again (from L1) and computes
//   its taps just before its gathers: holding them all cost more
//   occupancy than the reads;
// - occupancy: kS2dBlocksPerSM blocks of 256 threads an SM (registers
//   capped at 64) and a budget that leaves the L1 cache room: with 48 KB
//   a block, four blocks left the global path's gathers too little L1 and
//   random flows ran 24% slower than the plain gather of the first port.
template <typename T, int kFlow>
__global__ void __launch_bounds__(kS2dThreads, kS2dBlocksPerSM)
warp_s2d_kernel(const T* __restrict__ img, const FlowT<T, kFlow>* __restrict__ flow,
                T* __restrict__ out, int C, int Hs, int Ws, float norm_x, float norm_y,
                int flags) {
  using F = FlowT<T, kFlow>;
  constexpr bool kGrid = kFlow == kGridFlow;  // the grid warp alone stages
  extern __shared__ __align__(16) unsigned char stage_bytes[];
  T* stage = reinterpret_cast<T*>(stage_bytes);
  __shared__ float lin_x[kGrid ? 2 * kS2dCols : 1], lin_y[kGrid ? 2 * kS2dRows : 1];
  __shared__ Box box;

  const int tid = threadIdx.x, lane = tid & 31, row = tid >> 5, b = blockIdx.z;
  const int H = 2 * Hs, W = 2 * Ws;
  const int j0 = blockIdx.x * kS2dCols, i0 = blockIdx.y * kS2dRows;
  if constexpr (kGrid) {
    for (int t = tid; t < 2 * kS2dCols; t += kS2dThreads) lin_x[t] = linspace_at(2 * j0 + t, W);
    if (tid < 2 * kS2dRows) lin_y[tid] = linspace_at(2 * i0 + tid, H);
    if (tid == 0) empty_box(&box);
    __syncthreads();
  }

  // The coordinate of the tile's full-res column x (row y) displaced by f
  // (the grid's normalized one, the pixel convention's source i + f), and
  // the taps of such a coordinate along an axis of n.
  auto coord_x = [&](int x, float f) {
    if constexpr (kGrid) {
      return grid_coord(lin_x[x], f, norm_x);
    } else {
      return __fadd_rn((float)(2 * j0 + x), f);
    }
  };
  auto coord_y = [&](int y, float f) {
    if constexpr (kGrid) {
      return grid_coord(lin_y[y], f, norm_y);
    } else {
      return __fadd_rn((float)(2 * i0 + y), f);
    }
  };
  auto axis_tap = [&](float s, int n) {
    if constexpr (kGrid) {
      return border_tap(s, n);
    } else {
      return border_tap(pixel_norm(s, n), n);
    }
  };

  const bool vec = flags & kVecPairs, vec16 = flags & kVec16;
  const int i = i0 + row, fplane = H * W, splane = Hs * Ws;
  int n[kS2dPairs];  // s2d positions of pair m in the image; never grows with m
#pragma unroll
  for (int m = 0; m < kS2dPairs; ++m)
    n[m] = i < Hs ? max(0, min(2, Ws - j0 - pair_col(m, lane))) : 0;
  // full-res row 2i, column 2*j0; in phase form s2d row i, column j0
  const F* fb;
  if constexpr (kFlow == kPhaseFlow) {
    fb = flow + (int64_t)b * 8 * splane + (i < Hs ? i * Ws + j0 : 0);
  } else {
    fb = flow + (int64_t)b * 2 * fplane + (i < Hs ? 2 * i * W + 2 * j0 : 0);
  }
  // the flow of pair m in full-res row 2i + ry: element 2e + rx of fx and fy
  // is full-res column 2*(pair_col(m) + e) + rx of the tile (read again
  // for its taps: holding it costs occupancy)
  auto load_flow = [&](int ry, int m, Vec<F, 4>& fx, Vec<F, 4>& fy) {
    if constexpr (kFlow == kPhaseFlow) {
      // phase plane comp*4 + 2*ry + rx of q = comp*2 + rx
      const F* f = fb + 2 * ry * splane + pair_col(m, lane);
      Vec<F, 2> p[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        p[q] = load_vec<2>(f + ((q >> 1) * 4 + (q & 1)) * splane, vec, n[m]);
#pragma unroll
      for (int k = 0; k < 4; ++k) fx.v[k] = p[k & 1].v[k >> 1], fy.v[k] = p[2 + (k & 1)].v[k >> 1];
    } else {
      const F* f = fb + ry * W + 2 * pair_col(m, lane);
      fx = load_vec<4>(f, vec, 2 * n[m]);
      fy = load_vec<4>(f + fplane, vec, 2 * n[m]);
    }
  };

  const T* ib = img + (int64_t)b * 4 * C * splane;
  Source s{0, 0, Ws, splane};
  bool staged = false;
  if constexpr (kGrid) {
    Extremes ext;
#pragma unroll
    for (int ry = 0; ry < 2; ++ry) {
#pragma unroll
      for (int m = 0; m < kS2dPairs; ++m) {
        Vec<F, 4> fx, fy;
        load_flow(ry, m, fx, fy);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (e < 2 * n[m])
            ext.add(coord_x(2 * pair_col(m, lane) + e, to_f32(fx.v[e])),
                    coord_y(2 * row + ry, to_f32(fy.v[e])));
      }
    }
    const Box fp = block_box(ext.box(H, W, 1), &box);
    staged = fits_stage(fp, 4 * C, vec16, kS2dStageElems, &s);
    if (staged) {
      stage_footprint(stage, ib, 4 * C, splane, Ws, s, fp.r1 - fp.r0 + 1, vec16);
    } else {
      s = Source{0, 0, Ws, splane};
    }
  }
  // The taps of pair m in full-res row 2i + ry, phase rx: t[rx][e] for its
  // position e (past the edge: position 0's, never stored). Full-res tap
  // (yy, xx) lies in phase plane ((yy&1)*2 + (xx&1))*C at (yy/2, xx/2).
  const int xphase = C * s.cstride, yphase = 2 * C * s.cstride;
  auto quad_taps = [&](int ry, int m, Taps4 (&t)[2][2]) {
    Vec<F, 4> qx, qy;
    load_flow(ry, m, qx, qy);
#pragma unroll
    for (int rx = 0; rx < 2; ++rx) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = e < n[m];
        const int px = (in ? 2 * e : 0) + rx;  // full-res pixel of the quad
        const float ux = to_f32(in ? qx.v[2 * e + rx] : qx.v[rx]);
        const float uy = to_f32(in ? qy.v[2 * e + rx] : qy.v[rx]);
        const Tap a = axis_tap(coord_x(2 * pair_col(m, lane) + px, ux), W);
        const Tap c = axis_tap(coord_y(2 * row + ry, uy), H);
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
int launch_pixel_warp(const void* img, const void* flow, void* out, int B, int C, int H, int W,
                      cudaStream_t s) {
  constexpr int kPair = 2 * sizeof(T);
  int flags = 0;
  if (W % 2 == 0 && aligned(img, kPair) && aligned(flow, 8) && aligned(out, kPair))
    flags |= kVecPairs;
  dim3 grid((W + kPairCols - 1) / kPairCols, (H + kPwRows - 1) / kPwRows, B);
  pixel_warp_kernel<T><<<grid, kPwThreads, 0, s>>>(
      (const T*)img, (const float*)flow, (T*)out, C, H, W, flags);
  return (int)cudaGetLastError();
}

template <typename T, int kFlow>
int launch_warp_s2d(const void* img, const void* flow, void* out, int B, int C, int Hs, int Ws,
                    float norm_x, float norm_y, cudaStream_t s) {
  using F = FlowT<T, kFlow>;
  // The stage's dynamic shared memory (above 48 KB with the static only
  // after this opt-in, which holds for the current device alone: so at
  // every launch).
  constexpr int kBytes = kFlow == kGridFlow ? kS2dStageElems * sizeof(T) : 0;
  if constexpr (kBytes > 0) {
    const cudaError_t allowed = cudaFuncSetAttribute(
        warp_s2d_kernel<T, kFlow>, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (allowed != cudaSuccess) return (int)allowed;
  }
  constexpr int kPair = 2 * sizeof(T);
  constexpr int kFlowVec = (kFlow == kPhaseFlow ? 2 : 4) * sizeof(F);  // a pair's flow vector
  int flags = 0;
  if (Ws % 2 == 0 && aligned(img, kPair) && aligned(flow, kFlowVec) && aligned(out, kPair))
    flags |= kVecPairs;
  if (Ws % kAlign == 0 && aligned(img, 16)) flags |= kVec16;
  dim3 grid((Ws + kS2dCols - 1) / kS2dCols, (Hs + kS2dRows - 1) / kS2dRows, B);
  warp_s2d_kernel<T, kFlow><<<grid, kS2dThreads, kBytes, s>>>(
      (const T*)img, (const F*)flow, (T*)out, C, Hs, Ws, norm_x, norm_y, flags);
  return (int)cudaGetLastError();
}

// The kernels index one image of the batch in 32 bits.
inline bool fits_int32(int64_t elements) { return elements < (int64_t)INT_MAX; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns cudaGetLastError() after
// the launch (0 on success).

// img/out [B,C,H,W], flow [B,2,H,W], all of dtype.
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
    return launch_warp_s2d<float, kGridFlow>(img, flow, out, B, C, Hs, Ws, norm_x, norm_y, s);
  }
  if (dtype == 1) {
    return launch_warp_s2d<__nv_bfloat16, kGridFlow>(img, flow, out, B, C, Hs, Ws, norm_x,
                                                     norm_y, s);
  }
  return (int)cudaErrorInvalidValue;
}

// img/out [B,C,H,W] of dtype, flow [B,2,H,W] float32.
extern "C" int fvc_pixel_warp(const void* img, const void* flow, void* out, int B, int C,
                              int H, int W, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || B > 65535 || !fits_int32((int64_t)max(C, 2) * H * W))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_pixel_warp<float>(img, flow, out, B, C, H, W, s);
  if (dtype == 1) return launch_pixel_warp<__nv_bfloat16>(img, flow, out, B, C, H, W, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
static int launch_pixel_warp_s2d(const void* img, const void* flow, void* out, int B, int C,
                                 int Hs, int Ws, int phase_flow, cudaStream_t s) {
  if (phase_flow) {
    return launch_warp_s2d<T, kPhaseFlow>(img, flow, out, B, C, Hs, Ws, 0.0f, 0.0f, s);
  }
  return launch_warp_s2d<T, kPixelFlow>(img, flow, out, B, C, Hs, Ws, 0.0f, 0.0f, s);
}

// img/out [B,4C,Hs,Ws] of dtype; flow float32, [B,8,Hs,Ws] in c-major phase
// form when phase_flow is 1, else full-res [B,2,2Hs,2Ws]. C is the
// full-res channel count.
extern "C" int fvc_pixel_warp_s2d(const void* img, const void* flow, void* out, int B,
                                  int C, int Hs, int Ws, int phase_flow, int dtype,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || B > 65535 || !fits_int32((int64_t)max(4 * C, 8) * Hs * Ws))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_pixel_warp_s2d<float>(img, flow, out, B, C, Hs, Ws, phase_flow, s);
  if (dtype == 1) {
    return launch_pixel_warp_s2d<__nv_bfloat16>(img, flow, out, B, C, Hs, Ws, phase_flow, s);
  }
  return (int)cudaErrorInvalidValue;
}
