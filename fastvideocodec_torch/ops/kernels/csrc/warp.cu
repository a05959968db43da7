// Bilinear backward warp with border clamp, for sm_90a (H100).
//
// Three kernels, five entry points, and the backward of each entry point
// (flow_warp_backward_kernel for the two normalized-grid warps,
// pixel_warp_backward_kernel for the three pixel warps, after the s2d
// warps). pair_warp_kernel serves flow_warp at every shape and pixel_warp
// on the frames that would leave pixel_warp_kernel's grid idle
// (kTiledMinThreads).
// The sample coordinate is built in float32 exactly as the exact path
// builds it, in one of two conventions:
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

constexpr int kPwRows = 8;                 // warps of a block, one output row each
constexpr int kPwThreads = 32 * kPwRows;   // 256: a tile of kPwRows x kPairCols outputs
constexpr int kPwChunk = 3;                // channels whose gathers a thread issues together

// Replaces pallas_pixel_warp (fastvideocodec_tpu/ops/pallas/warp_kernel.py:577),
// the SSF-TPU half-resolution blurred-stack sample and the volume warp of
// stock SSF, ELFVC and MCVC. img [B,C,H,W] (float32 or bfloat16), flow
// [B,2,H,W] float32 pixel displacements, out [B,C,H,W].
//
// Bound by bytes: on the SSF-TPU path (C = 15 in bf16 at 512x1024, flow
// f32) 35.7 MB a launch, ~0.16 ms per GOP at 3.35 TB/s. The tiling:
// - grid (column tiles, row tiles, B): a block owns kPwRows x kPairCols
//   outputs, a warp one row of them and a thread one pair of neighbouring
//   outputs: with 15 channels a pair is 120 gathers, and a thread of
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
//   leave L1 room, and staging lost in the grid warps too.
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

// pixel_warp's plan rule, in plain numbers that
// ops/kernels/warp.py:pixel_warp_plan reads from this file: a launch keeps
// pixel_warp_kernel above when its grid holds at least kTiledMinThreads
// threads, and takes pair_warp_kernel below otherwise, where that
// kernel's grid fits. The threshold lies between the measured sides
// (warp_ab.py, PERF.md): the training steps' 1 x 15 x 128x128 and 1 x 18 x
// 256x256 (8K and 32K tiled threads) take 0.59 and 0.74 of the tiled
// kernel's device time in pair_warp_kernel, which recomputes its taps for
// each channel group; MCVC's 4 x 18 x 256x256 (128K) takes 1.08, and every
// larger frame more.
constexpr int kTiledMinThreads = 65536;
constexpr int kPairRows = 2;       // warps of a pair_warp_kernel block, one output row each
constexpr int kPairFewChunk = 3;   // channels of a thread when C <= kPairFewChunk (SpyNet's 3)
constexpr int kPairManyChunk = 6;  // channels of a thread's group when C is larger
constexpr int kGridYZ = 65535;     // CUDA's limit on gridDim.y and gridDim.z
constexpr int kPairThreads = 32 * kPairRows;  // 64: a tile of kPairRows x kPairCols outputs

// The same gathers and lerps as lerp_pair_chunk<K>, for the first nc (1..K)
// of K channels: every load is issued (predicated) before the first lerp.
template <int K, typename T>
__device__ __forceinline__ void lerp_pair_upto(const T* src, int cstride, const Taps4 (&t)[2],
                                               int nc, T* out, int ostride, bool vec, int n) {
  T v[K][2][4];
#pragma unroll
  for (int c = 0; c < K; ++c) {
    if (c < nc) {
      const T* sc = src + c * cstride;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        v[c][e][0] = sc[t[e].o00];
        v[c][e][1] = sc[t[e].o01];
        v[c][e][2] = sc[t[e].o10];
        v[c][e][3] = sc[t[e].o11];
      }
    }
  }
#pragma unroll
  for (int c = 0; c < K; ++c) {
    if (c < nc) {
      float r[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        r[e] = lerp2(to_f32(v[c][e][0]), to_f32(v[c][e][1]), to_f32(v[c][e][2]),
                     to_f32(v[c][e][3]), t[e].wx, t[e].wy);
      store_pair(out + c * ostride, vec, n, r[0], r[1]);
    }
  }
}

// Replaces pallas_flow_warp (fastvideocodec_tpu/ops/pallas/warp_kernel.py:502)
// at every shape (kPixel false: the normalized grid, a flow of the image's
// type): SpyNet's level warp, the DVC family's MC warp, LSVC-128's and
// -RW's (C = 12) MC warps; and pixel_warp (kPixel true: pixel offsets, a
// float32 flow) on the frames where pixel_warp_kernel's grid would leave
// the card idle (pixel_warp_plan). img [B,C,H,W], flow [B,2,H,W], out
// [B,C,H,W].
//
// Bound by bytes (C = 3 at 1024x2048 in bf16: 33.6 MB a launch), but on
// the small frames of DVC's SpyNet (1 x 3 x 128x256 .. 512x1024) latency
// sets the time: a tiled kernel of 8 x 256 outputs a block gave 16 to 256
// blocks on 132 SMs, each thread waiting on a dozen dependent round trips
// to L2 or HBM. Here a thread owns one pair of neighbouring outputs and a
// group of K channels of them:
// - grid (column tiles of kPairCols, row tiles of kPairRows, B x channel
//   groups): blocks of 64 threads, so 1 x 3 x 128x256 gives 256 blocks and
//   every SM holds up to 32 of them; K = kPairFewChunk (3) for C <= 3,
//   else kPairManyChunk (6). Groups of 3 at 18 channels, of 6 at 3, of 9
//   at 18, blocks of 4 rows, an L2 prefetch of the output's own rows
//   before the flow load, and gathering a smooth pair's taps as two runs
//   of three (pair vectors: 4 loads a channel in place of 8) all measured
//   slower on the path's inputs, or no faster (warp_ab.py, PERF.md);
// - one round trip for the flow pair (a 2-element vector), then every one
//   of the group's 8K gathers issued before the first lerp
//   (lerp_pair_upto), then the stores: two dependent round trips;
// - the taps are recomputed for each channel group (about 40 flops and
//   the flow pair, which L2 holds, against 8 gathers a channel), and the
//   linspace values by each thread (no shared memory, no block barrier);
// - at full resolution the same design beat the 8 x 256 tile by 14-20% on
//   the path's flows and lost 11-18% on +-200 px random ones (warp_ab.py,
//   PERF.md): no codec's flow is random, so it serves every shape;
// - the same border_tap / grid_coord / pixel_tap arithmetic and lerp2 as
//   the other kernels: bit for bit the plain versions, NaN flows included.
template <typename T, typename F, bool kPixel, int K>
__global__ void __launch_bounds__(kPairThreads)
pair_warp_kernel(const T* __restrict__ img, const F* __restrict__ flow, T* __restrict__ out,
                 int C, int groups, int H, int W, float norm_x, float norm_y, int flags) {
  const int lane = threadIdx.x & 31;
  const int x = blockIdx.x * kPairCols + 2 * lane, n = min(2, W - x);
  const int y = blockIdx.y * kPairRows + (threadIdx.x >> 5);
  if (y >= H || n <= 0) return;
  const int b = blockIdx.z / groups, c0 = (blockIdx.z - b * groups) * K;
  const bool vec = flags & kVecPairs;
  const int plane = H * W, pix = y * W + x;  // the pair's first output
  const F* fb = flow + (int64_t)b * 2 * plane + pix;
  const Vec<F, 2> fx = load_vec<2>(fb, vec, n), fy = load_vec<2>(fb + plane, vec, n);
  // the taps of the pair; past the edge the pair's first output's, never stored
  Taps4 t[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const bool in = e < n;
    const int xe = x + (in ? e : 0);
    const float ux = to_f32(in ? fx.v[e] : fx.v[0]), uy = to_f32(in ? fy.v[e] : fy.v[0]);
    Tap a, c;
    if constexpr (kPixel) {
      a = pixel_tap(ux, xe, W);
      c = pixel_tap(uy, y, H);
    } else {
      a = border_tap(grid_coord(linspace_at(xe, W), ux, norm_x), W);
      c = border_tap(grid_coord(linspace_at(y, H), uy, norm_y), H);
    }
    const int r0 = c.i0 * W, r1 = c.i1 * W;
    t[e] = Taps4{r0 + a.i0, r0 + a.i1, r1 + a.i0, r1 + a.i1, a.t, c.t};
  }
  const int64_t base = ((int64_t)b * C + c0) * plane;
  lerp_pair_upto<K>(img + base, plane, t, min(K, C - c0), out + base + pix, plane, vec, n);
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

// ---------------------------------------------------------------------------
// The backward kernels
// ---------------------------------------------------------------------------

constexpr int kBwThreads = 256;  // a block: 256 consecutive full-res outputs of one image

// Where full-res pixel (y, x) of channel c lies in an NCHW plane stack, or
// in its s2d form [4C, H/2, W/2], channel (ry*2 + rx)*C + c at (y/2, x/2).
template <bool kS2d>
__device__ __forceinline__ int pixel_offset(int c, int y, int x, int C, int H, int W) {
  if constexpr (kS2d) {
    const int Ws = W >> 1;
    return ((((y & 1) * 2 + (x & 1)) * C + c) * (H >> 1) + (y >> 1)) * Ws + (x >> 1);
  } else {
    return (c * H + y) * W + x;
  }
}

// Whether the border clamp passes the gradient of an axis's coordinate
// u = ((g + 1)*n - 1)/2: u inside [0, n - 1], the bounds included, as
// torch's clamp backward passes it; a NaN u passes none.
__device__ __forceinline__ bool clamp_passes(float g, int n) {
  const float u = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(g, 1.0f), (float)n), 1.0f), 0.5f);
  return u >= 0.0f && u <= (float)(n - 1);
}

// The gradient of u back to its flow component in the normalized-grid
// convention (g = lin + f*norm): gu*0.5*n*norm where the clamp passes it,
// else 0, in the plain version's order.
__device__ __forceinline__ float flow_grad(float gu, float g, int n, float norm) {
  if (!clamp_passes(g, n)) return 0.0f;
  return __fmul_rn(__fmul_rn(__fmul_rn(gu, 0.5f), (float)n), norm);
}

// The same in the pixel convention (g = (2*(i + f) + 1)/n - 1):
// ((gu*0.5*n)/n)*2, the plain version's order and IEEE division (the
// round trip is not the identity in float32).
__device__ __forceinline__ float pixel_flow_grad(float gu, float g, int n) {
  if (!clamp_passes(g, n)) return 0.0f;
  return __fmul_rn(__fdiv_rn(__fmul_rn(__fmul_rn(gu, 0.5f), (float)n), (float)n), 2.0f);
}

// The channel loop of a backward, for full-res output pixel (y, x) of one
// image of the batch (ib, gb, gi at that image) with its taps a (along x)
// and t (along y): the sums over the C channels of the incoming gradient
// times the lerp's derivative by its x weight and by its y weight, in
// *gtx and *gty; and, when gi is given, g times each tap's weight added
// into that float32 buffer by atomicAdd (several outputs may read one
// source pixel).
template <typename T, bool kS2d>
__device__ __forceinline__ void backward_channels(const T* ib, const T* gb, float* gi, int C,
                                                  int H, int W, int y, int x, Tap a, Tap t,
                                                  float* gtx, float* gty) {
  const float sx = __fsub_rn(1.0f, a.t), sy = __fsub_rn(1.0f, t.t);
  const float w00 = __fmul_rn(sx, sy), w01 = __fmul_rn(a.t, sy);
  const float w10 = __fmul_rn(sx, t.t), w11 = __fmul_rn(a.t, t.t);
  float sum_x = 0.0f, sum_y = 0.0f;
  for (int c = 0; c < C; ++c) {
    const int o00 = pixel_offset<kS2d>(c, t.i0, a.i0, C, H, W);
    const int o01 = pixel_offset<kS2d>(c, t.i0, a.i1, C, H, W);
    const int o10 = pixel_offset<kS2d>(c, t.i1, a.i0, C, H, W);
    const int o11 = pixel_offset<kS2d>(c, t.i1, a.i1, C, H, W);
    const float g = to_f32(gb[pixel_offset<kS2d>(c, y, x, C, H, W)]);
    const float v00 = to_f32(ib[o00]), v01 = to_f32(ib[o01]);
    const float v10 = to_f32(ib[o10]), v11 = to_f32(ib[o11]);
    const float top = __fadd_rn(__fmul_rn(v00, sx), __fmul_rn(v01, a.t));
    const float bot = __fadd_rn(__fmul_rn(v10, sx), __fmul_rn(v11, a.t));
    const float dtx =
        __fadd_rn(__fmul_rn(__fsub_rn(v01, v00), sy), __fmul_rn(__fsub_rn(v11, v10), t.t));
    sum_x = __fadd_rn(sum_x, __fmul_rn(g, dtx));
    sum_y = __fadd_rn(sum_y, __fmul_rn(g, __fsub_rn(bot, top)));
    if (gi) {
      atomicAdd(gi + o00, __fmul_rn(g, w00));
      atomicAdd(gi + o01, __fmul_rn(g, w01));
      atomicAdd(gi + o10, __fmul_rn(g, w10));
      atomicAdd(gi + o11, __fmul_rn(g, w11));
    }
  }
  *gtx = sum_x;
  *gty = sum_y;
}

// Replaces the custom_vjp backwards _pfw_bwd and _pfws_bwd
// (fastvideocodec_tpu/ops/pallas/warp_kernel.py:522, :567), which take the
// vjp of the XLA exact path (no Pallas kernel): the vjp of
// plain_flow_warp (kS2d false; img [B,C,H,W]) and of plain_flow_warp_s2d
// (kS2d true; img [B,4C,H/2,W/2], the full-res image in s2d form), both by
// flow [B,2,H,W] of the image's type, for the incoming gradient grad of
// the output's shape. A thread owns one full-res output pixel: it rebuilds
// the forward's four taps (border_tap, the same float32 arithmetic), then
// over the C channels
// - sums the derivative of the lerp by its two weights, g*((v01 - v00)*(1
//   - ty) + (v11 - v10)*ty) and g*(bot - top), into the pixel's flow
//   gradient (times 0.5*n*2/(n-1) and the clamp's mask, per axis), which it
//   writes once, rounded to the flow's type: no atomics;
// - when grad_img is given, adds g times each tap's weight into that float32
//   buffer (zeroed by the caller) with atomicAdd: several outputs may read
//   one source pixel. The caller rounds it once to the image's type. The
//   order of the atomics changes from run to run, so grad_img is not
//   bit-reproducible; it agrees with the plain vjp to float32 rounding.
// grad_flow may be null (no flow gradient wanted).
//
// Bound by bytes: it reads the image, the flow and the incoming gradient
// once and writes the two gradients (the float32 image gradient by
// atomics in L2), a few dozen flops per pixel and channel. A simple kernel:
// consecutive threads own consecutive pixels of a row, so the flow, the
// incoming gradient and the smooth-flow taps coalesce.
template <typename T, bool kS2d>
__global__ void __launch_bounds__(kBwThreads)
flow_warp_backward_kernel(const T* __restrict__ img, const T* __restrict__ flow,
                          const T* __restrict__ grad, float* __restrict__ grad_img,
                          T* __restrict__ grad_flow, int C, int H, int W, float norm_x,
                          float norm_y) {
  const int plane = H * W, p = blockIdx.x * kBwThreads + threadIdx.x, b = blockIdx.y;
  if (p >= plane) return;
  const int y = p / W, x = p - y * W;
  const int64_t base = (int64_t)b * C * plane;  // one image of the batch, either layout
  const T* fb = flow + (int64_t)b * 2 * plane;
  const float gx = grid_coord(linspace_at(x, W), to_f32(fb[p]), norm_x);
  const float gy = grid_coord(linspace_at(y, H), to_f32(fb[plane + p]), norm_y);
  float gtx, gty;
  backward_channels<T, kS2d>(img + base, grad + base, grad_img ? grad_img + base : nullptr, C, H,
                             W, y, x, border_tap(gx, W), border_tap(gy, H), &gtx, &gty);
  if (grad_flow) {
    T* fo = grad_flow + (int64_t)b * 2 * plane;
    fo[p] = from_f32<T>(flow_grad(gtx, gx, W, norm_x));
    fo[plane + p] = from_f32<T>(flow_grad(gty, gy, H, norm_y));
  }
}

// The layouts of the pixel warps, for their backward.
enum PixelLayout {
  kPixelNchw,   // img [B,C,H,W], flow [B,2,H,W]: pixel_warp
  kPixelS2d,    // img [B,4C,H/2,W/2], flow full-res [B,2,H,W]: pixel_warp_s2d
  kPixelPhase,  // img [B,4C,H/2,W/2], flow c-major phase form [B,8,H/2,W/2]: the sflow
};

// Where flow component comp (0: x, 1: y) of full-res pixel (y, x) lies in
// one image's flow: [2,H,W], or in c-major phase form [8,H/2,W/2], channel
// comp*4 + 2*(y%2) + x%2 at (y/2, x/2) (the vjp of the phase form's
// unpacking to full resolution is this permutation).
template <int kLayout>
__device__ __forceinline__ int flow_offset(int comp, int y, int x, int H, int W) {
  if constexpr (kLayout == kPixelPhase) {
    return ((comp * 4 + (y & 1) * 2 + (x & 1)) * (H >> 1) + (y >> 1)) * (W >> 1) + (x >> 1);
  } else {
    return (comp * H + y) * W + x;
  }
}

// Replaces the custom_vjp backwards _ppw_bwd, _ppws_bwd and _ppwss_bwd
// (fastvideocodec_tpu/ops/pallas/warp_kernel.py:594, :642, :698), which
// take the vjp of the XLA exact path (no Pallas kernel): the vjp of
// plain_pixel_warp (kPixelNchw), plain_pixel_warp_s2d (kPixelS2d) and
// plain_pixel_warp_s2d_sflow (kPixelPhase), img of type T and a float32
// flow, for the incoming gradient grad of the output's shape (type T).
// As flow_warp_backward_kernel: a thread owns one full-res output pixel,
// rebuilds the forward's taps (pixel_tap's float32 arithmetic), sums the
// flow gradient over the C channels in registers and writes it once as
// float32 (in the flow's own layout: no atomics), and adds the image
// gradient into the zeroed float32 grad_img by atomicAdd only when it is
// given. grad_flow may be null (no flow gradient wanted); on the SSF and
// ELFVC training path grad_img is null (the warped image is built from a
// detached reference and holds no parameter), so that path allocates and
// zeroes nothing of the image's size.
//
// Bound by bytes as the forward is: the image's taps, the flow and the
// incoming gradient read once, the gradients written once.
template <typename T, int kLayout>
__global__ void __launch_bounds__(kBwThreads)
pixel_warp_backward_kernel(const T* __restrict__ img, const float* __restrict__ flow,
                           const T* __restrict__ grad, float* __restrict__ grad_img,
                           float* __restrict__ grad_flow, int C, int H, int W) {
  constexpr bool kS2d = kLayout != kPixelNchw;
  const int plane = H * W, p = blockIdx.x * kBwThreads + threadIdx.x, b = blockIdx.y;
  if (p >= plane) return;
  const int y = p / W, x = p - y * W;
  const int64_t base = (int64_t)b * C * plane;  // one image of the batch, either layout
  const int ox = flow_offset<kLayout>(0, y, x, H, W), oy = flow_offset<kLayout>(1, y, x, H, W);
  const float* fb = flow + (int64_t)b * 2 * plane;  // [2,H,W] or [8,H/2,W/2]: 2*plane either way
  const float gx = pixel_norm(__fadd_rn((float)x, fb[ox]), W);
  const float gy = pixel_norm(__fadd_rn((float)y, fb[oy]), H);
  float gtx, gty;
  backward_channels<T, kS2d>(img + base, grad + base, grad_img ? grad_img + base : nullptr, C, H,
                             W, y, x, border_tap(gx, W), border_tap(gy, H), &gtx, &gty);
  if (grad_flow) {
    float* fo = grad_flow + (int64_t)b * 2 * plane;
    fo[ox] = pixel_flow_grad(gtx, gx, W);
    fo[oy] = pixel_flow_grad(gty, gy, H);
  }
}

inline bool aligned(const void* p, int bytes) { return (uintptr_t)p % bytes == 0; }

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

template <typename T, typename F, bool kPixel, int K>
int launch_pair_warp_of(const void* img, const void* flow, void* out, int B, int C, int H,
                        int W, float norm_x, float norm_y, cudaStream_t s) {
  const int groups = (C + K - 1) / K, rows = (H + kPairRows - 1) / kPairRows;
  if (groups < 1 || (int64_t)B * groups > kGridYZ || rows > kGridYZ)
    return (int)cudaErrorInvalidValue;
  constexpr int kPair = 2 * sizeof(T);
  int flags = 0;
  if (W % 2 == 0 && aligned(img, kPair) && aligned(flow, 2 * sizeof(F)) && aligned(out, kPair))
    flags |= kVecPairs;
  dim3 grid((W + kPairCols - 1) / kPairCols, rows, B * groups);
  pair_warp_kernel<T, F, kPixel, K><<<grid, kPairThreads, 0, s>>>(
      (const T*)img, (const F*)flow, (T*)out, C, groups, H, W, norm_x, norm_y, flags);
  return (int)cudaGetLastError();
}

// pair_warp_kernel's channel group by C (ops/kernels/warp.py:pixel_warp_plan
// has the same rule for its grid's limits).
template <typename T, typename F, bool kPixel>
int launch_pair_warp(const void* img, const void* flow, void* out, int B, int C, int H, int W,
                     float norm_x, float norm_y, cudaStream_t s) {
  if (C <= kPairFewChunk) {
    return launch_pair_warp_of<T, F, kPixel, kPairFewChunk>(img, flow, out, B, C, H, W, norm_x,
                                                            norm_y, s);
  }
  return launch_pair_warp_of<T, F, kPixel, kPairManyChunk>(img, flow, out, B, C, H, W, norm_x,
                                                           norm_y, s);
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

template <typename T>
int launch_flow_warp_backward(const void* img, const void* flow, const void* grad, void* grad_img,
                              void* grad_flow, int B, int C, int H, int W, float norm_x,
                              float norm_y, bool s2d, cudaStream_t s) {
  dim3 grid((H * W + kBwThreads - 1) / kBwThreads, B);
  if (s2d) {
    flow_warp_backward_kernel<T, true><<<grid, kBwThreads, 0, s>>>(
        (const T*)img, (const T*)flow, (const T*)grad, (float*)grad_img, (T*)grad_flow, C, H, W,
        norm_x, norm_y);
  } else {
    flow_warp_backward_kernel<T, false><<<grid, kBwThreads, 0, s>>>(
        (const T*)img, (const T*)flow, (const T*)grad, (float*)grad_img, (T*)grad_flow, C, H, W,
        norm_x, norm_y);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_pixel_warp_backward(const void* img, const void* flow, const void* grad,
                               void* grad_img, void* grad_flow, int B, int C, int H, int W,
                               int layout, cudaStream_t s) {
  dim3 grid((H * W + kBwThreads - 1) / kBwThreads, B);
  const T* i = (const T*)img;
  const float* f = (const float*)flow;
  const T* g = (const T*)grad;
  float *gi = (float*)grad_img, *gf = (float*)grad_flow;
  if (layout == kPixelNchw) {
    pixel_warp_backward_kernel<T, kPixelNchw><<<grid, kBwThreads, 0, s>>>(i, f, g, gi, gf, C, H, W);
  } else if (layout == kPixelS2d) {
    pixel_warp_backward_kernel<T, kPixelS2d><<<grid, kBwThreads, 0, s>>>(i, f, g, gi, gf, C, H, W);
  } else {
    pixel_warp_backward_kernel<T, kPixelPhase><<<grid, kBwThreads, 0, s>>>(i, f, g, gi, gf, C, H,
                                                                           W);
  }
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
  if (B < 1 || !fits_int32((int64_t)max(C, 2) * H * W)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    return launch_pair_warp<float, float, false>(img, flow, out, B, C, H, W, norm_x, norm_y, s);
  }
  if (dtype == 1) {
    return launch_pair_warp<__nv_bfloat16, __nv_bfloat16, false>(img, flow, out, B, C, H, W,
                                                                norm_x, norm_y, s);
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

// The small-frame plan of fvc_pixel_warp (pair_warp_kernel), with its
// arguments and results; ops/kernels/warp.py:pixel_warp_plan says which of
// the two forms a launch takes.
extern "C" int fvc_pixel_warp_small(const void* img, const void* flow, void* out, int B, int C,
                                    int H, int W, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || !fits_int32((int64_t)max(C, 2) * H * W)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    return launch_pair_warp<float, float, true>(img, flow, out, B, C, H, W, 0.0f, 0.0f, s);
  }
  if (dtype == 1) {
    return launch_pair_warp<__nv_bfloat16, float, true>(img, flow, out, B, C, H, W, 0.0f, 0.0f,
                                                        s);
  }
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

// The vjp of fvc_flow_warp (s2d 0: img, grad [B,C,H,W]) or of
// fvc_flow_warp_s2d (s2d 1: img, grad [B,4C,H/2,W/2]; C the full-res
// channel count), flow [B,2,H,W], all of dtype, H and W full-res. grad_img
// is a zeroed float32 buffer of img's shape that receives the image
// gradient, or null; grad_flow receives the flow gradient (dtype), or null.
extern "C" int fvc_flow_warp_backward(const void* img, const void* flow, const void* grad,
                                      void* grad_img, void* grad_flow, int B, int C, int H,
                                      int W, float norm_x, float norm_y, int s2d, int dtype,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || B > 65535 || !fits_int32((int64_t)max(C, 2) * H * W) ||
      (s2d && (H % 2 || W % 2)))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    return launch_flow_warp_backward<float>(img, flow, grad, grad_img, grad_flow, B, C, H, W,
                                            norm_x, norm_y, s2d, s);
  }
  if (dtype == 1) {
    return launch_flow_warp_backward<__nv_bfloat16>(img, flow, grad, grad_img, grad_flow, B, C,
                                                    H, W, norm_x, norm_y, s2d, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The vjp of the pixel warps: layout 0 fvc_pixel_warp (img, grad [B,C,H,W],
// flow [B,2,H,W]), 1 the full-res-flow fvc_pixel_warp_s2d (img, grad
// [B,4C,H/2,W/2], flow [B,2,H,W]), 2 its phase-flow form (flow
// [B,8,H/2,W/2]); img and grad of dtype, the flow float32, C the full-res
// channel count, H and W full-res. grad_img is a zeroed float32 buffer of
// img's shape that receives the image gradient, or null; grad_flow receives
// the flow gradient (float32, the flow's shape), or null.
extern "C" int fvc_pixel_warp_backward(const void* img, const void* flow, const void* grad,
                                       void* grad_img, void* grad_flow, int B, int C, int H,
                                       int W, int layout, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || B > 65535 || !fits_int32((int64_t)max(C, 2) * H * W) || layout < kPixelNchw ||
      layout > kPixelPhase || (layout != kPixelNchw && (H % 2 || W % 2)))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    return launch_pixel_warp_backward<float>(img, flow, grad, grad_img, grad_flow, B, C, H, W,
                                             layout, s);
  }
  if (dtype == 1) {
    return launch_pixel_warp_backward<__nv_bfloat16>(img, flow, grad, grad_img, grad_flow, B, C,
                                                     H, W, layout, s);
  }
  return (int)cudaErrorInvalidValue;
}
