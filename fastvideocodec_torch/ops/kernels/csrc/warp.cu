// Bilinear backward warp with border clamp, for sm_90a (H100).
//
// Four kernels, all a plain gather: one thread per output position, with
// neighbouring threads on neighbouring x, and a loop over the channels.
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
// PyTorch version's.
//
// There is no displacement bound: the TPU kernel's clamp to R pixels and
// its +-11-row window were limits of the TPU's VMEM halo, not semantics.
//
// All are memory-bound: a few flops per byte moved. This first version is
// a plain gather; shared-memory halo tiles and vector loads are later work.
// The pixel-convention kernels take a float32 flow with a float32 or
// bfloat16 image: a bfloat16 flow would be pixels coarse at 2048 wide.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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
// with align_corners=False, clamped to the border.
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

// Normalized-grid convention: output index i (of n) displaced by f pixels;
// norm = 2/max(n-1,1) rounded to float32 on the host.
__device__ __forceinline__ Tap make_tap(float f, int i, int n, float norm) {
  // jnp.linspace(-1, 1, n)[i] = -1*(1-s) + 1*s with s = i/(n-1)
  float lin = -1.0f;
  if (n > 1) {
    float s = __fdiv_rn((float)i, (float)(n - 1));
    lin = __fadd_rn(-__fsub_rn(1.0f, s), s);
  }
  return border_tap(__fadd_rn(lin, __fmul_rn(f, norm)), n);
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

// Replaces pallas_flow_warp (fastvideocodec_tpu/ops/pallas/warp_kernel.py:501),
// the SpyNet level warp. img [B,C,H,W], flow [B,2,H,W], out [B,C,H,W].
// Bound by bytes: it reads the flow and about the image once and writes the
// output (C=3 on the main path: ~167 MB per GOP at 1024x2048, ~0.05 ms at
// 3.35 TB/s).
template <typename T>
__global__ void flow_warp_kernel(const T* __restrict__ img, const T* __restrict__ flow,
                                 T* __restrict__ out, int B, int C, int H, int W,
                                 float norm_x, float norm_y) {
  int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t plane = (int64_t)H * W;
  if (p >= (int64_t)B * plane) return;
  int64_t b = p / plane;
  int64_t yx = p - b * plane;
  int y = (int)(yx / W), x = (int)(yx - (int64_t)y * W);
  const T* fb = flow + b * 2 * plane;
  Tap tx = make_tap(to_f32(fb[yx]), x, W, norm_x);
  Tap ty = make_tap(to_f32(fb[plane + yx]), y, H, norm_y);
  lerp_planes(img + b * C * plane, out + b * C * plane + yx, C, plane, W, tx, ty);
}

// Replaces pallas_flow_warp_s2d (fastvideocodec_tpu/ops/pallas/warp_kernel.py:547),
// the LSVC-TPU motion-compensation warp. img [B,4C,Hs,Ws] is a full-res
// [B,C,2Hs,2Ws] image in space-to-depth form, channel (ry*2 + rx)*C + c;
// flow [B,2,2Hs,2Ws] is full-res; out has img's s2d form. Each thread owns
// one s2d position and writes all 4C channels of it: for each of its 2x2
// full-res pixels it reads the flow there, and fetches full-res source
// pixel (y, x) from s2d channel ((y%2)*2 + x%2)*C + c at (y/2, x/2). The
// depth-to-space / space-to-depth round trip thus folds into the loads and
// stores, and nothing full-res is materialized. Bound by bytes: ~33.6 MB per
// 1024x2048 frame in bf16 (image, flow, output), ~0.15 ms per GOP at
// 3.35 TB/s.
template <typename T>
__global__ void flow_warp_s2d_kernel(const T* __restrict__ img, const T* __restrict__ flow,
                                     T* __restrict__ out, int B, int C, int Hs, int Ws,
                                     float norm_x, float norm_y) {
  int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t splane = (int64_t)Hs * Ws;
  if (p >= (int64_t)B * splane) return;
  int64_t b = p / splane;
  int64_t ij = p - b * splane;
  int i = (int)(ij / Ws), j = (int)(ij - (int64_t)i * Ws);
  int H = 2 * Hs, W = 2 * Ws;
  int64_t fplane = (int64_t)H * W;
  const T* fb = flow + b * 2 * fplane;
  const T* ib = img + b * 4 * C * splane;
  T* ob = out + b * 4 * C * splane + ij;
  for (int ry = 0; ry < 2; ++ry) {
    for (int rx = 0; rx < 2; ++rx) {
      int y = 2 * i + ry, x = 2 * j + rx;
      int64_t f = (int64_t)y * W + x;
      Tap tx = make_tap(to_f32(fb[f]), x, W, norm_x);
      Tap ty = make_tap(to_f32(fb[fplane + f]), y, H, norm_y);
      lerp_s2d(ib, ob + (int64_t)(ry * 2 + rx) * C * splane, C, splane, Ws, tx, ty);
    }
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int fvc_flow_warp(const void* img, const void* flow, void* out, int B, int C,
                             int H, int W, float norm_x, float norm_y, int dtype,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  unsigned grid = blocks_for((int64_t)B * H * W);
  if (dtype == 0) {
    flow_warp_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)img, (const float*)flow, (float*)out, B, C, H, W, norm_x, norm_y);
  } else if (dtype == 1) {
    flow_warp_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)img, (const __nv_bfloat16*)flow, (__nv_bfloat16*)out, B, C,
        H, W, norm_x, norm_y);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// img/out [B,4C,Hs,Ws], flow [B,2,2Hs,2Ws]; C is the full-res channel count.
extern "C" int fvc_flow_warp_s2d(const void* img, const void* flow, void* out, int B,
                                 int C, int Hs, int Ws, float norm_x, float norm_y,
                                 int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  unsigned grid = blocks_for((int64_t)B * Hs * Ws);
  if (dtype == 0) {
    flow_warp_s2d_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)img, (const float*)flow, (float*)out, B, C, Hs, Ws, norm_x, norm_y);
  } else if (dtype == 1) {
    flow_warp_s2d_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)img, (const __nv_bfloat16*)flow, (__nv_bfloat16*)out, B, C,
        Hs, Ws, norm_x, norm_y);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
