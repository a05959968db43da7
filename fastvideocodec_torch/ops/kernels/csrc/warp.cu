// Bilinear backward warp with border clamp, for sm_90a (H100).
//
// Two kernels, both a plain gather: one thread per output position, with
// neighbouring threads on neighbouring x, and a loop over the channels.
// The sample coordinate is built in float32 exactly as the exact path
// builds it (fastvideocodec_tpu/ops/warp.py:_xla_flow_warp, mirrored by
// fastvideocodec_torch/ops/warp.py:plain_flow_warp): the linspace(-1,1)
// grid plus flow*2/(size-1), unnormalized with align_corners=False, then
// clamped to the border. The four taps are read, lerped in float32 and
// rounded once to the output type. Every float operation goes through a
// round-to-nearest intrinsic, so nvcc contracts nothing into an FMA and
// the result equals the plain PyTorch version's.
//
// There is no displacement bound: the TPU kernel's clamp to R pixels and
// its +-11-row window were limits of the TPU's VMEM halo, not semantics.
//
// Both kernels are memory-bound: a few flops per byte moved. This first
// version is a plain gather kernel; shared-memory halo tiles and vector
// loads are later work.

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

// One axis of the sample coordinate of output index i (of n) displaced by
// f pixels; norm = 2/max(n-1,1) rounded to float32 on the host.
__device__ __forceinline__ Tap make_tap(float f, int i, int n, float norm) {
  // jnp.linspace(-1, 1, n)[i] = -1*(1-s) + 1*s with s = i/(n-1)
  float lin = -1.0f;
  if (n > 1) {
    float s = __fdiv_rn((float)i, (float)(n - 1));
    lin = __fadd_rn(-__fsub_rn(1.0f, s), s);
  }
  float g = __fadd_rn(lin, __fmul_rn(f, norm));
  float u = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(g, 1.0f), (float)n), 1.0f), 0.5f);
  u = fminf(fmaxf(u, 0.0f), (float)(n - 1));
  float u0 = floorf(u);
  Tap tap;
  tap.t = __fsub_rn(u, u0);
  tap.i0 = min(max((int)u0, 0), n - 1);
  tap.i1 = min(tap.i0 + 1, n - 1);
  return tap;
}

__device__ __forceinline__ float lerp2(float v00, float v01, float v10, float v11,
                                       float tx, float ty) {
  float sx = __fsub_rn(1.0f, tx), sy = __fsub_rn(1.0f, ty);
  float top = __fadd_rn(__fmul_rn(v00, sx), __fmul_rn(v01, tx));
  float bot = __fadd_rn(__fmul_rn(v10, sx), __fmul_rn(v11, tx));
  return __fadd_rn(__fmul_rn(top, sy), __fmul_rn(bot, ty));
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
  int64_t o00 = (int64_t)ty.i0 * W + tx.i0, o01 = (int64_t)ty.i0 * W + tx.i1;
  int64_t o10 = (int64_t)ty.i1 * W + tx.i0, o11 = (int64_t)ty.i1 * W + tx.i1;
  const T* ib = img + b * C * plane;
  T* ob = out + b * C * plane + yx;
  for (int c = 0; c < C; ++c) {
    const T* ic = ib + c * plane;
    float v = lerp2(to_f32(ic[o00]), to_f32(ic[o01]), to_f32(ic[o10]),
                    to_f32(ic[o11]), tx.t, ty.t);
    ob[c * plane] = from_f32<T>(v);
  }
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
      // s2d offsets (phase channel block, position) of the four taps
      int64_t s00 = (int64_t)((ty.i0 & 1) * 2 + (tx.i0 & 1)) * C * splane
                    + (int64_t)(ty.i0 >> 1) * Ws + (tx.i0 >> 1);
      int64_t s01 = (int64_t)((ty.i0 & 1) * 2 + (tx.i1 & 1)) * C * splane
                    + (int64_t)(ty.i0 >> 1) * Ws + (tx.i1 >> 1);
      int64_t s10 = (int64_t)((ty.i1 & 1) * 2 + (tx.i0 & 1)) * C * splane
                    + (int64_t)(ty.i1 >> 1) * Ws + (tx.i0 >> 1);
      int64_t s11 = (int64_t)((ty.i1 & 1) * 2 + (tx.i1 & 1)) * C * splane
                    + (int64_t)(ty.i1 >> 1) * Ws + (tx.i1 >> 1);
      T* oc = ob + (int64_t)(ry * 2 + rx) * C * splane;
      for (int c = 0; c < C; ++c) {
        const T* ic = ib + (int64_t)c * splane;
        float v = lerp2(to_f32(ic[s00]), to_f32(ic[s01]), to_f32(ic[s10]),
                        to_f32(ic[s11]), tx.t, ty.t);
        oc[(int64_t)c * splane] = from_f32<T>(v);
      }
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
