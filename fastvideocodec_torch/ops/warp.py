"""Warping and resampling ops (NCHW), ported from fastvideocodec_tpu/ops/warp.py.

Layout: tensors are NCHW. A flow is ``[B, 2, H, W]`` with channel 0 the x
displacement and channel 1 the y displacement, in pixels. Space-to-depth
keeps the JAX package's channel order ``(ry, rx, c)`` (channel index
``ry*r*C + rx*C + c``), so the shipped weights load with no channel
permutation. ``torch.pixel_unshuffle`` orders channels ``(c, ry, rx)`` and
is deliberately not used.

``plain_flow_warp`` is the gather form of the JAX exact path
(``_xla_flow_warp`` + ``grid_sample_bilinear``): the sampling coordinate is
built in float32 for every image dtype, and the four taps are lerped in
float32 and rounded once to the image dtype. ``flow_warp`` and
``flow_warp_fullres_s2d`` launch the hand-written CUDA kernels
(ops/kernels/warp.py) for CUDA tensors and run the plain versions for CPU
tensors only: a CUDA tensor never falls back to them. There is no
displacement bound: the TPU kernel's clamp was a limit of the TPU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from fastvideocodec_torch.ops.kernels import warp as kernels
from fastvideocodec_torch.ops.kernels.warp import grid_norm


def space_to_depth(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """[B, C, H, W] -> [B, r*r*C, H/r, W/r], channel order (ry, rx, c)."""
    B, C, H, W = x.shape
    x = x.reshape(B, C, H // r, r, W // r, r).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(B, r * r * C, H // r, W // r)


def depth_to_space(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """Inverse of space_to_depth: [B, r*r*C, H, W] -> [B, C, H*r, W*r]."""
    B, Crr, H, W = x.shape
    C = Crr // (r * r)
    x = x.reshape(B, r, r, C, H, W).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(B, C, H * r, W * r)


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool, stride 2."""
    return F.avg_pool2d(x, 2)


def _two_tap_indices(in_size: int, out_size: int, align_corners: bool):
    """Source indices and weights of a 1D bilinear resize (numpy, static)."""
    o = np.arange(out_size, dtype=np.float64)
    if align_corners:
        src = o * ((in_size - 1) / max(out_size - 1, 1)) if out_size > 1 else o * 0
    else:
        src = np.clip((o + 0.5) * (in_size / out_size) - 0.5, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int32)
    hi = np.minimum(lo + 1, in_size - 1)
    t = (src - lo).astype(np.float32)
    return lo, hi, t


@functools.lru_cache(maxsize=64)
def _x2_weights(size: int, align_corners: bool, ndim: int, axis: int,
                dtype: torch.dtype, device: torch.device):
    """The four per-row weights of a x2 resize along one axis, as tensors
    shaped to broadcast along ``axis`` (cached: built once per shape)."""
    lo, _, t = _two_tap_indices(size, 2 * size, align_corners)
    i = np.arange(size)
    assert ((lo[0::2] == i - 1) | (lo[0::2] == i)).all(), "even taps not (i-1, i)"
    assert (lo[1::2] == i).all(), "odd taps not (i, i+1)"
    shape = [1] * ndim
    shape[axis] = size
    t_even = t[0::2].astype(np.float32)
    lo_even_is_self = (lo[0::2] == i).astype(np.float32)
    t_odd = t[1::2].astype(np.float32)
    ws = (
        (1 - t_even) * (1 - lo_even_is_self),
        t_even + (1 - t_even) * lo_even_is_self,
        1 - t_odd,
        t_odd,
    )
    return tuple(
        torch.as_tensor(w.reshape(shape), dtype=dtype, device=device) for w in ws
    )


def _resize_axis_x2(x: torch.Tensor, axis: int, align_corners: bool) -> torch.Tensor:
    """2-tap bilinear x2 along one spatial axis: even outputs lerp (i-1, i),
    odd outputs (i, i+1), edges clamped; the same arithmetic as the JAX
    package's ``_resize_axis_x2``."""
    size = x.shape[axis]
    w_even_prev, w_even_self, w_odd_self, w_odd_next = _x2_weights(
        size, align_corners, x.ndim, axis, x.dtype, x.device
    )
    x_prev = torch.cat([x.narrow(axis, 0, 1), x.narrow(axis, 0, size - 1)], axis)
    x_next = torch.cat([x.narrow(axis, 1, size - 1), x.narrow(axis, size - 1, 1)], axis)
    even = x_prev * w_even_prev + x * w_even_self
    odd = x * w_odd_self + x_next * w_odd_next
    new_shape = list(x.shape)
    new_shape[axis] = 2 * size
    return torch.stack([even, odd], dim=axis + 1).reshape(new_shape)


def bilinear_upsample_x2(x: torch.Tensor) -> torch.Tensor:
    """x2 bilinear upsample of [B, C, H, W], align_corners=False."""
    return _resize_axis_x2(_resize_axis_x2(x, 2, False), 3, False)


def bilinear_upsample_x2_ac(x: torch.Tensor) -> torch.Tensor:
    """x2 bilinear upsample of [B, C, H, W], align_corners=True."""
    return _resize_axis_x2(_resize_axis_x2(x, 2, True), 3, True)


@functools.lru_cache(maxsize=64)
def _linspace(n: int, device) -> torch.Tensor:
    """linspace(-1, 1, n) in float32 by jnp.linspace's formula, s = i/(n-1),
    value = -1*(1-s) + 1*s, each step rounded once (XLA on the CPU may land
    an ulp away). Built with numpy's IEEE float32 division, not PyTorch's
    (its CUDA division by a scalar multiplies by the reciprocal), so that it
    equals the kernels' grid bit for bit."""
    if n == 1:
        lin = np.full((1,), -1.0, np.float32)
    else:
        s = np.arange(n, dtype=np.float32) / np.float32(n - 1)
        lin = -(np.float32(1.0) - s) + s
    return torch.as_tensor(lin, device=device)


def _taps(flow_c: torch.Tensor, lin: torch.Tensor, size: int):
    """Border-clamped bilinear taps along one axis for a pixel flow
    component: (index lo, index hi, weight of hi), all from float32 math."""
    g = lin + flow_c.float() * grid_norm(size)
    u = ((g + 1.0) * size - 1.0) * 0.5  # unnormalize, align_corners=False
    u = u.clamp(0.0, size - 1)
    u0 = torch.floor(u)
    t = u - u0
    i0 = u0.long().clamp(0, size - 1)
    i1 = (i0 + 1).clamp(max=size - 1)
    return i0, i1, t


def plain_flow_warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Bilinear backward warp, exact and unbounded (gather form).

    img [B, C, H, W]; flow [B, 2, H, W] in pixels. The sample point of
    output pixel (y, x) is linspace(-1,1)[x] + flow_x*2/(W-1) (same for y),
    unnormalized with align_corners=False and clamped to the border."""
    B, C, H, W = img.shape
    x0, x1, tx = _taps(flow[:, 0], _linspace(W, img.device)[None, None, :], W)
    y0, y1, ty = _taps(flow[:, 1], _linspace(H, img.device)[None, :, None], H)
    flat = img.reshape(B, C, H * W)

    def gather(yi, xi):
        idx = (yi * W + xi).reshape(B, 1, H * W).expand(B, C, H * W)
        return torch.gather(flat, 2, idx).float()

    tx = tx.reshape(B, 1, H * W)
    ty = ty.reshape(B, 1, H * W)
    top = gather(y0, x0) * (1.0 - tx) + gather(y0, x1) * tx
    bot = gather(y1, x0) * (1.0 - tx) + gather(y1, x1) * tx
    out = top * (1.0 - ty) + bot * ty
    return out.to(img.dtype).reshape(B, C, H, W)


def plain_flow_warp_s2d(img_s2d: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Full-resolution warp of an image carried in s2d form:
    img_s2d [B, 4C, H/2, W/2], flow [B, 2, H, W]; returns s2d form."""
    return space_to_depth(plain_flow_warp(depth_to_space(img_s2d, 2), flow), 2)


def _on_cpu(img: torch.Tensor, flow: torch.Tensor) -> bool:
    return img.device.type == "cpu" and flow.device.type == "cpu"


def flow_warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Bilinear backward warp, img [B, C, H, W], flow [B, 2, H, W] pixels:
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if _on_cpu(img, flow):
        return plain_flow_warp(img, flow)
    return kernels.launch_flow_warp(img, flow)


def flow_warp_fullres_s2d(img_s2d: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Full-resolution warp of an s2d image: img_s2d [B, 4C, H/2, W/2],
    flow [B, 2, H, W] full-res pixels; returns the warped image in s2d form.
    Equal to space_to_depth(flow_warp(depth_to_space(img_s2d), flow))."""
    if _on_cpu(img_s2d, flow):
        return plain_flow_warp_s2d(img_s2d, flow)
    return kernels.launch_flow_warp_s2d(img_s2d, flow)


__all__ = [
    "avg_pool2",
    "bilinear_upsample_x2",
    "bilinear_upsample_x2_ac",
    "depth_to_space",
    "flow_warp",
    "flow_warp_fullres_s2d",
    "grid_norm",
    "plain_flow_warp",
    "plain_flow_warp_s2d",
    "space_to_depth",
]
