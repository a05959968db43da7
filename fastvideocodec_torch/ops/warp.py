"""Warping and resampling ops (NCHW), ported from fastvideocodec_tpu/ops/warp.py.

Layout: tensors are NCHW. A flow is ``[B, 2, H, W]`` with channel 0 the x
displacement and channel 1 the y displacement, in pixels. Space-to-depth
keeps the JAX package's channel order ``(ry, rx, c)`` (channel index
``ry*r*C + rx*C + c``), so the shipped weights load with no channel
permutation. ``torch.pixel_unshuffle`` orders channels ``(c, ry, rx)`` and
is deliberately not used.

Two warp conventions, each the gather form of a JAX exact path:
``plain_flow_warp`` (``_xla_flow_warp``: linspace grid + flow*2/(size-1))
and ``plain_pixel_warp`` (``_xla_pixel_warp``: source = output + flow).
The sampling coordinate is built in float32 for every image dtype, and the
four taps are lerped in float32 and rounded once to the image dtype. The
dispatchers (``flow_warp``, ``flow_warp_fullres_s2d``, ``pixel_warp``,
``pixel_warp_s2d``, ``pixel_warp_s2d_sflow``) launch the hand-written CUDA
kernels (ops/kernels/warp.py) for CUDA tensors and run the plain versions
for CPU tensors only: a CUDA tensor never falls back to them. On a CUDA
tensor that needs a gradient the kernel runs inside ``KernelWarp``, whose
backward is the warp's backward kernel; the vjp of the plain version
(``plain_warp_vjp``) is that kernel's plain version, for CPU tensors, the
tests and the card's checks. There is no displacement bound: the TPU
kernel's clamp was a limit of the TPU.

The cached tensors (grids, resize weights, blur taps) are built outside
inference mode (``_cached``), so that a training step may follow an eval
rollout in one process.

The SSF scale-space volume ops at the end (blur, volume, the full-resolution
volume warp, phase mean, s2d upsample, the pyramid warps at full resolution
and in s2d form) are plain PyTorch around the pixel warp, as they were XLA fusions on the TPU.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from fastvideocodec_torch.ops.kernels import warp as kernels
from fastvideocodec_torch.ops.kernels.warp import grid_norm


def _cached(maxsize: int):
    """functools.lru_cache of a function that makes a tensor, run outside
    inference mode: a tensor first made during an eval rollout (under
    ``torch.inference_mode``) may later be saved for a backward, which an
    inference tensor cannot be."""

    def wrap(fn):
        @functools.lru_cache(maxsize=maxsize)
        @functools.wraps(fn)
        def build(*args):
            with torch.inference_mode(False):
                return fn(*args)

        return build

    return wrap


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


@_cached(maxsize=64)
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


@_cached(maxsize=64)
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


def _border_taps(u: torch.Tensor, size: int):
    """Border-clamped bilinear taps of an unnormalized float32 coordinate:
    (index lo, index hi, weight of hi)."""
    u = u.clamp(0.0, size - 1)
    u0 = torch.floor(u)
    t = u - u0
    i0 = u0.long().clamp(0, size - 1)
    i1 = (i0 + 1).clamp(max=size - 1)
    return i0, i1, t


def _taps(flow_c: torch.Tensor, lin: torch.Tensor, size: int):
    """Taps along one axis for a flow component in the normalized-grid
    convention: linspace(-1,1) + flow*2/(size-1), unnormalized with
    align_corners=False."""
    g = lin + flow_c.float() * grid_norm(size)
    return _border_taps(((g + 1.0) * size - 1.0) * 0.5, size)


@_cached(maxsize=64)
def _divisor(n: int, device) -> torch.Tensor:
    """n as a one-element float32 tensor on ``device``: dividing by it is
    IEEE float32 division on every device (PyTorch's CUDA division by a
    Python scalar multiplies by the reciprocal instead)."""
    return torch.full((1,), float(n), dtype=torch.float32, device=device)


@_cached(maxsize=64)
def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.float32, device=device)


def _pixel_taps(flow_c: torch.Tensor, pos: torch.Tensor, size: int):
    """Taps along one axis for a flow component in the pixel convention
    (source = output + flow), op for op as the JAX exact path builds them:
    g = (2*(i + f) + 1)/size - 1 (_xla_pixel_warp), then
    u = ((g + 1)*size - 1)/2 (grid_sample's unnormalize). The round trip
    is not the identity in float32, so it is kept."""
    s = pos + flow_c.float()
    g = (2.0 * s + 1.0) / _divisor(size, s.device) - 1.0
    return _border_taps(((g + 1.0) * size - 1.0) * 0.5, size)


def _gather_lerp(img: torch.Tensor, x_taps, y_taps) -> torch.Tensor:
    """Bilinear gather of img [B, C, H, W] at per-output-pixel taps
    ([B, H, W] each): the four taps lerped in float32, rounded once."""
    B, C, H, W = img.shape
    x0, x1, tx = x_taps
    y0, y1, ty = y_taps
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


def plain_flow_warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Bilinear backward warp, exact and unbounded (gather form).

    img [B, C, H, W]; flow [B, 2, H, W] in pixels. The sample point of
    output pixel (y, x) is linspace(-1,1)[x] + flow_x*2/(W-1) (same for y),
    unnormalized with align_corners=False and clamped to the border."""
    _, _, H, W = img.shape
    return _gather_lerp(
        img,
        _taps(flow[:, 0], _linspace(W, img.device)[None, None, :], W),
        _taps(flow[:, 1], _linspace(H, img.device)[None, :, None], H),
    )


def plain_flow_warp_s2d(img_s2d: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Full-resolution warp of an image carried in s2d form:
    img_s2d [B, 4C, H/2, W/2], flow [B, 2, H, W]; returns s2d form."""
    return space_to_depth(plain_flow_warp(depth_to_space(img_s2d, 2), flow), 2)


def _flow_like(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The flow of a flow warp in the image's dtype where the image is
    float32: a bf16 training step warps its float32 frames and recons by a
    bf16 flow from a conv, and JAX's warp takes the coordinates in float32
    whatever the flow's dtype (the cast is exact; its gradient rounds once
    to the flow's dtype). The kernels take one dtype for both."""
    return flow.float() if img.dtype == torch.float32 else flow


def flow_warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Bilinear backward warp, img [B, C, H, W], flow [B, 2, H, W] pixels:
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    return _dispatch("flow_warp", img, _flow_like(img, flow))


def flow_warp_fullres_s2d(img_s2d: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Full-resolution warp of an s2d image: img_s2d [B, 4C, H/2, W/2],
    flow [B, 2, H, W] full-res pixels; returns the warped image in s2d form.
    Equal to space_to_depth(flow_warp(depth_to_space(img_s2d), flow))."""
    return _dispatch("flow_warp_s2d", img_s2d, _flow_like(img_s2d, flow))


def plain_pixel_warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Bilinear warp with direct pixel displacements, exact and unbounded:
    output pixel (y, x) samples img at (x + flow_x, y + flow_y), clamped to
    the border (the JAX ``_xla_pixel_warp``). img [B, C, H, W] of any
    float dtype; flow [B, 2, H, W], its coordinates built in float32."""
    _, _, H, W = img.shape
    return _gather_lerp(
        img,
        _pixel_taps(flow[:, 0], _arange(W, img.device)[None, None, :], W),
        _pixel_taps(flow[:, 1], _arange(H, img.device)[None, :, None], H),
    )


def plain_pixel_warp_s2d(img_s2d: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Full-resolution pixel warp of an s2d image: img_s2d [B, 4C, H/2, W/2],
    flow [B, 2, H, W]; returns s2d form (the JAX ``_exact_pixel_fullres_s2d``)."""
    return space_to_depth(plain_pixel_warp(depth_to_space(img_s2d, 2), flow), 2)


def plain_pixel_warp_s2d_sflow(img_s2d: torch.Tensor, flow_s2d: torch.Tensor) -> torch.Tensor:
    """plain_pixel_warp_s2d with the flow in s2d phase form too:
    flow_s2d [B, 8, H/2, W/2] in c-major order, channel comp*4 + 2*ry + rx
    ([fx p0..p3, fy p0..p3]); each 4-channel block is the (ry, rx) phase
    set of one flow component (the JAX ``_exact_pixel_s2d_sflow``)."""
    return plain_pixel_warp_s2d(img_s2d, _full_res_flow(flow_s2d))


def _full_res_flow(flow_s2d: torch.Tensor) -> torch.Tensor:
    """A c-major s2d phase flow [B, 8, H/2, W/2] at full resolution [B, 2, H, W]."""
    return torch.cat(
        [depth_to_space(flow_s2d[:, 0:4], 2), depth_to_space(flow_s2d[:, 4:8], 2)], dim=1
    )


def pixel_warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Pixel-displacement warp, img [B, C, H, W], flow [B, 2, H, W]
    (float32): the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    return _dispatch("pixel_warp", img, flow)


def pixel_warp_s2d(img_s2d: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Full-resolution pixel warp of an s2d image, flow [B, 2, H, W]
    full-res (float32); returns s2d form."""
    return _dispatch("pixel_warp_s2d", img_s2d, flow)


def pixel_warp_s2d_sflow(img_s2d: torch.Tensor, flow_s2d: torch.Tensor) -> torch.Tensor:
    """Full-resolution pixel warp of an s2d image by a flow in c-major s2d
    phase form [B, 8, H/2, W/2] (float32); returns s2d form."""
    return _dispatch("pixel_warp_s2d_sflow", img_s2d, flow_s2d)


# Each kernel's plain version, by its launch-count name. Its launcher is
# ops/kernels/warp.py's launch_<name>, looked up at each call.
PLAIN = {
    "flow_warp": plain_flow_warp,
    "flow_warp_s2d": plain_flow_warp_s2d,
    "pixel_warp": plain_pixel_warp,
    "pixel_warp_s2d": plain_pixel_warp_s2d,
    "pixel_warp_s2d_sflow": plain_pixel_warp_s2d_sflow,
}


def _launcher(name: str):
    return getattr(kernels, f"launch_{name}")


# the attribute of each warp's backward launcher in ops/kernels/warp.py,
# looked up at each backward (so that a wrapped launcher is the one taken)
_BACKWARD_LAUNCHER = {name: f"launch_{name}_backward" for name in PLAIN}


def plain_warp_vjp(name: str, img: torch.Tensor, flow: torch.Tensor, grad: torch.Tensor,
                   need_img: bool = True, need_flow: bool = True) -> tuple:
    """The vjp of PLAIN[name] at (img, flow) for the output's gradient
    ``grad``: (grad_img, grad_flow), each None unless asked for, by
    autograd through the plain version on the inputs' device."""
    wanted = (need_img, need_flow)
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(w) for t, w in zip((img, flow), wanted)]
        out = PLAIN[name](*inputs)
        grads = iter(torch.autograd.grad(out, [t for t in inputs if t.requires_grad], grad))
    return tuple(next(grads) if w else None for w in wanted)


# Each warp's backward kernel's plain version, by the warp's launch-count
# name: ops/kernels/warp.py's launch_<name>_backward takes (img, flow, grad,
# need_img, need_flow) and gives (grad_img, grad_flow) as these do.
PLAIN_BACKWARD = {name: functools.partial(plain_warp_vjp, name) for name in PLAIN}


class KernelWarp(torch.autograd.Function):
    """A warp kernel with a gradient: the forward is the kernel's launcher,
    the backward the warp's backward kernel (``launch_<name>_backward``),
    asked for only the gradients autograd needs: the image's gradient, a
    scatter of float32 atomics, is skipped when the image needs none, as
    SpyNet's level image and the SSF and ELFVC references (detached) do. A
    build or launch failure raises; the plain vjp is never taken here (the
    JAX package's ``custom_vjp`` entry points take the vjp of the exact
    gather path, not a Pallas kernel). An empty batch (a rank's empty share
    of a split one) launches nothing either way. Call as
    ``KernelWarp.apply(name, img, flow)``."""

    @staticmethod
    def forward(ctx, name: str, img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
        ctx.name = name
        ctx.save_for_backward(img, flow)
        return _launch_nonempty(name, img, flow)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad: torch.Tensor):
        img, flow = ctx.saved_tensors
        needs = ctx.needs_input_grad[1:]
        if not img.shape[0]:
            return None, *(torch.zeros_like(t) if n else None for t, n in zip((img, flow), needs))
        launch = getattr(kernels, _BACKWARD_LAUNCHER[ctx.name])
        return None, *launch(img, flow, grad.contiguous(), *needs)


def _launch_nonempty(name: str, img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The kernel's launcher, or an empty output for an empty batch."""
    return _launcher(name)(img, flow) if img.shape[0] else torch.empty_like(img)


def _dispatch(name: str, img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The plain version for CPU tensors; else the kernel, through
    ``KernelWarp`` only when autograd needs its gradient (the launcher
    alone costs the host less, which the launch-bound rollouts feel)."""
    if img.is_cpu and flow.is_cpu:
        return PLAIN[name](img, flow)
    if (img.requires_grad or flow.requires_grad) and torch.is_grad_enabled():
        return KernelWarp.apply(name, img, flow)
    return _launch_nonempty(name, img, flow)


def _tile_reduce(v: torch.Tensor, tile: tuple, fill: int, op) -> torch.Tensor:
    """op (amin or amax) of v [B, H, W] over tiles of (rows, cols), the
    ragged edge padded with ``fill``: [B, tiles down, tiles across]."""
    B, H, W = v.shape
    th, tw = tile
    v = F.pad(v, (0, -W % tw, 0, -H % th), value=fill)
    return op(v.reshape(B, v.shape[1] // th, th, v.shape[2] // tw, tw), dim=(2, 4))


def staged_tiles(img_s2d: torch.Tensor, flow: torch.Tensor) -> tuple:
    """(tiles staged, tiles) of the s2d flow warp's kernel on these inputs
    (img_s2d [B, 4C, H/2, W/2], flow [B, 2, H, W]): a tile is staged when
    its source footprint fits the kernel's shared-memory budget, by
    warp.cu's rule: the box of the border-clamped taps of the tile's
    outputs in s2d rows and columns, its columns widened to multiples of
    kAlign when the image's rows allow 16-byte copies, times its 4C planes,
    against the budget in elements. The pixel s2d warps share the kernel's
    body but never stage."""
    k = kernels.tile_constants()
    align, budget = k["kAlign"], k["kS2dStageElems"]
    B, planes, Hs, Ws = img_s2d.shape
    H, W = 2 * Hs, 2 * Ws
    tile = (2 * k["kS2dRows"], 2 * k["kS2dCols"])  # in full-res pixels
    x0, x1, _ = _taps(flow[:, 0], _linspace(W, flow.device)[None, None, :], W)
    y0, y1, _ = _taps(flow[:, 1], _linspace(H, flow.device)[None, :, None], H)
    big = H + W
    r0 = _tile_reduce(y0, tile, big, torch.amin) >> 1
    r1 = _tile_reduce(y1, tile, -1, torch.amax) >> 1
    c0 = _tile_reduce(x0, tile, big, torch.amin) >> 1
    c1 = _tile_reduce(x1, tile, -1, torch.amax) >> 1
    if Ws % align == 0 and img_s2d.data_ptr() % 16 == 0:  # 16-byte copies
        c0 = c0 - c0 % align
        c1 = c1 + align - 1 - c1 % align
    elems = planes * (r1 - r0 + 1) * (c1 - c0 + 1)
    return int((elems <= budget).sum()), elems.numel()


# ---------------------------------------------------------------------------
# Scale-space volume ops of the SSF family (plain PyTorch: on the TPU they
# were XLA fusions, not kernels)
# ---------------------------------------------------------------------------


def gaussian_kernel1d(kernel_size: int, sigma: float) -> np.ndarray:
    half = (kernel_size - 1) * 0.5
    x = np.arange(kernel_size, dtype=np.float64) - half
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


@_cached(maxsize=16)
def _blur_taps(kernel_size: int, sigma: float, dtype: torch.dtype, device) -> torch.Tensor:
    """The tap coefficients rounded to the image dtype, on its device
    (cached: no host-to-device copy per call)."""
    return torch.as_tensor(gaussian_kernel1d(kernel_size, sigma)).to(device, dtype)


@_cached(maxsize=16)
def _phase_scale(H: int, W: int, device) -> torch.Tensor:
    """[W/2 x4, H/2 x4] as [8, 1, 1] float32: the c-major phase flow's
    normalized-to-pixel scale."""
    scl = np.asarray([W / 2.0] * 4 + [H / 2.0] * 4, np.float32)
    return torch.as_tensor(scl, device=device)[:, None, None]


def _edge_pad(v: torch.Tensor, axis: int, pad: int) -> torch.Tensor:
    shape = list(v.shape)
    shape[axis] = pad
    first = v.narrow(axis, 0, 1).expand(shape)
    last = v.narrow(axis, v.shape[axis] - 1, 1).expand(shape)
    return torch.cat([first, v, last], axis)


def gaussian_blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable gaussian blur of [B, C, H, W] with edge padding over
    2*ceil(3 sigma) + 1 taps, as the JAX package computes it: per axis,
    each tap coefficient is rounded to the image dtype and the products are
    summed left to right (a depthwise conv would sum in another order and
    round otherwise in bfloat16)."""
    kernel_size = 2 * int(math.ceil(3 * sigma)) + 1
    pad = kernel_size // 2
    k = _blur_taps(kernel_size, sigma, x.dtype, x.device)

    def tap_sum(v, axis):
        n = v.shape[axis]
        vp = _edge_pad(v, axis, pad)
        out = k[0] * vp.narrow(axis, 0, n)
        for t in range(1, kernel_size):
            out = out + k[t] * vp.narrow(axis, t, n)
        return out

    return tap_sum(tap_sum(x, 2), 3)


def gaussian_volume(x: torch.Tensor, sigma0: float, num_levels: int) -> torch.Tensor:
    """Scale-space volume as a flat channel stack [B, (num_levels+1)*C, H, W]:
    level 0 is x, level 1 blur(x), deeper levels avg-pool, blur and
    bilinear-upsample back (compressai ScaleSpaceFlow.gaussian_volume)."""
    levels = [x]
    cur = gaussian_blur(x, sigma0)
    levels.append(cur)
    for i in range(1, num_levels):
        cur = gaussian_blur(avg_pool2(cur), sigma0)
        interp = cur
        for _ in range(i):
            interp = bilinear_upsample_x2(interp)
        levels.append(interp)
    return torch.cat(levels, dim=1)


@_cached(maxsize=16)
def _half_size(H: int, W: int, device) -> torch.Tensor:
    """[W/2, H/2] as [1, 2, 1, 1] float32: a normalized flow's pixel scale."""
    return torch.as_tensor(np.asarray([W / 2.0, H / 2.0], np.float32),
                           device=device)[None, :, None, None]


def warp_volume(volume: torch.Tensor, flow: torch.Tensor, scale_field: torch.Tensor,
                num_levels: int) -> torch.Tensor:
    """Trilinear sample of a flat scale-space volume (compressai
    warp_volume, the JAX ``warp_volume``): stock SSF's full-resolution
    prediction.

    volume [B, D*C, H, W] from ``gaussian_volume`` (D = num_levels + 1,
    level-major channels); flow [B, 2, H, W] in normalized units;
    scale_field [B, 1, H, W], the depth coordinate in [-1, 1]. All D*C
    channels are sampled by one ``pixel_warp`` by the float32 flow scaled
    to pixels by (W/2, H/2) (the half-pixel-centred affine grid plus the
    flow, unnormalized, is source = output + flow*size/2). The depth
    z = clip(((s + 1)*D - 1)/2, 0, D - 1) is taken in the scale field's
    dtype, each hat weight max(0, 1 - |z - d|) cast to the volume's dtype,
    and the levels summed in order, as the JAX package does."""
    B, DC, H, W = volume.shape
    D = num_levels + 1
    C = DC // D
    flow_px = (flow.float() * _half_size(H, W, flow.device)).contiguous()
    sampled = pixel_warp(volume, flow_px)
    z = torch.clamp(((scale_field + 1.0) * D - 1.0) * 0.5, 0.0, D - 1)
    out = None
    for d in range(D):
        wd = torch.clamp(1.0 - torch.abs(z - d), min=0.0).to(volume.dtype)
        term = wd * sampled[:, d * C:(d + 1) * C]
        out = term if out is None else out + term
    return out


def _hat_blend(sampled: torch.Tensor, z: torch.Tensor, D: int, C: int) -> torch.Tensor:
    """The depth hat-weight blend over a flat level stack [B, D*C, H, W] by
    z [B, 1, H, W]: each weight max(0, 1 - |z - d|) cast to the stack's
    dtype, the levels summed in order (the JAX ``_hat_blend``)."""
    out = None
    for d in range(D):
        wd = torch.clamp(1.0 - torch.abs(z - d), min=0.0).to(sampled.dtype)
        term = wd * sampled[:, d * C:(d + 1) * C]
        out = term if out is None else out + term
    return out


def warp_volume_pyramid(level0: torch.Tensor, vol_half: torch.Tensor, flow: torch.Tensor,
                        scale_field: torch.Tensor, num_levels: int) -> torch.Tensor:
    """The pyramid scale-space sample at full resolution (the JAX
    ``warp_volume_pyramid``; no codec of either package calls it, SSF-TPU
    runs its s2d form ``warp_volume_pyramid_s2d``).

    level0 [B, C, H, W] is the reference frame; vol_half [B, (D-1)*C,
    H/2, W/2] the half-resolution blurred stack (D = num_levels + 1); flow
    [B, 2, H, W] normalized as ``warp_volume``'s; scale_field [B, 1, H, W]
    in [-1, 1]. Two ``pixel_warp`` launches: level 0 by the flow in pixels
    (W/2, H/2 times it), the stack at half resolution by the avg-pooled
    flow halved. The depth z is taken as ``warp_volume`` takes it; z in
    [0, 1) lerps the level-0 sample against the x2-upsampled blend of the
    stack, z >= 1 blends inside the stack."""
    B, C, H, W = level0.shape
    D = num_levels + 1
    flow_px = (flow.float() * _half_size(H, W, flow.device)).contiguous()
    s0 = pixel_warp(level0, flow_px)
    z = torch.clamp(((scale_field + 1.0) * D - 1.0) * 0.5, 0.0, D - 1)
    flow_h = (avg_pool2(flow_px) * 0.5).contiguous()
    z_h = torch.clamp(avg_pool2(z), 1.0, D - 1.0) - 1.0
    sampled_h = pixel_warp(vol_half, flow_h)
    t = bilinear_upsample_x2(_hat_blend(sampled_h, z_h, D - 1, C))
    a = torch.clamp(1.0 - z, min=0.0).to(level0.dtype)
    return a * s0 + (1.0 - a.to(t.dtype)) * t


def s2d_phase_mean(x_s2d: torch.Tensor, channels: int) -> torch.Tensor:
    """Mean over the four s2d phases, [B, 4C, H, W] -> [B, C, H, W]: the
    avg_pool2 of the full-resolution image, summed phase by phase."""
    C = channels
    return (x_s2d[:, 0:C] + x_s2d[:, C:2 * C] + x_s2d[:, 2 * C:3 * C]
            + x_s2d[:, 3 * C:4 * C]) * 0.25


def up2_to_s2d(x: torch.Tensor) -> torch.Tensor:
    """x2 bilinear upsample (align_corners=False) emitted in s2d form:
    [B, C, H, W] -> [B, 4C, H, W], phases in (ry, rx, c) order. Each phase
    is one shifted lerp: even = 0.25*prev + 0.75*self, odd = 0.75*self +
    0.25*next, edges clamped."""

    def taps(v, axis):
        n = v.shape[axis]
        prev = torch.cat([v.narrow(axis, 0, 1), v.narrow(axis, 0, n - 1)], axis)
        nxt = torch.cat([v.narrow(axis, 1, n - 1), v.narrow(axis, n - 1, 1)], axis)
        return 0.25 * prev + 0.75 * v, 0.75 * v + 0.25 * nxt

    phases = []
    for vh in taps(x, 2):  # ry = 0, 1
        phases.extend(taps(vh, 3))  # rx = 0, 1
    return torch.cat(phases, dim=1)


def warp_volume_pyramid_s2d(level0_s2d: torch.Tensor, vol_half: torch.Tensor,
                            motion_s2d: torch.Tensor, num_levels: int) -> torch.Tensor:
    """The SSF-TPU prediction: a pyramid scale-space warp with every tensor
    in the s2d domain.

    level0_s2d [B, 4C, H/2, W/2] is the reference frame in s2d form;
    vol_half [B, (D-1)*C, H/2, W/2] the flat half-resolution blurred stack
    (D = num_levels + 1); motion_s2d [B, 12, H/2, W/2] the motion field in
    c-major phase order [fx p0..p3, fy p0..p3, scale p0..p3], p = 2*ry + rx.
    The level-0 sample is a full-resolution pixel warp by the phase-form
    flow (float32); the blurred stack is sampled at half resolution by the
    phase-mean flow and blended by depth hat weights; a per-phase weight
    max(0, 1 - z) mixes the two. Returns the prediction in s2d form."""
    B, C4, H2, W2 = level0_s2d.shape
    C = C4 // 4
    H, W = 2 * H2, 2 * W2
    D = num_levels + 1
    dt = level0_s2d.dtype
    dev = level0_s2d.device
    motion = motion_s2d.float()
    s0 = pixel_warp_s2d_sflow(level0_s2d, motion[:, :8] * _phase_scale(H, W, dev))

    # half-resolution flow and depth: phase means (the JAX package's 12x3
    # mixing matmul, whose only non-zero weights are these)
    def phase_sum(first, weight):
        w = float(np.float32(weight))
        out = motion[:, first] * w
        for c in range(first + 1, first + 4):
            out = out + motion[:, c] * w
        return out[:, None]

    flow_h = torch.cat([phase_sum(0, 0.25 * (W / 2.0) * 0.5),
                        phase_sum(4, 0.25 * (H / 2.0) * 0.5)], dim=1)
    z_h = torch.clamp(((phase_sum(8, 0.25) + 1.0) * D - 1.0) * 0.5, 1.0, D - 1.0) - 1.0
    sampled_h = pixel_warp(vol_half, flow_h)

    # depth hat blend over the D-1 half-res levels, summed in float32
    lv = torch.arange(D - 1, dtype=torch.float32, device=dev)[None, :, None, None]
    wd = torch.clamp(1.0 - torch.abs(z_h - lv), min=0.0)  # [B, D-1, H2, W2]
    w_ext = wd.repeat_interleave(C, dim=1).to(dt)
    th = (w_ext * sampled_h).reshape(B, D - 1, C, H2, W2).float().sum(1).to(dt)
    t_s2d = up2_to_s2d(th)

    # per-phase level-0 weight a = max(0, 1 - z) in the motion dtype, as JAX
    zp = torch.clamp(((motion_s2d[:, 8:12] + 1.0) * D - 1.0) * 0.5, 0.0, D - 1)
    a4 = torch.clamp(1.0 - zp, min=0.0)
    a12 = a4.repeat_interleave(C, dim=1).to(dt)
    return a12 * s0 + (1.0 - a12) * t_s2d


__all__ = [
    "avg_pool2",
    "bilinear_upsample_x2",
    "bilinear_upsample_x2_ac",
    "depth_to_space",
    "flow_warp",
    "flow_warp_fullres_s2d",
    "gaussian_blur",
    "gaussian_kernel1d",
    "gaussian_volume",
    "KernelWarp",
    "PLAIN",
    "PLAIN_BACKWARD",
    "grid_norm",
    "pixel_warp",
    "pixel_warp_s2d",
    "pixel_warp_s2d_sflow",
    "plain_flow_warp",
    "plain_flow_warp_s2d",
    "plain_pixel_warp",
    "plain_pixel_warp_s2d",
    "plain_pixel_warp_s2d_sflow",
    "plain_warp_vjp",
    "s2d_phase_mean",
    "space_to_depth",
    "staged_tiles",
    "up2_to_s2d",
    "warp_volume",
    "warp_volume_pyramid",
    "warp_volume_pyramid_s2d",
]
