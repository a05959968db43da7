"""Launchers of the CUDA warp kernels (csrc/warp.cu), each with a launch count.

A launcher checks its CUDA tensors and launches its kernel on the current
stream, or raises. The dispatchers in ops/warp.py (``flow_warp``,
``flow_warp_fullres_s2d``, ``pixel_warp``, ``pixel_warp_s2d``,
``pixel_warp_s2d_sflow``) call these for CUDA tensors and the plain
versions beside them for CPU tensors. The normalized-grid warps take a
flow of the image's dtype; the pixel warps a float32 flow with a float32
or bfloat16 image.

``LAUNCHES[name]`` grows by one at each kernel launch and nowhere else, so
a run can show that it went through the kernels; ``reset_launches()``
zeroes the counts. A launcher gives no gradient: the dispatchers wrap it in
``ops.warp.KernelWarp`` when autograd needs one, whose backward launches
the warp's backward kernel, ``launch_<name>_backward`` (counted as
``<name>_backward``): csrc/warp.cu's flow_warp_backward_kernel for the two
normalized-grid warps, its pixel_warp_backward_kernel for the three pixel
warps.

All five are tiled: a block owns a tile of outputs. The three s2d warps
share one kernel body, and ``flow_warp_s2d``'s block stages the tile's
source footprint in shared memory when it fits a budget.
``tile_constants()`` reads that tile and budget from warp.cu itself, for
``ops.warp.staged_tiles``. ``flow_warp`` launches warp.cu's
pair_warp_kernel at every shape; ``pixel_warp`` has two plans, chosen by
shape (``pixel_warp_plan``, from warp.cu's constants too): its tiled
kernel where its grid fills the card, pair_warp_kernel on the small frames
where it would not (each plan a C entry point of its own,
``PIXEL_ENTRIES``).

A launch costs the host a few microseconds, which the small frames'
launches feel: the launchers check their tensors with cheap attribute
reads, cache each shape's arguments and plan, ask torch for the raw
current stream (no Stream object) and switch devices only when the
tensors lie on another card than the current one.
"""

from __future__ import annotations

import ctypes
import functools
import re
from pathlib import Path

import numpy as np
import torch

from fastvideocodec_torch.ops.kernels import build

LAUNCHES = {
    "flow_warp": 0,
    "flow_warp_s2d": 0,
    "pixel_warp": 0,
    "pixel_warp_s2d": 0,
    "pixel_warp_s2d_sflow": 0,
    "flow_warp_backward": 0,
    "flow_warp_s2d_backward": 0,
    "pixel_warp_backward": 0,
    "pixel_warp_s2d_backward": 0,
    "pixel_warp_s2d_sflow_backward": 0,
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def tile_constants(source: Path | None = None) -> dict:
    """warp.cu's constants written as plain numbers (``constexpr int kName =
    123;``), by name: among them kAlign, kS2dRows, kS2dCols and
    kS2dStageElems, the s2d kernel's staging rule, and those of
    ``pixel_warp_plan``. Read from the source the kernels are built from
    (``source``, default ``build.SOURCE``), so the host's copy of a rule
    cannot drift."""
    text = (source or build.SOURCE).read_text()
    return {name: int(v) for name, v in re.findall(r"constexpr int (k\w+) = (\d+);", text)}


# the C entry point of each plan of pixel_warp
PIXEL_ENTRIES = {"tiled": "fvc_pixel_warp", "small": "fvc_pixel_warp_small"}


def pixel_warp_plan(B: int, C: int, H: int, W: int, constants: dict | None = None) -> str:
    """The launch plan of ``pixel_warp`` on an image [B, C, H, W] of either
    dtype: "tiled" (pixel_warp_kernel) when that kernel's grid would hold
    at least kTiledMinThreads threads, else "small" (pair_warp_kernel: a
    thread a pair of outputs and a group of channels, kPairFewChunk of them
    when C is at most that, else kPairManyChunk; blocks of kPairRows rows)
    where that plan's grid fits CUDA's limits. A pure function of the shape
    and of warp.cu's constants (``tile_constants()``, or ``constants`` read
    from another version of the source)."""
    k = constants or tile_constants()
    tiled_threads = B * -(-H // k["kPwRows"]) * -(-W // k["kPairCols"]) * 32 * k["kPwRows"]
    chunk = k["kPairFewChunk"] if C <= k["kPairFewChunk"] else k["kPairManyChunk"]
    cells = B * -(-C // chunk)  # pair_warp_kernel's gridDim.z
    fits = 1 <= cells <= k["kGridYZ"] and -(-H // k["kPairRows"]) <= k["kGridYZ"]
    return "small" if tiled_threads < k["kTiledMinThreads"] and fits else "tiled"


@functools.lru_cache(maxsize=512)
def _pixel_entry(B: int, C: int, H: int, W: int) -> str:
    """The C entry point of pixel_warp_plan's plan at this shape."""
    return PIXEL_ENTRIES[pixel_warp_plan(B, C, H, W)]


@functools.lru_cache(maxsize=512)
def _flow_args(B: int, C: int, H: int, W: int) -> tuple:
    """fvc_flow_warp's arguments after the three pointers but the dtype:
    B, C, H, W and the two norms as ctypes floats, which cost the call less
    to pass than Python floats."""
    return B, C, H, W, ctypes.c_float(grid_norm(W)), ctypes.c_float(grid_norm(H))


@functools.lru_cache(maxsize=64)
def grid_norm(size: int) -> float:
    """2/(size-1) rounded to float32: the pixel-to-normalized flow scale,
    shared by the kernels and the plain versions."""
    return float(np.float32(2.0 / max(size - 1, 1)))


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(img: torch.Tensor, flow: torch.Tensor, flow_shape: tuple,
           flow_dtype: torch.dtype | None = None) -> int:
    """Raise unless img (4-D) and flow (of ``flow_shape``, and of
    ``flow_dtype`` or else img's dtype) are contiguous on one CUDA device;
    return the kernels' dtype code of img. Cheap reads first; the messages
    are built only on failure."""
    if not img.is_cuda or flow.get_device() != img.get_device():
        raise ValueError(
            f"warp kernel needs img and flow on one CUDA device, got {img.device} "
            f"and {flow.device}"
        )
    want = img.dtype if flow_dtype is None else flow_dtype
    code = _DTYPES.get(img.dtype)
    if code is None or flow.dtype != want:
        raise TypeError(
            f"warp kernel takes a float32 or bfloat16 img and a {want} flow, got "
            f"{img.dtype} and {flow.dtype}"
        )
    if img.dim() != 4 or flow.shape != flow_shape:
        raise ValueError(
            f"flow {tuple(flow.shape)} does not match img {tuple(img.shape)}: want "
            f"{tuple(flow_shape)}"
        )
    if not (img.is_contiguous() and flow.is_contiguous()):
        raise ValueError("warp kernel needs contiguous img and flow")
    return code


def _s2d_shape(img_s2d: torch.Tensor) -> tuple:
    if img_s2d.dim() != 4 or img_s2d.shape[1] % 4:
        raise ValueError(f"s2d image needs shape [B, 4C, H/2, W/2], got {tuple(img_s2d.shape)}")
    return tuple(img_s2d.shape)


@functools.cache
def _cuda_calls():
    """(the current device's index, the raw current stream of a device
    index): torch's C calls behind ``torch.cuda.current_device()`` and
    ``torch.cuda.current_stream(i).cuda_stream``, without the lazy-init
    check and the Stream object those build at every call; the public
    calls where this build of torch lacks them."""
    device = getattr(torch._C, "_cuda_getDevice", None)
    stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if device is None or stream is None:
        return torch.cuda.current_device, lambda i: torch.cuda.current_stream(i).cuda_stream
    return device, stream


def _launch(name: str, t: torch.Tensor, entry, *args) -> None:
    """``entry(*args, stream)`` (a C entry point of the library) on the
    current stream of t's device, in that device's context (switched to it
    only when it is not the current device); raise if it failed, else
    count a launch of ``name``."""
    current, stream = _cuda_calls()
    index = t.get_device()
    if index == current():
        rc = entry(*args, stream(index))
    else:
        with torch.cuda.device(index):
            rc = entry(*args, stream(index))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    LAUNCHES[name] += 1


def launch_flow_warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Bilinear backward warp, img [B, C, H, W], flow [B, 2, H, W] pixels."""
    B, C, H, W = img.shape
    dtype = _check(img, flow, (B, 2, H, W))
    entry = build.load().fvc_flow_warp
    out = torch.empty_like(img)
    _launch("flow_warp", img, entry, img.data_ptr(), flow.data_ptr(), out.data_ptr(),
            *_flow_args(B, C, H, W), dtype)
    return out


def launch_flow_warp_s2d(img_s2d: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Full-resolution warp of an s2d image: img_s2d [B, 4C, H/2, W/2],
    flow [B, 2, H, W] full-res pixels; returns the warped image in s2d form."""
    B, C4, Hs, Ws = _s2d_shape(img_s2d)
    dtype = _check(img_s2d, flow, (B, 2, 2 * Hs, 2 * Ws))
    entry = build.load().fvc_flow_warp_s2d
    out = torch.empty_like(img_s2d)
    _launch("flow_warp_s2d", img_s2d, entry, img_s2d.data_ptr(), flow.data_ptr(), out.data_ptr(),
            B, C4 // 4, Hs, Ws, grid_norm(2 * Ws), grid_norm(2 * Hs), dtype)
    return out


def launch_pixel_warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Pixel-displacement warp (source = output + flow), img [B, C, H, W],
    flow [B, 2, H, W] float32, in ``pixel_warp_plan``'s plan."""
    return _pixel_warp(img, flow, None)


def _pixel_warp(img: torch.Tensor, flow: torch.Tensor, plan: str | None) -> torch.Tensor:
    """``launch_pixel_warp`` in ``plan`` ("tiled" or "small"; None:
    pixel_warp_plan's), so that the card's checks hold each plan at every
    shape."""
    B, C, H, W = img.shape
    dtype = _check(img, flow, (B, 2, H, W), torch.float32)
    symbol = _pixel_entry(B, C, H, W) if plan is None else PIXEL_ENTRIES[plan]
    entry = getattr(build.load(), symbol)
    out = torch.empty_like(img)
    _launch("pixel_warp", img, entry, img.data_ptr(), flow.data_ptr(), out.data_ptr(), B, C, H,
            W, dtype)
    return out


def _launch_pixel_warp_s2d(img_s2d: torch.Tensor, flow: torch.Tensor, phase_flow: bool,
                           name: str) -> torch.Tensor:
    B, C4, Hs, Ws = _s2d_shape(img_s2d)
    shape = (B, 8, Hs, Ws) if phase_flow else (B, 2, 2 * Hs, 2 * Ws)
    dtype = _check(img_s2d, flow, shape, torch.float32)
    entry = build.load().fvc_pixel_warp_s2d
    out = torch.empty_like(img_s2d)
    _launch(name, img_s2d, entry, img_s2d.data_ptr(), flow.data_ptr(), out.data_ptr(), B, C4 // 4,
            Hs, Ws, int(phase_flow), dtype)
    return out


def launch_pixel_warp_s2d(img_s2d: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Full-resolution pixel warp of an s2d image: img_s2d [B, 4C, H/2, W/2],
    flow [B, 2, H, W] float32 full-res pixels; returns s2d form."""
    return _launch_pixel_warp_s2d(img_s2d, flow, False, "pixel_warp_s2d")


def launch_pixel_warp_s2d_sflow(img_s2d: torch.Tensor, flow_s2d: torch.Tensor) -> torch.Tensor:
    """Full-resolution pixel warp of an s2d image by a float32 flow in
    c-major s2d phase form [B, 8, H/2, W/2] (channel comp*4 + 2*ry + rx);
    returns s2d form."""
    return _launch_pixel_warp_s2d(img_s2d, flow_s2d, True, "pixel_warp_s2d_sflow")


def _launch_backward(bname: str, img: torch.Tensor, flow: torch.Tensor, grad: torch.Tensor,
                     need_img: bool, need_flow: bool, launch):
    """Check ``grad`` (a contiguous tensor of img's shape, dtype and device:
    the output's gradient), allocate the asked-for gradients (the image's a
    zeroed float32 buffer for the kernel's atomics, none of the image's size
    without it), run ``launch(lib, grad_img_ptr, grad_flow_ptr, stream)`` on
    img's device and count it under ``bname``: (grad_img in img's dtype,
    grad_flow), each None unless asked for."""
    if (grad.shape, grad.dtype, grad.device) != (img.shape, img.dtype, img.device) or (
            not grad.is_contiguous()):
        raise ValueError(f"grad {tuple(grad.shape)} {grad.dtype} on {grad.device} is not a "
                         f"contiguous tensor like img {tuple(img.shape)} {img.dtype}")
    lib = build.load()
    grad_img = torch.zeros(img.shape, dtype=torch.float32, device=img.device) if need_img else None
    grad_flow = torch.empty_like(flow) if need_flow else None
    _launch(bname, img, functools.partial(launch, lib), grad_img.data_ptr() if need_img else None,
            grad_flow.data_ptr() if need_flow else None)
    return (grad_img.to(img.dtype) if need_img else None), grad_flow


def _launch_flow_warp_backward(img: torch.Tensor, flow: torch.Tensor, grad: torch.Tensor,
                               need_img: bool, need_flow: bool, s2d: bool):
    B = img.shape[0]
    if s2d:
        _, C4, Hs, Ws = _s2d_shape(img)
        C, H, W = C4 // 4, 2 * Hs, 2 * Ws
    else:
        _, C, H, W = img.shape
    dtype = _check(img, flow, (B, 2, H, W))
    return _launch_backward(
        "flow_warp_s2d_backward" if s2d else "flow_warp_backward", img, flow, grad, need_img,
        need_flow, lambda lib, gi, gf, stream: lib.fvc_flow_warp_backward(
            img.data_ptr(), flow.data_ptr(), grad.data_ptr(), gi, gf, B, C, H, W, grid_norm(W),
            grid_norm(H), int(s2d), dtype, stream))


def launch_flow_warp_backward(img: torch.Tensor, flow: torch.Tensor, grad: torch.Tensor,
                              need_img: bool = True, need_flow: bool = True):
    """The vjp of ``flow_warp`` at (img [B, C, H, W], flow [B, 2, H, W]) for
    the output's gradient ``grad`` (img's shape and dtype): (grad_img,
    grad_flow), each None unless asked for. The image gradient is summed by
    float32 atomics and rounded once to img's dtype; its order changes
    from run to run."""
    return _launch_flow_warp_backward(img, flow, grad, need_img, need_flow, False)


def launch_flow_warp_s2d_backward(img_s2d: torch.Tensor, flow: torch.Tensor,
                                  grad: torch.Tensor, need_img: bool = True,
                                  need_flow: bool = True):
    """The vjp of ``flow_warp_s2d`` at (img_s2d [B, 4C, H/2, W/2], flow
    [B, 2, H, W]) for the output's gradient ``grad`` (img_s2d's shape and
    dtype), as ``launch_flow_warp_backward``."""
    return _launch_flow_warp_backward(img_s2d, flow, grad, need_img, need_flow, True)


# the layouts of the pixel warps' backward (csrc/warp.cu's PixelLayout)
_PIXEL_LAYOUT = {"pixel_warp": 0, "pixel_warp_s2d": 1, "pixel_warp_s2d_sflow": 2}


def _launch_pixel_warp_backward(name: str, img: torch.Tensor, flow: torch.Tensor,
                                grad: torch.Tensor, need_img: bool, need_flow: bool):
    layout = _PIXEL_LAYOUT[name]
    if layout == 0:
        B, C, H, W = img.shape
        flow_shape = (B, 2, H, W)
    else:
        B, C4, Hs, Ws = _s2d_shape(img)
        C, H, W = C4 // 4, 2 * Hs, 2 * Ws
        flow_shape = (B, 8, Hs, Ws) if layout == 2 else (B, 2, H, W)
    dtype = _check(img, flow, flow_shape, torch.float32)
    return _launch_backward(
        f"{name}_backward", img, flow, grad, need_img, need_flow,
        lambda lib, gi, gf, stream: lib.fvc_pixel_warp_backward(
            img.data_ptr(), flow.data_ptr(), grad.data_ptr(), gi, gf, B, C, H, W, layout, dtype,
            stream))


def launch_pixel_warp_backward(img: torch.Tensor, flow: torch.Tensor, grad: torch.Tensor,
                               need_img: bool = True, need_flow: bool = True):
    """The vjp of ``pixel_warp`` at (img [B, C, H, W], flow [B, 2, H, W]
    float32) for the output's gradient ``grad`` (img's shape and dtype):
    (grad_img in img's dtype, grad_flow float32), each None unless asked
    for. The image gradient is summed by float32 atomics and rounded once
    to img's dtype; its order changes from run to run. Without it nothing
    of the image's size is allocated."""
    return _launch_pixel_warp_backward("pixel_warp", img, flow, grad, need_img, need_flow)


def launch_pixel_warp_s2d_backward(img_s2d: torch.Tensor, flow: torch.Tensor,
                                   grad: torch.Tensor, need_img: bool = True,
                                   need_flow: bool = True):
    """The vjp of ``pixel_warp_s2d`` at (img_s2d [B, 4C, H/2, W/2], flow
    [B, 2, H, W] float32), as ``launch_pixel_warp_backward``."""
    return _launch_pixel_warp_backward("pixel_warp_s2d", img_s2d, flow, grad, need_img,
                                       need_flow)


def launch_pixel_warp_s2d_sflow_backward(img_s2d: torch.Tensor, flow_s2d: torch.Tensor,
                                         grad: torch.Tensor, need_img: bool = True,
                                         need_flow: bool = True):
    """The vjp of ``pixel_warp_s2d_sflow`` at (img_s2d [B, 4C, H/2, W/2],
    flow_s2d [B, 8, H/2, W/2] float32 in c-major phase form), as
    ``launch_pixel_warp_backward``: the flow gradient in the phase form."""
    return _launch_pixel_warp_backward("pixel_warp_s2d_sflow", img_s2d, flow_s2d, grad,
                                       need_img, need_flow)
