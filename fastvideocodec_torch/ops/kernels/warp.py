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
``ops.warp.KernelWarp`` when autograd needs one.

All five are tiled: a block owns a tile of outputs. The three s2d warps
share one kernel body, and ``flow_warp_s2d``'s block stages the tile's
source footprint in shared memory when it fits a budget.
``tile_constants()`` reads that tile and budget from warp.cu itself, for
``ops.warp.staged_tiles``.
"""

from __future__ import annotations

import contextlib
import functools
import re

import numpy as np
import torch

from fastvideocodec_torch.ops.kernels import build

LAUNCHES = {
    "flow_warp": 0,
    "flow_warp_s2d": 0,
    "pixel_warp": 0,
    "pixel_warp_s2d": 0,
    "pixel_warp_s2d_sflow": 0,
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def tile_constants() -> dict:
    """warp.cu's constants written as plain numbers (``constexpr int kName =
    123;``), by name: among them kAlign, kS2dRows, kS2dCols and
    kS2dStageElems, the s2d kernel's staging rule. Read from the source the
    kernels are built from, so the host's copy of the rule cannot drift."""
    text = build.SOURCE.read_text()
    return {name: int(v) for name, v in re.findall(r"constexpr int (k\w+) = (\d+);", text)}


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
    return the kernels' dtype code of img."""
    if img.device.type != "cuda" or flow.device != img.device:
        raise ValueError(
            f"warp kernel needs img and flow on one CUDA device, got {img.device} "
            f"and {flow.device}"
        )
    want = img.dtype if flow_dtype is None else flow_dtype
    if img.dtype not in _DTYPES or flow.dtype != want:
        raise TypeError(
            f"warp kernel takes a float32 or bfloat16 img and a {want} flow, got "
            f"{img.dtype} and {flow.dtype}"
        )
    if img.dim() != 4 or tuple(flow.shape) != tuple(flow_shape):
        raise ValueError(
            f"flow {tuple(flow.shape)} does not match img {tuple(img.shape)}: want "
            f"{tuple(flow_shape)}"
        )
    if not (img.is_contiguous() and flow.is_contiguous()):
        raise ValueError("warp kernel needs contiguous img and flow")
    return _DTYPES[img.dtype]


def _s2d_shape(img_s2d: torch.Tensor) -> tuple:
    if img_s2d.dim() != 4 or img_s2d.shape[1] % 4:
        raise ValueError(f"s2d image needs shape [B, 4C, H/2, W/2], got {tuple(img_s2d.shape)}")
    return tuple(img_s2d.shape)


def _on_device(t: torch.Tensor):
    """A kernel launches in the current device's context: switch to t's
    device only when it is another (the switch costs the host a few
    microseconds a launch)."""
    if t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


def _raise_if_failed(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def launch_flow_warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Bilinear backward warp, img [B, C, H, W], flow [B, 2, H, W] pixels."""
    B, C, H, W = img.shape
    dtype = _check(img, flow, (B, 2, H, W))
    lib = build.load()
    out = torch.empty_like(img)
    with _on_device(img):
        rc = lib.fvc_flow_warp(
            img.data_ptr(), flow.data_ptr(), out.data_ptr(), B, C, H, W,
            grid_norm(W), grid_norm(H), dtype, torch.cuda.current_stream().cuda_stream,
        )
    _raise_if_failed(rc, "flow_warp")
    LAUNCHES["flow_warp"] += 1
    return out


def launch_flow_warp_s2d(img_s2d: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Full-resolution warp of an s2d image: img_s2d [B, 4C, H/2, W/2],
    flow [B, 2, H, W] full-res pixels; returns the warped image in s2d form."""
    B, C4, Hs, Ws = _s2d_shape(img_s2d)
    dtype = _check(img_s2d, flow, (B, 2, 2 * Hs, 2 * Ws))
    lib = build.load()
    out = torch.empty_like(img_s2d)
    with _on_device(img_s2d):
        rc = lib.fvc_flow_warp_s2d(
            img_s2d.data_ptr(), flow.data_ptr(), out.data_ptr(), B, C4 // 4, Hs, Ws,
            grid_norm(2 * Ws), grid_norm(2 * Hs), dtype, torch.cuda.current_stream().cuda_stream,
        )
    _raise_if_failed(rc, "flow_warp_s2d")
    LAUNCHES["flow_warp_s2d"] += 1
    return out


def launch_pixel_warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Pixel-displacement warp (source = output + flow), img [B, C, H, W],
    flow [B, 2, H, W] float32."""
    B, C, H, W = img.shape
    dtype = _check(img, flow, (B, 2, H, W), torch.float32)
    lib = build.load()
    out = torch.empty_like(img)
    with _on_device(img):
        rc = lib.fvc_pixel_warp(
            img.data_ptr(), flow.data_ptr(), out.data_ptr(), B, C, H, W, dtype,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_if_failed(rc, "pixel_warp")
    LAUNCHES["pixel_warp"] += 1
    return out


def _launch_pixel_warp_s2d(img_s2d: torch.Tensor, flow: torch.Tensor, phase_flow: bool,
                           name: str) -> torch.Tensor:
    B, C4, Hs, Ws = _s2d_shape(img_s2d)
    shape = (B, 8, Hs, Ws) if phase_flow else (B, 2, 2 * Hs, 2 * Ws)
    dtype = _check(img_s2d, flow, shape, torch.float32)
    lib = build.load()
    out = torch.empty_like(img_s2d)
    with _on_device(img_s2d):
        rc = lib.fvc_pixel_warp_s2d(
            img_s2d.data_ptr(), flow.data_ptr(), out.data_ptr(), B, C4 // 4, Hs, Ws,
            int(phase_flow), dtype, torch.cuda.current_stream().cuda_stream,
        )
    _raise_if_failed(rc, name)
    LAUNCHES[name] += 1
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
