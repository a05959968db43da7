"""Launchers of the CUDA warp kernels (csrc/warp.cu), each with a launch count.

A launcher checks its CUDA tensors and launches its kernel on the current
stream, or raises. ``flow_warp`` and ``flow_warp_fullres_s2d`` in
ops/warp.py call these for CUDA tensors and the plain versions beside them
for CPU tensors.

``LAUNCHES[name]`` grows by one at each kernel launch and nowhere else, so
a run can show that it went through the kernels; ``reset_launches()``
zeroes the counts.
"""

from __future__ import annotations

import numpy as np
import torch

from fastvideocodec_torch.ops.kernels import build

LAUNCHES = {"flow_warp": 0, "flow_warp_s2d": 0}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def grid_norm(size: int) -> float:
    """2/(size-1) rounded to float32: the pixel-to-normalized flow scale,
    shared by the kernels and the plain versions."""
    return float(np.float32(2.0 / max(size - 1, 1)))


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(img: torch.Tensor, flow: torch.Tensor, flow_hw: tuple) -> int:
    if img.device.type != "cuda" or flow.device != img.device:
        raise ValueError(
            f"warp kernel needs img and flow on one CUDA device, got {img.device} "
            f"and {flow.device}"
        )
    if img.dtype not in _DTYPES or flow.dtype != img.dtype:
        raise TypeError(
            f"warp kernel takes float32 or bfloat16 img and flow of one dtype, got "
            f"{img.dtype} and {flow.dtype}"
        )
    if img.dim() != 4 or flow.dim() != 4 or flow.shape[1] != 2:
        raise ValueError(f"bad shapes img {tuple(img.shape)} flow {tuple(flow.shape)}")
    if flow.shape[0] != img.shape[0] or tuple(flow.shape[2:]) != flow_hw:
        raise ValueError(
            f"flow {tuple(flow.shape)} does not match img {tuple(img.shape)}"
        )
    if not (img.is_contiguous() and flow.is_contiguous()):
        raise ValueError("warp kernel needs contiguous img and flow")
    return _DTYPES[img.dtype]


def _raise_if_failed(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def launch_flow_warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Bilinear backward warp, img [B, C, H, W], flow [B, 2, H, W] pixels."""
    B, C, H, W = img.shape
    dtype = _check(img, flow, (H, W))
    lib = build.load()
    out = torch.empty_like(img)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fvc_flow_warp(
            img.data_ptr(), flow.data_ptr(), out.data_ptr(), B, C, H, W,
            grid_norm(W), grid_norm(H), dtype, stream,
        )
    _raise_if_failed(rc, "flow_warp")
    LAUNCHES["flow_warp"] += 1
    return out


def launch_flow_warp_s2d(img_s2d: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Full-resolution warp of an s2d image: img_s2d [B, 4C, H/2, W/2],
    flow [B, 2, H, W] full-res pixels; returns the warped image in s2d form."""
    B, C4, Hs, Ws = img_s2d.shape
    if C4 % 4:
        raise ValueError(f"s2d image needs 4C channels, got {C4}")
    dtype = _check(img_s2d, flow, (2 * Hs, 2 * Ws))
    lib = build.load()
    out = torch.empty_like(img_s2d)
    with torch.cuda.device(img_s2d.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fvc_flow_warp_s2d(
            img_s2d.data_ptr(), flow.data_ptr(), out.data_ptr(), B, C4 // 4, Hs, Ws,
            grid_norm(2 * Ws), grid_norm(2 * Hs), dtype, stream,
        )
    _raise_if_failed(rc, "flow_warp_s2d")
    LAUNCHES["flow_warp_s2d"] += 1
    return out
