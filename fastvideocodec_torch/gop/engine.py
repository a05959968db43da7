"""GOP rollout of the port: the LSVC whole-GOP call of
fastvideocodec_tpu/gop/engine.py (``lsvc_gop`` / ``rollout``)."""

from __future__ import annotations

import torch

from fastvideocodec_torch.models.registry import CodecSpec
from fastvideocodec_torch.ops.math import psnr_from_mse


@torch.inference_mode()
def lsvc_gop(spec: CodecSpec, gop: torch.Tensor):
    """gop [T, 3, H, W] with frame 0 the I-frame -> (recon [T-1, 3, H, W],
    metrics). Metrics are float32: the model's losses and bpp, plus
    per-frame ``psnr``, ``mc_psnr`` and ``warp_psnr`` ([T-1])."""
    com, mc, warped, metrics = spec.module(gop)
    target = gop[1:].float()

    def per_frame_psnr(frames):
        return psnr_from_mse(torch.mean((frames.float() - target) ** 2, dim=(1, 2, 3)))

    metrics["psnr"] = per_frame_psnr(com)
    metrics["mc_psnr"] = per_frame_psnr(mc)
    metrics["warp_psnr"] = per_frame_psnr(warped)
    return com, metrics


def rollout(spec: CodecSpec, gop: torch.Tensor):
    """Estimated-bits encode+decode of one GOP (eval mode)."""
    if spec.family != "lsvc":
        raise ValueError(f"family {spec.family!r} is not ported yet")
    return lsvc_gop(spec, gop)
