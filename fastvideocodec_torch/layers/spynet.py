"""SPyNet coarse-to-fine optical flow (NCHW), ported from
fastvideocodec_tpu/layers/spynet.py.

A LEVELS-deep avg-pool pyramid; each level refines the x2-upsampled
(and x2-scaled) flow with a MEBasic block fed [target, warp(ref, up), up].
The finest ``s2d_levels`` levels run their block in the space-to-depth
domain and emit the full-resolution refinement through 8 polyphase
channels (LSVC-TPU's 2; the stock SpyNet of DVC, RLVC and Base has none).
``forward(im1, im2)`` returns the flow with flow_warp(im2, flow) ~= im1.
The level warp is the hand-written ``flow_warp`` kernel on CUDA tensors.

``load_pretrained_spynet`` loads the reference's pretrained SpyNet
(``spynet.npz``: 4 levels, 7x7 kernels, widths 32/64/32/16) into a
module.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
from torch import nn

from fastvideocodec_torch.layers.blocks import MEBasic
from fastvideocodec_torch.ops.warp import (
    avg_pool2,
    bilinear_upsample_x2,
    depth_to_space,
    flow_warp,
    space_to_depth,
)


LEVELS = 4
S2D_LEVELS = 2  # the default: LSVC-TPU's
PRETRAINED = Path(__file__).resolve().parents[2] / "fastvideocodec_tpu" / "assets" / "spynet.npz"


class SpyNet(nn.Module):
    """``kernels``: each level's MEBasic kernel size, coarsest first."""

    def __init__(self, widths: tuple = (32, 64, 32, 16), kernels: tuple = (5, 5, 3, 3),
                 s2d_levels: int = S2D_LEVELS):
        super().__init__()
        self.s2d_levels = s2d_levels
        for lvl in range(LEVELS):
            s2d = lvl >= LEVELS - s2d_levels
            self.add_module(
                f"level{lvl + 1}",
                MEBasic(32 if s2d else 8, widths, kernels[lvl], 8 if s2d else 2),
            )

    def forward(self, im1: torch.Tensor, im2: torch.Tensor) -> torch.Tensor:
        """im1: target [B, 3, H, W]; im2: reference. Returns [B, 2, H, W]."""
        L = LEVELS
        im1s, im2s = [im1], [im2]
        for _ in range(L - 1):
            im1s.append(avg_pool2(im1s[-1]))
            im2s.append(avg_pool2(im2s[-1]))
        B, _, Hc, Wc = im2s[-1].shape
        flow = torch.zeros((B, 2, Hc // 2, Wc // 2), dtype=im1.dtype, device=im1.device)
        for lvl in range(L):
            up = bilinear_upsample_x2(flow) * 2.0
            tgt, ref = im1s[L - 1 - lvl], im2s[L - 1 - lvl]
            inp = torch.cat([tgt, flow_warp(ref, up), up], dim=1)
            block = getattr(self, f"level{lvl + 1}")
            if lvl >= L - self.s2d_levels:
                flow = up + depth_to_space(block(space_to_depth(inp, 2)), 2)
            else:
                flow = up + block(inp)
        return flow


def load_pretrained_spynet(spynet: SpyNet) -> SpyNet:
    """Copy the weights of PRETRAINED onto ``spynet`` (4 levels, 7x7,
    widths 32/64/32/16, no s2d level): the npz maps 'L{level}_F{conv}_
    {weight,bias}' (level 1..4, conv 1..5, weights OIHW, as the port holds
    them) to ``level{level}.Conv_{conv - 1}``."""
    with np.load(PRETRAINED) as data:
        with torch.no_grad():
            for lvl in range(1, 5):
                for ci in range(1, 6):
                    conv = getattr(getattr(spynet, f"level{lvl}"), f"Conv_{ci - 1}")
                    for kind in ("weight", "bias"):
                        value = torch.from_numpy(data[f"L{lvl}_F{ci}_{kind}"].astype(np.float32))
                        target = getattr(conv, kind)
                        if tuple(target.shape) != tuple(value.shape):
                            raise ValueError(f"L{lvl}_F{ci}_{kind}: shape {tuple(value.shape)} "
                                             f"does not fit {tuple(target.shape)}")
                        target.copy_(value)
    return spynet
