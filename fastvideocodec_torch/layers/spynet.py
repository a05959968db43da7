"""SPyNet coarse-to-fine optical flow (NCHW), ported from
fastvideocodec_tpu/layers/spynet.py.

A LEVELS-deep avg-pool pyramid; each level refines the x2-upsampled (and
x2-scaled) flow with a MEBasic block fed [target, warp(ref, up), up]. The
finest S2D_LEVELS levels run their block in the space-to-depth domain and
emit the full-resolution refinement through 8 polyphase channels.
``forward(im1, im2)`` returns the flow with flow_warp(im2, flow) ~= im1.
The level warp is the hand-written ``flow_warp`` kernel on CUDA tensors.
"""

from __future__ import annotations

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
S2D_LEVELS = 2


class SpyNet(nn.Module):
    def __init__(self, widths: tuple = (32, 64, 32, 16), kernels: tuple = (5, 5, 3, 3)):
        super().__init__()
        for lvl in range(LEVELS):
            s2d = lvl >= LEVELS - S2D_LEVELS
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
            if lvl >= L - S2D_LEVELS:
                flow = up + depth_to_space(block(space_to_depth(inp, 2)), 2)
            else:
                flow = up + block(inp)
        return flow
