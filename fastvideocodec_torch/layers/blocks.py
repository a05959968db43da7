"""Building blocks (NCHW), ported from fastvideocodec_tpu/layers/blocks.py:
ResBlock, the WarpNet motion-compensation U-net and the MEBasic SpyNet
level of the LSVC-TPU path, and the forward of QReLU for the SSF
hyper decoders."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fastvideocodec_torch.ops.warp import avg_pool2, bilinear_upsample_x2_ac


def conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    """k x k conv with the flax ``padding=k//2`` geometry."""
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2)


class ResBlock(nn.Module):
    """relu-conv-relu-conv residual block; a 1x1 conv matches the skip's
    channels when they differ."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3):
        super().__init__()
        self.Conv_0 = conv(in_channels, out_channels, kernel_size)
        self.Conv_1 = conv(out_channels, out_channels, kernel_size)
        self.Conv_2 = conv(in_channels, out_channels, 1) if in_channels != out_channels else None

    def forward(self, x):
        h = self.Conv_1(F.relu(self.Conv_0(F.relu(x))))
        if self.Conv_2 is not None:
            x = self.Conv_2(x)
        return x + h


class WarpNet(nn.Module):
    """Motion-compensation refinement U-net: concat(warped, ref) ->
    correction to the warped frame."""

    def __init__(self, in_channels: int, out_channels: int = 3, width: int = 64):
        super().__init__()
        w = width
        self.Conv_0 = conv(in_channels, w, 3)
        for i in range(6):
            self.add_module(f"ResBlock_{i}", ResBlock(w, w))
        self.Conv_1 = conv(w, out_channels, 3)

    def forward(self, x):
        f = F.relu(self.Conv_0(x))
        c0 = self.ResBlock_0(f)
        c1 = self.ResBlock_1(avg_pool2(c0))
        c2 = self.ResBlock_2(avg_pool2(c1))
        c3 = self.ResBlock_3(c2)
        c3_u = c1 + bilinear_upsample_x2_ac(c3)
        c4 = self.ResBlock_4(c3_u)
        c4_u = c0 + bilinear_upsample_x2_ac(c4)
        c5 = self.ResBlock_5(c4_u)
        return self.Conv_1(c5)


class MEBasic(nn.Module):
    """One SpyNet refinement level: relu convs of `widths`, then an output conv."""

    def __init__(self, in_channels: int, widths: tuple = (32, 64, 32, 16),
                 kernel: int = 7, out_channels: int = 2):
        super().__init__()
        self.n = len(widths)
        cin = in_channels
        for i, w in enumerate(widths):
            self.add_module(f"Conv_{i}", conv(cin, w, kernel))
            cin = w
        self.add_module(f"Conv_{self.n}", conv(cin, out_channels, kernel))

    def forward(self, x):
        for i in range(self.n):
            x = F.relu(getattr(self, f"Conv_{i}")(x))
        return getattr(self, f"Conv_{self.n}")(x)


def qrelu(x: torch.Tensor) -> torch.Tensor:
    """clamp(x, 0, 255): the forward of compressai's QReLU at 8 bits. Its
    smooth surrogate gradient waits for training."""
    return torch.clamp(x, 0.0, 255.0)
