"""Learned factorized CDF ("BitEstimator"), ported from
fastvideocodec_tpu/entropy/bit_estimator.py.

A 4-layer monotone per-channel net F(x) on NCHW latents; the symbol
probability is F(x + 0.5) - F(x - 0.5). Computed in float32.
"""

from __future__ import annotations

import torch
from torch import nn


class Bitparm(nn.Module):
    """x*softplus(h) + b, then + tanh(x)*tanh(a) (or sigmoid if final)."""

    def __init__(self, channels: int, final: bool = False):
        super().__init__()
        self.final = final
        self.h = nn.Parameter(torch.zeros(channels))
        self.b = nn.Parameter(torch.zeros(channels))
        if not final:
            self.a = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def per_channel(p):
            return p.float()[None, :, None, None]

        h = per_channel(self.h)
        x = x * torch.logaddexp(h, torch.zeros_like(h)) + per_channel(self.b)
        if self.final:
            return torch.sigmoid(x)
        return x + torch.tanh(x) * torch.tanh(per_channel(self.a))


class BitEstimator(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.f1 = Bitparm(channels)
        self.f2 = Bitparm(channels)
        self.f3 = Bitparm(channels)
        self.f4 = Bitparm(channels, final=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.f4(self.f3(self.f2(self.f1(x))))

    def likelihood(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        return self(x + 0.5) - self(x - 0.5)

    def numpy_params(self) -> dict:
        """{'f1': {'h', 'b', 'a'}, ..., 'f4': {'h', 'b'}} as float32 numpy
        arrays: the flax names, as the real-bits coder's tables take them."""
        return {name: {k: p.detach().float().cpu().numpy() for k, p in f.named_parameters()}
                for name, f in self.named_children()}
