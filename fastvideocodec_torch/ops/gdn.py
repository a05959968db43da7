"""Generalized Divisive Normalization, ported from fastvideocodec_tpu/ops/gdn.py.

y[i] = x[i] / sqrt(beta[i] + sum_j gamma[i, j] * x[j]^2)   (forward)
y[i] = x[i] * sqrt(...)                                    (inverse)

beta and gamma are stored reparameterized (sqrt(value + pedestal)) and
lower-bounded before squaring, in float32. With bfloat16 activations the
squares are rounded to bfloat16, gamma is rounded to bfloat16 and the
channel sum is taken in float32, as the JAX package's bf16 branch does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fastvideocodec_torch.ops.math import lower_bound


class GDN(nn.Module):
    def __init__(self, channels: int, inverse: bool = False, beta_min: float = 1e-6,
                 gamma_init: float = 0.1, reparam_offset: float = 2 ** -18):
        super().__init__()
        self.inverse = inverse
        self.pedestal = reparam_offset ** 2
        self.beta_bound = (beta_min + self.pedestal) ** 0.5
        self.gamma_bound = reparam_offset
        self.beta = nn.Parameter(torch.sqrt(torch.ones(channels) + self.pedestal))
        self.gamma = nn.Parameter(
            torch.sqrt(gamma_init * torch.eye(channels) + self.pedestal)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        beta = lower_bound(self.beta.float(), self.beta_bound) ** 2 - self.pedestal
        gamma = lower_bound(self.gamma.float(), self.gamma_bound) ** 2 - self.pedestal
        if x.dtype == torch.bfloat16:
            gamma = gamma.to(torch.bfloat16).float()
        norm = F.conv2d((x * x).float(), gamma[:, :, None, None])
        norm = torch.sqrt(norm + beta[None, :, None, None]).to(x.dtype)
        return x * norm if self.inverse else x / norm
