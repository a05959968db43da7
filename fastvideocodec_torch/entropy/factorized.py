"""Factorized entropy bottleneck at eval time, ported from
fastvideocodec_tpu/entropy/factorized.py (Balle et al. 2018, appendix 6.1).

A per-channel non-parametric cumulative F(x) of K = 5 monotone layers.
Eval rounds to the channel median; the likelihood is the sigmoid
difference of the cumulative logits with the sign trick, bounded below at
1e-9. Parameters keep the flax names and shapes (``matrix_i``, ``bias_i``,
``factor_i``, ``quantiles``), so checkpoints load with no renaming. Computed
in float32 whatever the activation dtype. The aux loss and the coder's CDF
tables wait for training and real bits.
"""

from __future__ import annotations

import torch
from torch import nn

from fastvideocodec_torch.ops.math import LIKELIHOOD_LOWER_BOUND, lower_bound

FILTERS = (3, 3, 3, 3)


class EntropyBottleneck(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.channels = channels
        filters = (1, *FILTERS, 1)
        self.K = len(FILTERS) + 1
        for i in range(self.K):
            shape = (channels, filters[i + 1])
            self.register_parameter(
                f"matrix_{i}", nn.Parameter(torch.zeros(*shape, filters[i]))
            )
            self.register_parameter(f"bias_{i}", nn.Parameter(torch.zeros(*shape, 1)))
            if i < self.K - 1:
                self.register_parameter(f"factor_{i}", nn.Parameter(torch.zeros(*shape, 1)))
        self.quantiles = nn.Parameter(torch.zeros(channels, 1, 3))

    def _logits_cumulative(self, x: torch.Tensor) -> torch.Tensor:
        """x: [C, 1, N] -> logits [C, 1, N]."""
        logits = x
        for i in range(self.K):
            m = getattr(self, f"matrix_{i}")
            m = torch.logaddexp(m, torch.zeros_like(m))  # softplus
            logits = torch.bmm(m, logits) + getattr(self, f"bias_{i}")
            if i < self.K - 1:
                logits = logits + torch.tanh(getattr(self, f"factor_{i}")) * torch.tanh(logits)
        return logits

    def forward(self, x: torch.Tensor):
        """x [B, C, H, W] -> (x_hat, likelihoods), both float32 [B, C, H, W]."""
        medians = self.quantiles[:, 0, 1][None, :, None, None]
        x_hat = torch.round(x.float() - medians) + medians
        # channel-major flattening for the per-channel cumulative
        v = x_hat.transpose(0, 1).reshape(self.channels, 1, -1)
        lower = self._logits_cumulative(v - 0.5)
        upper = self._logits_cumulative(v + 0.5)
        sign = -torch.sign(lower + upper)
        likelihood = torch.abs(torch.sigmoid(sign * upper) - torch.sigmoid(sign * lower))
        likelihood = lower_bound(likelihood, LIKELIHOOD_LOWER_BOUND)
        shape = (self.channels, x.shape[0], *x.shape[2:])
        return x_hat, likelihood.reshape(shape).transpose(0, 1)
