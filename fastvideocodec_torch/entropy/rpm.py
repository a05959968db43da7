"""The recurrent probability model of RLVC at eval time, ported from
fastvideocodec_tpu/entropy/rpm.py (reference entropy_models.py:26-148,
328-357).

``RPM``: from the previous frame's quantized latent and its hidden state,
four ReLU convs, a ConvLSTM, three ReLU convs and a ReLU'd conv to 2C
channels, split (sigma_raw, mu). The last ReLU is the reference's: mu is
never negative.

``RecProbModel``: the first P-frame's latent is coded by the factorized
bottleneck; later frames' by a Gaussian with the RPM's means and scales
sigma = exp(max(sigma_raw, -7)) / 10, and only those frames advance the RPM
state. The JAX module runs both branches and selects with ``jnp.where`` so
that a scan can carry a traced flag; the port is eager, takes a Python
bool and runs only the selected branch, with the same outputs. The next
prior is round(latent), as the JAX rollout takes it (its real-bits coder
takes round(latent_hat) instead; coder/video.py mirrors that there).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fastvideocodec_torch.entropy.factorized import EntropyBottleneck
from fastvideocodec_torch.entropy.gaussian import GaussianConditional
from fastvideocodec_torch.layers.blocks import ConvLSTM, conv
from fastvideocodec_torch.ops.math import quantize


def rpm_sigma(sigma_raw: torch.Tensor) -> torch.Tensor:
    """The RPM's Gaussian scales, exp(max(sigma_raw, -7)) / 10, in
    sigma_raw's dtype."""
    return torch.exp(torch.clamp(sigma_raw, min=-7.0)) / 10.0


class RPM(nn.Module):
    """forward(prior_latent [B, C, h, w], hidden [B, 2C, h, w]) ->
    (sigma_raw, mu, new hidden)."""

    def __init__(self, channels: int = 128):
        super().__init__()
        c = channels
        for i in range(7):
            self.add_module(f"Conv_{i}", conv(c, c, 3))
        self.ConvLSTM_0 = ConvLSTM(c)
        self.add_module("Conv_7", conv(c, 2 * c, 3))

    def forward(self, x, hidden):
        for i in range(4):
            x = F.relu(getattr(self, f"Conv_{i}")(x))
        x, hidden = self.ConvLSTM_0(x, hidden)
        for i in range(4, 7):
            x = F.relu(getattr(self, f"Conv_{i}")(x))
        sigma, mu = F.relu(self.Conv_7(x)).chunk(2, dim=1)
        return sigma, mu, hidden


class RecProbModel(nn.Module):
    def __init__(self, channels: int = 128):
        super().__init__()
        self.rpm = RPM(channels)
        self.bottleneck = EntropyBottleneck(channels)
        self.gaussian = GaussianConditional()

    def forward(self, x, rpm_hidden, rpm_flag: bool, prior_latent):
        """(x_hat, likelihoods, new hidden, new prior, sigma, mu); sigma and
        mu are None on the factorized frame. x_hat is float32 on the
        factorized frame (the bottleneck's), in x's dtype on the Gaussian
        ones; the likelihoods are float32."""
        new_prior = quantize(x)
        if not rpm_flag:
            x_hat, lik = self.bottleneck(x)
            return x_hat, lik, rpm_hidden, new_prior, None, None
        sigma_raw, mu, rpm_hidden = self.rpm(prior_latent.to(x.dtype), rpm_hidden)
        sigma = rpm_sigma(sigma_raw)
        x_hat, lik = self.gaussian(x, sigma, mu)
        return x_hat, lik, rpm_hidden, new_prior, sigma, mu

    def aux_loss(self) -> torch.Tensor:
        """The bottleneck's quantile loss."""
        return self.bottleneck.aux_loss()
