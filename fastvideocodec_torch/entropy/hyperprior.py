"""The SSF-family hyperprior at eval time, ported from
fastvideocodec_tpu/entropy/hyperprior.py (``SSFHyperprior`` without
``super_prec``; reference models.py:1958-1999).

y -> hyper encoder -> z; z is coded by the factorized bottleneck; the mean
and QReLU-scale hyper decoders give the Gaussian parameters of y, cropped
to y's size (the three stride-2 deconvs emit 8*ceil(y/8) pixels); y_hat is
the round of y around the means, in y's dtype, and y's rate is the float32
likelihood of that same symbol.
"""

from __future__ import annotations

import torch
from torch import nn

from fastvideocodec_torch.entropy.factorized import EntropyBottleneck
from fastvideocodec_torch.entropy.gaussian import GaussianConditional
from fastvideocodec_torch.layers.transforms import (
    SSFEncoder,
    SSFHyperDecoder,
    SSFHyperDecoderQReLU,
)


class SSFHyperprior(nn.Module):
    """Every stage of the hyper path is ``planes`` wide."""

    def __init__(self, planes: int = 192):
        super().__init__()
        self.bottleneck = EntropyBottleneck(planes)
        self.hyper_encoder = SSFEncoder(planes, planes, planes)
        self.hyper_decoder_mean = SSFHyperDecoder(planes)
        self.hyper_decoder_scale = SSFHyperDecoderQReLU(planes)
        self.gaussian = GaussianConditional()

    def forward(self, y: torch.Tensor):
        """y [B, C, h, w] -> (y_hat in y's dtype, {"y": likelihoods of y,
        "z": likelihoods of z}, float32)."""
        z_hat, z_lik = self.bottleneck(self.hyper_encoder(y))
        means, scales = self.means_scales(z_hat.to(y.dtype), *y.shape[2:])
        y_hat, y_lik = self.gaussian(y, scales, means)
        return y_hat, {"y": y_lik, "z": z_lik}

    def means_scales(self, z_hat: torch.Tensor, h: int, w: int):
        """The Gaussian parameters of y from the decoded z (in y's dtype),
        cropped to y's h x w."""
        scales = self.hyper_decoder_scale(z_hat)[:, :, :h, :w]
        means = self.hyper_decoder_mean(z_hat)[:, :, :h, :w]
        return means, scales
