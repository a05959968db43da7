"""The hyperpriors, ported from
fastvideocodec_tpu/entropy/hyperprior.py: ``MeanScaleHyperPriors``, RLVC-HP's
(reference entropy_models.py:150-324), and the SSF family's
``SSFHyperprior`` (reference models.py:1958-1999).

MeanScaleHyperPriors: a stride-1 hyper analysis (four 3x3 convs,
LeakyReLU(0.01) between) gives z at x's size, coded by a factorized
bottleneck; the hyper synthesis (three convs with LeakyReLU(0.01), a conv
to 2C) gives (sigma_raw, mu), sigma = exp(max(sigma_raw, -7)) (no /10,
unlike the RPM's), and x is coded Gaussian with those means. In training
z and x take noise from an explicit source, z's draw first.

SSFHyperprior:
y -> hyper encoder -> z; z is coded by the factorized bottleneck; the mean
and QReLU-scale hyper decoders give the Gaussian parameters of y, cropped
to y's size (the three stride-2 deconvs emit 8*ceil(y/8) pixels); y_hat is
the round of y around the means, in y's dtype, and y's rate is the float32
likelihood of that same symbol. In training (``SSFHyperprior`` only, the
SSF and ELFVC families') z and y take noise from an explicit source, z's
draw first: the rates are the likelihoods of the noisy z and y, while the
decoders take y_hat = quantize_ste(y - means) + means, the round with a
straight-through gradient.

With ``super_prec`` (ELFVC-SP) the hyperprior also holds an SPnet,
``y_predictor``, that predicts y from the symbol round(y - means) and the
previous frame's symbol (``q_y_prior``); with ``sp`` the decoders take that
prediction in place of y_hat. As in the JAX package, the prediction adds
the means detached, its error is taken against y detached, and the
decoders take it detached: the SPnet learns from its error alone.
``forward_with_prior`` is the JAX module's ``__call__`` with its prior;
``forward`` is the SSF codecs' call.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fastvideocodec_torch.entropy.factorized import EntropyBottleneck
from fastvideocodec_torch.entropy.gaussian import GaussianConditional
from fastvideocodec_torch.layers.blocks import SPnet, conv
from fastvideocodec_torch.layers.transforms import (
    SSFEncoder,
    SSFHyperDecoder,
    SSFHyperDecoderQReLU,
)
from fastvideocodec_torch.ops.math import quantize, quantize_ste


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.01)


class MeanScaleHyperPriors(nn.Module):
    def __init__(self, channels: int = 128):
        super().__init__()
        c = channels
        self.bottleneck = EntropyBottleneck(c)
        self.gaussian = GaussianConditional()
        for i in range(4):
            self.add_module(f"h_a_{i}", conv(c, c, 3))
            self.add_module(f"h_s_{i}", conv(c, 2 * c if i == 3 else c, 3))

    def hyper_encode(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(3):
            x = _lrelu(getattr(self, f"h_a_{i}")(x))
        return self.h_a_3(x)

    def hyper_decode(self, z_hat: torch.Tensor):
        """z_hat (in the model dtype) -> (sigma, mu)."""
        for i in range(3):
            z_hat = _lrelu(getattr(self, f"h_s_{i}")(z_hat))
        sigma_raw, mu = self.h_s_3(z_hat).chunk(2, dim=1)
        return torch.exp(torch.clamp(sigma_raw, min=-7.0)), mu

    def forward(self, x: torch.Tensor, training: bool = False, noise=None):
        """x -> (x_hat in x's dtype, (x likelihoods, z likelihoods), sigma,
        mu); the likelihoods float32, both of x's shape. ``training`` draws
        the noise of z, then of x, from ``noise``."""
        z = self.hyper_encode(x)
        z_hat, z_lik = self.bottleneck(z, True, noise) if training else self.bottleneck(z)
        sigma, mu = self.hyper_decode(z_hat.to(x.dtype))
        x_hat, x_lik = self.gaussian(x, sigma, mu, training, noise)
        return x_hat, (x_lik, z_lik), sigma, mu

    def aux_loss(self) -> torch.Tensor:
        """The bottleneck's quantile loss."""
        return self.bottleneck.aux_loss()


class SSFHyperprior(nn.Module):
    """Every stage of the hyper path is ``planes`` wide; the SPnet's trunk
    is ``8 * sp_dim``."""

    def __init__(self, planes: int = 192, super_prec: bool = False, sp: bool = False,
                 sp_dim: int = 64):
        super().__init__()
        self.bottleneck = EntropyBottleneck(planes)
        self.hyper_encoder = SSFEncoder(planes, planes, planes)
        self.hyper_decoder_mean = SSFHyperDecoder(planes)
        self.hyper_decoder_scale = SSFHyperDecoderQReLU(planes)
        self.gaussian = GaussianConditional()
        self.sp = sp
        self.y_predictor = SPnet(2 * planes, planes, sp_dim) if super_prec else None

    def _forward(self, y: torch.Tensor, training: bool, noise):
        z = self.hyper_encoder(y)
        z_hat, z_lik = self.bottleneck(z, True, noise) if training else self.bottleneck(z)
        means, scales = self.means_scales(z_hat.to(y.dtype), *y.shape[2:])
        if training:
            _, y_lik = self.gaussian(y, scales, means, True, noise)
            y_hat = quantize_ste(y - means) + means
        else:
            y_hat, y_lik = self.gaussian(y, scales, means)
        return y_hat, {"y": y_lik, "z": z_lik}, means

    def forward(self, y: torch.Tensor, training: bool = False, noise=None):
        """y [B, C, h, w] -> (y_hat in y's dtype, {"y": likelihoods of y,
        "z": likelihoods of z}, float32); ``training`` draws the noise of
        z, then of y, from ``noise``."""
        y_hat, lik, _ = self._forward(y, training, noise)
        return y_hat, lik

    def forward_with_prior(self, y: torch.Tensor, q_y_prior, training: bool = False,
                           noise=None):
        """(y_hat, {"y", "z", "pred_err_y", "Q_err_y"}, new prior), as the
        JAX module returns them. Q_err_y = round(y - means) + means - y.
        Without an SPnet, pred_err_y is None and the prior passes through;
        with one, pred_err_y = pred_y - y (y detached), y_hat is pred_y
        (detached) when ``sp``, and the new prior is round(y - means)."""
        y_hat, lik, means = self._forward(y, training, noise)
        round_y = quantize(y - means)
        lik["Q_err_y"] = round_y + means - y
        lik["pred_err_y"] = None
        if self.y_predictor is None:
            return y_hat, lik, q_y_prior
        pred_y = self.predict_y(round_y, q_y_prior, means.detach())
        lik["pred_err_y"] = pred_y - y.detach()
        return (pred_y.detach() if self.sp else y_hat), lik, round_y

    def predict_y(self, round_y: torch.Tensor, q_y_prior: torch.Tensor,
                  means: torch.Tensor) -> torch.Tensor:
        """SPnet(cat(round_y, q_y_prior)) + round_y + means."""
        return self.y_predictor(torch.cat([round_y, q_y_prior], dim=1)) + round_y + means

    def means_scales(self, z_hat: torch.Tensor, h: int, w: int):
        """The Gaussian parameters of y from the decoded z (in y's dtype),
        cropped to y's h x w."""
        scales = self.hyper_decoder_scale(z_hat)[:, :, :h, :w]
        means = self.hyper_decoder_mean(z_hat)[:, :, :h, :w]
        return means, scales

    def aux_loss(self) -> torch.Tensor:
        """The bottleneck's quantile loss."""
        return self.bottleneck.aux_loss()
