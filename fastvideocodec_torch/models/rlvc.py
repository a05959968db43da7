"""RLVC / RLVC2 / RLVC-HP: sequential P-frame codecs with recurrent
autoencoders, ported from fastvideocodec_tpu/models/rlvc.py
(reference IterPredVideoCodecs, models.py:954-1051, and Coder2D,
models.py:520-681).

  flow    = SpyNet(x_cur, x_ref)       (stock: 7x7, no s2d level)
  mv_hat  = Coder2D_mv(flow)           conv+GDN encoder with a ConvLSTM,
                                       entropy model, mirrored decoder
  x_mc    = WarpNet(cat(warp, x_ref)) + warp, warp = flow_warp(x_ref, mv_hat)
  res_hat = Coder2D_res(x_cur - x_mc)
  x_rec   = clip(res_hat + x_mc, 0, 1)

Entropy models: 'rpm' (RLVC) the RecProbModel, factorized on the first
P-frame and RPM-conditioned Gaussian after; 'rpm2' (RLVC2) a BitEstimator
on the first P-frame and a zero-mean Laplace of the RPM's raw sigma after;
'mshyper' (RLVC-HP) the frame-local mean-scale hyperprior, whose x and z
likelihoods concatenate on channels. The decoder has its own ConvLSTM
(``dec_lstm``), a deliberate deviation of the JAX package from the
reference. The decoders' stride-2 deconvs are flax's
``ConvTranspose(padding="SAME")`` (``SameConvTranspose``), not the
polyphase deconv of the DVC transforms. State is carried in ``RlvcHidden``
(NCHW): the autoencoders' [B, 4C, H/4, W/4] (encoder 2C, decoder 2C), the
RPMs' [B, 2C, H/16, W/16] and the previous latents [B, C, H/16, W/16].
The warp is the ``flow_warp`` kernel on CUDA tensors, 5 launches a
P-frame. In training the latents take noise from an explicit source (RLVC's
RecProbModel one draw for its selected branch, RLVC-HP's hyperprior z's
then the latent's), the autoencoders' states are detached from frame to
frame and the RPMs' are not, so the gradient runs through the RPMs across
the GOP's P-frames. The real-bits coder (coder/video.py) runs the Coder2D in pieces
(``encode``, ``decode``, the entropy model's nets).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from fastvideocodec_torch.entropy.bit_estimator import BitEstimator
from fastvideocodec_torch.entropy.hyperprior import MeanScaleHyperPriors
from fastvideocodec_torch.entropy.rpm import RPM, RecProbModel
from fastvideocodec_torch.layers.blocks import (
    ConvLSTM,
    SameConvTranspose,
    WarpNet,
    conv,
    frame_dtype,
)
from fastvideocodec_torch.layers.spynet import SpyNet
from fastvideocodec_torch.models.dvc import as_frames, mse
from fastvideocodec_torch.ops import GDN, bits_estimate, flow_warp, laplace_likelihood, quantize

ENTROPY_TYPES = ("rpm", "rpm2", "mshyper")


class Coder2D(nn.Module):
    """4 stride-2 convs with GDN, a ConvLSTM after the second; three
    stride-2 flax-SAME deconvs with inverse GDN, a ConvLSTM after the
    second, and the caller's last deconv (``dec4``); an entropy model."""

    def __init__(self, in_channels: int, channels: int = 128, kernel: int = 3,
                 entropy_type: str = "rpm"):
        super().__init__()
        c, k = channels, kernel
        if entropy_type not in ENTROPY_TYPES:
            raise ValueError(f"unknown entropy_type {entropy_type}")
        self.entropy_type = entropy_type
        self.enc1 = conv(in_channels, c, k, 2)
        self.enc2 = conv(c, c, k, 2)
        self.enc3 = conv(c, c, k, 2)
        self.enc4 = nn.Conv2d(c, c, k, stride=2, padding=k // 2, bias=False)
        for i in (1, 2, 3):
            self.add_module(f"gdn{i}", GDN(c))
            self.add_module(f"dec{i}", SameConvTranspose(c, c, k, 2))
            self.add_module(f"igdn{i}", GDN(c, inverse=True))
        self.enc_lstm = ConvLSTM(c)
        self.dec_lstm = ConvLSTM(c)
        if entropy_type == "rpm":
            self.entropy = RecProbModel(c)
        elif entropy_type == "rpm2":
            self.rpm = RPM(c)
            self.bit_estimator = BitEstimator(c)
        else:
            self.entropy = MeanScaleHyperPriors(c)

    def aux_loss(self) -> torch.Tensor:
        """The entropy model's quantile loss; zero for rpm2 (BitEstimator
        and RPM, no bottleneck)."""
        if self.entropy_type == "rpm2":
            return torch.zeros((), device=self.enc1.weight.device)
        return self.entropy.aux_loss()

    def encode(self, x, state_enc):
        x = self.gdn1(self.enc1(x))
        x = self.gdn2(self.enc2(x))
        x, state_enc = self.enc_lstm(x, state_enc)
        x = self.gdn3(self.enc3(x))
        return self.enc4(x), state_enc

    def decode(self, latent_hat, state_dec, dec4):
        x = self.igdn1(self.dec1(latent_hat))
        x = self.igdn2(self.dec2(x))
        x, state_dec = self.dec_lstm(x, state_dec)
        x = self.igdn3(self.dec3(x))
        return dec4(x), state_dec

    def entropy_code(self, latent, rpm_hidden, rpm_flag: bool, prior_latent,
                     training: bool = False, noise=None):
        """(latent_hat, likelihoods float32, rpm_hidden, prior_latent).
        ``training`` draws the latent's noise from ``noise`` (mshyper: z's,
        then the latent's); the next prior is round(latent), detached."""
        if self.entropy_type == "mshyper":
            latent_hat, (x_lik, z_lik), _, _ = self.entropy(latent, training, noise)
            return latent_hat, torch.cat([x_lik, z_lik], dim=1), rpm_hidden, prior_latent
        if self.entropy_type == "rpm2":
            latent_hat = quantize(latent, training, noise)
            if rpm_flag:
                sigma_raw, _, rpm_hidden = self.rpm(prior_latent.to(latent.dtype), rpm_hidden)
                lik = laplace_likelihood(latent_hat.float(), sigma_raw.float())
            else:
                lik = self.bit_estimator.likelihood(latent_hat)
            return latent_hat, lik, rpm_hidden, quantize(latent).detach()
        latent_hat, lik, rpm_hidden, prior_latent, _, _ = self.entropy(
            latent, rpm_hidden, rpm_flag, prior_latent, training, noise)
        return latent_hat, lik, rpm_hidden, prior_latent


def clip_recon(x: torch.Tensor) -> torch.Tensor:
    """The recon clipped to [0, 1] (a branch that tools/train_parity.py's
    CardBranches can pin: its gradient passes inside [0, 1] alone)."""
    return torch.clamp(x, 0.0, 1.0)


class RlvcHidden(NamedTuple):
    rae_mv: torch.Tensor   # [B, 4C, H/4, W/4] (encoder 2C, decoder 2C)
    rae_res: torch.Tensor
    rpm_mv: torch.Tensor   # [B, 2C, H/16, W/16]
    rpm_res: torch.Tensor
    mv_prior: torch.Tensor  # [B, C, H/16, W/16]
    res_prior: torch.Tensor


class RLVC(nn.Module):
    """forward(x_ref, x_cur, hidden, rpm_flag) -> (recon, new hidden,
    metrics); ``rpm_flag`` is a Python bool, true after the first
    P-frame."""

    def __init__(self, channels: int = 128, entropy_type: str = "rpm",
                 spynet_widths: tuple = (32, 64, 32, 16), spynet_kernel: int = 7,
                 warp_width: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.channels, self.entropy_type, self.dtype = channels, entropy_type, dtype
        self.optic_flow = SpyNet(widths=spynet_widths, kernels=(spynet_kernel,) * 4,
                                 s2d_levels=0)
        self.warpnet = WarpNet(6, 3, warp_width)
        self.mv_codec = Coder2D(2, channels, 3, entropy_type)
        self.res_codec = Coder2D(3, channels, 5, entropy_type)
        self.mv_dec4 = SameConvTranspose(channels, 2, 3, 2)
        self.res_dec4 = SameConvTranspose(channels, 3, 5, 2)

    def init_hidden(self, batch: int, height: int, width: int, device=None) -> RlvcHidden:
        c = self.channels
        device = device if device is not None else next(self.parameters()).device

        def zeros(ch, f):
            return torch.zeros((batch, ch, height // f, width // f), dtype=self.dtype,
                               device=device)

        return RlvcHidden(zeros(4 * c, 4), zeros(4 * c, 4), zeros(2 * c, 16), zeros(2 * c, 16),
                          zeros(c, 16), zeros(c, 16))

    def aux_loss(self) -> torch.Tensor:
        return self.mv_codec.aux_loss() + self.res_codec.aux_loss()

    def motion_compensation(self, x_ref: torch.Tensor, mv_hat: torch.Tensor):
        """(x_mc, x_warp)."""
        x_warp = flow_warp(x_ref, mv_hat)
        return self.warpnet(torch.cat([x_warp, x_ref], dim=1)) + x_warp, x_warp

    def _run_codec(self, codec, dec4, x, rae_hidden, rpm_hidden, rpm_flag, prior_latent,
                   training: bool = False, noise=None):
        state_enc, state_dec = rae_hidden.chunk(2, dim=1)
        latent, state_enc = codec.encode(x, state_enc)
        latent_hat, lik, rpm_hidden, prior_latent = codec.entropy_code(
            latent, rpm_hidden, rpm_flag, prior_latent, training, noise)
        hat, state_dec = codec.decode(latent_hat.to(self.dtype), state_dec, dec4)
        rae_hidden = torch.cat([state_enc, state_dec], dim=1).detach()
        return hat, rae_hidden, rpm_hidden, bits_estimate(lik), prior_latent

    def forward(self, x_ref: torch.Tensor, x_cur: torch.Tensor, hidden: RlvcHidden,
                rpm_flag: bool, training: bool = False, noise=None):
        """``training``: the mv codec's latent takes its noise from
        ``noise``, then the residual codec's. The autoencoders' states
        leave detached; the RPMs' stay attached. ``img_loss`` is the MSE of
        the clipped recon, so its gradient passes the clip. The frames come
        in ``frame_dtype``."""
        x_cur, x_ref = as_frames(frame_dtype(self, x_cur, training), x_cur, x_ref)
        B, _, H, W = x_cur.shape
        mv = self.optic_flow(x_cur, x_ref)
        mv_hat, rae_mv, rpm_mv, mv_bits, mv_prior = self._run_codec(
            self.mv_codec, self.mv_dec4, mv, hidden.rae_mv, hidden.rpm_mv, rpm_flag,
            hidden.mv_prior, training, noise)
        x_mc, x_warp = self.motion_compensation(x_ref, mv_hat)
        res_hat, rae_res, rpm_res, res_bits, res_prior = self._run_codec(
            self.res_codec, self.res_dec4, x_cur - x_mc, hidden.rae_res, hidden.rpm_res,
            rpm_flag, hidden.res_prior, training, noise)
        x_rec = clip_recon(res_hat + x_mc)
        denom = B * H * W
        metrics = {
            "bpp_est": (mv_bits + res_bits) / denom,
            "bpp_res_est": res_bits / denom,
            "img_loss": mse(x_cur, x_rec),
            "warp_loss": mse(x_cur, x_warp),
            "mc_loss": mse(x_cur, x_mc),
        }
        return x_rec, RlvcHidden(rae_mv, rae_res, rpm_mv, rpm_res, mv_prior, res_prior), metrics
