"""DVC, the classic sequential P-frame codec (Lu et al., CVPR 2019), ported
from fastvideocodec_tpu/models/dvc.py (reference DVC/net.py:38-220).

One call codes one P-frame against the previous recon, statelessly:

  flow = SpyNet(x_cur, x_ref)           (stock: 7x7, no s2d level)
  mv latent -> round -> SynthesisMVNet   rate: BitEstimator_mv
  x_mc = WarpNet(cat(warp, x_ref)) + warp, warp = flow_warp(x_ref, mv_hat)
  residual feature -> round -> SynthesisNet
                                         rate: Laplace(sigma), sigma from
  z = AnalysisPriorNet(feature) -> round -> SynthesisPriorNet; z's rate:
  BitEstimator_z.

The transforms are the stock ones (``stages=4``; the mv decoder's last
stride-2 deconv runs at full resolution). The warp is the hand-written
``flow_warp`` kernel on CUDA tensors: four SpyNet levels and the MC warp, 5
launches a P-frame. The real-bits coder (coder/video.py) runs the same
network in pieces (``mv_symbols`` .. ``reconstruct``), which Base
(models/base.py) overrides with its error restoration and concealment.
"""

from __future__ import annotations

import torch
from torch import nn

from fastvideocodec_torch.entropy.bit_estimator import BitEstimator
from fastvideocodec_torch.layers.blocks import WarpNet
from fastvideocodec_torch.layers.spynet import SpyNet
from fastvideocodec_torch.layers.transforms import (
    OUT_CHANNEL_M,
    OUT_CHANNEL_MV,
    OUT_CHANNEL_N,
    AnalysisMVNet,
    AnalysisNet,
    AnalysisPriorNet,
    SynthesisMVNet,
    SynthesisNet,
    SynthesisPriorNet,
)
from fastvideocodec_torch.ops import bits_estimate, flow_warp, laplace_likelihood, quantize

STOCK_STAGES = 4


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a.float() - b.float()) ** 2)


def as_frames(dtype: torch.dtype, *xs):
    """The frames in ``dtype``, contiguous NCHW, as the warp kernel takes
    them."""
    return (x.to(dtype).contiguous() for x in xs)


class DVC(nn.Module):
    """forward(x_cur, x_ref) -> (recon clipped to [0, 1], metrics)."""

    def __init__(self, channels_n: int = OUT_CHANNEL_N, channels_m: int = OUT_CHANNEL_M,
                 channels_mv: int = OUT_CHANNEL_MV, spynet_widths: tuple = (32, 64, 32, 16),
                 spynet_kernel: int = 7, warp_width: int = 64,
                 dtype: torch.dtype = torch.float32, res_decoder_in: int | None = None,
                 prior_out: int | None = None):
        super().__init__()
        cn, cm, cmv, st = channels_n, channels_m, channels_mv, STOCK_STAGES
        self.dtype = dtype
        self.optic_flow = SpyNet(widths=spynet_widths, kernels=(spynet_kernel,) * 4,
                                 s2d_levels=0)
        self.mv_encoder = AnalysisMVNet(2, cmv, cmv, stages=st)
        self.mv_decoder = SynthesisMVNet(cmv, cmv, 2, stages=st, polyphase_factor=None)
        self.warpnet = WarpNet(6, 3, warp_width)
        self.res_encoder = AnalysisNet(3, cn, cm, stages=st)
        self.res_decoder = SynthesisNet(res_decoder_in or cm, cn, 3, stages=st)
        self.prior_encoder = AnalysisPriorNet(cm, cn)
        self.prior_decoder = SynthesisPriorNet(cn, prior_out or cm)
        self.bit_estimator_mv = BitEstimator(cmv)
        self.bit_estimator_z = BitEstimator(cn)

    def motion_compensation(self, x_ref: torch.Tensor, mv_hat: torch.Tensor):
        """(x_mc, x_warp): the warped reference and its WarpNet refinement."""
        x_warp = flow_warp(x_ref, mv_hat)
        return self.warpnet(torch.cat([x_warp, x_ref], dim=1)) + x_warp, x_warp

    # Pieces of the real-bits coder (coder/video.py). The encoder and the
    # decoder take the motion compensation, the scales and the recon from
    # these same functions on the same shapes and dtypes, so that decode ==
    # encode holds bit for bit; symbols arrive in the model dtype.
    def mv_symbols(self, x_cur: torch.Tensor, x_ref: torch.Tensor) -> torch.Tensor:
        return quantize(self.mv_encoder(self.optic_flow(x_cur, x_ref)))

    def mc(self, x_ref: torch.Tensor, mv_q: torch.Tensor) -> torch.Tensor:
        return self.motion_compensation(x_ref, self.mv_decoder(mv_q))[0]

    def analyze(self, x_cur: torch.Tensor, x_mc: torch.Tensor):
        """(z_q, feat_q) of the residual."""
        feature = self.res_encoder(x_cur - x_mc)
        return quantize(self.prior_encoder(feature)), quantize(feature)

    def sigma(self, z_q: torch.Tensor):
        """(the features' Laplace scales, Base-EC's correction or None)."""
        return self.prior_decoder(z_q), None

    def reconstruct(self, x_mc: torch.Tensor, feat_q: torch.Tensor, correction) -> torch.Tensor:
        return torch.clamp(x_mc + self.res_decoder(feat_q), 0.0, 1.0)

    def rates(self, mv_q, z_q, feat_q, sigma, denom: int) -> dict:
        bits_feature = bits_estimate(laplace_likelihood(feat_q.float(), sigma.float()))
        bits_z = bits_estimate(self.bit_estimator_z.likelihood(z_q))
        bits_mv = bits_estimate(self.bit_estimator_mv.likelihood(mv_q))
        return {
            "bpp_feature": bits_feature / denom,
            "bpp_z": bits_z / denom,
            "bpp_mv": bits_mv / denom,
            "bpp_est": (bits_feature + bits_z + bits_mv) / denom,
        }

    def aux_loss(self) -> torch.Tensor:
        """Zero, as the JAX module's: no entropy bottleneck (the rates are
        BitEstimators and a Laplace)."""
        return torch.zeros((), device=next(self.parameters()).device)

    def forward(self, x_cur: torch.Tensor, x_ref: torch.Tensor):
        x_cur, x_ref = as_frames(self.dtype, x_cur, x_ref)
        B, _, H, W = x_cur.shape
        mv_q = self.mv_symbols(x_cur, x_ref)
        x_mc, x_warp = self.motion_compensation(x_ref, self.mv_decoder(mv_q))
        z_q, feature_q = self.analyze(x_cur, x_mc)
        sigma, _ = self.sigma(z_q)
        x_rec = x_mc + self.res_decoder(feature_q)
        metrics = {
            "img_loss": mse(x_rec, x_cur),
            "warp_loss": mse(x_warp, x_cur),
            "mc_loss": mse(x_mc, x_cur),
            **self.rates(mv_q, z_q, feature_q, sigma, B * H * W),
        }
        return torch.clamp(x_rec, 0.0, 1.0), metrics
