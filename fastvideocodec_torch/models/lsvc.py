"""LSVC ("Hermes") tree-structured whole-GOP codec in its LSVC-TPU
configuration, ported from fastvideocodec_tpu/models/lsvc.py.

All P-frames of a GOP are coded against a binary reference tree: optical
flow (on the 2x2-pooled RGB frames, against the RAW tree parents) and
motion coding run for every P-frame in one batch; motion compensation and
residual coding then run tree layer by tree layer, each layer batched,
against the RECONSTRUCTED parents. The codec state lives in the
space-to-depth domain ([T, 12, H/2, W/2]); the mv decoder emits the
full-resolution flow (polyphase factor 4) and the motion-compensation warp
runs at full resolution on the s2d reference (``flow_warp_fullres_s2d``,
the hand-written s2d kernel on CUDA tensors). Rates are Laplace (residual
features, sigma from the hyper decoder) and BitEstimator (z, mv).

The real-bits coder (coder/video.py) runs the same network in pieces
(``mv_encode`` .. ``sigmas``). Eval only: training noise, attention and
frame sharding are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from fastvideocodec_torch.entropy.bit_estimator import BitEstimator
from fastvideocodec_torch.gop.graph import TreeSchedule, tree_schedule
from fastvideocodec_torch.layers.blocks import WarpNet
from fastvideocodec_torch.layers.spynet import SpyNet
from fastvideocodec_torch.layers.transforms import (
    OUT_CHANNEL_M,
    OUT_CHANNEL_N,
    AnalysisMVNet,
    AnalysisNet,
    AnalysisPriorNet,
    SynthesisMVNet,
    SynthesisNet,
    SynthesisPriorNet,
)
from fastvideocodec_torch.ops import (
    avg_pool2,
    bits_estimate,
    depth_to_space,
    flow_warp_fullres_s2d,
    laplace_likelihood,
    quantize,
    space_to_depth,
)


class LSVC(nn.Module):
    """forward(x: [T, 3, H, W]) codes the whole GOP (frame 0 = the I-frame)."""

    S2D = 2

    def __init__(self, channels: int = 128, conv_channels: int = 128,
                 spynet_widths: tuple = (32, 64, 32, 16),
                 spynet_kernels: tuple = (5, 5, 3, 3),
                 warp_width: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.channels = channels
        self.dtype = dtype
        img_c = 3 * self.S2D * self.S2D
        self.optic_flow = SpyNet(widths=spynet_widths, kernels=spynet_kernels)
        self.mv_encoder = AnalysisMVNet(2, channels, channels)
        self.mv_decoder = SynthesisMVNet(channels, channels, 2)
        self.res_encoder = AnalysisNet(img_c, conv_channels, OUT_CHANNEL_M)
        self.res_decoder = SynthesisNet(OUT_CHANNEL_M, conv_channels, img_c)
        self.prior_encoder = AnalysisPriorNet(OUT_CHANNEL_M, OUT_CHANNEL_N)
        self.prior_decoder = SynthesisPriorNet(OUT_CHANNEL_N, OUT_CHANNEL_M)
        self.bit_estimator_mv = BitEstimator(channels)
        self.bit_estimator_z = BitEstimator(OUT_CHANNEL_N)
        self.warpnet = WarpNet(2 * img_c, img_c, warp_width)

    def schedule(self, bs: int) -> TreeSchedule:
        return tree_schedule(bs)

    def motioncompensation(self, ref: torch.Tensor, mv: torch.Tensor):
        """ref: s2d reference [n, 12, H/2, W/2]; mv: decoded flow [n, 2, H, W]
        in half-res pixels. Returns (prediction, warped), both s2d."""
        warped = flow_warp_fullres_s2d(ref, 2.0 * mv)
        pred = self.warpnet(torch.cat([warped, ref], dim=1)) + warped
        return pred, warped

    # Pieces of the real-bits coder (coder/video.py). The encoder and the
    # decoder take the motion compensation, the recon and the f16 sigmas
    # from these same functions on the same shapes and dtypes, so that
    # decode == encode holds bit for bit. Symbols travel as int16.
    def mv_encode(self, x_flow_cur: torch.Tensor, x_flow_ref: torch.Tensor) -> torch.Tensor:
        """Flow of the pooled frames, then the mv encoder: int16 symbols."""
        return quantize(self.mv_encoder(self.optic_flow(x_flow_cur, x_flow_ref))).to(torch.int16)

    def mv_decode(self, mv_q: torch.Tensor) -> torch.Tensor:
        return self.mv_decoder(mv_q.to(self.dtype))

    def layer_mc(self, refs: torch.Tensor, mv_hat: torch.Tensor) -> torch.Tensor:
        """Motion compensation of one tree layer against its stacked parents."""
        return self.motioncompensation(refs, mv_hat)[0]

    def analyze(self, target: torch.Tensor, mc: torch.Tensor):
        """Residual and prior encoders: (z_q, feat_q), both int16."""
        feature = self.res_encoder(target - mc)
        z_q = quantize(self.prior_encoder(feature))
        return z_q.to(torch.int16), quantize(feature).to(torch.int16)

    def layer_recon(self, feat_q: torch.Tensor, mc: torch.Tensor) -> torch.Tensor:
        return torch.clamp(self.res_decoder(feat_q.to(mc.dtype)) + mc, 0.0, 1.0)

    def sigmas(self, z_q: torch.Tensor) -> torch.Tensor:
        """The Laplace scales of the features, float16: the host coder
        buckets them into its scale table, and both sides bucket these."""
        return self.prior_decoder(z_q.to(self.dtype)).to(torch.float16)

    def res_codec(self, res: torch.Tensor):
        feature = self.res_encoder(res)
        z_q = quantize(self.prior_encoder(feature))
        sigma = self.prior_decoder(z_q)
        feature_q = quantize(feature)
        res_hat = self.res_decoder(feature_q)
        bits = bits_estimate(laplace_likelihood(feature_q.float(), sigma.float()))
        bits = bits + bits_estimate(self.bit_estimator_z.likelihood(z_q))
        return res_hat, bits

    def mv_codec(self, mv: torch.Tensor):
        latent_q = quantize(self.mv_encoder(mv))
        mv_hat = self.mv_decoder(latent_q)
        return mv_hat, bits_estimate(self.bit_estimator_mv.likelihood(latent_q))

    def forward(self, x: torch.Tensor):
        """x: [T, 3, H, W] GOP with the (already coded) I-frame at index 0.

        Returns (com_frames, mc_frames, warped_frames, metrics); the frames
        are [T-1, 3, H, W] at full resolution."""
        x = x.to(self.dtype)
        T, _, H, W = x.shape
        bs = T - 1
        sched = self.schedule(bs)
        x_flow = avg_pool2(x)  # [T, 3, H/2, W/2]
        x = space_to_depth(x, self.S2D)
        target = x[1:]
        ref_raw = x_flow[list(sched.ref_index)]
        est_mv = self.optic_flow(x_flow[1:], ref_raw)
        mv_hat, bits_mv = self.mv_codec(est_mv)

        com = [None] * bs
        mc = [None] * bs
        warped = [None] * bs
        bits_res = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer in sched.layers:
            ref = torch.stack(
                [x[0] if sched.parents[f] == 0 else com[sched.parents[f] - 1] for f in layer]
            )
            ids = [f - 1 for f in layer]
            mc_frames, warped_frames = self.motioncompensation(ref, mv_hat[ids])
            res_hat, rb = self.res_codec(target[ids] - mc_frames)
            com_frames = torch.clamp(res_hat + mc_frames, 0.0, 1.0)
            bits_res = bits_res + rb
            for i, f in enumerate(layer):
                com[f - 1] = com_frames[i]
                mc[f - 1] = mc_frames[i]
                warped[f - 1] = warped_frames[i]

        com_frames = torch.stack(com)
        mc_frames = torch.stack(mc)
        warped_frames = torch.stack(warped)

        def mse(a):
            return torch.mean((a.float() - target.float()) ** 2)

        denom = bs * H * W
        metrics = {
            "rec_loss": mse(com_frames),
            "warp_loss": mse(warped_frames),
            "mc_loss": mse(mc_frames),
            "bpp_res": bits_res / denom,
            "bpp_mv": bits_mv / denom,
            "bpp": (bits_res + bits_mv) / denom,
        }
        return (
            depth_to_space(com_frames, self.S2D),
            depth_to_space(mc_frames, self.S2D),
            depth_to_space(warped_frames, self.S2D),
            metrics,
        )
