"""LSVC ("Hermes") tree-structured whole-GOP codec, ported from
fastvideocodec_tpu/models/lsvc.py, in every configuration the JAX
registry builds: the reference-structure ``s2d=1`` form (LSVC, LSVC-128,
LSVC-TINY) and the space-to-depth LSVC-TPU forms with their warp
ablations, attention and graphs.

All P-frames of a GOP are coded against a reference graph (the binary
tree; ``graph`` "chain" for -L, "onehop" for -O): optical flow against the
RAW graph parents and motion coding run for every P-frame in one batch
(or per layer with ``per_layer_mv``); motion compensation and residual
coding then run layer by layer, each layer batched (in chunks of at most
``layer_chunk`` frames when set), against the RECONSTRUCTED parents. Rates
are Laplace (residual features, sigma from the hyper decoder) and
BitEstimator (z, mv).

``s2d=2``: the codec state lives in the space-to-depth domain
([T, 12, H/2, W/2]); SpyNet runs on the 2x2-pooled RGB frames; the
transforms have 3 stride-2 stages instead of 4. Its motion compensation
(``motioncompensation``) takes one of JAX's three branches:

- the full-resolution warp of the s2d reference (``flow_warp_fullres_s2d``,
  the hand-written s2d kernel on CUDA tensors) by the mv decoder's own
  full-resolution flow (polyphase factor 4, the default), or by its
  half-resolution flow upsampled x2 with half-pixel centres (-HF);
- the rigid warp of the s2d reference by the half-resolution flow in the
  codec domain (``flow_warp`` on 12 channels, -RW), which is also the
  ``s2d=1`` form's warp of the full-resolution frame.

The refinement is the WarpNet U-net (-HU: 32 wide), the strided-trunk
WarpNetTPU (-WT), or the U-net one resolution down on the pooled input
with its correction upsampled x2 (-QU). With ``use_attn``/``use_syn_attn``
the analysis/synthesis transforms carry a SpaceTimeAttention of
``attn_depth`` (-A/-S): its time attention mixes the frames of a batch,
so a layer's (or chunk's) batch composition is part of the result.

The real-bits coder (coder/video.py) runs the same network in pieces
(``fold`` .. ``sigmas``). ``forward(x, training=True, noise=...)`` is the
training branch (additive quantization noise, the stop-gradient of
``detach_tree`` (-D) and of the chain graph).

Frame sharding (``frame_axis``, set by parallel/frame.py's
``frame_sharded_spec``): inside a step on a mesh, the stage-1 flow and mv
batch and each layer's (chunk's) frame batch split over the mesh axis
(``parallel.collectives``: ceil(n / ranks) frames a rank, a rank short or
empty). Each rank codes its frames, the quantizers' noise drawn for the
whole batch and sliced, and gathers the decoded motion and the layer's
recons, predictions and warps, so that every rank holds every parent.
The -A/-S time attention gathers its normalized tokens and mixes the
layer's frames whole (layers/blocks.py). The loss terms are this rank's
frames' (the recons' rows a rank is given of the gathered layers, its own
latents' bits), summed over the axis into the whole values every rank
goes on with; the gradients are summed over the mesh after the backward
(train/trainer.py).
"""

from __future__ import annotations

import torch
from torch import nn

from fastvideocodec_torch.entropy.bit_estimator import BitEstimator
from fastvideocodec_torch.gop.graph import TreeSchedule, tree_schedule
from fastvideocodec_torch.layers.blocks import WarpNet, WarpNetTPU, frame_dtype
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
    bilinear_upsample_x2,
    bits_estimate,
    depth_to_space,
    flow_warp,
    flow_warp_fullres_s2d,
    laplace_likelihood,
    quantize,
    space_to_depth,
)
from fastvideocodec_torch.parallel.collectives import frame_rows, time_batch

GRAPHS = ("tree", "chain", "onehop")


class LSVC(nn.Module):
    """forward(x: [T, 3, H, W]) codes the whole GOP (frame 0 = the I-frame).

    The arguments are the JAX module's fields, with its defaults (the
    reference-structure ``s2d=1`` LSVC); ``conv_channels`` 0 means the
    family's 64-wide residual transforms."""

    def __init__(self, channels: int = 128, use_attn: bool = False, use_syn_attn: bool = False,
                 graph: str = "tree", detach_tree: bool = False, attn_depth: int = 12,
                 per_layer_mv: bool = False, layer_chunk: int = 0, s2d: int = 1,
                 spynet_widths: tuple = (32, 64, 32, 16), spynet_kernel: int = 7,
                 spynet_kernels: tuple = (), spynet_s2d_levels: int = 0,
                 conv_channels: int = 0, warp_width: int = 64, warp_tpu: bool = False,
                 warp_stride: int = 4, warp_pooled: bool = False,
                 mv_polyphase_out: bool = False, full_res_warp: bool = False,
                 mv_full_res_out: bool = False, frame_axis: str = "",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if s2d not in (1, 2):
            raise ValueError(f"s2d must be 1 or 2, got {s2d}")
        if graph not in GRAPHS:
            raise ValueError(f"graph must be one of {GRAPHS}, got {graph!r}")
        self.channels, self.s2d, self.graph, self.dtype = channels, s2d, graph, dtype
        self.detach_tree = detach_tree  # a stop-gradient between graph layers
        self.per_layer_mv, self.layer_chunk = per_layer_mv, layer_chunk
        self.full_res_warp, self.mv_full_res_out = full_res_warp, mv_full_res_out
        self.warp_pooled = warp_pooled
        self.frame_axis = frame_axis  # the mesh axis the frame batches split over ("": none)
        stages = 4 if s2d == 1 else 3
        res_c = conv_channels or OUT_CHANNEL_N
        img_c = 3 * s2d * s2d
        enc_d = attn_depth if use_attn else 0
        dec_d = attn_depth if use_syn_attn else 0
        self.optic_flow = SpyNet(widths=spynet_widths,
                                 kernels=spynet_kernels or (spynet_kernel,) * 4,
                                 s2d_levels=spynet_s2d_levels)
        self.mv_encoder = AnalysisMVNet(2, channels, channels, stages=stages, attn_depth=enc_d)
        polyphase = mv_polyphase_out or mv_full_res_out
        self.mv_decoder = SynthesisMVNet(
            channels, channels, 2, stages=stages, attn_depth=dec_d,
            polyphase_factor=(4 if mv_full_res_out else 2) if polyphase else None)
        self.res_encoder = AnalysisNet(img_c, res_c, OUT_CHANNEL_M, stages=stages,
                                       attn_depth=enc_d)
        self.res_decoder = SynthesisNet(OUT_CHANNEL_M, res_c, img_c, stages=stages,
                                        attn_depth=dec_d)
        self.prior_encoder = AnalysisPriorNet(OUT_CHANNEL_M, OUT_CHANNEL_N, attn_depth=enc_d)
        self.prior_decoder = SynthesisPriorNet(OUT_CHANNEL_N, OUT_CHANNEL_M, attn_depth=dec_d)
        self.bit_estimator_mv = BitEstimator(channels)
        self.bit_estimator_z = BitEstimator(OUT_CHANNEL_N)
        if warp_tpu:
            self.warpnet = WarpNetTPU(2 * img_c, img_c, warp_width, stem_stride=warp_stride)
        else:
            self.warpnet = WarpNet(2 * img_c, img_c, warp_width)

    def aux_loss(self) -> torch.Tensor:
        """Zero, as the JAX module's: no entropy bottleneck (the rates are
        BitEstimators and a Laplace)."""
        return torch.zeros((), device=next(self.parameters()).device)

    def schedule(self, bs: int) -> TreeSchedule:
        """The static graph of ``bs`` P-frames; raises if it leaves a frame
        uncoded (the one-hop graph reaches 14 P-frames)."""
        sched = tree_schedule(bs, is_linear=self.graph == "chain",
                              is_onehop=self.graph == "onehop")
        if sorted(f for layer in sched.layers for f in layer) != list(range(1, bs + 1)):
            raise ValueError(f"the {self.graph} graph does not reach all {bs} P-frames")
        return sched

    def chunks(self, layer: tuple) -> list:
        """A tree layer's frame batches: the whole layer, or runs of at most
        ``layer_chunk`` frames."""
        n = self.layer_chunk if self.layer_chunk > 0 else len(layer)
        return [layer[i:i + n] for i in range(0, len(layer), n)]

    def fold(self, x: torch.Tensor):
        """Frames [T, 3, H, W] -> (the codec's frames, the flow's frames):
        (s2d, 2x2-pooled) for ``s2d=2``, the frames themselves for 1."""
        if self.s2d > 1:
            return space_to_depth(x, self.s2d), avg_pool2(x)
        return x, x

    def unfold(self, frames: torch.Tensor) -> torch.Tensor:
        return depth_to_space(frames, self.s2d) if self.s2d > 1 else frames

    def motioncompensation(self, ref: torch.Tensor, mv: torch.Tensor):
        """ref: reference in the codec domain; mv: the decoded flow (s2d=2:
        half-res pixels, at full resolution with the default decoder).
        Returns (prediction, warped) in the codec domain."""
        if self.full_res_warp and self.s2d > 1:
            mv_full = 2.0 * (mv if self.mv_full_res_out else bilinear_upsample_x2(mv))
            warped = flow_warp_fullres_s2d(ref, mv_full)
        else:
            warped = flow_warp(ref, mv)
        inp = torch.cat([warped, ref], dim=1)
        if self.warp_pooled:
            return bilinear_upsample_x2(self.warpnet(avg_pool2(inp))) + warped, warped
        return self.warpnet(inp) + warped, warped

    # Pieces of the real-bits coder (coder/video.py). The encoder and the
    # decoder take the motion compensation, the recon and the f16 sigmas
    # from these same functions on the same shapes and dtypes, so that
    # decode == encode holds bit for bit. Symbols travel as int16.
    def mv_encode(self, x_flow_cur: torch.Tensor, x_flow_ref: torch.Tensor) -> torch.Tensor:
        """Flow of the flow's frames, then the mv encoder: int16 symbols."""
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
        """The Laplace scales of one layer's features (one prior-decoder
        call on the layer's z), float16: the host coder buckets them into
        its scale table, and both sides bucket these."""
        return self.prior_decoder(z_q.to(self.dtype)).to(torch.float16)

    def res_codec(self, res: torch.Tensor, training: bool = False, noise=None):
        """Residual codec with its Laplace-sigma hyperprior: (res_hat, bits).
        In training z, then the feature, take noise from ``noise``."""
        feature = self.res_encoder(res)
        z_q = quantize(self.prior_encoder(feature), training, noise)
        sigma = self.prior_decoder(z_q)
        feature_q = quantize(feature, training, noise)
        res_hat = self.res_decoder(feature_q)
        bits = bits_estimate(laplace_likelihood(feature_q.float(), sigma.float()))
        bits = bits + bits_estimate(self.bit_estimator_z.likelihood(z_q))
        return res_hat, bits

    def mv_codec(self, mv: torch.Tensor, training: bool = False, noise=None):
        latent_q = quantize(self.mv_encoder(mv), training, noise)
        mv_hat = self.mv_decoder(latent_q)
        return mv_hat, bits_estimate(self.bit_estimator_mv.likelihood(latent_q))

    def forward(self, x: torch.Tensor, training: bool = False, noise=None):
        """x: [T, 3, H, W] GOP with the (already coded) I-frame at index 0.

        Returns (com_frames, mc_frames, warped_frames, metrics); the frames
        are [T-1, 3, H, W] at full resolution. ``training``: the latents
        take additive U(-0.5, 0.5) noise from ``noise`` (ops.math.quantize)
        in place of the round, drawn in the JAX module's order: the mv
        latent, then per layer (chunk) z before the feature; with
        ``per_layer_mv`` each chunk's mv latent first, inside its layer.
        The stop-gradient on the parents of ``detach_tree`` and of the
        chain graph holds in both modes. The frames come in
        ``frame_dtype``."""
        x = x.to(frame_dtype(self, x, training))
        T, _, H, W = x.shape
        bs = T - 1
        sched = self.schedule(bs)
        frames = frame_rows(self.frame_axis)
        x, x_flow = self.fold(x)
        target = x[1:]
        bits_mv = torch.zeros((), dtype=torch.float32, device=x.device)
        if not self.per_layer_mv:
            lo, hi = frames.span(bs)
            est_mv = self.optic_flow(x_flow[1 + lo:1 + hi], x_flow[list(sched.ref_index[lo:hi])])
            with time_batch(frames, bs):
                mv_hat, bits_mv = self.mv_codec(est_mv, training, frames.noise(noise, bs))
            mv_hat = frames.gather(mv_hat, bs)

        com = [None] * bs
        mc = [None] * bs
        warped = [None] * bs
        bits_res = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer in sched.layers:
            for part in self.chunks(layer):
                n = len(part)
                lo, hi = frames.span(n)
                mine = part[lo:hi]  # this rank's frames of the batch (all of it unsharded)
                ref = torch.stack(
                    [x[0] if sched.parents[f] == 0 else com[sched.parents[f] - 1] for f in mine]
                ) if mine else x[:0]
                if self.detach_tree or self.graph == "chain":
                    ref = ref.detach()
                ids = [f - 1 for f in mine]
                part_noise = frames.noise(noise, n)
                with time_batch(frames, n):
                    if self.per_layer_mv:
                        est_mv = self.optic_flow(x_flow[list(mine)],
                                                 x_flow[[sched.ref_index[i] for i in ids]])
                        diff, mv_bits = self.mv_codec(est_mv, training, part_noise)
                        bits_mv = bits_mv + mv_bits
                    else:
                        diff = mv_hat[ids]
                    mc_frames, warped_frames = self.motioncompensation(ref, diff)
                    res_hat, rb = self.res_codec(target[ids] - mc_frames, training, part_noise)
                com_frames = torch.clamp(res_hat + mc_frames, 0.0, 1.0)
                bits_res = bits_res + rb
                com_frames, mc_frames, warped_frames = (
                    frames.gather(t, n) for t in (com_frames, mc_frames, warped_frames))
                for i, f in enumerate(part):
                    com[f - 1] = com_frames[i]
                    mc[f - 1] = mc_frames[i]
                    warped[f - 1] = warped_frames[i]

        com_frames = torch.stack(com)
        mc_frames = torch.stack(mc)
        warped_frames = torch.stack(warped)
        lo, hi = frames.span(bs)

        def mse(a):
            if frames.parts == 1:
                return torch.mean((a.float() - target.float()) ** 2)
            # this rank's rows of the gathered frames, summed over the axis
            err = torch.sum((a[lo:hi].float() - target[lo:hi].float()) ** 2)
            return frames.sum(err / a.numel())

        bits_res, bits_mv = frames.sum(bits_res), frames.sum(bits_mv)
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
            self.unfold(com_frames),
            self.unfold(mc_frames),
            self.unfold(warped_frames),
            metrics,
        )
