"""Scale-space-flow (SSF) codec, ported from
fastvideocodec_tpu/models/ssf.py, in its two registry forms:

- ``s2d=1``, stock SSF (SSF-Official, MCVC-Original): full-resolution
  frames [B, 3, H, W], transforms with four stride-2 stages, and the
  prediction of ``FullResPrediction`` (one ``pixel_warp`` of the
  18-channel volume per P-frame);
- ``s2d=2``, SSF-TPU (``pipeline_s2d``): the whole inter pipeline in the
  space-to-depth domain, frames [B, 12, H/2, W/2] folded once per GOP, and
  the pyramid prediction ``warp_volume_pyramid_s2d`` (its level-0 sample
  and half-resolution stack sample are the two pixel warps).

Per P-frame, in either form:

  y_motion = motion_encoder(cat(x_cur, x_ref))
  y_motion_hat ~ motion_hyperprior
  motion_info = motion_decoder(y_motion_hat)   (flow x, flow y, scale)
  x_pred = warp_prediction(make_volume(x_ref), motion_info)
  y_res_hat ~ res_hyperprior(res_encoder(x_cur - x_pred))
  x_rec = x_pred + res_decoder(cat(y_res_hat, y_motion_hat))

``fold_gop``/``unfold_gop`` carry a GOP into the form's domain and back
(the identity for ``s2d=1``), so the rollouts and the real-bits coder
(coder/video.py) are one code path for both. Keyframes go through the
img_* transforms. ``training`` (with ``noise``, an ``ops.math.UniformNoise``
-like source) draws each hyperprior's noise, the motion's before the
residual's; the chained reference is detached between frames, as in the
JAX package.

A third form, ``ScaleSpaceFlow(s2d=2, pipeline_s2d=False)``, has no
registry name in either package (JAX ``models/ssf.py:46-78``): full-res
frames, the s2d transforms folding their input in (the motion encoder's
after the concat: s2d(cat(cur, ref))) and unfolding their output, and the
full-resolution prediction of ``FullResPrediction`` between them. The
weight shapes are SSF-TPU's.
"""

from __future__ import annotations

import torch
from torch import nn

from fastvideocodec_torch.entropy.hyperprior import SSFHyperprior
from fastvideocodec_torch.layers.blocks import frame_dtype
from fastvideocodec_torch.layers.transforms import SSFDecoder, SSFEncoder
from fastvideocodec_torch.ops.warp import (
    depth_to_space,
    gaussian_volume,
    s2d_phase_mean,
    space_to_depth,
    warp_volume,
    warp_volume_pyramid_s2d,
)


NUM_LEVELS = 5  # scale-space levels, the original included
SIGMA0 = 1.5  # blur of each level


class FullResPrediction:
    """The scale-space prediction of stock SSF (the JAX ``ScaleSpaceFlow``
    methods outside ``pipeline_s2d``), for the codecs that predict at full
    resolution: stock SSF and ELFVC, and MCVC. The volume is the flat
    [B, 18, H, W] stack of the reference's six levels; the prediction
    samples all of it with one full-resolution pixel warp (C = 18) and
    blends the levels by the decoded scale."""

    @staticmethod
    def make_volume(x_ref: torch.Tensor) -> torch.Tensor:
        return gaussian_volume(x_ref, SIGMA0, NUM_LEVELS)

    @staticmethod
    def warp_prediction(volume: torch.Tensor, motion_info: torch.Tensor) -> torch.Tensor:
        """motion_info [B, 3, H, W] = (flow x, flow y, scale), the flow in
        normalized units."""
        return warp_volume(volume, motion_info[:, 0:2], motion_info[:, 2:3], NUM_LEVELS)

    def forward_prediction(self, x_ref: torch.Tensor, motion_info: torch.Tensor) -> torch.Tensor:
        return self.warp_prediction(self.make_volume(x_ref), motion_info)


class ScaleSpaceFlow(nn.Module):
    """``pipeline_s2d`` (``s2d=2`` only) keeps the inter pipeline in the s2d
    domain; None takes it with ``s2d=2``, the registry's SSF-TPU."""

    def __init__(self, mid_planes: int = 128, planes: int = 192, s2d: int = 1,
                 dtype: torch.dtype = torch.float32, pipeline_s2d: bool | None = None):
        super().__init__()
        if s2d not in (1, 2):
            raise ValueError(f"s2d must be 1 or 2, got {s2d}")
        pipeline_s2d = s2d == 2 if pipeline_s2d is None else pipeline_s2d
        if pipeline_s2d and s2d != 2:
            raise ValueError("pipeline_s2d needs s2d=2")
        self.s2d, self.dtype, self.pipeline_s2d = s2d, dtype, pipeline_s2d
        # the non-pipeline s2d form folds each transform's input in and its
        # output back out; the others run their transforms as they are
        self.fold = s2d == 2 and not pipeline_s2d
        mp, pl = mid_planes, planes
        img_c = 3 * s2d * s2d  # a frame's channels in the form's domain
        self.img_encoder = SSFEncoder(img_c, mp, pl, s2d)
        self.img_decoder = SSFDecoder(pl, mp, 3, s2d)
        self.img_hyperprior = SSFHyperprior(pl)
        self.motion_encoder = SSFEncoder(2 * img_c, mp, pl, s2d)
        self.motion_decoder = SSFDecoder(pl, mp, 3, s2d)
        self.motion_hyperprior = SSFHyperprior(pl)
        self.res_encoder = SSFEncoder(img_c, mp, pl, s2d)
        self.res_decoder = SSFDecoder(2 * pl, mp, 3, s2d)
        self.res_hyperprior = SSFHyperprior(pl)

    def enc_in(self, x: torch.Tensor) -> torch.Tensor:
        return space_to_depth(x, 2) if self.fold else x

    def dec_out(self, x: torch.Tensor) -> torch.Tensor:
        return depth_to_space(x, 2) if self.fold else x

    def make_volume(self, x_ref: torch.Tensor):
        """``s2d=1``: the full-resolution volume [B, 18, H, W]. ``s2d=2``:
        (x_ref, vol_half): level 0 is the s2d reference itself; the blurred
        levels are built at half resolution from its phase mean."""
        if not self.pipeline_s2d:
            return FullResPrediction.make_volume(x_ref)
        h = s2d_phase_mean(x_ref, 3)  # == avg_pool2 of the full frame
        return x_ref, gaussian_volume(h, SIGMA0, NUM_LEVELS - 1)

    def warp_prediction(self, volume, motion_info: torch.Tensor) -> torch.Tensor:
        """motion_info: ``s2d=1`` [B, 3, H, W] (flow x, flow y, scale, the
        flow normalized); ``s2d=2`` [B, 12, H/2, W/2] in the warp's c-major
        phase form."""
        if not self.pipeline_s2d:
            return FullResPrediction.warp_prediction(volume, motion_info)
        level0_s2d, vol_half = volume
        return warp_volume_pyramid_s2d(level0_s2d, vol_half, motion_info, NUM_LEVELS)

    def forward_prediction(self, x_ref: torch.Tensor, motion_info: torch.Tensor) -> torch.Tensor:
        return self.warp_prediction(self.make_volume(x_ref), motion_info)

    def fold_gop(self, frames: torch.Tensor) -> torch.Tensor:
        """[T, B, 3, H, W] -> the form's domain: [T, B, 12, H/2, W/2] for
        ``pipeline_s2d``, the frames themselves otherwise."""
        if not self.pipeline_s2d:
            return frames
        T = frames.shape[0]
        return space_to_depth(frames.flatten(0, 1), self.s2d).unflatten(0, (T, -1))

    def unfold_gop(self, x: torch.Tensor) -> torch.Tensor:
        """The inverse of ``fold_gop``: back to [T, B, 3, H, W]."""
        if not self.pipeline_s2d:
            return x
        T = x.shape[0]
        return depth_to_space(x.flatten(0, 1), self.s2d).unflatten(0, (T, -1))

    def aux_loss(self) -> torch.Tensor:
        """The quantile losses of the three hyperpriors' bottlenecks."""
        return (self.img_hyperprior.aux_loss() + self.motion_hyperprior.aux_loss()
                + self.res_hyperprior.aux_loss())

    def forward_keyframe(self, x: torch.Tensor, training: bool = False, noise=None):
        y_hat, lik = self.img_hyperprior(self.img_encoder(self.enc_in(x)), training, noise)
        return self.dec_out(self.img_decoder(y_hat)), {"keyframe": lik}

    def forward_inter(self, x_cur: torch.Tensor, x_ref: torch.Tensor, training: bool = False,
                      noise=None):
        """x_cur, x_ref in the form's domain and the model dtype -> (x_rec,
        {"motion": lik, "residual": lik})."""
        y_motion = self.motion_encoder(self.enc_in(torch.cat([x_cur, x_ref], dim=1)))
        y_motion_hat, motion_lik = self.motion_hyperprior(y_motion, training, noise)
        x_pred = self.forward_prediction(x_ref, self.dec_out(self.motion_decoder(y_motion_hat)))
        y_res_hat, res_lik = self.res_hyperprior(self.res_encoder(self.enc_in(x_cur - x_pred)),
                                                 training, noise)
        x_res_hat = self.dec_out(self.res_decoder(torch.cat([y_res_hat, y_motion_hat], dim=1)))
        return x_pred + x_res_hat, {"motion": motion_lik, "residual": res_lik}

    def forward(self, frames: torch.Tensor, training: bool = False, noise=None):
        """Keyframe + chained inter frames over frames [T, B, 3, H, W]:
        returns (recon [T, B, 3, H, W], per-frame likelihood dicts). The
        frames fold into the form's domain once and the recon unfolds once;
        each inter frame takes the previous recon detached."""
        x = self.fold_gop(frames.to(frame_dtype(self, frames, training)))
        x_ref, lik0 = self.forward_keyframe(x[0], training, noise)
        recons, liks = [x_ref], [lik0]
        for i in range(1, x.shape[0]):
            x_ref, lik = self.forward_inter(x[i], x_ref.detach(), training, noise)
            recons.append(x_ref)
            liks.append(lik)
        return self.unfold_gop(torch.stack(recons)), liks
