"""ELFVC / ELFVC-SP ("Vesper"), ported from fastvideocodec_tpu/models/elfvc.py
(reference models.py:1866-2124), in the stock form (``s2d=1``: ELFVC,
ELFVC-SP) and the '-TPU' form (``s2d=2``, ``pipeline_s2d``).

On top of the SSF skeleton of the same form (models/ssf.py), per P-frame:

  motion_info_local = flow_predictor(cat(x_ref, x_ref_ref, motion_prior))
  volume = make_volume(x_ref)                       built once, warped twice
  x_pred_local = warp_prediction(volume, motion_info_local)
  y_motion_hat ~ motion_hyperprior(motion_encoder(cat(x_cur, x_pred_local)))
  motion_info = motion_prior + motion_decoder(y_motion_hat)   (the delta)
  x_pred = warp_prediction(volume, motion_info)
  y_res_hat ~ res_hyperprior(res_encoder(x_cur - x_pred))
  x_rec = x_pred + res_decoder(cat(y_res_hat, y_motion_hat))

The temporal state (x_ref_ref, the motion prior, and the hyperpriors'
round-y priors for the SPnets) is an ``ElfvcState`` carried from frame to
frame; it starts at zeros at each GOP, and carries x_ref and the decoded
motion detached, as in the JAX package. With ``super_prec`` the motion and
residual hyperpriors hold SPnets; ``sp_stage`` >= 1 lets the motion SPnet
replace y_motion_hat, >= 2 the residual one as well. The motion tensors
(the predictor's output, the prior, the decoded delta) are the stock
form's [B, 3, H, W] (flow x, flow y, scale; the flow normalized) and the
'-TPU' form's [B, 12, H/2, W/2] in the warp's c-major phase form.
``training`` (with ``noise``) draws the motion hyperprior's noise, then
the residual's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fastvideocodec_torch.entropy.hyperprior import SSFHyperprior
from fastvideocodec_torch.layers.blocks import frame_dtype
from fastvideocodec_torch.layers.transforms import FlowPredictor
from fastvideocodec_torch.models.ssf import ScaleSpaceFlow


class ElfvcState(NamedTuple):
    """The carry between P-frames, in the carried dims: [B, 3, H, W] in the
    stock form, [B, 12, H/2, W/2] in the '-TPU' form."""

    x_ref_ref: torch.Tensor
    motion_info_prior: torch.Tensor
    q_y_prior_motion: torch.Tensor  # [B, planes, H/16, W/16]
    q_y_prior_res: torch.Tensor


class ELFVC(ScaleSpaceFlow):
    def __init__(self, mid_planes: int = 128, planes: int = 192, super_prec: bool = False,
                 sp_stage: int = 1, sp_dim: int = 64, s2d: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__(mid_planes, planes, s2d, dtype)
        self.planes = planes
        self.super_prec, self.sp_stage = super_prec, sp_stage
        self.flow_predictor = FlowPredictor(9 * s2d * s2d, mid_planes, s2d=s2d)
        self.motion_hyperprior = SSFHyperprior(planes, super_prec, sp_stage >= 1, sp_dim)
        self.res_hyperprior = SSFHyperprior(planes, super_prec, sp_stage >= 2, sp_dim)

    def init_state(self, batch: int, height: int, width: int) -> ElfvcState:
        """Zeros, with (height, width) the dims of the tensors as carried
        (full resolution, or the s2d dims); the latent grid lies at /16 of
        full resolution."""
        c, lat = 3 * self.s2d * self.s2d, 16 // self.s2d
        device = self.flow_predictor.Conv_0.weight.device

        def zeros(*shape):
            return torch.zeros(shape, dtype=self.dtype, device=device)

        return ElfvcState(zeros(batch, c, height, width), zeros(batch, c, height, width),
                          zeros(batch, self.planes, height // lat, width // lat),
                          zeros(batch, self.planes, height // lat, width // lat))

    def forward_inter(self, x_cur: torch.Tensor, x_ref: torch.Tensor, state: ElfvcState,
                      training: bool = False, noise=None):
        """x_cur, x_ref in the form's domain and the model dtype -> (x_rec,
        {"motion": lik, "residual": lik, "pred_err": [...], "Q_err": [...]},
        the next state); each lik as ``SSFHyperprior.forward_with_prior``
        gives it; pred_err holds the SPnets' errors (none without
        ``super_prec``)."""
        motion_info_local = self.flow_predictor(
            torch.cat([x_ref, state.x_ref_ref, state.motion_info_prior], dim=1))
        volume = self.make_volume(x_ref)
        x_pred_local = self.warp_prediction(volume, motion_info_local)
        y_motion = self.motion_encoder(torch.cat([x_cur, x_pred_local], dim=1))
        y_motion_hat, motion_lik, q_prior_m = self.motion_hyperprior.forward_with_prior(
            y_motion, state.q_y_prior_motion, training, noise)
        motion_info = state.motion_info_prior + self.motion_decoder(y_motion_hat)
        x_pred = self.warp_prediction(volume, motion_info)
        y_res_hat, res_lik, q_prior_r = self.res_hyperprior.forward_with_prior(
            self.res_encoder(x_cur - x_pred), state.q_y_prior_res, training, noise)
        x_rec = x_pred + self.res_decoder(torch.cat([y_res_hat, y_motion_hat], dim=1))
        new_state = ElfvcState(x_ref.detach(), motion_info.detach(), q_prior_m, q_prior_r)
        liks = (motion_lik, res_lik)
        out = {
            "motion": motion_lik,
            "residual": res_lik,
            "pred_err": [lik["pred_err_y"] for lik in liks if lik["pred_err_y"] is not None],
            "Q_err": [lik["Q_err_y"] for lik in liks],
        }
        return x_rec, out, new_state

    def forward(self, frames: torch.Tensor, training: bool = False, noise=None):
        """Keyframe + chained inter frames over frames [T, B, 3, H, W], the
        state starting at zeros after the keyframe: (recon [T, B, 3, H, W],
        per-frame dicts: the keyframe's {"keyframe": lik}, then each inter
        frame's ``forward_inter`` dict); each inter frame takes the previous
        recon detached."""
        x = self.fold_gop(frames.to(frame_dtype(self, frames, training)))
        x_ref, lik0 = self.forward_keyframe(x[0], training, noise)
        B, _, h, w = x_ref.shape
        state = self.init_state(B, h, w)
        recons, liks = [x_ref], [lik0]
        for i in range(1, x.shape[0]):
            x_ref, out, state = self.forward_inter(x[i], x_ref.detach(), state, training, noise)
            recons.append(x_ref)
            liks.append(out)
        return self.unfold_gop(torch.stack(recons)), liks
