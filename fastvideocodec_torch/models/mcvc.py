"""MCVC / MCVC-IA(-OLFT): the multi-camera joint codec, ported from
fastvideocodec_tpu/models/mcvc.py (reference models.py:2240-2400).

The V views of a scene are folded into the batch axis ([B*V, 3, H, W],
index b*V + v), and coded by stock SSF's full-resolution transforms
(``s2d=1``) and scale-space prediction (``FullResPrediction``: one
``pixel_warp`` of the 18-channel volume per P-frame). Views that fail are
zero-masked before analysis. The IA ("imbalanced attention") form adds
backup image and residual decoders whose first stage is a cross-view
attention over (view, y, x) tokens, decoding the masked latents so that
the surviving views reconstruct the lost ones; the GOP's output is their
enhanced frames, while the plain decoders' frames stay the references.
OLFT changes training only, so MCVC-IA-OLFT serves as MCVC-IA does.

``training`` (with ``noise``, an ``ops.math.UniformNoise``-like source)
draws each hyperprior's noise in the JAX package's order: the keyframe's,
then for each P-frame the motion hyperprior's before the residual's. As in
the JAX package, each P-frame predicts from the previous plain recon
detached (the keyframe's too), while the returned frames and references
stay attached.
"""

from __future__ import annotations

from math import comb

import numpy as np
import torch
from torch import nn

from fastvideocodec_torch.entropy.hyperprior import SSFHyperprior
from fastvideocodec_torch.layers.blocks import ConvAttention, frame_dtype
from fastvideocodec_torch.layers.transforms import SSFDecoder, SSFEncoder
from fastvideocodec_torch.models.ssf import FullResPrediction


class AttnDecoder(nn.Module):
    """Residual cross-view attention, then the ``s2d=1`` SSF decoder
    (reference MCVC Decoder with attn=True, models.py:2256-2280)."""

    def __init__(self, in_channels: int, num_views: int, mid_planes: int, heads: int,
                 dim_head: int, out_planes: int = 3):
        super().__init__()
        self.ConvAttention_0 = ConvAttention(in_channels, heads, dim_head, num_views)
        self.SSFDecoder_0 = SSFDecoder(in_channels, mid_planes, out_planes, s2d=1)

    def forward(self, x):
        return self.SSFDecoder_0(x + self.ConvAttention_0(x))


def mask_views(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Zero the failed views: x [B*V, ...], mask [B*V] of {0, 1}."""
    return x * mask.reshape(-1, *(1,) * (x.dim() - 1)).to(x.dtype)


def sample_view_mask(rng: np.random.Generator, batch: int, num_views: int, max_failed: int,
                     failure_probability: float = 0.1, force_resilience: int = -1,
                     training: bool = True) -> np.ndarray:
    """The host's view-failure draw (models.py:2140-2183), a copy of the
    JAX package's that gives the same mask for the same generator state:
    a {0, 1} float32 mask [batch*num_views], the same views failed in
    every item of the batch. The number failed is ``force_resilience``
    when it is >= 0, else drawn from a binomial(num_views,
    failure_probability) truncated to at most min(num_views - 1,
    max_failed) (uniform over that range when not ``training``)."""
    max_failed = min(num_views - 1, max_failed)
    if force_resilience >= 0:
        failed = force_resilience
    elif max_failed <= 0:
        failed = 0
    else:
        ks = np.arange(max_failed + 1)
        if training:
            p = failure_probability
            probs = np.array([comb(num_views, int(k)) * p ** k * (1 - p) ** (num_views - k)
                              for k in ks], dtype=np.float64)
            probs /= probs.sum()
        else:
            probs = np.full(max_failed + 1, 1.0 / (max_failed + 1))
        failed = int(rng.choice(ks, p=probs))
    alive = rng.choice(num_views, size=num_views - failed, replace=False)
    view_mask = np.zeros(num_views, dtype=np.float32)
    view_mask[alive] = 1.0
    return np.tile(view_mask, batch)


class MCVC(FullResPrediction, nn.Module):
    """``forward`` runs a whole GOP: frames [T, B*V, 3, H, W] and a mask
    [B*V]. Widths: ``planes`` latent channels, ``mid_planes`` in the
    transforms; the attention has 8 heads of 64 at 128 planes and above,
    else 4 of max(planes // 4, 8) (the miniature configurations)."""

    def __init__(self, num_views: int, imbalanced_correlation: bool = True,
                 planes: int = 192, mid_planes: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if num_views < 1:
            raise ValueError(f"MCVC needs num_views >= 1, got {num_views}")
        self.num_views, self.dtype = num_views, dtype
        self.imbalanced_correlation = imbalanced_correlation
        mp, pl = mid_planes, planes
        self.img_encoder = SSFEncoder(3, mp, pl, s2d=1)
        self.img_decoder = SSFDecoder(pl, mp, 3, s2d=1)
        self.img_hyperprior = SSFHyperprior(pl)
        self.motion_encoder = SSFEncoder(6, mp, pl, s2d=1)
        self.motion_decoder = SSFDecoder(pl, mp, 3, s2d=1)
        self.motion_hyperprior = SSFHyperprior(pl)
        self.res_encoder = SSFEncoder(3, mp, pl, s2d=1)
        self.res_decoder = SSFDecoder(2 * pl, mp, 3, s2d=1)
        self.res_hyperprior = SSFHyperprior(pl)
        if imbalanced_correlation:
            heads, dim_head = (8, 64) if pl >= 128 else (4, max(pl // 4, 8))
            self.backup_img_decoder = AttnDecoder(pl, num_views, mp, heads, dim_head)
            self.backup_res_decoder = AttnDecoder(2 * pl, num_views, mp, heads, dim_head)

    def enhance_keyframe(self, x_hat: torch.Tensor, y_hat: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
        """The keyframe's output: with -IA the backup image decoder's frame
        from the masked latent, else x_hat."""
        if not self.imbalanced_correlation:
            return x_hat
        return self.backup_img_decoder(mask_views(y_hat, mask))

    def enhance_inter(self, x_rec: torch.Tensor, x_pred: torch.Tensor, y_res_hat: torch.Tensor,
                      y_motion_hat: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """A P-frame's output: with -IA the prediction plus the backup
        residual decoder's residual from the masked latents, else x_rec."""
        if not self.imbalanced_correlation:
            return x_rec
        y_masked = torch.cat([mask_views(y_res_hat, mask), mask_views(y_motion_hat, mask)], dim=1)
        return x_pred + self.backup_res_decoder(y_masked)

    def aux_loss(self) -> torch.Tensor:
        """The quantile losses of the three hyperpriors' bottlenecks."""
        return (self.img_hyperprior.aux_loss() + self.motion_hyperprior.aux_loss()
                + self.res_hyperprior.aux_loss())

    def forward_keyframe(self, x: torch.Tensor, mask: torch.Tensor, training: bool = False,
                         noise=None):
        """(x_hat, the enhanced x_hat, {"keyframe": lik})."""
        y_hat, lik = self.img_hyperprior(self.img_encoder(mask_views(x, mask)), training, noise)
        x_hat = self.img_decoder(y_hat)
        return x_hat, self.enhance_keyframe(x_hat, y_hat, mask), {"keyframe": lik}

    def forward_inter(self, x_cur: torch.Tensor, x_ref: torch.Tensor, mask: torch.Tensor,
                      training: bool = False, noise=None):
        """(x_rec, the enhanced x_rec, {"motion": lik, "residual": lik}):
        both frames masked, then encoded, and the prediction made from the
        masked reference."""
        x_cur = mask_views(x_cur, mask)
        x_ref = mask_views(x_ref, mask)
        y_motion = self.motion_encoder(torch.cat([x_cur, x_ref], dim=1))
        y_motion_hat, motion_lik = self.motion_hyperprior(y_motion, training, noise)
        x_pred = self.forward_prediction(x_ref, self.motion_decoder(y_motion_hat))
        y_res_hat, res_lik = self.res_hyperprior(self.res_encoder(x_cur - x_pred), training,
                                                 noise)
        x_rec = x_pred + self.res_decoder(torch.cat([y_res_hat, y_motion_hat], dim=1))
        x_enh = self.enhance_inter(x_rec, x_pred, y_res_hat, y_motion_hat, mask)
        return x_rec, x_enh, {"motion": motion_lik, "residual": res_lik}

    def forward(self, frames: torch.Tensor, mask: torch.Tensor, training: bool = False,
                noise=None):
        """frames [T, B*V, 3, H, W] (in ``frame_dtype``), mask [B*V] ->
        (the enhanced frames [T, B*V, 3, H, W], per-frame likelihood dicts,
        the references [T, B*V, 3, H, W]): the keyframe is coded, and each
        P-frame predicts from the previous plain recon, detached."""
        frames = frames.to(frame_dtype(self, frames, training))
        x_ref, x_enh, lik = self.forward_keyframe(frames[0], mask, training, noise)
        recons, liks, refs = [x_enh], [lik], [x_ref]
        for t in range(1, frames.shape[0]):
            x_ref, x_enh, lik = self.forward_inter(frames[t], x_ref.detach(), mask, training,
                                                   noise)
            recons.append(x_enh)
            liks.append(lik)
            refs.append(x_ref)
        return torch.stack(recons), liks, torch.stack(refs)
