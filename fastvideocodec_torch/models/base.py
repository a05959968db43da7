"""Base (+'-EC', +'-ER'), the reference's experimental DVC-skeleton codec
(models.py:1550-1835), ported at eval time from
fastvideocodec_tpu/models/base.py.

- EC ("error concealment"): the prior decoder emits 2x the channels; the
  second half becomes sigmoid(x) - 0.5, a feature correction concatenated
  into the residual decoder's input.
- ER ("error restoration"): CodecNet stacks predict the quantization error
  of the mv, residual-feature and z latents from their rounded values; at
  eval the decoders take gen(round(l)) + round(l). In training the decoders
  take l + (pred - target), pred = gen(round(l)) + round(l), with JAX's
  detach topology (``detach_mode``: 0 detaches the target l, 1 the
  correction), and the soft2hard stage (``s2h_stage``, set by the trainer's
  three passes) hands the decoders round(l) instead: the mv decoder from
  stage 1, the z and residual decoders and a detached motion compensation
  from stage 2. ``round`` passes no gradient.

DVC's pieces of the real-bits coder carry the corrections, so both sides
recompute them from the decoded symbols alone.
"""

from __future__ import annotations

import torch

from fastvideocodec_torch.layers.codecnet import CodecNet, er_gen_config
from fastvideocodec_torch.layers.transforms import OUT_CHANNEL_M, OUT_CHANNEL_MV, OUT_CHANNEL_N
from fastvideocodec_torch.layers.blocks import frame_dtype
from fastvideocodec_torch.models.dvc import DVC, as_frames, mse
from fastvideocodec_torch.ops import quantize


class Base(DVC):
    def __init__(self, use_ec: bool = False, use_er: bool = False,
                 channels_n: int = OUT_CHANNEL_N, channels_m: int = OUT_CHANNEL_M,
                 channels_mv: int = OUT_CHANNEL_MV, gen_width_mv: int = 192,
                 gen_width: int = 128, spynet_widths: tuple = (32, 64, 32, 16),
                 spynet_kernel: int = 7, warp_width: int = 64,
                 dtype: torch.dtype = torch.float32, s2h_stage: int = 0,
                 detach_mode: tuple = (0, 1)):
        cm = channels_m
        super().__init__(channels_n, cm, channels_mv, spynet_widths, spynet_kernel, warp_width,
                         dtype, res_decoder_in=2 * cm if use_ec else cm,
                         prior_out=2 * cm if use_ec else cm)
        self.use_ec, self.use_er = use_ec, use_er
        self.s2h_stage, self.detach_mode = s2h_stage, detach_mode
        if use_er:
            self.mv_gen = CodecNet(er_gen_config(channels_mv, gen_width_mv), channels_mv)
            self.res_gen = CodecNet(er_gen_config(cm, gen_width), cm)
            self.z_gen = CodecNet(er_gen_config(channels_n, gen_width), channels_n)

    def _restore(self, gen_name: str, q: torch.Tensor) -> torch.Tensor:
        """The decoders' input from a rounded latent: gen(q) + q with ER."""
        return getattr(self, gen_name)(q) + q if self.use_er else q

    def _decoder_input(self, gen_name: str, latent, q, training: bool, hard: bool):
        """(the decoder's input, the ER prediction's error against the
        latent in float32, or None without ER) from the latent and its
        quantized ``q``. Eval: gen(q) + q, q the round. Training (JAX's
        ``_er_correct``): pred = gen(round(l)) + round(l) and its error
        against l (detached under detach mode 0); the input is round(l)
        when ``hard``, else l plus that error (detached under mode 1). The
        training chain runs in float32 from the generator's output and
        rounds once, at the decoder's input, as XLA computes JAX's chain
        (one elementwise fusion) in a bf16 run."""
        if not self.use_er:
            return q, None
        if not training:
            restored = self._restore(gen_name, q)
            return restored, restored.float() - latent.float()
        rounded = torch.round(latent.detach())
        pred_err = getattr(self, gen_name)(rounded).float() + rounded.float() - (
            latent.detach() if 0 in self.detach_mode else latent).float()
        if hard:
            return rounded, pred_err
        corr = latent.float() + (pred_err.detach() if 1 in self.detach_mode else pred_err)
        return corr.to(latent.dtype), pred_err

    def mc(self, x_ref, mv_q):
        return self.motion_compensation(x_ref, self.mv_decoder(self._restore("mv_gen", mv_q)))[0]

    def _split(self, sigma_out):
        if not self.use_ec:
            return sigma_out, None
        sigma, correction = sigma_out.chunk(2, dim=1)
        return sigma, torch.sigmoid(correction) - 0.5

    def sigma(self, z_q):
        return self._split(self.prior_decoder(self._restore("z_gen", z_q)))

    def _res_decode(self, feat_in, correction):
        if correction is not None:
            feat_in = torch.cat([feat_in, correction], dim=1)
        return self.res_decoder(feat_in)

    def reconstruct(self, x_mc, feat_q, correction):
        return torch.clamp(x_mc + self._res_decode(self._restore("res_gen", feat_q), correction),
                           0.0, 1.0)

    def forward(self, x_cur: torch.Tensor, x_ref: torch.Tensor, training: bool = False,
                noise=None):
        """``training``: the mv, feature and z latents take U(-0.5, 0.5)
        noise from ``noise``, drawn in that order (JAX's; DVC draws z
        before the feature); the rates are those of the noisy latents.
        ``img_loss`` is the MSE of the unclipped recon."""
        x_cur, x_ref = as_frames(frame_dtype(self, x_cur, training), x_cur, x_ref)
        B, _, H, W = x_cur.shape
        hard = training and self.use_er and self.s2h_stage > 0
        hard2 = hard and self.s2h_stage > 1
        mv_latent = self.mv_encoder(self.optic_flow(x_cur, x_ref))
        mv_q = quantize(mv_latent, training, noise)
        mv_in, err_mv = self._decoder_input("mv_gen", mv_latent, mv_q, training, hard)
        x_mc = self.motion_compensation(x_ref, self.mv_decoder(mv_in))[0]
        if hard2:
            x_mc = x_mc.detach()
        feature = self.res_encoder(x_cur - x_mc)
        feature_q = quantize(feature, training, noise)
        z = self.prior_encoder(feature)
        z_q = quantize(z, training, noise)
        z_in, err_z = self._decoder_input("z_gen", z, z_q, training, hard2)
        sigma, correction = self._split(self.prior_decoder(z_in))
        feat_in, err_feat = self._decoder_input("res_gen", feature, feature_q, training, hard2)
        x_rec = x_mc + self._res_decode(feat_in, correction)

        def mean_abs(a, b):
            return torch.mean(torch.abs(a.float() - b.float()))

        pred_err = torch.zeros((), dtype=torch.float32, device=x_cur.device)
        if self.use_er:
            for err in (err_mv, err_feat, err_z):
                pred_err = pred_err + torch.mean(torch.abs(err))
        metrics = {
            "img_loss": mse(x_rec, x_cur),
            "inter_loss": mse(x_mc, x_cur),
            **self.rates(mv_q, z_q, feature_q, sigma, B * H * W),
            "Q_err": sum(mean_abs(latent, torch.round(latent))
                         for latent in (mv_latent, feature, z)),
            "pred_err": pred_err,
        }
        return torch.clamp(x_rec, 0.0, 1.0), metrics
