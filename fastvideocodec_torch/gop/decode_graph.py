"""Receiver-side decode graph of the LSVC tree codec, ported from
fastvideocodec_tpu/gop/decode_graph.py.

What a receiver runs per GOP once the host entropy decoder has produced the
quantized latents: mv synthesis, the log-depth graph of motion
compensation, hyper and residual synthesis, back to full resolution.
"""

from __future__ import annotations

import torch

from fastvideocodec_torch.layers.transforms import OUT_CHANNEL_M, OUT_CHANNEL_N
from fastvideocodec_torch.models.lsvc import LSVC


def build_lsvc_decode(module: LSVC, GOP: int, H: int, W: int):
    """Decode graph for ``module`` at [GOP, H, W] full resolution.

    Returns (decode_fn, example_latents). ``decode_fn(iframe, mv_q, z_qs,
    feat_qs)`` takes the I-frame in the codec's domain ([12, H/2, W/2] for
    ``s2d=2``, [3, H, W] for 1) and returns (recon mean, sum of per-layer
    sigma means) as float32 scalars, and the recon [GOP-1, 3, H, W] as a
    third value. Each layer's motion compensation and residual synthesis
    run in the module's chunks of the layer, its sigmas on the whole layer,
    as the JAX graph does. The example latents are drawn from a
    ``torch.Generator`` seeded with 0, on the module's device, in its
    dtype, with the shapes the host decoder would produce; like the JAX
    version's, their values only set shapes.
    """
    bs = GOP - 1
    sched = module.schedule(bs)
    dtype = module.dtype
    device = next(module.parameters()).device

    @torch.inference_mode()
    def decode(iframe, mv_q, z_qs, feat_qs):
        mv_hat = module.mv_decoder(mv_q)
        com = [None] * bs
        sigma_sum = torch.zeros((), dtype=torch.float32, device=mv_q.device)
        for li, layer in enumerate(sched.layers):
            sigma_sum = sigma_sum + module.prior_decoder(z_qs[li]).float().mean()
            start = 0
            for part in module.chunks(layer):
                ref = torch.stack(
                    [iframe if sched.parents[f] == 0 else com[sched.parents[f] - 1]
                     for f in part]
                )
                mc, _ = module.motioncompensation(ref, mv_hat[[f - 1 for f in part]])
                res_hat = module.res_decoder(feat_qs[li][start:start + len(part)])
                com_frames = torch.clamp(res_hat + mc, 0.0, 1.0)
                start += len(part)
                for i, f in enumerate(part):
                    com[f - 1] = com_frames[i]
        out = module.unfold(torch.stack(com))
        return out.float().mean(), sigma_sum, out

    gen = torch.Generator(device=device).manual_seed(0)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    lh, lw = H // 16, W // 16  # latent resolution, /16 of full in both forms
    mv_q = normal(bs, module.channels, lh, lw)
    z_qs = [normal(len(layer), OUT_CHANNEL_N, lh // 4, lw // 4) for layer in sched.layers]
    feat_qs = [normal(len(layer), OUT_CHANNEL_M, lh, lw) for layer in sched.layers]
    return decode, (mv_q, z_qs, feat_qs)
