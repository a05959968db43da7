"""Receiver-side decode graph of the LSVC tree codec, ported from
fastvideocodec_tpu/gop/decode_graph.py.

What a receiver runs per GOP once the host entropy decoder has produced the
quantized latents: mv synthesis, the log-depth tree of motion compensation,
hyper and residual synthesis, depth-to-space.
"""

from __future__ import annotations

import torch

from fastvideocodec_torch.layers.transforms import OUT_CHANNEL_M, OUT_CHANNEL_N
from fastvideocodec_torch.models.lsvc import LSVC
from fastvideocodec_torch.ops.warp import depth_to_space


def build_lsvc_decode(module: LSVC, GOP: int, H: int, W: int):
    """Decode graph for ``module`` at [GOP, H, W] full resolution.

    Returns (decode_fn, example_latents). ``decode_fn(iframe_s2d, mv_q,
    z_qs, feat_qs)`` returns (recon mean, sum of per-layer sigma means) as
    float32 scalars, and the recon [GOP-1, 3, H, W] as a third value. The
    example latents are drawn from a ``torch.Generator`` seeded with 0, on
    the module's device, in its dtype, with the shapes the host decoder would produce
    (iframe_s2d is [12, H/2, W/2]); like the JAX version's, their values
    only set shapes.
    """
    bs = GOP - 1
    sched = module.schedule(bs)
    dtype = module.dtype
    device = next(module.parameters()).device

    @torch.inference_mode()
    def decode(iframe_s2d, mv_q, z_qs, feat_qs):
        mv_hat = module.mv_decoder(mv_q)
        com = [None] * bs
        sigma_sum = torch.zeros((), dtype=torch.float32, device=mv_q.device)
        for li, layer in enumerate(sched.layers):
            sigma_sum = sigma_sum + module.prior_decoder(z_qs[li]).float().mean()
            ref = torch.stack(
                [iframe_s2d if sched.parents[f] == 0 else com[sched.parents[f] - 1]
                 for f in layer]
            )
            mc, _ = module.motioncompensation(ref, mv_hat[[f - 1 for f in layer]])
            com_frames = torch.clamp(module.res_decoder(feat_qs[li]) + mc, 0.0, 1.0)
            for i, f in enumerate(layer):
                com[f - 1] = com_frames[i]
        out = depth_to_space(torch.stack(com), module.S2D)
        return out.float().mean(), sigma_sum, out

    gen = torch.Generator(device=device).manual_seed(0)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    lh, lw = H // 16, W // 16  # latent resolution, /16 of full
    mv_q = normal(bs, module.channels, lh, lw)
    z_qs = [normal(len(layer), OUT_CHANNEL_N, lh // 4, lw // 4) for layer in sched.layers]
    feat_qs = [normal(len(layer), OUT_CHANNEL_M, lh, lw) for layer in sched.layers]
    return decode, (mv_q, z_qs, feat_qs)
