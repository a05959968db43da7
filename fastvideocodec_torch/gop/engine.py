"""GOP rollouts of the port, from fastvideocodec_tpu/gop/engine.py: the
LSVC whole-GOP call (``lsvc_gop``), the chain of DVC and Base P-frames on
the previous recon (``sequential_gop``), RLVC's chain with its recurrent
state (``rlvc_gop``), the SSF chain of inter frames
(``ssf_gop``; SSF-Official, SSF-TPU, MCVC-Original), the ELFVC chain with
its temporal state (``elfvc_gop``), both over a batch, and
the MCVC multi-view GOP with its view mask (``mcvc_gop``), dispatched by
family in ``rollout``."""

from __future__ import annotations

import torch

from fastvideocodec_torch.layers.blocks import frame_dtype
from fastvideocodec_torch.models.registry import CodecSpec
from fastvideocodec_torch.ops.math import bits_estimate, psnr_from_mse


def lsvc_gop(spec: CodecSpec, gop: torch.Tensor, training: bool = False, noise=None):
    """gop [T, 3, H, W] with frame 0 the I-frame -> (recon [T-1, 3, H, W],
    metrics). Metrics are float32: the model's losses and bpp, plus
    per-frame ``psnr``, ``mc_psnr`` and ``warp_psnr`` ([T-1]). Eval runs
    under ``torch.inference_mode``; ``training`` runs the module's training
    branch with ``noise`` and keeps the autograd graph."""
    with torch.inference_mode(not training):
        com, mc, warped, metrics = spec.module(gop, training=training, noise=noise)
        target = gop[1:].float()

        def per_frame_psnr(frames):
            return psnr_from_mse(torch.mean((frames.float() - target) ** 2, dim=(1, 2, 3)))

        metrics["psnr"] = per_frame_psnr(com)
        metrics["mc_psnr"] = per_frame_psnr(mc)
        metrics["warp_psnr"] = per_frame_psnr(warped)
    return com, metrics


def _ssf_metrics(x_cur: torch.Tensor, x_rec: torch.Tensor, lik: dict) -> dict:
    """Per-frame metrics of a frame in the codec's domain ([B, 3, H, W], or
    [B, 12, H/2, W/2] in the s2d form), float32: bpp is per full-resolution
    pixel over the B items."""
    B, C, H, W = x_cur.shape
    denom = B * H * W * (C // 3)
    mot = bits_estimate(lik["motion"]["y"]) + bits_estimate(lik["motion"]["z"])
    res = bits_estimate(lik["residual"]["y"]) + bits_estimate(lik["residual"]["z"])
    mse = torch.mean((x_rec.float() - x_cur.float()) ** 2)
    return {
        "img_loss": mse,
        "psnr": psnr_from_mse(mse),
        "bpp_est": (mot + res) / denom,
        "bpp_res_est": res / denom,
    }


def _fold(module, gop: torch.Tensor, training: bool) -> torch.Tensor:
    """gop [T, 3, H, W] (batch 1) or [T, B, 3, H, W] -> the codec's domain,
    [T, B, ...], folded once by the codec's ``fold_gop`` where it has one
    (SSF's s2d form; DVC, Base and RLVC have none). Eval casts the frames
    to the model dtype; training keeps gop's (``frame_dtype``)."""
    frames = (gop[:, None] if gop.dim() == 4 else gop).to(frame_dtype(module, gop, training))
    return module.fold_gop(frames) if hasattr(module, "fold_gop") else frames


def _unfold(module, recons: list, gop: torch.Tensor) -> torch.Tensor:
    """The P-frames' recons, unfolded once, at the rank of ``gop``."""
    recon = torch.stack(recons)
    if hasattr(module, "unfold_gop"):
        recon = module.unfold_gop(recon)
    return recon[:, 0] if gop.dim() == 4 else recon


def _stack(per_frame: list) -> dict:
    return {k: torch.stack([m[k] for m in per_frame]) for k in per_frame[0]}


def _chain(module, gop: torch.Tensor, step, training: bool):
    """The P-frames of gop [T, 3, H, W] or [T, B, 3, H, W], frame 0 the
    (uncoded) reference, each coded by ``step(t, x_cur, x_prev)`` ->
    (recon, metrics) against the previous recon, detached. Returns (recon
    [T-1, (B,) 3, H, W], metrics): float32 [T-1] stacks of the model's
    metrics and ``psnr`` from ``img_loss``; the frames in ``frame_dtype``."""
    x = _fold(module, gop, training)
    x_prev = x[0]
    recons, per_frame = [], []
    for t in range(1, x.shape[0]):
        x_rec, metrics = step(t, x[t], x_prev)
        metrics["psnr"] = psnr_from_mse(metrics["img_loss"])
        recons.append(x_rec)
        per_frame.append(metrics)
        x_prev = x_rec.detach()
    return _unfold(module, recons, gop), _stack(per_frame)


def sequential_gop(spec: CodecSpec, gop: torch.Tensor, training: bool = False, noise=None):
    """DVC and Base: each P-frame coded against the previous recon, as
    ``_chain``. Eval runs under ``torch.inference_mode``; ``training``
    draws the quantizers' noise from ``noise``, frame by frame, and keeps
    the autograd graph."""
    with torch.inference_mode(not training):
        return _chain(spec.module, gop,
                      lambda t, x_cur, x_prev: spec.module(x_cur, x_prev, training, noise),
                      training)


def rlvc_gop(spec: CodecSpec, gop: torch.Tensor, training: bool = False, noise=None):
    """RLVC, RLVC2, RLVC-HP: as ``sequential_gop``, the recurrent state
    starting at zeros and carried from frame to frame; the entropy model is
    the factorized one on the first P-frame and the RPM's after
    (rpm_flag = t > 1)."""
    module = spec.module
    with torch.inference_mode(not training):
        hidden = module.init_hidden(gop.shape[1] if gop.dim() == 5 else 1, *gop.shape[-2:],
                                    gop.device)

        def step(t, x_cur, x_prev):
            nonlocal hidden
            x_rec, hidden, metrics = module(x_prev, x_cur, hidden, t > 1, training, noise)
            return x_rec, metrics

        return _chain(module, gop, step, training)


def ssf_gop(spec: CodecSpec, gop: torch.Tensor, training: bool = False, noise=None):
    """gop [T, 3, H, W] or [T, B, 3, H, W] with frame 0 the (uncoded)
    reference -> (recon [T-1, (B,) 3, H, W], metrics): the GOP folds into
    the codec's domain once (the s2d domain for SSF-TPU), the P-frames run
    a chain of ``forward_inter`` calls, each on the previous recon
    detached, and the recon unfolds once. MCVC-Original runs here with the
    views as the batch. Metrics are float32 [T-1] stacks of ``img_loss``,
    ``psnr``, ``bpp_est`` and ``bpp_res_est``. Eval runs under
    ``torch.inference_mode``; ``training`` draws the quantizers' noise
    from ``noise``, frame by frame, and keeps the autograd graph, the
    frames in gop's dtype (``frame_dtype``)."""
    module = spec.module
    with torch.inference_mode(not training):
        x = _fold(module, gop, training)
        x_prev = x[0]
        recons, per_frame = [], []
        for i in range(1, x.shape[0]):
            x_rec, lik = module.forward_inter(x[i], x_prev, training, noise)
            recons.append(x_rec)
            per_frame.append(_ssf_metrics(x[i], x_rec, lik))
            x_prev = x_rec.detach()
        return _unfold(module, recons, gop), _stack(per_frame)


def elfvc_gop(spec: CodecSpec, gop: torch.Tensor, training: bool = False, noise=None):
    """As ``ssf_gop``, with the ELFVC state starting at zeros; with
    ``super_prec`` the metrics add ``pred_err_norm`` and ``Q_err_norm``,
    the sums over the frame's hyperpriors of the L2 norms of pred_y - y
    and of round(y - means) + means - y. All float32 [T-1]."""
    module = spec.module
    with torch.inference_mode(not training):
        x = _fold(module, gop, training)
        x_prev = x[0]
        B, _, h, w = x_prev.shape
        state = module.init_state(B, h, w)
        recons, per_frame = [], []
        for i in range(1, x.shape[0]):
            x_rec, out, state = module.forward_inter(x[i], x_prev, state, training, noise)
            recons.append(x_rec)
            metrics = _ssf_metrics(x[i], x_rec, out)
            if module.super_prec:
                for key in ("pred_err", "Q_err"):
                    metrics[f"{key}_norm"] = sum(torch.linalg.vector_norm(e.float())
                                                 for e in out[key])
            per_frame.append(metrics)
            x_prev = x_rec.detach()
        return _unfold(module, recons, gop), _stack(per_frame)


def view_weights(mask, n: int, device) -> torch.Tensor:
    """MCVC's view mask (numpy, a tensor or None: every view alive) as a
    float32 tensor [n] on ``device``."""
    mask = torch.ones(n) if mask is None else torch.as_tensor(mask)
    return mask.to(device, torch.float32)


def alive_mse(frames: torch.Tensor, target: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """Per-frame MSE over the alive views only, float32 [T]: frames and
    target [T, B*V, 3, H, W], alive the float32 view mask [B*V]."""
    per_view = torch.mean((frames.float() - target.float()) ** 2, dim=(2, 3, 4))  # [T, B*V]
    return torch.sum(per_view * alive, dim=1) / torch.clamp(torch.sum(alive), min=1.0)


def mcvc_gop(spec: CodecSpec, gop: torch.Tensor, mask=None, training: bool = False,
             noise=None):
    """gop [T, B*V, 3, H, W], the views folded into the batch (b*V + v);
    mask [B*V] of {0, 1} (numpy or tensor; None: every view alive). The
    keyframe is coded. Returns (the enhanced recon [T, B*V, 3, H, W] in the
    model dtype, metrics), the metrics float32 as in the reference's
    metrics_per_gop (train_multiview.py:161-210): ``psnr`` [T] of the
    distortion averaged over the alive views only, ``img_loss`` [T] that
    distortion (in training the mean of it and the plain references'
    distortion, which trains the reference chain alongside), ``bpp_est``
    [T] over the B*V*H*W pixels of each frame, and ``completeness``, the
    share of the views alive. Eval runs under ``torch.inference_mode``;
    ``training`` draws the quantizers' noise from ``noise`` and keeps the
    autograd graph."""
    _, N, _, H, W = gop.shape
    with torch.inference_mode(not training):
        alive = view_weights(mask, N, gop.device)
        recons, liks, refs = spec.module(gop, alive, training, noise)
        bpps = [sum(bits_estimate(part[key]) for part in lik.values() for key in ("y", "z"))
                / (N * H * W) for lik in liks]
        mse = alive_mse(recons, gop, alive)
        metrics = {
            "img_loss": 0.5 * (mse + alive_mse(refs, gop, alive)) if training else mse,
            "psnr": psnr_from_mse(mse),
            "bpp_est": torch.stack(bpps),
            "completeness": torch.sum(alive) / N,
        }
    return recons, metrics


def estimated_bits(liks) -> float:
    """The estimated bits of a codec ``forward``'s per-frame dicts: the sum
    of every "y" and "z" likelihood's bits (the keyframe's included)."""
    return sum(float(bits_estimate(part[key])) for lik in liks for name, part in lik.items()
               if name in ("keyframe", "motion", "residual") for key in ("y", "z"))


ROLLOUTS = {"lsvc": lsvc_gop, "dvc": sequential_gop, "base": sequential_gop,
            "rlvc": rlvc_gop, "ssf": ssf_gop, "elfvc": elfvc_gop}


def rollout(spec: CodecSpec, gop: torch.Tensor, mask=None, *, training: bool = False,
            noise=None):
    """Estimated-bits encode+decode of one GOP; ``mask``, the view mask, is
    MCVC's alone (it stays the third argument, as callers pass it).
    ``training``: the quantizers take U(-0.5, 0.5) noise from ``noise``
    (``ops.math.UniformNoise``, or any callable shaped like it) and the
    autograd graph is kept; every family trains."""
    if spec.family == "mcvc":
        return mcvc_gop(spec, gop, mask, training, noise)
    if mask is not None:
        raise ValueError(f"family {spec.family!r} takes no view mask")
    if spec.family not in ROLLOUTS:
        raise ValueError(f"family {spec.family!r} is not ported yet")
    return ROLLOUTS[spec.family](spec, gop, training, noise)
