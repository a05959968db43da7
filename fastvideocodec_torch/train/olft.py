"""MCVC-IA-OLFT's online fine-tuning (OLFT), ported from
fastvideocodec_tpu/train/olft.py (reference replace_elements,
models.py:2192-2235, and train_multiview.py:171-244).

The camera ships the top ``ratio`` share of a frame's values by
reconstruction error as "touch-up" labels: ``touchup_labels`` builds the
label (the recon with those values replaced by the raw frame's) on the
device, ``touchup_bits`` prices them on the host (zlib of the deltas and
the location bitmap; ``touchup_bytes`` for the port's NCHW tensors),
``olft_loss`` and ``make_olft_step`` fine-tune on them, and
``probe_sample_interval`` picks the frame sampling interval that fits a
bandwidth budget.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from fastvideocodec_torch.gop.engine import alive_mse, rollout, view_weights
from fastvideocodec_torch.ops.math import bits_estimate, psnr_from_mse
from fastvideocodec_torch.layers.blocks import cast_once
from fastvideocodec_torch.train.trainer import descend, make_optimizer


def touchup_labels(recon: torch.Tensor, raw: torch.Tensor, ratio: float):
    """(label, mask): the mask holds every element of |recon - raw| at or
    above its k-th largest value, k = int(ratio * numel) (ties included),
    and the label is raw there and recon elsewhere, in their promoted
    dtype as JAX's ``jnp.where`` gives it (float32 beside a bf16 recon).
    ``ratio`` <= 0 gives (recon, an all-false mask)."""
    if ratio <= 0:
        return recon, torch.zeros_like(recon, dtype=torch.bool)
    diff = torch.abs(recon - raw)
    k = int(ratio * diff.numel())
    thresh = torch.topk(diff.flatten(), k).values[-1]
    mask = diff >= thresh
    return torch.where(mask, raw, recon), mask


def olft_loss(spec, gop: torch.Tensor, noise, mask, ratio: float):
    """(loss, metrics) of OLFT on MCVC's gop [T, B*V, 3, H, W] of raw frames
    and its view mask [B*V] (JAX's ``make_olft_step`` loss): each frame's
    touch-up label is built from the detached plain reference of that
    frame, and the loss is sum(r * alive-view MSE of the enhanced recon
    against the label), with no rate term (the touch-up bandwidth is
    priced on the host). Metrics: ``loss``; ``psnr`` against the raw
    frames; ``bpp``, the estimated bits of every likelihood over T *
    B*V*H*W pixels; ``img_loss``, the mean label MSE; and for the host's
    pricing ``touch_refs``, ``touch_labels`` and ``touch_mask`` [T, B*V, 3,
    H, W]."""
    T, N, _, H, W = gop.shape
    alive = view_weights(mask, N, gop.device)
    recons, liks, refs = spec.module(gop, alive, True, noise)
    refs = refs.detach()
    labels, masks = zip(*(touchup_labels(refs[t], gop[t], ratio) for t in range(T)))
    labels, masks = torch.stack(labels), torch.stack(masks)
    mse = alive_mse(recons, labels, alive)
    loss = torch.sum(spec.r * mse)
    bits = sum(bits_estimate(part[key]) for lik in liks for part in lik.values()
               for key in ("y", "z"))
    psnr = psnr_from_mse(torch.clamp(alive_mse(recons, gop, alive), min=1e-12))
    return loss, {"loss": loss, "psnr": torch.mean(psnr), "bpp": bits / (T * N * H * W),
                  "img_loss": torch.mean(mse), "touch_refs": refs, "touch_labels": labels,
                  "touch_mask": masks}


def make_olft_step(spec, cfg, ratio: float, optimizer=None):
    """OLFT's training step (JAX's ``make_olft_step``): (init_fn(params) ->
    opt_state, step_fn).

    step_fn(params, opt_state, gop, noise, mask=None) -> (params,
    opt_state, metrics), as ``make_train_step``'s, on ``olft_loss``: its
    metrics and ``grad_norm`` (pop the ``touch_*`` tensors before logging
    scalars)."""
    tx = make_optimizer(cfg) if optimizer is None else optimizer

    def init_fn(params: dict) -> dict:
        return tx.init(params)

    def step_fn(params: dict, opt_state: dict, gop: torch.Tensor, noise, mask=None):
        for p in params.values():
            p.grad = None
        with cast_once():
            loss, metrics = olft_loss(spec, gop, noise, mask, ratio)
            loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        params, opt_state, metrics["grad_norm"] = descend(tx, params, opt_state)
        return params, opt_state, metrics

    return init_fn, step_fn


def touchup_bits(recon: np.ndarray, label: np.ndarray, mask: np.ndarray,
                 use_compression: bool = True) -> int:
    """The touch-up labels' bandwidth in bytes (models.py:2218-2233), on the
    host: zlib of the changed values' deltas (uint8) and the packed
    location bitmap; without compression the raw uint8 label."""
    if not mask.any():
        return 0
    if use_compression:
        deltas = ((label - recon) * 255.0).astype(np.uint8)[mask]
        payload = deltas.tobytes() + np.packbits(mask.astype(np.uint8)).tobytes()
        return len(zlib.compress(payload))
    return len((label * 255.0).astype(np.uint8).tobytes())


def touchup_bytes(recon: torch.Tensor, label: torch.Tensor, mask: torch.Tensor) -> int:
    """``touchup_bits`` of NCHW tensors [..., 3, H, W] on any device, priced
    in the JAX package's channel-last order (the bytes it counts)."""
    def host(t):
        return np.ascontiguousarray(torch.movedim(t, -3, -1).cpu().numpy())

    return touchup_bits(host(recon.float()), host(label.float()), host(mask))


def probe_sample_interval(spec, dataset, sample_ratio: float, bw_limit_bps: float,
                          fps: float = 30.0, num_gops: int = 2, rng=None) -> int:
    """The bandwidth probe (reference probe_sample_interval,
    train_multiview.py:392-406): the touch-up rate, in bits a second at
    ``fps``, of ``num_gops`` GOPs of ``dataset`` (each drawn with ``rng``,
    a numpy Generator, default_rng(0) if None; the eval rollout with every
    view alive, the labels over the whole GOP) sampled every frame, and the
    frame sampling interval that fits it under ``bw_limit_bps``. The GOPs
    go to the device of the model's parameters."""
    rng = np.random.default_rng(0) if rng is None else rng
    device = next(spec.module.parameters()).device
    total_bits = total_frames = 0
    for _ in range(num_gops):
        idx = int(rng.integers(0, len(dataset)))
        gop = torch.as_tensor(dataset[idx]).to(device)
        recons, _ = rollout(spec, gop)
        labels, masks = touchup_labels(recons, gop, sample_ratio)
        total_bits += 8 * touchup_bytes(recons, labels, masks)
        total_frames += gop.shape[0]
    rate_bps = total_bits / max(total_frames, 1) * fps
    return max(1, int(np.ceil(rate_bps / max(bw_limit_bps, 1.0))))
