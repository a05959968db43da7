"""MS-SSIM on NCHW batches, ported from fastvideocodec_tpu/ops/msssim.py
(pytorch_msssim's defaults, the reference's metric and MS-SSIM loss,
models.py:475-487): data_range 1, an 11-tap gaussian window of sigma 1.5,
weights (0.0448, 0.2856, 0.3001, 0.2363, 0.1333), K = (0.01, 0.03), and a
2x2 average pool between the five scales.

Plain torch ops: the separable window is two depthwise convolutions
(``groups=C``, VALID padding); the pool pads only the bottom and the right
of an odd side with zeros, as the JAX package does (``F.avg_pool2d``'s
padding would pad both sides). H and W must exceed 160 (the window's
reach at the coarsest scale), as in pytorch_msssim.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _gauss_1d(size: int, sigma: float) -> np.ndarray:
    coords = np.arange(size, dtype=np.float64) - size // 2
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _gaussian_filter(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """The separable window over H, then W, per channel, VALID."""
    C, k = x.shape[1], win.shape[0]
    x = F.conv2d(x, win.reshape(1, 1, k, 1).expand(C, 1, k, 1), groups=C)
    return F.conv2d(x, win.reshape(1, 1, 1, k).expand(C, 1, 1, k), groups=C)


def _ssim(x, y, win, data_range: float = 1.0, k1: float = 0.01, k2: float = 0.03):
    """(ssim, cs) per batch item, the means of their maps."""
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu1, mu2 = _gaussian_filter(x, win), _gaussian_filter(y, win)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _gaussian_filter(x * x, win) - mu1_sq
    sigma2_sq = _gaussian_filter(y * y, win) - mu2_sq
    sigma12 = _gaussian_filter(x * y, win) - mu1_mu2
    cs_map = (2 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    ssim_map = ((2 * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1)) * cs_map
    return ssim_map.mean(dim=(1, 2, 3)), cs_map.mean(dim=(1, 2, 3))


def avg_pool2_pad(x: torch.Tensor) -> torch.Tensor:
    """2x2 mean, an odd H or W first padded with one zero row or column at
    the bottom or the right."""
    B, C, H, W = x.shape
    x = F.pad(x, (0, W % 2, 0, H % 2))
    B, C, H, W = x.shape
    return x.reshape(B, C, H // 2, 2, W // 2, 2).mean(dim=(3, 5))


def ms_ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0, win_size: int = 11,
            win_sigma: float = 1.5, weights=WEIGHTS) -> torch.Tensor:
    """The mean over the batch of the multi-scale SSIM of x and y, NCHW, a
    scalar in their dtype."""
    levels = len(weights)
    min_side = (win_size - 1) * 2 ** (levels - 1)
    if min(x.shape[-2], x.shape[-1]) <= min_side:
        raise ValueError(
            f"ms_ssim needs H and W > {min_side} for win_size={win_size} "
            f"and {levels} scales (pytorch_msssim has the same constraint); "
            f"got {x.shape[-2]}x{x.shape[-1]}"
        )
    win = torch.from_numpy(_gauss_1d(win_size, win_sigma)).to(x.device, x.dtype)
    mcs = []
    for i in range(levels):
        ssim_val, cs = _ssim(x, y, win, data_range)
        if i < levels - 1:
            mcs.append(torch.clamp(cs, min=0.0))
            x, y = avg_pool2_pad(x), avg_pool2_pad(y)
    ssim_val = torch.clamp(ssim_val, min=0.0)
    w = torch.tensor(weights, dtype=x.dtype, device=x.device)
    stacked = torch.stack(mcs + [ssim_val], dim=0)  # [levels, B]
    return torch.prod(stacked ** w[:, None], dim=0).mean()


def msssim_db(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """-10 log10(1 - ms_ssim), the reference's MS-SSIM quality
    (models.py:480)."""
    q = ms_ssim(x, y)
    return -10.0 * torch.log(1.0 - q) / math.log(10.0)
