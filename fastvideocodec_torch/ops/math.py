"""Quantization and rate-estimation math, ported from fastvideocodec_tpu/ops/math.py.

Quantization is the eval-time hard round (half to even, as ``jnp.round``);
training noise is not ported yet. Rates are computed in float32 whatever
the activation dtype. The real-bits coder buckets scales into the
exp-spaced ``scale_table`` (float64, host numpy) with ``build_indexes``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

LOG2 = math.log(2.0)
SCALES_MIN = 0.11  # compressai's scale lower bound
SCALES_MAX = 256.0
SCALES_LEVELS = 64
LIKELIHOOD_LOWER_BOUND = 1e-9


def quantize(x: torch.Tensor) -> torch.Tensor:
    """Hard round (eval time). It is also the JAX package's straight-through
    ``quantize_ste`` at eval time: x + (round(x) - x) equals round(x)
    exactly in floating point. The straight-through gradient waits for
    training."""
    return torch.round(x)


def laplace_cdf(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """CDF of Laplace(0, scale) at x."""
    return 0.5 - 0.5 * torch.sign(x) * torch.expm1(-torch.abs(x) / scale)


def laplace_likelihood(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """P(x - 0.5 < X <= x + 0.5) under Laplace(0, scale), scale clamped to
    [1e-5, 1e10]."""
    scale = torch.clamp(scale, 1e-5, 1e10)
    return laplace_cdf(x + 0.5, scale) - laplace_cdf(x - 0.5, scale)


def gaussian_std_cdf(x: torch.Tensor) -> torch.Tensor:
    """Standard normal CDF via erfc (compressai ``_standardized_cumulative``)."""
    return 0.5 * torch.special.erfc(-x * 2 ** -0.5)


def gaussian_likelihood(x: torch.Tensor, scale: torch.Tensor,
                        mean: torch.Tensor) -> torch.Tensor:
    """P(x - 0.5 < X <= x + 0.5) under N(mean, scale^2), the scale bounded
    below at SCALES_MIN and the result at 1e-9 (compressai
    GaussianConditional)."""
    scale = lower_bound(scale, SCALES_MIN)
    x = torch.abs(x - mean)
    upper = gaussian_std_cdf((0.5 - x) / scale)
    lower = gaussian_std_cdf((-0.5 - x) / scale)
    return lower_bound(upper - lower, LIKELIHOOD_LOWER_BOUND)


class _LowerBound(torch.autograd.Function):
    """max(x, bound); the gradient passes where x >= bound or where it
    pushes x up (grad < 0)."""

    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp(x, min=bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        pass_through = (x >= ctx.bound) | (g < 0)
        return torch.where(pass_through, g, torch.zeros_like(g)), None


def lower_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    return _LowerBound.apply(x, bound)


def bits_estimate(likelihoods: torch.Tensor) -> torch.Tensor:
    """sum(clamp(-log2(p + 1e-5), 0, 50))."""
    return torch.sum(torch.clamp(-torch.log(likelihoods + 1e-5) / LOG2, 0.0, 50.0))


def scale_table() -> np.ndarray:
    """The coder's exp-spaced scale table, SCALES_LEVELS scales from
    SCALES_MIN to SCALES_MAX, float64 numpy (reference
    entropy_models.py:18-23)."""
    return np.exp(np.linspace(math.log(SCALES_MIN), math.log(SCALES_MAX), SCALES_LEVELS))


def build_indexes(scales: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Bucket each scale into the scale table (compressai build_indexes):
    the number of entries of table[:-1] strictly below max(scale, table[0]),
    compared in the table's dtype (a binary search; a NaN scale takes the
    last bucket, as no entry compares below it in the JAX package's sum of
    comparisons); int32."""
    scales = torch.maximum(scales.to(table.dtype), table[0])
    idx = torch.searchsorted(table[:-1].contiguous(), scales.contiguous(), right=False)
    return torch.where(scales.isnan(), table.shape[0] - 1, idx).to(torch.int32)


def psnr_from_mse(mse: torch.Tensor) -> torch.Tensor:
    return 10.0 * torch.log(1.0 / mse) / math.log(10.0)
