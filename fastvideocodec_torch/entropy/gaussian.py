"""Conditional Gaussian entropy model at eval time, ported from
fastvideocodec_tpu/entropy/gaussian.py (compressai GaussianConditional).
The coder's scale table and CDF tables wait for real bits."""

from __future__ import annotations

import torch

from fastvideocodec_torch.ops.math import gaussian_likelihood


class GaussianConditional:
    """Stateless: round around the means and the interval likelihood."""

    def __call__(self, x: torch.Tensor, scales: torch.Tensor, means: torch.Tensor):
        """(x_hat, likelihoods), both float32: x_hat = round(x - means) +
        means, the likelihood of x_hat under N(means, scales^2). Computed in
        float32 whatever the activation dtype."""
        x, scales, means = x.float(), scales.float(), means.float()
        x_hat = torch.round(x - means) + means
        return x_hat, gaussian_likelihood(x_hat, scales, means)
