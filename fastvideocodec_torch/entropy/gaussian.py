"""Conditional Gaussian entropy model at eval time, ported from
fastvideocodec_tpu/entropy/gaussian.py (compressai GaussianConditional).
The coder's scale table and CDF tables wait for real bits."""

from __future__ import annotations

import torch

from fastvideocodec_torch.ops.math import gaussian_likelihood, quantize


class GaussianConditional:
    """Stateless: round around the means and the interval likelihood."""

    def __call__(self, x: torch.Tensor, scales: torch.Tensor, means: torch.Tensor):
        """(x_hat, likelihoods): x_hat = round(x - means) + means in x's
        dtype, the symbol rounded once in that dtype as the decoder receives
        it; the likelihood of that same symbol under N(means, scales^2),
        computed in float32 whatever the activation dtype."""
        q = quantize(x - means)
        means32 = means.float()
        lik = gaussian_likelihood(q.float() + means32, scales.float(), means32)
        return q + means, lik
