"""Conditional Gaussian and Laplace entropy models, ported from
fastvideocodec_tpu/entropy/gaussian.py (compressai GaussianConditional, and
the Laplace rate model of LSVC, reference models.py:1216-1245).

Real-bitstream coding uses a fixed scale table: each latent is bucketed to
one of SCALES_LEVELS scales (``build_indexes``) and coded with that scale's
quantized CDF over a bounded integer support. The tables are host numpy in
float64, built as the JAX package builds them: the Gaussian ones with
``scipy.stats.norm``, so that they equal the JAX package's bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from fastvideocodec_torch.entropy.factorized import pmf_to_quantized_cdf
from fastvideocodec_torch.ops import math as om

TAIL_MASS = 1e-9
LAPLACE_MXRANGE = 150  # the Laplace tables' support is at most [-150, 150]


class ScaleTable:
    """The coder's scale table (float64 numpy) and the bucketing of scales
    into it, on the scales' own device."""

    def __init__(self):
        self.table = om.scale_table()
        self._on_device = {}

    def build_indexes(self, scales: torch.Tensor) -> torch.Tensor:
        table = self._on_device.get(scales.device)
        if table is None:
            table = self._on_device[scales.device] = torch.as_tensor(self.table,
                                                                      device=scales.device)
        return om.build_indexes(scales, table)


class GaussianConditional(ScaleTable):
    """Round around the means, the interval likelihood, and the coder's
    scale table and CDF tables."""

    def __call__(self, x: torch.Tensor, scales: torch.Tensor, means: torch.Tensor | None = None,
                 training: bool = False, noise=None):
        """(x_hat, likelihoods): x_hat = round(x - means) + means in x's
        dtype, the symbol rounded once in that dtype as the decoder receives
        it; the likelihood of that same symbol under N(means, scales^2),
        computed in float32 whatever the activation dtype. In training
        x_hat = x + noise(x), as in the JAX package: the noise goes on x
        itself, not on x - means, and the likelihood is that of x_hat.
        Without ``means`` (the JAX package's ``means=None`` branch, which no
        codec takes) the means are 0: x_hat = round(x)."""
        if means is None:
            means = torch.zeros((), dtype=x.dtype, device=x.device)
        means32 = means.float()
        if training:
            x_hat = om.quantize_noise(x, noise)
            return x_hat, om.gaussian_likelihood(x_hat.float(), scales.float(), means32)
        q = om.quantize(x - means)
        lik = om.gaussian_likelihood(q.float() + means32, scales.float(), means32)
        return q + means, lik

    def build_cdf_tables(self):
        """Quantized CDFs per table scale: (cdfs [S, L+2], lengths, offsets),
        the support of each cut where the tail mass is 1e-9, as compressai's
        ``update()`` cuts it (no further bound)."""
        from scipy.stats import norm

        multiplier = -norm.ppf(TAIL_MASS / 2)
        pmf_center = np.ceil(self.table * multiplier).astype(np.int64)
        S = len(self.table)
        max_len = int((2 * pmf_center + 1).max())
        cdfs = np.zeros((S, max_len + 2), dtype=np.uint32)
        lengths = np.zeros((S,), dtype=np.int32)
        offsets = (-pmf_center).astype(np.int32)
        for s in range(S):
            c = int(pmf_center[s])
            samples = np.arange(-c, c + 1, dtype=np.float64)
            up = norm.cdf((samples + 0.5) / self.table[s])
            lo = norm.cdf((samples - 0.5) / self.table[s])
            pmf = up - lo
            tail = 2 * norm.cdf((-c - 0.5) / self.table[s])
            p = np.concatenate([pmf, [max(tail, 1e-12)]])
            q = pmf_to_quantized_cdf(p)
            cdfs[s, : len(q)] = q
            lengths[s] = len(q)
        return cdfs, lengths, offsets


class LaplaceConditional(ScaleTable):
    """Laplace(0, sigma) rate model, zero-mean, and its coder's scale table
    and CDF tables."""

    def likelihood(self, x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
        return om.laplace_likelihood(x, sigma)

    def build_cdf_tables(self):
        """Per-scale quantized Laplace CDFs, each support cut where the tail
        mass is 1e-9 and at most [-LAPLACE_MXRANGE, LAPLACE_MXRANGE]."""
        S = len(self.table)

        def lap_cdf(v, b):
            return np.where(v < 0, 0.5 * np.exp(v / b), 1 - 0.5 * np.exp(-v / b))

        half = np.ceil(-self.table * np.log(TAIL_MASS)).astype(np.int64)
        half = np.minimum(np.maximum(half, 1), LAPLACE_MXRANGE)
        max_len = int((2 * half + 1).max())
        cdfs = np.zeros((S, max_len + 2), dtype=np.uint32)
        lengths = np.zeros((S,), dtype=np.int32)
        offsets = (-half).astype(np.int32)
        for s in range(S):
            c = int(half[s])
            samples = np.arange(-c, c + 1, dtype=np.float64)
            pmf = lap_cdf(samples + 0.5, self.table[s]) - lap_cdf(samples - 0.5, self.table[s])
            tail = 2 * lap_cdf(-c - 0.5, self.table[s])
            p = np.concatenate([pmf, [max(tail, 1e-12)]])
            q = pmf_to_quantized_cdf(p)
            cdfs[s, : len(q)] = q
            lengths[s] = len(q)
        return cdfs, lengths, offsets
