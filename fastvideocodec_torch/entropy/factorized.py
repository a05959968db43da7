"""Factorized entropy bottleneck, ported from
fastvideocodec_tpu/entropy/factorized.py (Balle et al. 2018, appendix 6.1).

A per-channel non-parametric cumulative F(x) of K = 5 monotone layers.
Eval rounds to the channel median; training adds U(-0.5, 0.5) noise from
an explicit source to x itself (the medians take no part, so no gradient
reaches them). The likelihood is the sigmoid difference of the cumulative
logits with the sign trick, bounded below at 1e-9. Parameters keep the
flax names and shapes (``matrix_i``, ``bias_i``, ``factor_i``,
``quantiles``), so checkpoints load with no renaming. Computed in float32
whatever the activation dtype. ``aux_loss`` pins the quantiles
to the tails and the median of F; only the quantiles receive its gradient.

The real-bits coder's per-channel CDF tables are host numpy in float64
(``build_cdf_tables``), a copy of the JAX package's function with the same
``einsum`` and the same order of operations: an ulp in a pmf can move a
quantized frequency, and with it every byte after it. They take the
bottleneck's float32 parameters (``EntropyBottleneck.numpy_params``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from fastvideocodec_torch.ops.math import LIKELIHOOD_LOWER_BOUND, lower_bound, quantize_noise

FILTERS = (3, 3, 3, 3)
PRECISION = 16  # the coder's tables sum to 2^16
TAIL_MASS = 1e-9


class EntropyBottleneck(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.channels = channels
        filters = (1, *FILTERS, 1)
        self.K = len(FILTERS) + 1
        for i in range(self.K):
            shape = (channels, filters[i + 1])
            self.register_parameter(
                f"matrix_{i}", nn.Parameter(torch.zeros(*shape, filters[i]))
            )
            self.register_parameter(f"bias_{i}", nn.Parameter(torch.zeros(*shape, 1)))
            if i < self.K - 1:
                self.register_parameter(f"factor_{i}", nn.Parameter(torch.zeros(*shape, 1)))
        self.quantiles = nn.Parameter(torch.zeros(channels, 1, 3))

    def _logits_cumulative(self, x: torch.Tensor, detach: bool = False) -> torch.Tensor:
        """x: [C, 1, N] -> logits [C, 1, N]; ``detach``: the layers'
        parameters enter as constants."""

        def param(name):
            p = getattr(self, name)
            return p.detach() if detach else p

        logits = x
        for i in range(self.K):
            m = param(f"matrix_{i}")
            m = torch.logaddexp(m, torch.zeros_like(m))  # softplus
            logits = torch.bmm(m, logits) + param(f"bias_{i}")
            if i < self.K - 1:
                logits = logits + torch.tanh(param(f"factor_{i}")) * torch.tanh(logits)
        return logits

    def aux_loss(self) -> torch.Tensor:
        """sum |F-logits(quantiles) - (-t, 0, t)|, t = log(2/tail_mass - 1):
        pins the quantiles to the tail_mass/2, 0.5 and 1 - tail_mass/2
        points of F (compressai ``EntropyBottleneck.loss()``). The matrices,
        biases and factors enter detached, so only the quantiles receive
        its gradient (the trainer's aux group)."""
        target = float(np.log(2.0 / TAIL_MASS - 1.0))
        t = torch.tensor([-target, 0.0, target], device=self.quantiles.device)
        return torch.sum(torch.abs(self._logits_cumulative(self.quantiles, detach=True) - t))

    def dequantize(self, x: torch.Tensor) -> torch.Tensor:
        """round(x - median) + median per channel, float32 [B, C, H, W]: what
        the coder's decoder gives back (coder/service.py:FactorizedCodec)."""
        medians = self.quantiles[:, 0, 1][None, :, None, None]
        return torch.round(x.float() - medians) + medians

    def forward(self, x: torch.Tensor, training: bool = False, noise=None):
        """x [B, C, H, W] -> (x_hat, likelihoods), both float32 [B, C, H, W]:
        x_hat the round around the medians, or in training x + noise(x)
        (``noise`` an ``ops.math.UniformNoise``-like source)."""
        x_hat = quantize_noise(x.float(), noise) if training else self.dequantize(x)
        # channel-major flattening for the per-channel cumulative
        v = x_hat.transpose(0, 1).reshape(self.channels, 1, -1)
        lower = self._logits_cumulative(v - 0.5)
        upper = self._logits_cumulative(v + 0.5)
        sign = -torch.sign(lower + upper)
        likelihood = torch.abs(torch.sigmoid(sign * upper) - torch.sigmoid(sign * lower))
        likelihood = lower_bound(likelihood, LIKELIHOOD_LOWER_BOUND)
        shape = (self.channels, x.shape[0], *x.shape[2:])
        return x_hat, likelihood.reshape(shape).transpose(0, 1)

    def numpy_params(self) -> dict:
        """The parameters as float32 numpy arrays under their flax names,
        as ``build_cdf_tables`` takes them."""
        return {name: p.detach().float().cpu().numpy() for name, p in self.named_parameters()}


def logits_cumulative_numpy(params: dict, x: np.ndarray, filters_n: int) -> np.ndarray:
    """Host-side replica of _logits_cumulative for CDF-table construction.

    params: the bottleneck's param dict (numpy-able); x: [C, 1, N].
    """
    logits = x
    for i in range(filters_n):
        m = np.logaddexp(0.0, np.asarray(params[f"matrix_{i}"]))  # softplus
        logits = np.einsum("cof,cfn->con", m, logits) + np.asarray(params[f"bias_{i}"])
        if i < filters_n - 1:
            f = np.tanh(np.asarray(params[f"factor_{i}"]))
            logits = logits + f * np.tanh(logits)
    return logits


def build_cdf_tables(params: dict):
    """Quantized per-channel CDFs for the host range coder: (cdf [C, Lmax+2]
    uint32 cumulative frequencies summing to 2^PRECISION, cdf_lengths [C],
    offsets [C]), compressai's ``update()`` contract. The support of a
    channel runs from its lower to its upper quantile around the median;
    the mass outside it goes into one extra escape bucket."""
    quantiles = np.asarray(params["quantiles"])  # [C, 1, 3]
    medians = quantiles[:, 0, 1]
    minima = np.ceil(medians - quantiles[:, 0, 0]).astype(np.int64)
    maxima = np.ceil(quantiles[:, 0, 2] - medians).astype(np.int64)
    minima = np.maximum(minima, 0)
    maxima = np.maximum(maxima, 0)
    offsets = -minima
    C = medians.shape[0]
    pmf_lengths = maxima + minima + 1
    max_len = int(pmf_lengths.max())

    samples = np.arange(max_len, dtype=np.float64)[None, None, :] - minima[:, None, None]
    samples = samples + medians[:, None, None]

    k = len(FILTERS) + 1
    lower = logits_cumulative_numpy(params, samples - 0.5, k)
    upper = logits_cumulative_numpy(params, samples + 0.5, k)
    sign = -np.sign(lower + upper)

    def sigmoid(v):
        return 1.0 / (1.0 + np.exp(-v))

    pmf = np.abs(sigmoid(sign * upper) - sigmoid(sign * lower))[:, 0, :]  # [C, L]

    tail = sigmoid(lower[:, 0, :1]) + sigmoid(-upper[:, 0, -1:])
    cdfs = np.zeros((C, max_len + 2), dtype=np.uint32)
    lengths = np.zeros((C,), dtype=np.int32)
    for c in range(C):
        L = int(pmf_lengths[c])
        p = np.concatenate([pmf[c, :L], tail[c]])
        cdfs[c, : L + 2] = pmf_to_quantized_cdf(p)
        lengths[c] = L + 2
    return cdfs, lengths, offsets.astype(np.int32)


def pmf_to_quantized_cdf(pmf: np.ndarray) -> np.ndarray:
    """Quantize a pmf to a cumulative distribution summing to 2^PRECISION.

    Every symbol keeps frequency >= 1 (taken from the largest buckets),
    like compressai's C++ ``pmf_to_quantized_cdf``.
    """
    pmf = np.clip(np.nan_to_num(pmf, nan=0.0), 0.0, None).astype(np.float64)
    total = 1 << PRECISION
    freq = np.round(pmf / max(pmf.sum(), 1e-30) * total).astype(np.int64)
    freq = np.maximum(freq, 1)
    excess = int(freq.sum() - total)
    while excess > 0:
        i = int(np.argmax(freq))
        take = min(excess, int(freq[i] - 1))
        if take <= 0:
            # one at a time from every bucket above 1
            for j in np.argsort(-freq):
                if excess == 0:
                    break
                if freq[j] > 1:
                    freq[j] -= 1
                    excess -= 1
            break
        freq[i] -= take
        excess -= take
    while excess < 0:
        i = int(np.argmax(freq))
        freq[i] += -excess
        excess = 0
    cdf = np.zeros(len(freq) + 1, dtype=np.uint32)
    cdf[1:] = np.cumsum(freq)
    return cdf
