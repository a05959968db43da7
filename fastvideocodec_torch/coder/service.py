"""Latent-level real-bitstream codecs: symbols and scales in, bytes out,
ported from fastvideocodec_tpu/coder/service.py.

- FactorizedCodec: EntropyBottleneck latents (symbols = round(x - median),
  per-channel tables from entropy/factorized.build_cdf_tables).
- GaussianCodec: mean-scale conditional latents (index = the scale-table
  bucket of each element; symbols = round(x - mean)).
- LaplaceCodec: zero-mean Laplace latents (the LSVC feature rates).
- BitEstimatorCodec: BitEstimator latents (LSVC's z and mv), the CDF grid
  evaluated once per channel.

Arrays are numpy with the table index on the LAST axis, as the JAX package
codes its NHWC arrays: the port hands its NCHW tensors over as
``permute(0, 2, 3, 1)`` so that both packages code the same symbol order
and write the same bytes. Tables are built once per codec, on the host.
The scale-table codecs bucket scales with ``bucket``, on the scales' own
device: on the card for the video path, so that only one byte a symbol
crosses to the host and its threads only code, and on the host for
``compress``/``decompress``.
"""

from __future__ import annotations

import numpy as np
import torch

from fastvideocodec_torch.coder import decode_with_indexes, encode_with_indexes
from fastvideocodec_torch.entropy.factorized import build_cdf_tables, pmf_to_quantized_cdf
from fastvideocodec_torch.entropy.gaussian import GaussianConditional, LaplaceConditional

BIT_ESTIMATOR_MXRANGE = 150  # the BitEstimator tables' support is [-150, 150]


def _channel_indexes(shape) -> np.ndarray:
    return np.broadcast_to(np.arange(shape[-1], dtype=np.int32), shape)


class FactorizedCodec:
    """Real coding for EntropyBottleneck latents."""

    def __init__(self, params: dict):
        params = {k: np.asarray(v) for k, v in params.items()}
        self.cdfs, self.lengths, self.offsets = build_cdf_tables(params)
        self.medians = np.asarray(params["quantiles"])[:, 0, 1]

    def compress(self, x: np.ndarray) -> bytes:
        """x: [..., C] raw (unquantized) latents."""
        symbols = np.round(x - self.medians).astype(np.int32)
        return encode_with_indexes(symbols, _channel_indexes(x.shape), self.cdfs,
                                   self.lengths, self.offsets)

    def decompress(self, data: bytes, shape) -> np.ndarray:
        """Dequantized latents, round(x - median) + median, float32."""
        symbols = decode_with_indexes(data, _channel_indexes(shape), self.cdfs,
                                      self.lengths, self.offsets)
        return symbols.astype(np.float32) + self.medians


class _ScaleTableCodec:
    """A codec whose table index is the bucket of each symbol's scale in the
    scale table: ``compress``/``decompress`` take numpy scales, as the JAX
    codecs do; ``encode``/``decode`` take the indexes that ``bucket`` gives
    for a tensor on its own device."""

    def __init__(self, cond, cdf_tables):
        self.cond = cond
        self.cdfs, self.lengths, self.offsets = cdf_tables

    def bucket(self, scales: torch.Tensor) -> torch.Tensor:
        """The table index of each scale, on the scales' device, uint8 (the
        table has SCALES_LEVELS = 64 scales)."""
        return self.cond.build_indexes(scales).to(torch.uint8)

    def _host_indexes(self, scales) -> np.ndarray:
        return self.bucket(torch.from_numpy(np.ascontiguousarray(scales))).numpy()

    def encode(self, symbols: np.ndarray, indexes: np.ndarray) -> bytes:
        return encode_with_indexes(symbols, indexes, self.cdfs, self.lengths, self.offsets)

    def decode(self, data: bytes, indexes: np.ndarray) -> np.ndarray:
        """int32 symbols shaped like ``indexes``."""
        return decode_with_indexes(data, indexes, self.cdfs, self.lengths, self.offsets)


class GaussianCodec(_ScaleTableCodec):
    def __init__(self):
        gc = GaussianConditional()
        super().__init__(gc, gc.build_cdf_tables())

    def compress(self, x, scales, means=None) -> bytes:
        symbols = np.round(x - means if means is not None else x).astype(np.int32)
        return self.encode(symbols, self._host_indexes(scales))

    def decompress(self, data, scales, means=None) -> np.ndarray:
        out = self.decode(data, self._host_indexes(scales))
        out = out.astype(np.float32)
        return out + means if means is not None else out


class LaplaceCodec(_ScaleTableCodec):
    def __init__(self):
        lc = LaplaceConditional()
        super().__init__(lc, lc.build_cdf_tables())

    def compress(self, x, scales) -> bytes:
        symbols = np.round(x).astype(np.int32)
        return self.encode(symbols, self._host_indexes(scales))

    def decompress(self, data, scales) -> np.ndarray:
        return self.decode(data, self._host_indexes(scales)).astype(np.float32)


def _bitparm_numpy(x, h, b, a=None):
    y = x * np.logaddexp(0.0, h) + b  # softplus(h), overflow-safe
    if a is None:
        return 1.0 / (1.0 + np.exp(-np.clip(y, -60, 60)))
    return y + np.tanh(y) * np.tanh(a)


class BitEstimatorCodec:
    """Real coding for BitEstimator latents (per-channel factorized): the
    quantized CDF of each channel over [-BIT_ESTIMATOR_MXRANGE,
    BIT_ESTIMATOR_MXRANGE], from one evaluation of the 4-layer monotone net
    on the integer grid."""

    def __init__(self, params: dict):
        # params: {'f1': {'h', 'b', 'a'}, ..., 'f4': {'h', 'b'}}
        p = {k: {kk: np.asarray(vv) for kk, vv in v.items()} for k, v in params.items()}
        C = p["f1"]["h"].shape[-1]
        grid = np.arange(-BIT_ESTIMATOR_MXRANGE, BIT_ESTIMATOR_MXRANGE + 1, dtype=np.float64)
        x = np.tile(grid[:, None], (1, C))  # [G, C]

        def F(v):
            v = _bitparm_numpy(v, p["f1"]["h"], p["f1"]["b"], p["f1"]["a"])
            v = _bitparm_numpy(v, p["f2"]["h"], p["f2"]["b"], p["f2"]["a"])
            v = _bitparm_numpy(v, p["f3"]["h"], p["f3"]["b"], p["f3"]["a"])
            return _bitparm_numpy(v, p["f4"]["h"], p["f4"]["b"])

        pmf = (F(x + 0.5) - F(x - 0.5)).T  # [C, G]
        tail = 1.0 - pmf.sum(axis=1, keepdims=True)
        G = pmf.shape[1]
        self.cdfs = np.zeros((C, G + 2), dtype=np.uint32)
        self.lengths = np.full((C,), G + 2, dtype=np.int32)
        self.offsets = np.full((C,), -BIT_ESTIMATOR_MXRANGE, dtype=np.int32)
        for c in range(C):
            p_c = np.concatenate([pmf[c], [max(float(tail[c, 0]), 1e-12)]])
            self.cdfs[c, : G + 2] = pmf_to_quantized_cdf(p_c)

    def compress(self, x: np.ndarray) -> bytes:
        symbols = np.round(x).astype(np.int32)
        return encode_with_indexes(symbols, _channel_indexes(x.shape), self.cdfs,
                                   self.lengths, self.offsets)

    def decompress(self, data: bytes, shape) -> np.ndarray:
        symbols = decode_with_indexes(data, _channel_indexes(shape), self.cdfs,
                                      self.lengths, self.offsets)
        return symbols.astype(np.float32)
