"""Real bitstreams of the port against the JAX package's, on the CPU.

LSVC-TPU-TINY (tiny_lsvctpu_l2) and LSVC-TPU (hd_lsvctpuf2_l2) code the
synth_gop_multi clip (numpy seed 0) at 64x128, GOP 4; SSF-TPU-TINY
(tiny_ssftpu_l2) codes it at 128x128, GOP 3, batch 1. For each, in float32:

- the port's decode equals its encode recon bit for bit;
- its encode recon is within RECON_ATOL of JAX's ``lsvc_compress`` /
  ``ssf_compress_gop`` recon: the rollout parity tolerance
  (tests/test_torch_lsvc.py, tests/test_torch_ssf.py; about 3e-6 measured);
- the symbols of the two packages' streams, both decoded by the port,
  differ at no more than MAX_SYMBOL_FLIPS of them: a feature within 3e-6
  of x.5 may round the other way (none does at this seed);
- every stream whose symbols agree is byte for byte JAX's, and the streams
  hold the same keys and NHWC shapes;
- the port decodes JAX's streams to within RECON_ATOL of JAX's recon;
- the port's real bits are within 5% of its own estimated bits (the
  clamped estimate of its rollout for LSVC, of its keyframe + inter
  forward for SSF), as TestGoldenRDLSVCTPU holds JAX's.

One bfloat16 case per family: decode equals encode bit for bit.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastvideocodec_torch as ft
from fastvideocodec_torch.coder import measure_ac_time
from fastvideocodec_torch.coder import video as tv
from fastvideocodec_torch.data.synthetic import synth_gop_multi
from fastvideocodec_torch.ops.kernels import warp as kw
from fastvideocodec_torch.ops.math import bits_estimate
from fastvideocodec_tpu.coder import video as jv
from fastvideocodec_tpu.models import get_codec_model as jax_get_codec_model
from fastvideocodec_tpu.train.checkpoint import asset_params

RECON_ATOL = 1e-4
MAX_SYMBOL_FLIPS = 2
EST_REL = 0.05
CONFIGS = {
    "LSVC-TPU-TINY": ("tiny_lsvctpu_l2", 4, 64, 128),
    "LSVC-TPU": ("hd_lsvctpuf2_l2", 4, 64, 128),
    "SSF-TPU-TINY": ("tiny_ssftpu_l2", 3, 128, 128),
}


def clip(gop, h, w) -> np.ndarray:
    return synth_gop_multi(np.random.default_rng(0), size=max(h, w), gop=gop)[:, :h, :w]


def port_model(name, dtype=torch.float32):
    spec = ft.get_codec_model(name, dtype=dtype, device="cpu")
    ft.load_asset(spec.module, CONFIGS[name][0])
    return spec


class Recorder:
    """A codec whose decompress and decode keep (stream, output) of every
    call (from the coder's threads: list appends are atomic)."""

    def __init__(self, codec):
        self.codec, self.calls = codec, []

    def __getattr__(self, name):
        return getattr(self.codec, name)

    def _record(self, fn, data, *args):
        out = fn(data, *args)
        self.calls.append((data, np.array(out)))
        return out

    def decompress(self, data, *args):
        return self._record(self.codec.decompress, data, *args)

    def decode(self, data, *args):
        return self._record(self.codec.decode, data, *args)

    def symbols_of(self, data):
        return next(out for d, out in self.calls if d is data)


def recorded_codecs(spec):
    """The port's codecs with every decoded symbol array recorded, and the
    stream lists of each recorder: (codecs, {key path: recorder})."""
    if spec.family == "lsvc":
        mv, z, feat = (Recorder(c) for c in tv.lsvc_codecs(spec.module))
        return (mv, z, feat), {"mv": mv, "z": z, "features": feat}
    hps = tv.ssf_codecs(spec.module)
    recs = {}
    for name, hp in zip(("keyframe", "motion", "residual"), hps):
        hp.z_codec, hp.y_codec = Recorder(hp.z_codec), Recorder(hp.y_codec)
        recs[name] = hp
    return hps, recs


def streams_and_symbols(spec, streams, gop, iframe):
    """Decode ``streams`` with the port, recording the symbols: (recon,
    [(stream bytes, symbols)] in a fixed order)."""
    codecs, recs = recorded_codecs(spec)
    if spec.family == "lsvc":
        recon = tv.lsvc_decompress(spec, iframe, streams, gop - 1, codecs=codecs)
        pairs = [(streams["mv"], recs["mv"].symbols_of(streams["mv"]))]
        for key in ("z", "features"):
            pairs += [(d, recs[key].symbols_of(d)) for d in streams[key]]
        return recon, pairs
    recon = tv.ssf_decompress_gop(spec, streams, codecs=codecs)
    parts = [("keyframe", streams["keyframe"])]
    for s in streams["inter"]:
        parts += [("motion", s["motion"]), ("residual", s["residual"])]
    pairs = []
    for name, s in parts:
        hp = recs[name]
        pairs += [(s["z"], hp.z_codec.symbols_of(s["z"])),
                  (s["y"], hp.y_codec.symbols_of(s["y"]))]
    return recon, pairs


def structure(streams):
    """The keys and shapes of a streams dict, with the bytes left out."""
    if isinstance(streams, dict):
        return {k: structure(v) for k, v in streams.items()}
    if isinstance(streams, list):
        return [structure(v) for v in streams]
    return "bytes" if isinstance(streams, bytes) else tuple(streams)


@functools.lru_cache(maxsize=None)
def coded(name):
    """Both packages' encodes of the clip, and the port's decodes of its own
    and of JAX's streams."""
    asset, gop, h, w = CONFIGS[name]
    frames = clip(gop, h, w)
    spec = port_model(name)
    x = torch.from_numpy(np.ascontiguousarray(frames.transpose(0, 3, 1, 2)))
    jspec = jax_get_codec_model(name)
    params = {"params": asset_params(asset)["params"]}
    kw.reset_launches()
    if spec.family == "lsvc":
        with measure_ac_time() as ac:
            streams, recon, bits = tv.lsvc_compress(spec, x)
        _, metrics = ft.rollout(spec, x)
        bits_est = float(metrics["bpp"]) * (gop - 1) * h * w
        jstreams, jrecon, jbits = jv.lsvc_compress(jspec, params, jnp.asarray(frames))
        to_nhwc = (0, 2, 3, 1)
    else:
        x = x[:, None]
        with measure_ac_time() as ac:
            streams, recon, bits = tv.ssf_compress_gop(spec, x)
        with torch.inference_mode():
            _, liks = spec.module(x)
        bits_est = sum(float(bits_estimate(v)) for lik in liks for d in lik.values()
                       for v in d.values())
        jstreams, jrecon, jbits = jv.ssf_compress_gop(jspec, params, jnp.asarray(frames)[:, None])
        to_nhwc = (0, 1, 3, 4, 2)
    decoded, symbols = streams_and_symbols(spec, streams, gop, x[0])
    jdecoded, jsymbols = streams_and_symbols(spec, jstreams, gop, x[0])
    return {
        "streams": streams, "recon": recon, "bits": bits, "decoded": decoded,
        "symbols": symbols, "ac": ac["seconds"], "bits_est": bits_est,
        "jstreams": jstreams, "jrecon": np.asarray(jrecon), "jbits": jbits,
        "jdecoded": jdecoded.permute(*to_nhwc).numpy(), "jsymbols": jsymbols,
        "recon_nhwc": recon.permute(*to_nhwc).numpy(), "launches": dict(kw.LAUNCHES),
    }


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_decode_equals_encode(name):
    r = coded(name)
    assert r["decoded"].dtype == r["recon"].dtype == torch.float32
    assert torch.equal(r["decoded"], r["recon"])
    assert r["bits"] > 0 and r["ac"] > 0.0
    assert set(r["launches"].values()) == {0}  # CPU tensors take the plain warps


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_encoder_recon_matches_jax(name):
    r = coded(name)
    assert r["recon_nhwc"].shape == r["jrecon"].shape
    np.testing.assert_allclose(r["recon_nhwc"], r["jrecon"], rtol=0, atol=RECON_ATOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_symbols_agree_with_jax(name):
    r = coded(name)
    assert len(r["symbols"]) == len(r["jsymbols"])
    flips = 0
    for (_, a), (_, b) in zip(r["symbols"], r["jsymbols"], strict=True):
        assert a.shape == b.shape
        flips += int(np.sum(a != b))
    assert flips <= MAX_SYMBOL_FLIPS, flips


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_streams_are_jax_bytes_where_symbols_agree(name):
    r = coded(name)
    assert structure(r["streams"]) == structure(r["jstreams"])
    agreeing = 0
    for (data, a), (jdata, b) in zip(r["symbols"], r["jsymbols"], strict=True):
        if np.array_equal(a, b):
            assert data == jdata
            agreeing += 1
    assert agreeing >= len(r["symbols"]) - MAX_SYMBOL_FLIPS
    if agreeing == len(r["symbols"]):
        assert r["bits"] == r["jbits"]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_port_decodes_jax_streams(name):
    r = coded(name)
    np.testing.assert_allclose(r["jdecoded"], r["jrecon"], rtol=0, atol=RECON_ATOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_real_bits_near_estimate(name):
    r = coded(name)
    assert abs(r["bits"] - r["bits_est"]) / r["bits_est"] < EST_REL, (r["bits"], r["bits_est"])


@pytest.mark.parametrize("name", ["LSVC-TPU-TINY", "SSF-TPU-TINY"])
def test_bf16_decode_equals_encode(name):
    _, gop, h, w = CONFIGS[name]
    spec = port_model(name, torch.bfloat16)
    x = torch.from_numpy(np.ascontiguousarray(clip(gop, h, w).transpose(0, 3, 1, 2)))
    if spec.family == "lsvc":
        streams, recon, bits = tv.lsvc_compress(spec, x)
        decoded = tv.lsvc_decompress(spec, x[0], streams, gop - 1)
    else:
        streams, recon, bits = tv.ssf_compress_gop(spec, x[:, None])
        decoded = tv.ssf_decompress_gop(spec, streams)
    assert recon.dtype == decoded.dtype == torch.bfloat16
    assert torch.equal(decoded, recon) and bits > 0
    f32 = coded(name)
    assert abs(bits - f32["bits"]) / f32["bits"] < 0.05  # bf16 codes near the f32 rate
