"""Real bitstreams of the stock (``s2d=1``) scale-space codecs against the
JAX package's, on the CPU, in float32.

Cases, GOP 3, the keyframe coded:
- SSF-TINY on the shipped tiny_ssf_l2, the synth_gop_multi clip (numpy
  seed 0) at 64x128, batch 1;
- ELFVC-SP-TINY on tiny_elfvc_l3 at sp_stage 2, the same clip;
- ELFVC-SP at its full widths on ``seeded_flat("ELFVC-SP", 0)`` at
  128x256, sp_stage 2: the trained ELFVC-SP-TINY codes every P-frame y
  symbol of the clip as 0 (also at 128x256, and tiny_elfvc_l6 too), and
  so does seeded ELFVC-SP-TINY but for one symbol; this case codes
  300-odd nonzero residual y symbols a P-frame, so that the residual
  SPnet runs on nonzero decoded symbols and a nonzero carried prior. Its
  motion y symbols are all 0, as every seeded stock model's are on these
  clips;
- MCVC-Original at its full widths on ``seeded_flat("MCVC-Original",
  0)``, 3 views of 128x128 (synth_mv_gop, seed 0) as a batch of 3: the
  symbols run in JAX's NHWC order (b, y, x, c) over the batch.

For each: decode equals encode bit for bit; every symbol and every byte
of the streams is JAX's; the port's encoder recon and its decode of JAX's
streams are within 1e-4 of JAX's encoder recon (the rollout bar,
tests/test_torch_stock_ssf.py); and the seeded cases' real bits are
within 5% of the model's estimate over the same GOP (the trained tiny
models' few thousand bits sit further above it: the range coder's flush
of about 30 bits a stream).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastvideocodec_torch as ft
from fastvideocodec_torch.coder import video as tv
from fastvideocodec_torch.data.synthetic import synth_gop_multi, synth_mv_gop
from fastvideocodec_torch.gop.engine import estimated_bits
from fastvideocodec_torch.ops.kernels import warp as kw
from fastvideocodec_tpu.coder import video as jv
from fastvideocodec_tpu.models import get_codec_model as jax_get_codec_model

ATOL = 1e-4
GOP = 3
CASES = {  # case: (registry name, weights, h, w, batch)
    "SSF-TINY": ("SSF-TINY", "tiny_ssf_l2", 64, 128, 1),
    "ELFVC-SP-TINY": ("ELFVC-SP-TINY", "tiny_elfvc_l3", 64, 128, 1),
    "ELFVC-SP": ("ELFVC-SP", "seeded 0", 128, 256, 1),
    "MCVC-Original": ("MCVC-Original", "seeded 0", 128, 128, 3),
}
SEEDED = ["ELFVC-SP", "MCVC-Original"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's convs at these sizes run as fast on one thread as on
    eight, and the suite's parallel workers share the host's cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def frames_of(case) -> np.ndarray:
    """[T, B, h, w, 3]: the clip (batch 1), or B views of synth_mv_gop,
    cropped from max(h, w)."""
    _, _, h, w, batch = CASES[case]
    rng, size = np.random.default_rng(0), max(h, w)
    if batch == 1:
        return synth_gop_multi(rng, size=size, gop=GOP)[:, None, :h, :w]
    return synth_mv_gop(rng, views=batch, size=size, gop=GOP)[:, :, :h, :w]


@functools.lru_cache(maxsize=None)
def flat_params(name, weights) -> dict:
    if weights == "seeded 0":
        return ft.seeded_flat(name, 0)
    with np.load(ft.weights.asset_path(weights)) as data:
        return {k: data[k].astype(np.float32) for k in data.files}


def jax_params(name, weights) -> dict:
    tree: dict = {}
    for key, value in flat_params(name, weights).items():
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = jnp.asarray(value)
    return tree


class Recorder:
    """A codec whose decompress and decode keep the output of every call."""

    def __init__(self, codec):
        self.codec, self.calls = codec, []

    def __getattr__(self, name):
        return getattr(self.codec, name)

    def decompress(self, data, *args):
        out = self.codec.decompress(data, *args)
        self.calls.append((data, np.array(out)))
        return out

    def decode(self, data, *args):
        out = self.codec.decode(data, *args)
        self.calls.append((data, np.array(out)))
        return out

    def symbols_of(self, data):
        return next(out for d, out in self.calls if d is data)


def decode_with_symbols(spec, streams):
    """The port's decode of ``streams``, and the symbols of each stream in
    stream order (keyframe z, y, then each P-frame's motion and residual z,
    y)."""
    hps = tv.ssf_codecs(spec.module)
    for hp in hps:
        hp.z_codec, hp.y_codec = Recorder(hp.z_codec), Recorder(hp.y_codec)
    fn = tv.elfvc_decompress_gop if spec.family == "elfvc" else tv.ssf_decompress_gop
    recon = fn(spec, streams, codecs=hps)
    parts = [(hps[0], streams["keyframe"])]
    for s in streams["inter"]:
        parts += [(hps[1], s["motion"]), (hps[2], s["residual"])]
    symbols = []
    for hp, s in parts:
        symbols += [hp.z_codec.symbols_of(s["z"]), hp.y_codec.symbols_of(s["y"])]
    return recon, symbols


@functools.lru_cache(maxsize=None)
def coded(case):
    name, weights, h, w, batch = CASES[case]
    frames = frames_of(case)
    spec = ft.get_codec_model(name, device="cpu", sp_stage=2)
    ft.load_flat(spec.module, flat_params(name, weights))
    x = torch.from_numpy(np.ascontiguousarray(frames.transpose(0, 1, 4, 2, 3)))
    compress = tv.elfvc_compress_gop if spec.family == "elfvc" else tv.ssf_compress_gop
    kw.reset_launches()
    streams, recon, bits = compress(spec, x)
    launches = dict(kw.LAUNCHES)
    with torch.inference_mode():
        _, liks = spec.module(x)
    jspec = jax_get_codec_model(name, sp_stage=2, num_views=batch)
    jcompress = jv.elfvc_compress_gop if spec.family == "elfvc" else jv.ssf_compress_gop
    jstreams, jrecon, jbits = jcompress(jspec, jax_params(name, weights), jnp.asarray(frames))
    decoded, symbols = decode_with_symbols(spec, streams)
    jdecoded, jsymbols = decode_with_symbols(spec, jstreams)
    return {"streams": streams, "recon": recon, "bits": bits, "launches": launches,
            "bits_est": estimated_bits(liks), "decoded": decoded, "symbols": symbols,
            "jstreams": jstreams, "jrecon": np.asarray(jrecon), "jbits": jbits,
            "jdecoded": jdecoded, "jsymbols": jsymbols}


def nhwc(t):
    return t.permute(0, 1, 3, 4, 2).numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_equals_encode(case):
    r = coded(case)
    _, _, h, w, batch = CASES[case]
    assert r["recon"].shape == (GOP, batch, 3, h, w) and r["recon"].dtype == torch.float32
    assert torch.equal(r["decoded"], r["recon"]) and r["bits"] > 0
    assert set(r["launches"].values()) == {0}  # CPU tensors take the plain warp


@pytest.mark.parametrize("case", sorted(CASES))
def test_streams_are_jax_streams(case):
    """Every symbol, every byte and every NHWC shape: the whole streams
    dict equals JAX's."""
    r = coded(case)
    assert len(r["symbols"]) == len(r["jsymbols"]) == 2 + 4 * (GOP - 1)
    for a, b in zip(r["symbols"], r["jsymbols"], strict=True):
        np.testing.assert_array_equal(a, b)
    assert r["streams"] == r["jstreams"]
    assert r["bits"] == r["jbits"]
    assert r["streams"]["y0_shape"][0] == CASES[case][4]


@pytest.mark.parametrize("case", sorted(CASES))
def test_recon_and_decode_of_jax_streams_match_jax(case):
    r = coded(case)
    assert nhwc(r["recon"]).shape == r["jrecon"].shape
    np.testing.assert_allclose(nhwc(r["recon"]), r["jrecon"], rtol=0, atol=ATOL)
    np.testing.assert_allclose(nhwc(r["jdecoded"]), r["jrecon"], rtol=0, atol=ATOL)


@pytest.mark.parametrize("case", ["SSF-TINY", *SEEDED])
def test_p_frame_residual_symbols_are_not_all_zero(case):
    """These cases code nonzero residual y symbols in every P-frame, so the
    streams above hold the P-frames' coding, not zeros alone; the trained
    ELFVC-SP-TINY codes every P-frame y symbol as 0."""
    inter = coded(case)["symbols"][2:]  # per P-frame: motion z, y, then residual z, y
    for i in range(0, len(inter), 4):
        assert np.any(inter[i + 3] != 0), (case, i // 4)
    tiny = coded("ELFVC-SP-TINY")["symbols"][2:]
    assert not any(np.any(tiny[i]) for i in range(1, len(tiny), 2))


@pytest.mark.parametrize("case", SEEDED)
def test_seeded_real_bits_near_estimate(case):
    """Within 5% of the model's estimate over the same GOP (the trained
    tiny models' few thousand bits sit further above theirs: the range
    coder's flush of about 30 bits a stream)."""
    r = coded(case)
    assert abs(r["bits"] - r["bits_est"]) / r["bits_est"] < 0.05, (r["bits"], r["bits_est"])


@pytest.mark.parametrize("case", ["SSF-TINY", "MCVC-Original"])
def test_bf16_decode_equals_encode(case):
    """bfloat16: decode equals encode bit for bit, and the real bits are
    within 5% of the bfloat16 model's own estimate (its flush overhead
    included, as in float32: SSF-TINY's real bits sit 1.4% above its f32
    estimate)."""
    name, weights, *_ = CASES[case]
    spec = ft.get_codec_model(name, dtype=torch.bfloat16, device="cpu")
    ft.load_flat(spec.module, flat_params(name, weights))
    x = torch.from_numpy(np.ascontiguousarray(frames_of(case).transpose(0, 1, 4, 2, 3)))
    streams, recon, bits = tv.ssf_compress_gop(spec, x.to(torch.bfloat16))
    assert recon.dtype == torch.bfloat16 and bits > 0
    assert torch.equal(tv.ssf_decompress_gop(spec, streams), recon)
    with torch.inference_mode():
        _, liks = spec.module(x)
    est = estimated_bits(liks)
    assert abs(bits - est) / est < 0.05, (bits, est)
