"""Real bitstreams of the port against the JAX package's, on the CPU.

LSVC-TPU-TINY (tiny_lsvctpu_l2), LSVC-TPU (hd_lsvctpuf2_l2), the s2d=1
LSVC-128 (hd_lsvc128_l2), LSVC-TPU-RW (hd_lsvctpu_l2) and the chain
LSVC-TPU-L (hd_lsvctpuf2_l2) code the synth_gop_multi clip (numpy seed 0)
at 64x128, GOP 4; SSF-TPU-TINY
(tiny_ssftpu_l2) codes it at 128x128, GOP 3, batch 1; ELFVC-SP-TPU-TINY
(tiny_elfvctpu_l3, sp_stage 2: both SPnets replace y) at 64x128, GOP 3,
and ELFVC-TPU-TINY (no SPnet) and ELFVC-SP-TPU-TINY at sp_stage 2 and 1,
all three on ``seeded_flat(name, 0)``, at 128x256, GOP 3. The trained
ELFVC-SP-TPU-TINY codes every P-frame y symbol of this clip as 0, so the
seeded SP cases are the ones that hold the SPnets fed with decoded
symbols, and the carried round-y prior, to JAX on nonzero symbols
(``test_elfvc_sp_symbols_are_not_all_zero`` keeps them so). At 64x128
the seeded ELFVC-TPU-TINY's nine streams hold 2482 estimated bits, and
the range coder's flush (about 30 bits a stream) alone puts its real
bits 11% above them: 128x256 brings that share under 2%. For each, in
float32:

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

MCVC-IA codes 3 views of a synth_mv_gop clip (numpy seed 0), GOP 3, with
view 1 failed: MCVC-IA-TINY on tiny_mcvc_l3 at 64x64, and MCVC-IA at its
full widths on ``seeded_flat("MCVC-IA", 0)`` at 64x128. Its symbols and
streams are JAX's, all of them, with the mask carried in them; decode
equals encode bit for bit; its encoder recon and its decode of JAX's
streams are within MCVC_ATOL of JAX's encoder recon (the enhanced
frames). The trained tiny model codes every P-frame y symbol as 0; the
seeded case codes nonzero residual y symbols in every P-frame, and its
real bits are within 5% of its estimate.

ELFVC is held closer: its symbols and its streams are JAX's, all of them,
and both its encoder recon and its decode of JAX's streams are within
ELFVC_ATOL = 3e-6 of JAX's recon (measured 4e-7).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastvideocodec_torch as ft
from fastvideocodec_torch.coder import measure_ac_time
from fastvideocodec_torch.coder import video as tv
from fastvideocodec_torch.data.synthetic import synth_gop_multi, synth_mv_gop
from fastvideocodec_torch.gop.engine import estimated_bits
from fastvideocodec_torch.ops.kernels import warp as kw
from fastvideocodec_tpu.coder import video as jv
from fastvideocodec_tpu.models import get_codec_model as jax_get_codec_model
from fastvideocodec_tpu.train.checkpoint import asset_params

RECON_ATOL = 1e-4
ELFVC_ATOL = 3e-6
MAX_SYMBOL_FLIPS = 2
EST_REL = 0.05
SP_STAGE = 2  # ELFVC-SP's: both SPnets replace y (ignored by the other codecs)
CONFIGS = {  # case: (registry name, weights, gop, h, w, sp_stage)
    "LSVC-TPU-TINY": ("LSVC-TPU-TINY", "tiny_lsvctpu_l2", 4, 64, 128, SP_STAGE),
    "LSVC-TPU": ("LSVC-TPU", "hd_lsvctpuf2_l2", 4, 64, 128, SP_STAGE),
    "LSVC-128": ("LSVC-128", "hd_lsvc128_l2", 4, 64, 128, SP_STAGE),
    "LSVC-TPU-RW": ("LSVC-TPU-RW", "hd_lsvctpu_l2", 4, 64, 128, SP_STAGE),
    "LSVC-TPU-L": ("LSVC-TPU-L", "hd_lsvctpuf2_l2", 4, 64, 128, SP_STAGE),
    "SSF-TPU-TINY": ("SSF-TPU-TINY", "tiny_ssftpu_l2", 3, 128, 128, SP_STAGE),
    "ELFVC-SP-TPU-TINY": ("ELFVC-SP-TPU-TINY", "tiny_elfvctpu_l3", 3, 64, 128, SP_STAGE),
    "ELFVC-TPU-TINY": ("ELFVC-TPU-TINY", "seeded 0", 3, 128, 256, SP_STAGE),
    "ELFVC-SP-TPU-TINY-seeded": ("ELFVC-SP-TPU-TINY", "seeded 0", 3, 128, 256, 2),
    "ELFVC-SP-TPU-TINY-seeded-sp1": ("ELFVC-SP-TPU-TINY", "seeded 0", 3, 128, 256, 1),
}
SP_SEEDED = ["ELFVC-SP-TPU-TINY-seeded", "ELFVC-SP-TPU-TINY-seeded-sp1"]
MCVC_ATOL = 1e-5
MCVC_VIEWS = 3
MCVC_MASK = (1.0, 0.0, 1.0)  # view 1 failed
MCVC_CONFIGS = {  # case: (registry name, weights, gop, h, w)
    "MCVC-IA-TINY": ("MCVC-IA-TINY", "tiny_mcvc_l3", 3, 64, 64),
    "MCVC-IA": ("MCVC-IA", "seeded 0", 3, 64, 128),
}
ELFVC = ["ELFVC-SP-TPU-TINY", "ELFVC-TPU-TINY", *SP_SEEDED]


def clip(gop, h, w) -> np.ndarray:
    return synth_gop_multi(np.random.default_rng(0), size=max(h, w), gop=gop)[:, :h, :w]


def port_model(case, dtype=torch.float32, sp_stage=None):
    """The port's model of a CONFIGS case, at the case's sp_stage unless
    one is given."""
    name, weights, *_, case_stage = CONFIGS[case]
    spec = ft.get_codec_model(name, dtype=dtype, device="cpu",
                              sp_stage=case_stage if sp_stage is None else sp_stage)
    if weights == "seeded 0":
        ft.load_flat(spec.module, ft.seeded_flat(name, 0))
    else:
        ft.load_asset(spec.module, weights)
    return spec


def jax_params(case, configs=CONFIGS) -> dict:
    name, weights = configs[case][:2]
    if weights != "seeded 0":
        return {"params": asset_params(weights)["params"]}
    tree: dict = {}
    for key, value in ft.seeded_flat(name, 0).items():
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = jnp.asarray(value)
    return tree


def compress(spec, x, codecs=None):
    """The chain codecs' encode of x [T, B, 3, H, W]."""
    fn = tv.elfvc_compress_gop if spec.family == "elfvc" else tv.ssf_compress_gop
    return fn(spec, x, codecs=codecs)


def decompress(spec, streams, codecs=None):
    fn = {"elfvc": tv.elfvc_decompress_gop,
          "mcvc": tv.mcvc_decompress_gop}.get(spec.family, tv.ssf_decompress_gop)
    return fn(spec, streams, codecs=codecs)


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
        mv, z, feat = (Recorder(c) for c in tv.bit_estimator_laplace_codecs(spec.module))
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
    recon = decompress(spec, streams, codecs=codecs)
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
def coded(case):
    """Both packages' encodes of the clip, and the port's decodes of its own
    and of JAX's streams."""
    name, _, gop, h, w, sp_stage = CONFIGS[case]
    frames = clip(gop, h, w)
    spec = port_model(case)
    x = torch.from_numpy(np.ascontiguousarray(frames.transpose(0, 3, 1, 2)))
    jspec = jax_get_codec_model(name, sp_stage=sp_stage)
    params = jax_params(case)
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
            streams, recon, bits = compress(spec, x)
        with torch.inference_mode():
            _, liks = spec.module(x)
        bits_est = estimated_bits(liks)
        jcompress = jv.elfvc_compress_gop if spec.family == "elfvc" else jv.ssf_compress_gop
        jstreams, jrecon, jbits = jcompress(jspec, params, jnp.asarray(frames)[:, None])
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


@pytest.mark.parametrize("name", ["LSVC-TPU-TINY", "SSF-TPU-TINY", "ELFVC-SP-TPU-TINY"])
def test_bf16_decode_equals_encode(name):
    _, _, gop, h, w, _ = CONFIGS[name]
    spec = port_model(name, torch.bfloat16)
    x = torch.from_numpy(np.ascontiguousarray(clip(gop, h, w).transpose(0, 3, 1, 2)))
    if spec.family == "lsvc":
        streams, recon, bits = tv.lsvc_compress(spec, x)
        decoded = tv.lsvc_decompress(spec, x[0], streams, gop - 1)
    else:
        streams, recon, bits = compress(spec, x[:, None])
        decoded = decompress(spec, streams)
    assert recon.dtype == decoded.dtype == torch.bfloat16
    assert torch.equal(decoded, recon) and bits > 0
    f32 = coded(name)
    assert abs(bits - f32["bits"]) / f32["bits"] < 0.05  # bf16 codes near the f32 rate


@pytest.mark.parametrize("name", ELFVC)
def test_elfvc_streams_are_jax_streams(name):
    """Every symbol and every byte: the whole streams dict equals JAX's."""
    r = coded(name)
    for (_, a), (_, b) in zip(r["symbols"], r["jsymbols"], strict=True):
        np.testing.assert_array_equal(a, b)
    assert r["streams"] == r["jstreams"]
    assert r["bits"] == r["jbits"]


@pytest.mark.parametrize("name", ELFVC)
def test_elfvc_recon_within_3e6_of_jax(name):
    """The encoder's recon and the port's decode of JAX's streams, against
    JAX's encoder recon."""
    r = coded(name)
    np.testing.assert_allclose(r["recon_nhwc"], r["jrecon"], rtol=0, atol=ELFVC_ATOL)
    np.testing.assert_allclose(r["jdecoded"], r["jrecon"], rtol=0, atol=ELFVC_ATOL)


def test_elfvc_sp_stage_1_decode_equals_encode():
    """At sp_stage 1 only the motion SPnet replaces y; the residual y is
    round(y - means) + means. decode == encode bit for bit, and the
    keyframe's streams are stage 2's."""
    name = "ELFVC-SP-TPU-TINY"
    _, _, gop, h, w, _ = CONFIGS[name]
    spec = port_model(name, sp_stage=1)
    codecs = tv.ssf_codecs(spec.module)
    assert [c.sp for c in codecs] == [False, True, False]
    x = torch.from_numpy(np.ascontiguousarray(clip(gop, h, w).transpose(0, 3, 1, 2)))[:, None]
    streams, recon, bits = compress(spec, x, codecs)
    assert torch.equal(decompress(spec, streams, codecs), recon) and bits > 0
    assert streams["keyframe"] == coded(name)["streams"]["keyframe"]


@pytest.mark.parametrize("name", SP_SEEDED)
def test_elfvc_sp_symbols_are_not_all_zero(name):
    """The seeded SP cases code nonzero motion and residual y symbols in
    every P-frame, so the streams and recon above hold the SPnets on
    decoded symbols and the carried prior, not on zeros. The coders' sp
    flags follow the stage."""
    r = coded(name)
    inter = r["symbols"][2:]  # per P-frame: motion z, y, then residual z, y
    assert len(inter) == 4 * (CONFIGS[name][2] - 1)
    for i in range(0, len(inter), 4):
        assert np.any(inter[i + 1][1] != 0) and np.any(inter[i + 3][1] != 0)
    stage = CONFIGS[name][5]
    assert [c.sp for c in tv.ssf_codecs(port_model(name).module)] == [False, True, stage >= 2]


def mcvc_clip(gop, h, w) -> np.ndarray:
    """[T, V, h, w, 3]: synth_mv_gop (numpy seed 0) at max(h, w), cropped."""
    return synth_mv_gop(np.random.default_rng(0), views=MCVC_VIEWS, size=max(h, w),
                        gop=gop)[:, :, :h, :w]


def mcvc_model(case, dtype=torch.float32):
    name, weights = MCVC_CONFIGS[case][:2]
    spec = ft.get_codec_model(name, dtype=dtype, device="cpu", num_views=MCVC_VIEWS)
    if weights == "seeded 0":
        ft.load_flat(spec.module, ft.seeded_flat(name, 0))
    else:
        ft.load_asset(spec.module, weights)
    return spec


@functools.lru_cache(maxsize=None)
def mcvc_coded(case):
    """Both packages' MCVC encodes of the clip with view 1 failed, and the
    port's decodes of its own and of JAX's streams."""
    name, weights, gop, h, w = MCVC_CONFIGS[case]
    frames = mcvc_clip(gop, h, w)
    spec = mcvc_model(case)
    x = torch.from_numpy(np.ascontiguousarray(frames.transpose(0, 1, 4, 2, 3)))
    mask = np.asarray(MCVC_MASK, np.float32)
    kw.reset_launches()
    streams, recon, bits = tv.mcvc_compress_gop(spec, x, mask)
    launches = dict(kw.LAUNCHES)
    with torch.inference_mode():
        _, liks, _ = spec.module(x, torch.from_numpy(mask))
    jspec = jax_get_codec_model(name, num_views=MCVC_VIEWS)
    jstreams, jrecon, jbits = jv.mcvc_compress_gop(jspec, jax_params(case, MCVC_CONFIGS),
                                                   jnp.asarray(frames), jnp.asarray(mask))
    decoded, symbols = streams_and_symbols(spec, streams, gop, None)
    jdecoded, jsymbols = streams_and_symbols(spec, jstreams, gop, None)
    to_nhwc = (0, 1, 3, 4, 2)
    return {
        "streams": streams, "recon": recon, "bits": bits, "decoded": decoded,
        "symbols": symbols, "bits_est": estimated_bits(liks), "launches": launches,
        "jstreams": jstreams, "jrecon": np.asarray(jrecon), "jbits": jbits,
        "jdecoded": jdecoded.permute(*to_nhwc).numpy(), "jsymbols": jsymbols,
        "recon_nhwc": recon.permute(*to_nhwc).numpy(),
    }


@pytest.mark.parametrize("name", sorted(MCVC_CONFIGS))
def test_mcvc_decode_equals_encode_with_a_failed_view(name):
    r = mcvc_coded(name)
    _, _, gop, h, w = MCVC_CONFIGS[name]
    assert r["recon"].shape == (gop, MCVC_VIEWS, 3, h, w) and r["recon"].dtype == torch.float32
    assert torch.equal(r["decoded"], r["recon"]) and r["bits"] > 0
    assert r["streams"]["mask"] == list(MCVC_MASK)
    assert set(r["launches"].values()) == {0}  # CPU tensors take the plain warp


@pytest.mark.parametrize("name", sorted(MCVC_CONFIGS))
def test_mcvc_streams_are_jax_streams(name):
    """Every symbol and every byte, the mask included: the whole streams
    dict equals JAX's."""
    r = mcvc_coded(name)
    for (_, a), (_, b) in zip(r["symbols"], r["jsymbols"], strict=True):
        np.testing.assert_array_equal(a, b)
    assert r["streams"] == r["jstreams"]
    assert r["bits"] == r["jbits"]


@pytest.mark.parametrize("name", sorted(MCVC_CONFIGS))
def test_mcvc_recon_and_decode_of_jax_streams_match_jax(name):
    """The encoder's enhanced recon, and the port's decode of JAX's streams,
    against JAX's encoder recon."""
    r = mcvc_coded(name)
    assert r["recon_nhwc"].shape == r["jrecon"].shape
    np.testing.assert_allclose(r["recon_nhwc"], r["jrecon"], rtol=0, atol=MCVC_ATOL)
    np.testing.assert_allclose(r["jdecoded"], r["jrecon"], rtol=0, atol=MCVC_ATOL)


def test_mcvc_seeded_p_frame_symbols_are_not_all_zero():
    """The trained tiny model codes every P-frame y symbol of this clip as
    0; the seeded full-width case codes nonzero residual y symbols in every
    P-frame, so the streams above hold the P-frames' coding, not zeros
    alone (its motion latents stay within +-0.54 of their means and round
    to 0)."""
    tiny = mcvc_coded("MCVC-IA-TINY")["symbols"][2:]
    r = mcvc_coded("MCVC-IA")
    inter = r["symbols"][2:]  # per P-frame: motion z, y, then residual z, y
    assert len(inter) == len(tiny) == 4 * (MCVC_CONFIGS["MCVC-IA"][2] - 1)
    assert not any(np.any(tiny[i][1]) for i in range(1, len(tiny), 2))
    for i in range(0, len(inter), 4):
        assert np.any(inter[i + 3][1] != 0)


def test_mcvc_seeded_real_bits_near_estimate():
    """Within 5% of the model's estimate over the same GOP (keyframe coded,
    the same mask): measured 1.9%. The tiny case's 12 streams hold 3662
    estimated bits, and the range coder's flush puts its real bits 9%
    above them."""
    r = mcvc_coded("MCVC-IA")
    assert abs(r["bits"] - r["bits_est"]) / r["bits_est"] < EST_REL, (r["bits"], r["bits_est"])


def test_mcvc_bf16_decode_equals_encode():
    _, _, gop, h, w = MCVC_CONFIGS["MCVC-IA-TINY"]
    spec = mcvc_model("MCVC-IA-TINY", torch.bfloat16)
    x = torch.from_numpy(np.ascontiguousarray(mcvc_clip(gop, h, w).transpose(0, 1, 4, 2, 3)))
    streams, recon, bits = tv.mcvc_compress_gop(spec, x, np.asarray(MCVC_MASK, np.float32))
    assert recon.dtype == torch.bfloat16 and bits > 0
    assert torch.equal(tv.mcvc_decompress_gop(spec, streams), recon)


def test_mcvc_compress_takes_a_tensor_mask():
    """A tensor mask codes the same streams as the numpy mask."""
    r = mcvc_coded("MCVC-IA-TINY")
    _, _, gop, h, w = MCVC_CONFIGS["MCVC-IA-TINY"]
    x = torch.from_numpy(np.ascontiguousarray(mcvc_clip(gop, h, w).transpose(0, 1, 4, 2, 3)))
    streams, recon, _ = tv.mcvc_compress_gop(mcvc_model("MCVC-IA-TINY"), x,
                                             torch.tensor(MCVC_MASK))
    assert streams == r["streams"] and torch.equal(recon, r["recon"])
