"""The port's host coder against the JAX package's, on the CPU.

- The range coder is a verbatim copy, built by g++ into build/coder/; for
  the same symbols, indexes and tables it writes the JAX binding's bytes,
  and decodes them back (the cases of tests/test_coder.py).
- The Laplace, Gaussian, factorized and BitEstimator tables equal the JAX
  package's bit for bit (uint32 counts, int32 lengths and offsets): the
  factorized ones from every hyperprior bottleneck of tiny_ssftpu_l2, the
  BitEstimator ones from both estimators of hd_lsvctpuf2_l2.
- The scale bucketing (a binary search in the port, on the scales' own
  device) equals the JAX codecs' comparison sum, on table entries,
  between them, and on NaN and zero.
- The port's codecs round-trip as tests/test_bitstream.py's
  Test*Roundtrip classes hold the JAX codecs, and an NCHW tensor handed
  over as ``permute(0, 2, 3, 1)`` codes to the bytes JAX writes for the
  NHWC array.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import norm

import fastvideocodec_torch as ft
from fastvideocodec_torch import coder as tc
from fastvideocodec_torch.coder import service as ts
from fastvideocodec_torch.coder.video import HostCopy, deterministic_convs, nhwc
from fastvideocodec_torch.entropy import factorized as tfac
from fastvideocodec_torch.entropy import gaussian as tgauss
from fastvideocodec_torch.ops import math as tmath
from fastvideocodec_tpu import coder as jc
from fastvideocodec_tpu.coder import service as js
from fastvideocodec_tpu.entropy import factorized as jfac
from fastvideocodec_tpu.entropy import gaussian as jgauss
from fastvideocodec_tpu.ops import math as jmath
from fastvideocodec_tpu.train.checkpoint import asset_params


def simple_tables(scales=(0.5, 1.0, 4.0), support=8):
    """Gaussian-ish tables over [-support, support] per scale, with an
    escape bucket (tests/test_coder.py's)."""
    rows = []
    for s in scales:
        xs = np.arange(-support, support + 1)
        pmf = norm.cdf(xs + 0.5, 0, s) - norm.cdf(xs - 0.5, 0, s)
        rows.append(jfac.pmf_to_quantized_cdf(np.concatenate([pmf, [1e-9]]), 16))
    cdfs = np.zeros((len(rows), max(len(r) for r in rows)), dtype=np.uint32)
    lengths = np.zeros(len(rows), dtype=np.int32)
    for i, r in enumerate(rows):
        cdfs[i, : len(r)] = r
        lengths[i] = len(r)
    return cdfs, lengths, np.full(len(rows), -support, dtype=np.int32)


def case_in_range():
    rng = np.random.RandomState(0)
    n = 5000
    indexes = rng.randint(0, 3, n)
    symbols = np.round(rng.randn(n) * np.asarray([0.5, 1.0, 4.0])[indexes]).astype(np.int32)
    return np.clip(symbols, -8, 7), indexes, simple_tables()


def case_overflow_escape():
    """Mostly far outside the support, on both sides of it."""
    rng = np.random.RandomState(1)
    n = 1000
    return (rng.randint(-100, 100, n).astype(np.int32), rng.randint(0, 3, n),
            simple_tables(support=4))


def case_empty():
    return np.zeros(0, np.int32), np.zeros(0, np.int32), simple_tables()


def case_single():
    return np.asarray([3], np.int32), np.zeros(1, np.int32), simple_tables()


def case_near_entropy():
    rng = np.random.RandomState(2)
    n = 200_000
    symbols = np.clip(np.round(rng.randn(n) * 2.0), -32, 31).astype(np.int32)
    return symbols, np.zeros(n, dtype=np.int32), simple_tables(scales=(2.0,), support=32)


CASES = {"in_range": case_in_range, "overflow_escape": case_overflow_escape,
         "empty": case_empty, "single": case_single, "near_entropy": case_near_entropy}


def test_range_coder_source_is_the_jax_packages():
    with open(jc._SRC, "rb") as f:
        assert tc.SOURCE.read_bytes() == f.read()


def test_library_is_built_into_build_coder():
    lib = tc.get_lib()
    path = tc.library_path()
    assert path.exists() and path.name == "librangecoder.so"
    assert path.parent.parent == tc.BUILD_ROOT
    assert tc.BUILD_ROOT.parts[-2:] == ("build", "coder")
    assert lib is tc.get_lib()
    assert not list(path.parent.glob("*.tmp"))


def test_failed_build_raises_and_leaves_nothing(tmp_path, monkeypatch):
    bad = tmp_path / "range_coder.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tc, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tc.build(bad)
    assert not tc.library_path(bad).exists()
    assert not list(tc.library_path(bad).parent.iterdir())


@pytest.mark.parametrize("case", sorted(CASES))
def test_bytes_equal_jax_and_decode_back(case):
    symbols, indexes, (cdfs, lengths, offsets) = CASES[case]()
    data = tc.encode_with_indexes(symbols, indexes, cdfs, lengths, offsets)
    assert data == jc.encode_with_indexes(symbols, indexes, cdfs, lengths, offsets)
    out = tc.decode_with_indexes(data, indexes, cdfs, lengths, offsets)
    np.testing.assert_array_equal(out, symbols)
    if case == "near_entropy":  # within 3% of the model's entropy, as JAX's
        xs = np.arange(-32, 33)
        pmf = norm.cdf(xs + 0.5, 0, 2.0) - norm.cdf(xs - 0.5, 0, 2.0)
        bits_est = -(pmf * np.log2(np.maximum(pmf, 1e-30))).sum() * symbols.size
        assert abs(len(data) * 8 - bits_est) / bits_est < 0.03


def test_bad_indexes_raise_before_the_coder():
    cdfs, lengths, offsets = simple_tables()
    with pytest.raises(ValueError, match="indexes"):
        tc.encode_with_indexes(np.zeros(4, np.int32), np.asarray([0, 1, 2, 3]), cdfs, lengths,
                               offsets)
    with pytest.raises(ValueError, match="symbols"):
        tc.encode_with_indexes(np.zeros(4, np.int32), np.zeros(3, np.int32), cdfs, lengths,
                               offsets)


def assert_tables_equal(got, want):
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_scale_table_is_the_jax_packages():
    np.testing.assert_array_equal(tmath.scale_table(), jmath.scale_table())
    assert (tmath.SCALES_MIN, tmath.SCALES_MAX, tmath.SCALES_LEVELS) == (
        jmath.SCALES_MIN, jmath.SCALES_MAX, jmath.SCALES_LEVELS)


def codec_tables(codec):
    return codec.cdfs, codec.lengths, codec.offsets


@pytest.mark.parametrize("via", ["conditional", "codec"])
def test_laplace_tables_equal_jax(via):
    """The port's one Laplace table set (support at most +-150, JAX's
    default) is JAX's, from the conditional and as the codec holds it."""
    if via == "conditional":
        got = tgauss.LaplaceConditional().build_cdf_tables()
        want = jgauss.LaplaceConditional().build_cdf_tables(mxrange=tgauss.LAPLACE_MXRANGE)
    else:
        got, want = codec_tables(ts.LaplaceCodec()), codec_tables(js.LaplaceCodec())
    assert_tables_equal(got, want)


@pytest.mark.parametrize("via", ["conditional", "codec"])
def test_gaussian_tables_equal_jax(via):
    """The port's one Gaussian table set (no bound on the support, JAX's
    default) is JAX's, from the conditional and as the codec holds it."""
    if via == "conditional":
        got = tgauss.GaussianConditional().build_cdf_tables()
        want = jgauss.GaussianConditional().build_cdf_tables(mxrange=None)
    else:
        got, want = codec_tables(ts.GaussianCodec()), codec_tables(js.GaussianCodec())
    assert_tables_equal(got, want)


@pytest.mark.parametrize("name", ["img_hyperprior", "motion_hyperprior", "res_hyperprior"])
def test_factorized_tables_equal_jax(name):
    spec = ft.get_codec_model("SSF-TPU-TINY", device="cpu")
    ft.load_asset(spec.module, "tiny_ssftpu_l2")
    got = tfac.build_cdf_tables(getattr(spec.module, name).bottleneck.numpy_params())
    want = jfac.build_cdf_tables(
        {k: np.asarray(v) for k, v in asset_params("tiny_ssftpu_l2")["params"][name]
         ["bottleneck"].items()})
    assert_tables_equal(got, want)
    codec = ts.FactorizedCodec(getattr(spec.module, name).bottleneck.numpy_params())
    np.testing.assert_array_equal(
        codec.medians, asset_params("tiny_ssftpu_l2")["params"][name]["bottleneck"]
        ["quantiles"][:, 0, 1])


@pytest.mark.parametrize("name", ["bit_estimator_mv", "bit_estimator_z"])
def test_bit_estimator_tables_equal_jax(name):
    spec = ft.get_codec_model("LSVC-TPU", device="cpu")
    ft.load_asset(spec.module, "hd_lsvctpuf2_l2")
    got = ts.BitEstimatorCodec(getattr(spec.module, name).numpy_params())
    want = js.BitEstimatorCodec(asset_params("hd_lsvctpuf2_l2")["params"][name],
                                mxrange=ts.BIT_ESTIMATOR_MXRANGE)
    assert_tables_equal(codec_tables(got), codec_tables(want))


def test_pmf_to_quantized_cdf_equals_jax():
    rng = np.random.RandomState(5)
    for pmf in (rng.dirichlet(np.ones(40) * 0.05), np.full(70000, 1.0), np.r_[1.0, 1e-12],
                np.r_[np.nan, 0.3, 0.7]):
        np.testing.assert_array_equal(tfac.pmf_to_quantized_cdf(pmf),
                                      jfac.pmf_to_quantized_cdf(pmf))


@pytest.mark.parametrize("dtype", [np.float16, np.float32])
def test_scale_indexes_equal_the_jax_codecs(dtype):
    table = tmath.scale_table()
    rng = np.random.RandomState(6)
    scales = np.concatenate([
        np.exp(rng.uniform(-4.0, 7.0, 20000)), table, np.nextafter(table, 0),
        np.nextafter(table, np.inf), [0.0, -1.0, np.nan, np.inf, 1e-30]]).astype(dtype)
    want = js.LaplaceCodec()._indexes(scales)
    np.testing.assert_array_equal(js.GaussianCodec()._indexes(scales), want)
    for codec in (ts.LaplaceCodec(), ts.GaussianCodec()):  # what compress/decompress take
        np.testing.assert_array_equal(codec._host_indexes(scales), want)
    got = tmath.build_indexes(torch.from_numpy(scales), torch.from_numpy(table))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(jmath.build_indexes(jnp.asarray(scales[:200]), jnp.asarray(table))),
        want[:200])


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.float32])
def test_bucket_on_the_tensors_device_equals_scale_indexes(dtype):
    """The codecs' ``bucket`` (build_indexes on the scales' device) gives
    the JAX codecs' indexes of the same scales, as uint8."""
    table = tmath.scale_table()
    rng = np.random.RandomState(8)
    scales = torch.from_numpy(np.concatenate([
        np.exp(rng.uniform(-4.0, 7.0, 5000)), table, [0.0, np.nan, np.inf]])).to(dtype)
    want = js.LaplaceCodec()._indexes(scales.float().numpy())
    for codec in (ts.LaplaceCodec(), ts.GaussianCodec()):
        got = codec.bucket(scales[None, :, None, None])
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.flatten().numpy(), want)


# --- the port's codecs round trip (tests/test_bitstream.py's classes) -------


def ssf_bottleneck():
    spec = ft.get_codec_model("SSF-TPU-TINY", device="cpu")
    ft.load_asset(spec.module, "tiny_ssftpu_l2")
    return spec.module.res_hyperprior.bottleneck


class TestFactorizedRoundtrip:
    def test_decode_matches_forward(self):
        eb = ssf_bottleneck()
        x = torch.from_numpy(np.random.RandomState(0).randn(2, 48, 8, 8).astype(np.float32) * 3)
        with torch.no_grad():
            x_hat, _ = eb(x)
        codec = ts.FactorizedCodec(eb.numpy_params())
        data = codec.compress(nhwc(x).numpy())
        out = codec.decompress(data, (2, 8, 8, 48))
        np.testing.assert_array_equal(out, nhwc(x_hat).numpy())

    def test_bits_act_tracks_bits_est(self):
        eb = ssf_bottleneck()
        x = torch.from_numpy(np.random.RandomState(1).randn(4, 48, 16, 16).astype(np.float32) * 2)
        with torch.no_grad():
            _, lik = eb(x)
        bits_est = float(-torch.log2(lik.double()).sum())
        bits_act = len(ts.FactorizedCodec(eb.numpy_params()).compress(nhwc(x).numpy())) * 8
        assert abs(bits_act - bits_est) / bits_est < 0.10, (bits_act, bits_est)


class TestGaussianRoundtrip:
    def test_decode_matches_quantization(self):
        rng = np.random.RandomState(0)
        x = rng.randn(2, 8, 8, 16).astype(np.float32) * 2
        means = rng.randn(2, 8, 8, 16).astype(np.float32) * 0.3
        scales = np.exp(rng.uniform(-1, 2, (2, 8, 8, 16))).astype(np.float32)
        codec = ts.GaussianCodec()
        data = codec.compress(x, scales, means)
        assert data == js.GaussianCodec().compress(x, scales, means)
        np.testing.assert_array_equal(codec.decompress(data, scales, means),
                                      np.round(x - means) + means)


class TestLaplaceRoundtrip:
    def test_decode_matches_symbols(self):
        rng = np.random.RandomState(4)
        scales = np.exp(rng.uniform(np.log(0.12), np.log(20), (2, 4, 8, 96))).astype(np.float16)
        symbols = np.round(rng.laplace(0, scales.astype(np.float32))).astype(np.int16)
        codec = ts.LaplaceCodec()
        data = codec.compress(symbols, scales)
        assert data == js.LaplaceCodec().compress(symbols, scales)
        np.testing.assert_array_equal(codec.decompress(data, scales), symbols)
        idx = codec.bucket(torch.from_numpy(scales)).numpy()
        assert codec.encode(symbols, idx) == data
        np.testing.assert_array_equal(codec.decode(data, idx), symbols)


class TestBitEstimatorRoundtrip:
    def test_decode_and_bits(self):
        spec = ft.get_codec_model("LSVC-TPU-TINY", device="cpu")
        ft.load_asset(spec.module, "tiny_lsvctpu_l2")
        be = spec.module.bit_estimator_mv
        x = torch.from_numpy(np.random.RandomState(1).randn(2, 48, 4, 4).astype(np.float32) * 4)
        codec = ts.BitEstimatorCodec(be.numpy_params())
        data = codec.compress(nhwc(x).numpy())
        np.testing.assert_array_equal(codec.decompress(data, (2, 4, 4, 48)),
                                      np.round(nhwc(x).numpy()))
        with torch.no_grad():
            bits_est = float(tmath.bits_estimate(be.likelihood(torch.round(x))))
        assert abs(len(data) * 8 - bits_est) / max(bits_est, 1) < 0.15


def test_nchw_tensor_codes_to_the_jax_bytes_of_its_nhwc_array():
    """The same latents as a port NCHW tensor and as a JAX NHWC array: the
    port's nhwc() hand-over gives JAX's bytes; coding NCHW order would not."""
    spec = ft.get_codec_model("LSVC-TPU", device="cpu")
    ft.load_asset(spec.module, "hd_lsvctpuf2_l2")
    rng = np.random.RandomState(7)
    arr = np.round(rng.randn(3, 4, 8, 128) * 3).astype(np.float32)  # NHWC, as JAX holds it
    t = torch.from_numpy(np.ascontiguousarray(arr.transpose(0, 3, 1, 2)))  # NCHW
    port = ts.BitEstimatorCodec(spec.module.bit_estimator_mv.numpy_params())
    want = js.BitEstimatorCodec(asset_params("hd_lsvctpuf2_l2")["params"]["bit_estimator_mv"])
    assert port.compress(nhwc(t).numpy()) == want.compress(arr)
    assert port.compress(t.numpy()) != want.compress(arr)
    sig = np.exp(rng.uniform(-2, 3, (3, 4, 8, 96))).astype(np.float16)
    feat = np.round(rng.laplace(0, 2, sig.shape))
    ft_feat = torch.from_numpy(np.ascontiguousarray(feat.transpose(0, 3, 1, 2)))
    ft_sig = torch.from_numpy(np.ascontiguousarray(sig.transpose(0, 3, 1, 2)))
    assert (ts.LaplaceCodec().compress(nhwc(ft_feat).numpy(), nhwc(ft_sig).numpy())
            == js.LaplaceCodec().compress(feat, sig))
    # bfloat16 tensors go over as float32, which holds them exactly
    b = torch.from_numpy(np.ascontiguousarray(arr.transpose(0, 3, 1, 2))).bfloat16()
    assert nhwc(b).dtype == torch.float32 and torch.equal(nhwc(b), nhwc(b.float()))


def test_ac_time_counts_the_workers():
    """Coding on AsyncCoder threads lands in the dispatching thread's scope;
    the scope ends with its block."""
    cdfs, lengths, offsets = simple_tables()
    symbols, indexes = np.zeros(100_000, np.int32), np.zeros(100_000, np.int32)
    with tc.measure_ac_time() as acc, tc.AsyncCoder(workers=2) as pool:
        futures = [pool.submit(tc.encode_with_indexes, symbols, indexes, cdfs, lengths, offsets)
                   for _ in range(4)]
        streams = {f.result() for f in futures}
    assert acc["seconds"] > 0.0 and len(streams) == 1
    seconds = acc["seconds"]
    tc.encode_with_indexes(symbols, indexes, cdfs, lengths, offsets)
    assert acc["seconds"] == seconds


def test_host_copy_and_deterministic_scope_on_cpu():
    t = torch.arange(6, dtype=torch.int16).reshape(1, 2, 3, 1)
    np.testing.assert_array_equal(HostCopy(t).numpy(), t.numpy())
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.benchmark = True
    try:
        with deterministic_convs():
            assert cudnn.deterministic and not cudnn.benchmark
        assert not cudnn.deterministic and cudnn.benchmark
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
