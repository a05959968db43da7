"""Golden RD tests of the port: the JAX package's golden RD classes
(tests/test_rd.py) held on the port alone, on the shipped tiny
checkpoints, with JAX's gates. No JAX: the clips come from the port's
copies of the generators, ``synth_gop(np.random.default_rng(123))`` at
64x64, GOP 4 (held out: the checkpoints were trained on seed 0), and the
codecs are the port's, on the CPU, in float32.

- SSF-TINY (tiny_ssf_l{0,2,4}), ELFVC-SP-TINY at sp_stage 2
  (tiny_elfvc_l{0,3,6}) and MCVC-IA-TINY on 3 views
  (tiny_mcvc_l{0,3,6}, synth_mv_gop): real-bits bpp and PSNR rise with
  the level; decode equals encode; the real bits exceed the estimate, by
  less than 64 bits a stream plus 5%; the top level's PSNR is above 15 dB.
  MCVC-IA-TINY with view 2 failed rebuilds it through the backup decoders
  to under 0.8 of the MSE of a zeroed view.
- LSVC-TPU-TINY (tiny_lsvctpu_l{0,2,4}) and LSVC-TINY (tiny_lsvc_l{0,2,4},
  JAX's TestGoldenRD, the s2d=1 form): monotone, decode equals encode,
  real bits within 5% of the rollout's estimate; LSVC-TINY's top level
  above 17 dB.
- JAX's TestHDHeadToHead: the full-width LSVC-128 (hd_lsvc128_l{0,2,4})
  against LSVC-TPU (hd_lsvctpuf2), -HF (hd_lsvctpuf) and -RW (hd_lsvctpu)
  on four held-out synth_gop_multi clips (numpy seed 123) of 128x128,
  GOP 8, real bits: all four curves monotone; LSVC-TPU's BD-rate against
  LSVC-128 under 10% and its BD-PSNR above -0.6 dB; the ablation chain
  full < half-res < rigid in BD-rate, rigid under 32% and half-res under
  16%. About a minute on one thread, LSVC-128 most of it.
- SSF-TPU-TINY and ELFVC-SP-TPU-TINY, each against the stock curve on
  three clips: matched-rate quality (within 0.5 dB where the two ladders'
  rates meet), as JAX's TestGoldenRDSSFTPU and TestGoldenRDELFVCTPU hold.
- The low-rate rung: SSF-TINY on lr_ssf_l{0,2,4} over three
  ``synth_gop_lowrate`` clips of 64x64, GOP 4: the endpoints ordered in
  rate and quality, the lowest rate under 0.9 bpp.
- RLVC-TINY (tiny_rlvc_l{0,2,4}), DVC-TINY (tiny_dvc_l{0,2,4}) and
  Base-ER-TINY (tiny_base_l{0,2,4}), JAX's TestGoldenRDRLVC, -DVC and
  -Base: real-bits bpp and PSNR of the P-frames rise with the level;
  decode equals encode; the real bits within 64 bits a stream plus 8% of
  the rollout's estimate (2 streams a P-frame for RLVC, 3 for DVC and
  Base); the top level's PSNR above 15 dB.
"""

import functools

import numpy as np
import pytest
import torch

import fastvideocodec_torch as ft
from fastvideocodec_torch.analysis import bd_psnr, bd_rate
from fastvideocodec_torch.coder import video as tv
from fastvideocodec_torch.data.synthetic import (
    synth_gop,
    synth_gop_lowrate,
    synth_gop_multi,
    synth_mv_gop,
)
from fastvideocodec_torch.gop.engine import estimated_bits

T, H, W = 4, 64, 64
V = 3  # MCVC's views


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's convs at these sizes run as fast on one thread as on
    eight, and the suite's parallel workers share the host's cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def tensor(frames: np.ndarray) -> torch.Tensor:
    """numpy [T, (B,) H, W, 3] -> [T, (B,) 3, H, W]."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(frames, -1, -3)))


def held_out_clip() -> torch.Tensor:
    return tensor(synth_gop(np.random.default_rng(123), size=H, gop=T))


def psnr(recon: torch.Tensor, target: torch.Tensor) -> float:
    mse = float(torch.mean((recon.float() - target.float()) ** 2))
    return 10 * np.log10(1.0 / max(mse, 1e-12))


@functools.lru_cache(maxsize=None)
def model(name: str, asset: str, sp_stage: int = 2, num_views: int = 0):
    spec = ft.get_codec_model(name, device="cpu", sp_stage=sp_stage, num_views=num_views)
    ft.load_asset(spec.module, asset)
    return spec


def chain_point(name: str, asset: str, gop: torch.Tensor):
    """An SSF-family codec's real bits of gop [T, 1, 3, H, W], the keyframe
    coded: (bits, PSNR, the model's estimated bits of the same GOP);
    decode must equal encode."""
    spec = model(name, asset)
    compress, decompress = ((tv.elfvc_compress_gop, tv.elfvc_decompress_gop)
                            if spec.family == "elfvc" else
                            (tv.ssf_compress_gop, tv.ssf_decompress_gop))
    streams, recon, bits = compress(spec, gop)
    assert torch.equal(decompress(spec, streams), recon)
    with torch.inference_mode():
        _, liks = spec.module(gop)
    return bits, psnr(recon, gop), estimated_bits(liks)


def assert_excess_bounded(bits: int, est: float):
    """JAX's gate: the range coder's flush puts the real bits above the
    estimate, by less than 64 bits a stream plus 5% modelling drift."""
    n_streams = 2 + 4 * (T - 1)
    assert 0 < bits - est < n_streams * 64 + 0.05 * est, (bits, est)


def assert_monotone(bpps, psnrs, floor=15.0):
    assert bpps[0] < bpps[1] < bpps[2], bpps
    assert psnrs[0] < psnrs[1] < psnrs[2], psnrs
    assert psnrs[-1] > floor, psnrs


@pytest.mark.parametrize("name, assets", [
    ("SSF-TINY", [f"tiny_ssf_l{lv}" for lv in (0, 2, 4)]),
    ("ELFVC-SP-TINY", [f"tiny_elfvc_l{lv}" for lv in (0, 3, 6)]),
])
def test_stock_monotone_bpp_psnr_across_levels_real_bits(name, assets):
    """JAX's TestGoldenRDSSF and TestGoldenRDELFVC."""
    gop = held_out_clip()[:, None]
    bpps, psnrs = [], []
    for asset in assets:
        bits, q, est = chain_point(name, asset, gop)
        assert_excess_bounded(bits, est)
        bpps.append(bits / (T * H * W))
        psnrs.append(q)
    assert_monotone(bpps, psnrs)


def mv_clip() -> torch.Tensor:
    return tensor(synth_mv_gop(np.random.default_rng(123), views=V, size=H, gop=T))


def test_mcvc_monotone_bpp_psnr_across_levels_real_bits():
    """JAX's TestGoldenRDMCVC, every view alive."""
    gop, mask = mv_clip(), np.ones(V, np.float32)
    bpps, psnrs = [], []
    for level in (0, 3, 6):
        spec = model("MCVC-IA-TINY", f"tiny_mcvc_l{level}", num_views=V)
        streams, recon, bits = tv.mcvc_compress_gop(spec, gop, mask)
        assert torch.equal(tv.mcvc_decompress_gop(spec, streams), recon)
        with torch.inference_mode():
            _, liks, _ = spec.module(gop, torch.from_numpy(mask))
        assert_excess_bounded(bits, estimated_bits(liks))
        bpps.append(bits / (T * V * H * W))
        psnrs.append(psnr(recon, gop))
    assert_monotone(bpps, psnrs)


def test_mcvc_failed_view_reconstructed_by_backup_decoders():
    """JAX's test_failed_view_reconstructed_by_backup_decoders: view 2
    failed, level 3."""
    gop = mv_clip()
    spec = model("MCVC-IA-TINY", "tiny_mcvc_l3", num_views=V)
    _, recon, _ = tv.mcvc_compress_gop(spec, gop, np.asarray([1.0, 1.0, 0.0], np.float32))
    target = gop[:, 2].float()
    mse_backup = float(torch.mean((recon[:, 2].float() - target) ** 2))
    mse_zero = float(torch.mean(target ** 2))  # what a zeroed view scores
    assert mse_backup < 0.8 * mse_zero, (mse_backup, mse_zero)


def lsvc_golden(name: str, asset: str, floor: float = 15.0):
    """An LSVC model's real bits over the held-out clip at levels 0, 2, 4:
    decode equals encode, the bits within 5% of the rollout's estimate at
    every level, the curve monotone with its top above ``floor`` dB."""
    gop = held_out_clip()
    bpps, psnrs = [], []
    for level in (0, 2, 4):
        spec = model(name, f"{asset}_l{level}")
        streams, recon, bits = tv.lsvc_compress(spec, gop)
        assert torch.equal(tv.lsvc_decompress(spec, gop[0], streams, T - 1), recon)
        _, metrics = ft.rollout(spec, gop)
        est = float(metrics["bpp"]) * (T - 1) * H * W
        assert abs(bits - est) / est < 0.05, (level, bits, est)
        bpps.append(bits / ((T - 1) * H * W))
        psnrs.append(psnr(recon, gop[1:]))
    assert_monotone(bpps, psnrs, floor)


def test_lsvc_tpu_monotone_bpp_psnr_across_levels_real_bits():
    """JAX's TestGoldenRDLSVCTPU."""
    lsvc_golden("LSVC-TPU-TINY", "tiny_lsvctpu")


def test_lsvc_tiny_monotone_bpp_psnr_across_levels_real_bits():
    """JAX's TestGoldenRD: the s2d=1 LSVC-TINY, its top level above 17 dB
    (17.5/18.4/18.8 dB at the checkpoints' training)."""
    lsvc_golden("LSVC-TINY", "tiny_lsvc", floor=17.0)


HD_SIZE, HD_GOP = 128, 8


@functools.lru_cache(maxsize=None)
def hd_curve(name: str, family: str):
    """(bpp, PSNR) at levels 0, 2, 4 of hd_{family}_l*, each the mean over
    the four held-out 128x128 clips, real bits; decode equals encode."""
    rng = np.random.default_rng(123)  # held out: training used seed 0
    clips = [tensor(synth_gop_multi(rng, size=HD_SIZE, gop=HD_GOP)) for _ in range(4)]
    bpps, psnrs = [], []
    for level in (0, 2, 4):
        spec = model(name, f"hd_{family}_l{level}")
        codecs = tv.bit_estimator_laplace_codecs(spec.module)
        bs, ps = [], []
        for i, gop in enumerate(clips):
            streams, recon, bits = tv.lsvc_compress(spec, gop, codecs)
            if i == 0:
                decoded = tv.lsvc_decompress(spec, gop[0], streams, HD_GOP - 1, codecs)
                assert torch.equal(decoded, recon)
            bs.append(bits / ((HD_GOP - 1) * HD_SIZE * HD_SIZE))
            ps.append(psnr(recon, gop[1:]))
        bpps.append(float(np.mean(bs)))
        psnrs.append(float(np.mean(ps)))
    return bpps, psnrs


def test_hd_flagship_bd_rate_bounded_vs_parity_config():
    """JAX's TestHDHeadToHead::test_flagship_bd_rate_bounded_vs_parity_config:
    both curves monotone; LSVC-TPU's BD-rate against LSVC-128 under 10%
    and its BD-PSNR above -0.6 dB."""
    ref = hd_curve("LSVC-128", "lsvc128")
    tpu = hd_curve("LSVC-TPU", "lsvctpuf2")
    for bpps, psnrs in (ref, tpu):
        assert bpps[0] < bpps[1] < bpps[2], bpps
        assert psnrs[0] < psnrs[1] < psnrs[2], psnrs
    bdr, bdp = bd_rate(*ref, *tpu), bd_psnr(*ref, *tpu)
    assert bdr < 10.0, (bdr, ref, tpu)
    assert bdp > -0.6, (bdp, ref, tpu)


def test_hd_warp_ablation_attribution():
    """JAX's TestHDHeadToHead::test_warp_ablation_attribution: BD-rate
    against LSVC-128 orders full-res flow < half-res flow (-HF) < rigid
    s2d warp (-RW), with rigid under 32% and half-res under 16%."""
    ref = hd_curve("LSVC-128", "lsvc128")
    rigid = bd_rate(*ref, *hd_curve("LSVC-TPU-RW", "lsvctpu"))
    halfres = bd_rate(*ref, *hd_curve("LSVC-TPU-HF", "lsvctpuf"))
    full = bd_rate(*ref, *hd_curve("LSVC-TPU", "lsvctpuf2"))
    assert full < halfres < rigid, (full, halfres, rigid)
    assert rigid < 32.0 and halfres < 16.0, (rigid, halfres)


def curve(name: str, assets, clips):
    """(mean bpp, mean PSNR) of each level over the clips, real bits."""
    bpps, psnrs = [], []
    for asset in assets:
        points = [chain_point(name, asset, gop)[:2] for gop in clips]
        bpps.append(float(np.mean([b for b, _ in points])) / (T * H * W))
        psnrs.append(float(np.mean([q for _, q in points])))
    return bpps, psnrs


def three_clips():
    rng = np.random.default_rng(123)
    return [tensor(synth_gop(rng, size=H, gop=T))[:, None] for _ in range(3)]


def matched(ref, tpu) -> int:
    """Pairs of points where the TPU variant spends at least the stock
    point's rate and less than 10% more; each must be within 0.5 dB."""
    n = 0
    for rb, rp in zip(*ref):
        for tb, tp in zip(*tpu):
            if tb >= rb and (tb - rb) / rb < 0.10:
                n += 1
                assert tp > rp - 0.5, (rb, rp, tb, tp)
    return n


def test_ssf_tpu_matched_rate_quality_vs_stock_ssf():
    """JAX's TestGoldenRDSSFTPU: quality monotone in level, rate grows
    endpoint to endpoint, and at least one matched-rate pair."""
    clips = three_clips()
    ref = curve("SSF-TINY", [f"tiny_ssf_l{lv}" for lv in (0, 2, 4)], clips)
    tpu = curve("SSF-TPU-TINY", [f"tiny_ssftpu_l{lv}" for lv in (0, 2, 4)], clips)
    assert tpu[1][0] < tpu[1][1] < tpu[1][2], tpu
    assert tpu[0][2] > tpu[0][0], tpu
    assert matched(ref, tpu) >= 1, (ref, tpu)


def test_elfvc_tpu_matched_rate_quality_vs_stock_elfvc():
    """JAX's TestGoldenRDELFVCTPU: rate grows with level; quality within
    the 0.1 dB saturation wiggle of the bottom level; matched-rate pairs
    within 0.5 dB, else (ladders offset) the interpolated quality at the
    overlap's middle, else (disjoint ladders) dominance: the TPU curve's
    best point at stock's bottom-point quality (within 0.5 dB) at no more
    rate."""
    clips = three_clips()
    ref = curve("ELFVC-SP-TINY", [f"tiny_elfvc_l{lv}" for lv in (0, 3, 6)], clips)
    tpu = curve("ELFVC-SP-TPU-TINY", [f"tiny_elfvctpu_l{lv}" for lv in (0, 3, 6)], clips)
    assert tpu[0][2] > tpu[0][0], tpu
    assert tpu[1][1] > tpu[1][0] - 0.1 and tpu[1][2] > tpu[1][0] - 0.1, tpu
    if matched(ref, tpu) == 0:
        lo, hi = max(min(ref[0]), min(tpu[0])), min(max(ref[0]), max(tpu[0]))
        if hi > lo:
            mid = 0.5 * (lo + hi)
            assert np.interp(mid, tpu[0], tpu[1]) > np.interp(mid, ref[0], ref[1]) - 0.5, (
                ref, tpu)
        else:
            assert max(tpu[0]) <= min(ref[0]), (ref, tpu)
            assert max(tpu[1]) > ref[1][0] - 0.5, (ref, tpu)


def test_ssf_lowrate_points():
    """JAX's TestLowRateRung::test_ssf_lowrate_points."""
    rng = np.random.default_rng(123)
    clips = [tensor(synth_gop_lowrate(rng, size=64, gop=4))[:, None] for _ in range(3)]
    bpps, psnrs = curve("SSF-TINY", [f"lr_ssf_l{lv}" for lv in (0, 2, 4)], clips)
    assert bpps[0] < bpps[2] and psnrs[0] < psnrs[2], (bpps, psnrs)
    assert min(bpps) < 0.9, bpps  # below the noisy rung's floor


@pytest.mark.parametrize("name, asset, n_streams", [("RLVC-TINY", "tiny_rlvc", 2),
                                                    ("DVC-TINY", "tiny_dvc", 3),
                                                    ("Base-ER-TINY", "tiny_base", 3)])
def test_p_frame_chain_monotone_bpp_psnr_across_levels_real_bits(name, asset, n_streams):
    """JAX's TestGoldenRDRLVC, TestGoldenRDDVC and TestGoldenRDBase."""
    gop = held_out_clip()
    compress, decompress = {
        "rlvc": (tv.rlvc_compress_gop, tv.rlvc_decompress_gop),
        "dvc": (tv.dvc_compress_gop, tv.dvc_decompress_gop),
        "base": (tv.base_compress_gop, tv.base_decompress_gop)}[model(name, f"{asset}_l0").family]
    bpps, psnrs = [], []
    for level in (0, 2, 4):
        spec = model(name, f"{asset}_l{level}")
        streams, recon, bits = compress(spec, gop)
        assert torch.equal(decompress(spec, gop[0], streams), recon)
        _, metrics = ft.rollout(spec, gop)
        est = float(metrics["bpp_est"].sum()) * H * W
        assert abs(bits - est) < n_streams * (T - 1) * 64 + 0.08 * est, (level, bits, est)
        bpps.append(bits / ((T - 1) * H * W))
        psnrs.append(psnr(recon, gop[1:]))
    assert_monotone(bpps, psnrs)
