"""The port's streaming simulations (analysis/abr.py, analysis/trace_sim.py,
cli/simulate.py) against the JAX package's, on the CPU. They are host
numpy in float64 in both packages, so every number is held equal, not
close: the same tables, traces and records give the same floats, and both
CLIs print the same lines.

The eval logs read here are written by the port's ``write_eval_log`` (as
``train/evaluate.py:evaluate_video`` writes them), and the ``.avg.log`` in
``cli/train_multiview.py``'s format. The units are pinned: ``dec_t`` is
seconds a frame (``bola_simulate`` multiplies it by the GOP), and the
log's three decimals keep a decode of a few milliseconds a frame from
reading as 0, which the CLI would replace with ``--decode-time``.
"""

import numpy as np
import pytest

from fastvideocodec_torch import analysis as pa
from fastvideocodec_torch.cli import simulate as port_cli
from fastvideocodec_torch.utils.logs import read_eval_log, write_eval_log
from fastvideocodec_tpu import analysis as ja
from fastvideocodec_tpu.cli import simulate as jax_cli

LEVELS, FRAMES, GOP = 4, 64, 16


def tables(seed: int = 0):
    """Per-level per-frame PSNR lists, bpp and decode s/frame, seeded."""
    rng = np.random.default_rng(seed)
    psnr = [list(28 + 2 * lvl + rng.normal(0, 0.5, FRAMES)) for lvl in range(LEVELS)]
    bpp = [0.02 * 2 ** lvl * (1 + 0.1 * rng.random()) for lvl in range(LEVELS)]
    dect = [0.004 + 0.002 * rng.random() for _ in range(LEVELS)]
    return psnr, bpp, dect


def traces(seed: int = 1, n: int = 200):
    rng = np.random.default_rng(seed)
    return np.clip(rng.lognormal(np.log(8e6), 0.8, n), 1e6, 100e6), rng.random(n) * 0.05


def test_segment_tables_equal_jax():
    psnr, bpp, dect = tables()
    got = pa.segment_tables(psnr, bpp, dect, pa.AbrConfig())
    want = ja.segment_tables(psnr, bpp, dect, ja.AbrConfig())
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float64 and np.array_equal(g, w)


@pytest.mark.parametrize("use_psnr_utility", [True, False])
@pytest.mark.parametrize("seed", [0, 3])
def test_bola_simulate_equals_jax(use_psnr_utility, seed):
    psnr, bpp, dect = tables(seed)
    down, lat = traces(seed + 1)
    kw = dict(use_psnr_utility=use_psnr_utility, trace_dur=2.0)
    got = pa.bola_simulate(*pa.segment_tables(psnr, bpp, dect, pa.AbrConfig(**kw)), down, lat,
                           pa.AbrConfig(**kw))
    want = ja.bola_simulate(*ja.segment_tables(psnr, bpp, dect, ja.AbrConfig(**kw)), down, lat,
                            ja.AbrConfig(**kw))
    assert got == want
    assert all(np.isfinite(v) for v in got)


def test_bola_drains_a_full_buffer_as_jax_does():
    """A fast link fills the buffer: BOLA's drain branch (no level viable)."""
    psnr, bpp, dect = tables(2)
    down, lat = np.full(50, 99e6), np.zeros(50)
    cfg_p, cfg_j = pa.AbrConfig(q_max=3.0, q_low=1.0), ja.AbrConfig(q_max=3.0, q_low=1.0)
    got = pa.bola_simulate(*pa.segment_tables(psnr, bpp, dect, cfg_p), down, lat, cfg_p)
    want = ja.bola_simulate(*ja.segment_tables(psnr, bpp, dect, cfg_j), down, lat, cfg_j)
    assert got == want


def write_avg_log(path, seed: int = 4, gops: int = 300):
    """cli/train_multiview.py's rows: 'cat,lvl,bpp,psnr,ssim', and a row
    without ssim."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for cat in (1, 3):
            for lvl in (2, 3, 4, 5):
                for _ in range(gops):
                    bpp = 0.01 * 2 ** lvl * (0.5 + rng.random())
                    f.write(f"{cat},{lvl},{bpp:.6f},{30 + lvl + rng.normal():.4f},"
                            f"{0.9 + 0.01 * rng.random():.5f}\n")
        f.write("\n7,2,0.1,31.0\n7,3,0.2,32.0\n")
    return str(path)


def test_read_avg_log_and_trace_simulation_equal_jax(tmp_path):
    path = write_avg_log(tmp_path / "MCVC-IA.avg.log")
    got, want = pa.read_avg_log(path), ja.read_avg_log(path)
    assert got == want and got[7][2] == [(0.1, 31.0, 0.0)]
    down, _ = traces(6, 500)
    for cat in sorted(want):
        for views, pixels in ((4, 1920 * 1080), (2, 256 * 256)):
            assert pa.simulate_over_trace(got[cat], down, views, pixels) == \
                ja.simulate_over_trace(want[cat], down, views, pixels)


def test_trace_simulation_picks_the_last_level_that_fits():
    """JAX's pick (and the port's): the highest level under the cap, not the
    reference's first level over it."""
    records = {0: [(0.1, 30.0, 0.9)], 1: [(0.2, 31.0, 0.91)], 2: [(0.4, 32.0, 0.92)]}
    bw = [0.3 * 4 * 100]  # a cap of 0.3 bpp over 4 views of 100 pixels
    assert pa.simulate_over_trace(records, bw, 4, 100)["bpp"] == 0.2
    assert pa.simulate_over_trace(records, bw, 4, 100) == ja.simulate_over_trace(records, bw, 4,
                                                                                100)


def write_eval_logs(path, dec_t: float = 0.0057):
    """Two records a level at levels 0, 2, 4 (two clips), as evaluate_video
    writes them: dec_t in s/frame, the PSNR of every coded frame."""
    rng = np.random.default_rng(8)
    for clip in range(2):
        for level in (0, 2, 4):
            psnrs = list(26 + level + rng.normal(0, 0.3, 33))
            write_eval_log(str(path), level, 0.3 * (level + 1) + 0.01 * clip, 0.009,
                           dec_t * (1 + 0.1 * level), psnrs)
    return str(path)


def write_trace_csv(path, seed: int = 9, n: int = 1200):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        f.write("downthrpt,latency\n")
        for _ in range(n):
            f.write(f"{rng.lognormal(np.log(1e7), 1.5):.1f},{0.05 * rng.random():.4f}\n")
    return str(path)


@pytest.mark.parametrize("csv", [False, True])
@pytest.mark.parametrize("task", ["abr", "trace"])
def test_cli_prints_jax_lines(tmp_path, capsys, task, csv):
    if task == "abr":
        logs = [write_eval_logs(tmp_path / "LSVC-TPU.UVG.0.log"),
                write_eval_logs(tmp_path / "one.log")]
        # a log with one level: both CLIs say so and go on
        write_eval_log(str(tmp_path / "single.log"), 2, 0.5, 0.01, 0.006, [30.0] * 32)
        logs.append(str(tmp_path / "single.log"))
    else:
        logs = [write_avg_log(tmp_path / "MCVC-IA.avg.log")]
    argv = ["--task", task, "--logs", *logs, "--num-traces", "3", "--trace-len", "400",
            "--trace-dur", "2"]
    if csv:
        argv += ["--trace-csv", write_trace_csv(tmp_path / "traces.csv")]
    jax_cli.main(argv)
    want = capsys.readouterr().out
    rows = port_cli.main(argv)
    got = capsys.readouterr().out
    assert got == want and len(want.splitlines()) == len(logs if task == "abr" else [1, 3, 7])
    assert rows and "nan" not in got


def test_cli_args_and_traces_match_jax():
    argv = ["--logs", "a.log", "--num-traces", "4", "--trace-len", "50", "--seed", "3"]
    pargs, jargs = port_cli.parse_args(argv), jax_cli.parse_args(argv)
    assert vars(pargs) == vars(jargs)
    for g, w in zip(port_cli.load_traces(pargs), jax_cli.load_traces(jargs)):
        assert np.array_equal(g, w)


def test_dec_t_is_seconds_a_frame_and_survives_the_log(tmp_path):
    """evaluate_video logs dec_t in s/frame; ``:.3f`` keeps a decode of
    0.006 s/frame (a 1024x2048 LSVC-TPU frame on the card) as 0.006, and
    the table multiplies it by the GOP. Only under 0.5 ms a frame would it
    read as 0 and be replaced by --decode-time."""
    path = write_eval_logs(tmp_path / "e.log", dec_t=0.0057)
    header = read_eval_log(path)[0][0]
    assert header["dec_t"] == 0.006 and header["enc_t"] == 0.009
    (_, rows), = port_cli.main(["--logs", path, "--num-traces", "1", "--trace-len", "10"])
    dect = rows["tables"][2]
    assert np.allclose(dect[:, 0], [0.006 * GOP, 0.007 * GOP, 0.008 * GOP])
    write_eval_log(str(tmp_path / "z.log"), 0, 0.1, 0.01, 0.0004, [30.0] * 16)
    assert read_eval_log(str(tmp_path / "z.log"))[0][0]["dec_t"] == 0.0


def test_evaluate_video_logs_decode_seconds_a_frame(tmp_path):
    """The port's evaluate_video (LSVC-TPU-TINY, 2 GOPs of 4 at 64x64)
    writes dec_t as its returned dec_sec_per_frame, rounded to the ms."""
    import torch

    import fastvideocodec_torch as ft
    from fastvideocodec_torch.data import ClipDataset
    from fastvideocodec_torch.data.synthetic import synth_gop
    from fastvideocodec_torch.train.evaluate import evaluate_video

    torch.manual_seed(0)
    spec = ft.get_codec_model("LSVC-TPU-TINY", device="cpu")
    ft.load_asset(spec.module, "tiny_lsvctpu_l2")
    ds = ClipDataset([synth_gop(np.random.default_rng(0), size=64, gop=8)])
    stats = evaluate_video(spec, ds, gop_size=4, log_path=str(tmp_path / "e.log"), level=2,
                           compress_iframe=False)
    (header, psnrs), = read_eval_log(str(tmp_path / "e.log"))
    assert header["dec_t"] == round(stats["dec_sec_per_frame"], 3)
    assert len(psnrs) == 6  # the P-frames of 2 GOPs (the I-frame passed through)
