"""The port's evaluation inputs, anchors, logs and drivers against the JAX
package's, on the CPU:

- ``data/video.py:VideoDataset`` reads the same frames bit for bit, with
  the same eof flags and in the same order (the files popped from the end
  of the sorted list), from a raw 1920x1080 I420 ``.yuv`` with an
  all-black frame (skipped) and a resize, and from a cv2-written mp4v
  ``.mp4`` (skipped where this cv2 has no mp4 encoder);
- ``anchors``: ``_x26x_cmd`` equal for all six names, an unknown one
  raising; ``multiview_frame_layout`` equal for layouts 0-3, 4 raising;
  with PATH emptied the binaries are missing and both coders raise JAX's
  errors; every subprocess the port starts has a timeout, an ffmpeg that
  stops reading its frames among them;
- ``analysis/plots.py``: ``rd_points`` and ``bd_rate_table`` equal on logs
  written by both packages; ``cli/plot.py`` prints JAX's table and writes
  the charts;
- ``utils/torch_import.py:convert_dvc_state_dict`` equal on the synthetic
  state dict of tests/test_torch_import.py, and its load of a saved one;
- ``cli/train.py --test-size HxW``: the port's frames are H x W; JAX's
  are W x H (its reader takes (width, height); the JAX package is not
  edited, ROADMAP.md section 3);
- ``cli/train_multiview.py --task eval``: JAX's row of
  ``{codec}.avg.log`` on the synthetic JPEG tree of
  tests/test_torch_train_olft.py, both packages reading one checkpoint of
  tiny_mcvc_l3 (bpp, psnr and completeness to the row's 4 decimals);
- ``cli/eval.py --real-bits`` runs through ``main`` on a .yuv directory
  and its log parses back to the printed point.
"""

import functools
import os
import subprocess

import jax
import numpy as np
import pytest
import torch

import fastvideocodec_torch as ft
from fastvideocodec_torch import anchors
from fastvideocodec_torch.analysis.plots import bd_rate_table, rd_points
from fastvideocodec_torch.cli import eval as eval_cli
from fastvideocodec_torch.cli import plot as plot_cli
from fastvideocodec_torch.cli import train as train_cli
from fastvideocodec_torch.cli import train_multiview as mv_cli
from fastvideocodec_torch.data import VideoDataset
from fastvideocodec_torch.data.synthetic import synth_gop, synth_mv_gop
from fastvideocodec_torch.train import save_checkpoint
from fastvideocodec_torch.utils import StageTimers
from fastvideocodec_torch.utils.logs import read_eval_log, write_eval_log
from fastvideocodec_torch.utils.torch_import import (
    convert_dvc_state_dict,
    load_torch_dvc_checkpoint,
)
from fastvideocodec_tpu import anchors as jax_anchors
from fastvideocodec_tpu.analysis import plots as jax_plots
from fastvideocodec_tpu.cli import train as jax_train_cli
from fastvideocodec_tpu.cli import train_multiview as jax_mv_cli
from fastvideocodec_tpu.data import video as jax_video
from fastvideocodec_tpu.train.checkpoint import asset_params
from fastvideocodec_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from fastvideocodec_tpu.utils import logs as jax_logs
from fastvideocodec_tpu.utils.torch_import import convert_dvc_state_dict as jax_convert
from test_torch_import import _synthetic_dvc_state_dict
from test_torch_train_common import one_torch_thread, yuv_clip_dir  # noqa: F401 (autouse)

X26X = ["x265-veryfast", "x265-medium", "x265-veryslow", "x264-veryfast", "x264-medium",
        "x264-veryslow"]


def small_clips(n=2, frames=3, size=(40, 56)):
    rng = np.random.default_rng(3)
    return [synth_gop(rng, size=max(size), gop=frames)[:, :size[0], :size[1]] for _ in range(n)]


def read_all(ds) -> list:
    return [ds[i] for i in range(len(ds))]


def assert_same_stream(got, want):
    assert len(got) == len(want)
    for (gf, ge), (wf, we) in zip(got, want):
        assert ge == we and gf.dtype == np.float32 and np.array_equal(gf, wf)


def test_video_dataset_reads_yuv_as_jax(tmp_path):
    """Two 1920x1080 I420 files, each with a black frame, resized to 48 x
    32 (width, height): JAX's frames, flags and file order, and
    ``max_files``."""
    root = yuv_clip_dir(tmp_path / "uvg", small_clips(), black=1)
    port, jax_ds = VideoDataset(root, (48, 32)), jax_video.VideoDataset(root, (48, 32))
    assert len(port) == len(jax_ds) == 6  # the black frames are skipped
    got, want = read_all(port), read_all(jax_ds)
    assert_same_stream(got, want)
    assert got[0][0].shape == (32, 48, 3)
    assert [e for _, e in got] == [False, False, True] * 2
    port.reset()
    assert np.array_equal(port[0][0], want[0][0])
    one = VideoDataset(root, (48, 32), max_files=1)
    assert len(one) == 3
    assert_same_stream(read_all(one), read_all(jax_video.VideoDataset(root, (48, 32), 1)))


def test_video_dataset_reads_mp4_as_jax(tmp_path):
    import cv2

    root = tmp_path / "mcl"
    root.mkdir()
    writer = cv2.VideoWriter(str(root / "a.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 30, (64, 48))
    if not writer.isOpened():
        pytest.skip("cv2.VideoWriter has no mp4 encoder in this build")
    for frame in small_clips(1, 4, (48, 64))[0]:
        writer.write(np.ascontiguousarray((frame[..., ::-1] * 255).astype(np.uint8)))
    writer.release()
    yuv_clip_dir(root, small_clips(1))
    port, jax_ds = VideoDataset(str(root)), jax_video.VideoDataset(str(root))
    assert len(port) == len(jax_ds) == 7
    got = read_all(port)
    assert_same_stream(got, read_all(jax_ds))
    assert [g[0].shape for g in got] == [(1080, 1920, 3)] * 3 + [(48, 64, 3)] * 4


@pytest.mark.parametrize("name", X26X)
def test_x26x_command_is_jax(name):
    assert (anchors._x26x_cmd(name, 640, 360, 27, 16, "/o.mp4")
            == jax_anchors._x26x_cmd(name, 640, 360, 27, 16, "/o.mp4"))


def test_x26x_command_unknown_name_raises():
    for mod in (anchors, jax_anchors):
        with pytest.raises(ValueError, match="codec not supported"):
            mod._x26x_cmd("x266", 64, 64, 27, 16, "o.mp4")


@pytest.mark.parametrize("comb", [0, 1, 2, 3])
def test_multiview_frame_layout_is_jax(comb):
    clip = np.random.default_rng(1).random((4, 3, 8, 12, 3), dtype=np.float32)
    got, gop = anchors.multiview_frame_layout(clip, comb, gop=8)
    want, jgop = jax_anchors.multiview_frame_layout(clip, comb, gop=8)
    assert gop == jgop and np.array_equal(got, want)


def test_multiview_frame_layout_unknown_raises():
    clip = np.zeros((2, 2, 4, 4, 3), np.float32)
    for mod in (anchors, jax_anchors):
        with pytest.raises(ValueError, match="Undefined frame comb"):
            mod.multiview_frame_layout(clip, 4)


def test_missing_binaries_raise_as_jax(monkeypatch):
    monkeypatch.setenv("PATH", "")
    frames = np.zeros((2, 16, 16, 3), np.float32)
    for mod in (anchors, jax_anchors):
        assert not mod.have_ffmpeg() and not mod.have_bpg()
        with pytest.raises(RuntimeError, match="ffmpeg binary not available"):
            mod.compress_whole_video("x264-medium", frames, 27)
        with pytest.raises(RuntimeError, match="bpgenc/bpgdec binaries not available"):
            mod.bpg_compress_iframe(frames[0], 27)


def test_anchor_subprocesses_have_timeouts(monkeypatch):
    """Every subprocess call and wait of the port's anchors carries a
    timeout (the JAX package's carry none), and a hung encoder is killed."""
    calls = []

    class Hung:
        def __init__(self, cmd, **kw):
            calls.append(("popen", cmd[0], kw))
            self.stdin, self.killed = open(os.devnull, "wb"), False

        def communicate(self, input=None, timeout=None):
            calls.append(("communicate", timeout))
            raise subprocess.TimeoutExpired("ffmpeg", timeout)

        def wait(self, timeout=None):
            calls.append(("wait", timeout))

        def poll(self):
            return None

        def kill(self):
            self.killed = True
            calls.append(("kill",))

    def run(cmd, **kw):
        calls.append(("run", cmd[0], kw))
        raise subprocess.TimeoutExpired(cmd[0], kw.get("timeout"))

    monkeypatch.setattr(anchors, "have_ffmpeg", lambda: True)
    monkeypatch.setattr(anchors, "have_bpg", lambda: True)
    monkeypatch.setattr(anchors.sp, "Popen", Hung)
    monkeypatch.setattr(anchors.sp, "run", run)
    with pytest.raises(subprocess.TimeoutExpired):
        anchors.compress_whole_video("x264-medium", np.zeros((2, 16, 16, 3), np.float32), 27)
    with pytest.raises(subprocess.TimeoutExpired):
        anchors.bpg_compress_iframe(np.zeros((16, 16, 3), np.float32), 27)
    assert ("communicate", anchors.X26X_TIMEOUT_S) in calls and ("kill",) in calls
    assert calls[-1][:2] == ("run", "bpgenc") and calls[-1][2]["timeout"] == anchors.BPG_TIMEOUT_S


def fake_ffmpeg(monkeypatch, tmp_path, body: str) -> list:
    """An ``ffmpeg`` on PATH that runs the shell ``body``; returns the list
    that collects the processes the anchors start."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    (bin_dir / "ffmpeg").write_text(f"#!/bin/sh\n{body}\n")
    (bin_dir / "ffmpeg").chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    procs = []

    class Recorded(subprocess.Popen):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            procs.append(self)

    monkeypatch.setattr(anchors.sp, "Popen", Recorded)
    return procs


def test_stalled_ffmpeg_times_out_and_is_killed(monkeypatch, tmp_path):
    """An ffmpeg that never reads its input: 8 frames of 128 x 128 (384
    KiB, more than a pipe holds) raise TimeoutExpired at the deadline
    instead of blocking on a full pipe, and the encoder is killed."""
    procs = fake_ffmpeg(monkeypatch, tmp_path, "exec sleep 60")
    monkeypatch.setattr(anchors, "X26X_TIMEOUT_S", 0.5)
    frames = np.zeros((8, 128, 128, 3), np.float32)
    with pytest.raises(subprocess.TimeoutExpired):
        anchors.compress_whole_video("x264-medium", frames, 27)
    assert len(procs) == 1 and procs[0].returncode is not None and procs[0].returncode < 0


def test_x26x_feeds_every_frame_to_ffmpeg(monkeypatch, tmp_path):
    """Every frame reaches ffmpeg's input, as uint8 RGB bytes."""
    got = tmp_path / "stdin.raw"
    fake_ffmpeg(monkeypatch, tmp_path, f"exec cat > '{got}'")
    frames = np.random.default_rng(5).random((8, 128, 128, 3), dtype=np.float32)
    with pytest.raises(FileNotFoundError):  # the fake writes no video
        anchors.compress_whole_video("x264-medium", frames, 27)
    assert got.read_bytes() == (frames * 255).astype(np.uint8).tobytes()


def rd_logs(d, write, name):
    """A 4-level log (two records a level) written by ``write``."""
    path = str(d / f"{name}.UVG.0.log")
    rng = np.random.default_rng(len(name))
    for level in range(4):
        for _ in range(2):
            bpp = 0.05 * 2 ** level * (1 + 0.1 * rng.random())
            psnrs = list(30 + 2.5 * level + rng.random(3))
            write(path, level, bpp, 0.01 * (1 + rng.random()), 0.005, psnrs, aux=(0.5,))
    return path


def test_rd_points_and_bd_rate_table_are_jax(tmp_path, capsys):
    logs = {}
    for pkg, write in (("port", write_eval_log), ("jax", jax_logs.write_eval_log)):
        d = tmp_path / pkg
        d.mkdir()
        logs[pkg] = [rd_logs(d, write, n) for n in ("DVC", "LSVC-TPU", "SSF-TPU")]
    for p, j in zip(logs["port"], logs["jax"]):
        assert open(p).read() == open(j).read()
        assert rd_points(p) == jax_plots.rd_points(j)
    got = bd_rate_table(logs["port"][0], logs["port"][1:])
    want = jax_plots.bd_rate_table(logs["jax"][0], logs["jax"][1:])
    assert got == want and set(got) == {"LSVC-TPU", "SSF-TPU"}
    plot_cli.main(["--logs", *logs["port"], "--bd-anchor", logs["port"][0],
                   "--rd", str(tmp_path / "rd.png"), "--speed", str(tmp_path / "speed.png")])
    out = capsys.readouterr().out
    for name, row in want.items():
        assert f"{name}: BD-rate {row['bd_rate_pct']:+.2f}%" in out
    assert (tmp_path / "rd.png").stat().st_size > 0 and (tmp_path / "speed.png").stat().st_size


def test_convert_dvc_state_dict_is_jax(tmp_path):
    sd = _synthetic_dvc_state_dict()
    got, want = ft.weights.flatten_params(convert_dvc_state_dict(sd)), \
        ft.weights.flatten_params(jax_convert(sd))
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    path = tmp_path / "snapshot.model"
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    loaded = ft.weights.flatten_params(load_torch_dvc_checkpoint(str(path)))
    assert all(np.array_equal(loaded[k], want[k]) for k in want)
    spec = ft.get_codec_model("DVC", device="cpu")
    ft.weights.load_flat(spec.module, got)  # every DVC parameter mapped


def test_test_size_is_h_by_w_in_the_port_and_transposed_in_jax(tmp_path, monkeypatch):
    """--test-size 32x48 (H x W): the port evaluates 32 x 48 frames; JAX's
    run_evaluate_sweep hands (32, 48) to a reader that takes (width,
    height), so its frames are 48 x 32."""
    root = yuv_clip_dir(tmp_path / "uvg", small_clips(1))
    monkeypatch.chdir(tmp_path)
    shapes = {}

    def spy(pkg):
        def evaluate_video(spec, *args, **kw):
            ds = args[-1] if pkg == "jax" else args[0]
            shapes[pkg] = ds[0][0].shape
            return {}
        return evaluate_video

    from fastvideocodec_torch.train import evaluate as port_evaluate
    from fastvideocodec_tpu.train import evaluate as jax_evaluate

    monkeypatch.setattr(port_evaluate, "evaluate_video", spy("port"))
    monkeypatch.setattr(jax_evaluate, "evaluate_video", spy("jax"))
    argv = ["--codec", "LSVC-TPU-TINY", "--dataset-dir", "unused", "--evaluate",
            "--test-dataset-dir", root, "--test-size", "32x48"]
    train_cli.run_evaluate_sweep(train_cli.parse_args([*argv, "--device", "cpu"]),
                                 torch.device("cpu"))
    jax_train_cli.run_evaluate_sweep(jax_train_cli.parse_args(argv), None, None, None)
    assert shapes == {"port": (32, 48, 3), "jax": (48, 32, 3)}


@pytest.fixture(scope="module")
def mv_tree(tmp_path_factory):
    """The JPEG tree of tests/test_torch_train_olft.py: lobby_0, 4 views,
    20 frames (16 train, 4 test)."""
    from PIL import Image

    root = tmp_path_factory.mktemp("mmptracking")
    d = root / "lobby_0"
    d.mkdir()
    base = synth_mv_gop(np.random.default_rng(11), views=4, size=80, gop=20)
    for t in range(20):
        for v in range(4):
            Image.fromarray((base[t, v, :72] * 255).astype(np.uint8)).save(
                d / f"rgb_{t:05d}_{v + 1}.jpg", quality=90)
    return str(root)


def avg_row(path) -> list:
    return [ln.strip().split(",") for ln in open(path) if ln.strip()]


def test_eval_multicam_is_jax(mv_tree, tmp_path, monkeypatch):
    """--task eval of MCVC-IA-TINY at level 3 on the test split (one GOP of
    3 x 4 views of 32x32), view mask drawn with one view allowed to fail,
    both packages on one tiny_mcvc_l3 checkpoint: the same row."""
    flat = {k: v for k, v in ft.weights.flatten_params(asset_params("tiny_mcvc_l3")).items()}
    spec = ft.get_codec_model("MCVC-IA-TINY", device="cpu", num_views=4)
    ft.weights.load_flat(spec.module, flat)
    ckpt = tmp_path / "ckpt"
    save_checkpoint(str(ckpt / "port" / "MCVC-IA-TINY-3P-lobby_0"),
                    {"params": dict(spec.module.named_parameters())}, best=True)
    jax_save_checkpoint(str(ckpt / "jax" / "MCVC-IA-TINY-3P-lobby_0"),
                        {"params": asset_params("tiny_mcvc_l3")}, best=True)
    args = ["--codec", "MCVC-IA-TINY", "--task", "eval", "--dataset-dir", mv_tree,
            "--category", "1", "--gop", "3", "--frame-size", "32", "--level-range", "3", "4",
            "--resilience", "1", "--seed", "4"]
    # JAX's CLI initialises the model under jax.jit only to have a target
    # for its checkpoint's restore: the checkpoint's own variables serve
    # (the restore replaces every value), and the init's compile is spared
    variables, jit = asset_params("tiny_mcvc_l3"), jax.jit

    def jit_but_init(fn, *a, **kw):
        if isinstance(fn, functools.partial) and getattr(fn.func, "__name__", "") == "init":
            return lambda *args, **kwargs: variables
        return jit(fn, *a, **kw)

    rows = {}
    for pkg, cli, extra in (("port", mv_cli, ["--device", "cpu"]), ("jax", jax_mv_cli, [])):
        d = tmp_path / pkg
        d.mkdir()
        monkeypatch.chdir(d)
        with jax.default_matmul_precision("highest"), pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_mv_cli.jax, "jit", jit_but_init)
            cli.main([*args, "--ckpt-dir", str(ckpt / pkg), *extra])
        rows[pkg] = avg_row(d / "MCVC-IA-TINY.avg.log")
    assert len(rows["port"]) == len(rows["jax"]) == 1
    got, want = rows["port"][0], rows["jax"][0]
    assert got[:2] == want[:2] == ["1", "3"] and len(got) == len(want) == 5
    for g, w in zip(got[2:], want[2:]):
        assert abs(float(g) - float(w)) <= 1e-4, (got, want)


def test_eval_cli_real_bits_runs_and_logs(tmp_path, monkeypatch, capsys):
    """``cli/eval.py --real-bits`` of LSVC-TPU-TINY on the CPU at 64x64,
    from a checkpoint of tiny_lsvctpu_l2 (level 2): the log's point is the
    one printed, decode == encode inside (real bits), and without a
    checkpoint it warns and evaluates the seeded weights."""
    root = yuv_clip_dir(tmp_path / "uvg", small_clips(1, 3, (64, 64)))
    spec = ft.get_codec_model("LSVC-TPU-TINY", device="cpu")
    ft.load_asset(spec.module, "tiny_lsvctpu_l2")
    save_checkpoint(str(tmp_path / "ckpt" / "LSVC-TPU-TINY-2P"),
                    {"params": dict(spec.module.named_parameters())}, best=True)
    monkeypatch.chdir(tmp_path)
    argv = ["--codec", "LSVC-TPU-TINY", "--dataset-dir", root, "--resolution", "64", "64",
            "--level-range", "2", "3", "--fP", "2", "--ckpt-dir", str(tmp_path / "ckpt"),
            "--real-bits", "--device", "cpu"]
    eval_cli.main(argv)
    out = capsys.readouterr().out
    assert "loaded weights from" in out and "bpp_est" in out
    pts = rd_points(str(tmp_path / "LSVC-TPU-TINY.UVG.0.log"))
    (header, psnrs), = read_eval_log(str(tmp_path / "LSVC-TPU-TINY.UVG.0.log"))
    assert list(pts) == [2] and len(psnrs) == 3 and len(header["aux"]) == 4
    assert f"bpp {header['bpp']:.4f}" in out
    eval_cli.main([*argv[:7], "--fP", "2", "--ckpt-dir", str(tmp_path / "none"),
                   "--device", "cpu"])
    assert "WARNING: no checkpoint" in capsys.readouterr().out
    assert eval_cli.parse_args(["--dataset-dir", "d"]).device == "cuda"


def test_stage_timers_time_each_stage():
    timers = StageTimers(torch.device("cpu"))
    with timers.stage("E-NET"):
        sum(range(1000))
    with timers.stage("custom"):
        pass
    assert timers.meters["E-NET"].count == 1 and timers.meters["E-NET"].val > 0
    assert timers.meters["custom"].count == 1
    assert timers.encoding_time == 0.0 and timers.decoding_time == 0.0
