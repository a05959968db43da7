"""The evaluation path on the card: ``chip_smoke.py``'s phases 61-64, also
runnable alone on a CUDA card.

    python -m fastvideocodec_torch.tools.eval_smoke

61. ``train/evaluate.py:evaluate_video`` on LSVC-TPU (hd_lsvctpuf2_l2),
    bf16, 1024x2048, GOP 16, estimated bits and then real bits: a 33-frame
    synth_gop_multi clip (seed 0) written as a 1920x1080 I420 ``.yuv`` and
    read back through ``data/video.py:VideoDataset`` resized to 2048x1024
    (cli/eval.py's default), or without OpenCV served from memory: 2 GOPs
    and a 1-frame tail, which is skipped. Each GOP's rollout launches
    exactly 4 ``flow_warp`` and 4 ``flow_warp_s2d``, no plain warp runs,
    every real-bits decode equals its encode bit for bit, the real bpp is
    within 5% of the estimate, and ``analysis/plots.py:rd_points`` reads
    the log back to the returned bpp and PSNR.
62. The other families through ``_real_bits_gop`` at 256x256 GOP 16, bf16:
    SSF-TPU and ELFVC-SP-TPU (sp_stage 2, the keyframe self-coded) on
    seeded_flat, DVC with the pretrained SpyNet; then
    ``cli/train_multiview.py --task eval --real-bits`` of MCVC-IA on 4 x
    256x256 views of a JPEG tree in the MMPTracking layout. Every decode
    equals its encode.
63. ``train/evolve.py:evolve_on_video`` on LSVC-TPU (hd_lsvctpuf2_l2), f32,
    256x256 GOP 16, 5 steps (each timed, the card synchronised where the
    next starts): both flow warps' backward kernels launch, no
    plain warp or vjp runs, every parameter outside ``encoder_mask`` keeps
    its bits, the encoder's move, and the evolved encoder's stream decodes
    to its recon on the evolved model and on an un-evolved receiver; then
    ``cli/train.py --evaluate --evolve`` through its ``main`` on a .yuv
    directory.
64. ``cli/eval.py --real-bits`` through ``main`` (weights from a checkpoint
    of hd_lsvctpuf2_l2), ``cli/train_multiview.py --task speed`` for 1..6
    views at 256x256 bf16 (its ms/frame table), and the x26x anchors when
    ffmpeg is there.

Without OpenCV the steps that read a video file are reported and left
out; without ffmpeg the x26x anchors are. The card and the kernels are
never left out. The same functions are held against the JAX package's on
the CPU by tests/test_torch_eval.py and tests/test_torch_eval_cli.py.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import fastvideocodec_torch as ft
from fastvideocodec_torch.analysis import rd_points
from fastvideocodec_torch.coder import video as cv
from fastvideocodec_torch.data import ClipDataset, VideoDataset, write_yuv
from fastvideocodec_torch.data.synthetic import synth_gop_multi
from fastvideocodec_torch.layers.spynet import load_pretrained_spynet
from fastvideocodec_torch.ops import warp as ow
from fastvideocodec_torch.ops.kernels import warp as kw
from fastvideocodec_torch.train import evaluate as ev
from fastvideocodec_torch.train import save_checkpoint
from fastvideocodec_torch.train import evolve as evolve_module
from fastvideocodec_torch.train.evolve import encoder_mask, evolve_on_video
from fastvideocodec_torch.utils.logs import read_eval_log
from fastvideocodec_torch.utils.meters import synchronize
from fastvideocodec_torch.weights import load_flat, seeded_flat

# each family's real coder: (compress, decompress) in coder/video.py
CODERS = {"lsvc": ("lsvc_compress", "lsvc_decompress"),
          "ssf": ("ssf_compress_gop", "ssf_decompress_gop"),
          "elfvc": ("elfvc_compress_gop", "elfvc_decompress_gop"),
          "dvc": ("dvc_compress_gop", "dvc_decompress_gop"),
          "base": ("base_compress_gop", "base_decompress_gop"),
          "rlvc": ("rlvc_compress_gop", "rlvc_decompress_gop"),
          "mcvc": ("mcvc_compress_gop", "mcvc_decompress_gop")}
LSVC_ROLLOUT = {"flow_warp": 4, "flow_warp_s2d": 4}  # LSVC-TPU's launches a GOP
REAL_BPP_REL = 0.05  # real bits against the estimate, trained weights
MV_FRAMES = 85  # the JPEG tree's frame ids: a test split of 17, one GOP of 16
H, W = 1024, 2048  # LSVC-TPU's eval: cli/eval.py's default size
SIZE, GOP = 256, 16  # the other steps' frames


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"eval smoke failed: {msg}")


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    log(f"== phase {name}")
    yield
    log(f"== phase {name}: {time.perf_counter() - t0:.3f} s")


def environment() -> dict:
    """What the host offers the eval path: OpenCV (and an mp4 writer),
    ffmpeg and BPG."""
    out = {"ffmpeg": shutil.which("ffmpeg"), "bpgenc": shutil.which("bpgenc"),
           "bpgdec": shutil.which("bpgdec"), "cv2": None, "mp4_writer": False}
    try:
        import cv2
    except ImportError:
        return out
    out["cv2"] = cv2.__version__
    with tempfile.TemporaryDirectory() as d:
        writer = cv2.VideoWriter(os.path.join(d, "a.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 25,
                                 (64, 48))
        out["mp4_writer"] = bool(writer.isOpened())
        writer.release()
    return out


@contextlib.contextmanager
def patched(module, name: str, wrap):
    orig = getattr(module, name)
    setattr(module, name, wrap(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def plain_calls(calls: dict):
    """Counts the calls of the plain warps and their vjps in ``calls``."""
    saved = dict(ow.PLAIN), dict(ow.PLAIN_BACKWARD)

    def counted(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        return wrapped

    ow.PLAIN.update({n: counted(n, f) for n, f in saved[0].items()})
    ow.PLAIN_BACKWARD.update({n: counted(f"{n} vjp", f) for n, f in saved[1].items()})
    try:
        yield calls
    finally:
        ow.PLAIN.update(saved[0])
        ow.PLAIN_BACKWARD.update(saved[1])


@contextlib.contextmanager
def decode_checks(out: list):
    """Every real coder's compress records its recon; the next decompress
    appends to ``out`` whether it decoded that recon bit for bit."""
    pending = []

    def wrap_compress(fn):
        @functools.wraps(fn)
        def compress(*args, **kwargs):
            streams, recon, bits = fn(*args, **kwargs)
            pending.append(recon)
            return streams, recon, bits
        return compress

    def wrap_decompress(fn):
        @functools.wraps(fn)
        def decompress(*args, **kwargs):
            dec = fn(*args, **kwargs)
            out.append(bool(torch.equal(dec, pending.pop(0))))
            return dec
        return decompress

    with contextlib.ExitStack() as stack:
        for enc, dec in CODERS.values():
            stack.enter_context(patched(cv, enc, wrap_compress))
            stack.enter_context(patched(cv, dec, wrap_decompress))
        yield out


@contextlib.contextmanager
def rollout_launches(record: list):
    """Each rollout that evaluate_video runs appends its launch counts."""
    def wrap(fn):
        def rollout(*args, **kwargs):
            before = dict(kw.LAUNCHES)
            result = fn(*args, **kwargs)
            record.append({n: v - before[n] for n, v in kw.LAUNCHES.items() if v != before[n]})
            return result
        return rollout

    with patched(ev, "rollout", wrap):
        yield record


def write_mv_tree(root: Path, size: int, frames: int = MV_FRAMES) -> str:
    """lobby_0/rgb_{frame:05d}_{view}.jpg, 4 views of ``size`` squares (the
    MMPTracking layout data/multiview.py reads): crops of one synth_gop_multi
    clip (seed 11), view v offset by 4v pixels in both axes."""
    from PIL import Image

    d = root / "lobby_0"
    d.mkdir(parents=True)
    base = synth_gop_multi(np.random.default_rng(11), size=size + 12, gop=frames)
    for t in range(frames):
        for v in range(4):
            view = base[t, 4 * v:4 * v + size, 4 * v:4 * v + size]
            Image.fromarray((view * 255).astype(np.uint8)).save(
                d / f"rgb_{t:05d}_{v + 1}.jpg", quality=90)
    return str(root)


def eval_clip(tmp: Path, env: dict, frames: int):
    """Phase 61's clip: (the dataset, its description). A synth_gop_multi
    clip (seed 0) of ``frames`` frames, written once as a 1920x1080 I420
    ``tmp/uvg/clip.yuv`` and read back through VideoDataset at W x H
    (cli/eval.py's default); without OpenCV served from memory."""
    clip = synth_gop_multi(np.random.default_rng(0), size=max(H, W), gop=frames)
    if env["cv2"]:
        (tmp / "uvg").mkdir(exist_ok=True)
        if not (tmp / "uvg" / "clip.yuv").exists():
            write_yuv(tmp / "uvg" / "clip.yuv", clip)
        return (VideoDataset(str(tmp / "uvg"), (W, H)),
                f"{frames} frames of 1920x1080 I420 through VideoDataset at {W}x{H}")
    return ClipDataset([clip[:, :H, :W]]), f"{frames} frames of {H}x{W} from memory"


def run(smi: str = "", workdir: Path | None = None) -> dict:
    """Phases 61-64 on the CUDA card, its kernels built; returns their
    numbers, the launch counts by path (``launches``, each counted from 0
    over its run) among them. ``smi`` names the card in the printed
    lines. Their files (phase 61's clip and ``estimated.log``, phase 62's
    ``MCVC-IA.avg.log``) go to ``workdir``, kept, or else to a temporary
    directory that is removed."""
    device, size, gop = "cuda", SIZE, GOP
    env = environment()
    log(f"eval environment: {env}")
    if not env["cv2"]:
        log("OpenCV absent: the video-file reads (the .yuv clip, cli/eval.py, cli/train.py "
            "--evaluate) are not run; evaluate_video reads the clips from memory")
    if not env["ffmpeg"]:
        log("ffmpeg absent: x26x not run")
    frames = 2 * gop + 1
    lsvc, lsvc_asset = "LSVC-TPU", "hd_lsvctpuf2_l2"
    out = {"environment": env, "launches": {}, "card": smi}
    launches = out["launches"]

    def count_from_zero(path):
        kw.reset_launches()
        return lambda: launches.__setitem__(path, {k: v for k, v in kw.LAUNCHES.items() if v})

    tmp = Path(workdir) if workdir is not None else Path(tempfile.mkdtemp(prefix="eval_smoke_"))
    tmp.mkdir(parents=True, exist_ok=True)
    try:
        with phase(f"eval {lsvc} {H}x{W} GOP{gop} bf16: estimated bits, then real bits"):
            spec = ft.get_codec_model(lsvc, dtype=torch.bfloat16, device=device)
            ft.load_asset(spec.module, lsvc_asset)
            ds, source = eval_clip(tmp, env, frames)
            with torch.inference_mode():  # one warm-up GOP outside the timed runs
                ft.rollout(spec, ev._nchw(np.zeros((gop, H, W, 3), np.float32), device))
            rows = {}
            for mode in ("estimated", "real"):
                ds.reset()
                calls, decodes, per_rollout = {}, [], []
                done = count_from_zero(f"lsvc_eval_{mode}")
                t0 = time.perf_counter()
                with plain_calls(calls), decode_checks(decodes), rollout_launches(per_rollout):
                    stats = ev.evaluate_video(spec, ds, gop_size=gop,
                                              log_path=str(tmp / f"{mode}.log"), level=2,
                                              compress_iframe=False,
                                              real_bits=mode == "real")
                synchronize(device)
                wall = time.perf_counter() - t0
                done()
                pts = rd_points(str(tmp / f"{mode}.log"))[2]
                rows[mode] = {"stats": stats, "wall_s": wall, "rollouts": per_rollout,
                              "plain_calls": calls, "decodes": decodes, "rd_points": pts}
                log(f"eval {mode} ({smi}; {source}): bpp {stats['bpp']:.6f} (estimate "
                    f"{stats['bpp_est']:.6f}) psnr {stats['psnr']:.4f}; enc "
                    f"{stats['sec_per_frame'] * 1e3:.3f} dec "
                    f"{stats['dec_sec_per_frame'] * 1e3:.3f} ms/frame"
                    + (f", AC enc {stats['enc_ac_sec_per_frame'] * 1e3:.3f} dec "
                       f"{stats['dec_ac_sec_per_frame'] * 1e3:.3f} ms/frame"
                       if mode == "real" else
                       f"; the decode graph {stats['dec_sec_per_frame'] * (gop - 1) * 1e3:.3f} "
                       f"ms/GOP") + f"; {wall:.3f} s in all; rollout launches "
                    f"{per_rollout}; decode == encode {decodes}; rd_points {pts}")
                require(len(per_rollout) == 2, f"{mode}: {len(per_rollout)} GOPs, want 2")
                require(all(r == LSVC_ROLLOUT for r in per_rollout),
                        f"{mode}: rollout launches {per_rollout}, want {LSVC_ROLLOUT}")
                require(not calls, f"{mode}: plain warps called {calls}")
                require(all(decodes) and len(decodes) == (2 if mode == "real" else 0),
                        f"{mode}: decode != encode {decodes}")
                require(abs(pts["bpp"] - stats["bpp"]) <= 5e-5
                        and abs(pts["psnr"] - stats["psnr"]) <= 1e-9,
                        f"{mode}: rd_points {pts} against {stats}")
            real = rows["real"]["stats"]
            rel = abs(real["bpp"] - real["bpp_est"]) / real["bpp_est"]
            log(f"eval real bits: bpp {real['bpp']:.6f} against the estimate "
                f"{real['bpp_est']:.6f} (rel {rel:.4f}, tolerance {REAL_BPP_REL})")
            require(rel < REAL_BPP_REL, "real bpp far from the estimate")
            out["lsvc_eval"] = rows
            del spec, ds

        with phase(f"real bits of the other families through _real_bits_gop, {size}x{size} "
                   f"GOP{gop} bf16; cli/train_multiview.py --task eval --real-bits"):
            names = ["SSF-TPU", "ELFVC-SP-TPU", "DVC"]
            clip = synth_gop_multi(np.random.default_rng(1), size=size, gop=gop)
            out["families"] = {}
            for name in names:
                spec = ft.get_codec_model(name, dtype=torch.bfloat16, device=device, sp_stage=2)
                load_flat(spec.module, seeded_flat(name, 0))
                if spec.family == "dvc":
                    load_pretrained_spynet(spec.module.optic_flow)
                decodes = []
                done = count_from_zero(f"{name.lower()}_eval_real_bits")
                with decode_checks(decodes):
                    p_rec, key_rec, bits, enc_t, dec_t, enc_ac, dec_ac = ev._real_bits_gop(
                        spec, clip)
                synchronize(device)
                done()
                row = {"bits": bits, "bpp": bits / ((gop - 1) * size * size), "enc_ms": enc_t * 1e3,
                       "dec_ms": dec_t * 1e3, "enc_ac_ms": enc_ac * 1e3, "dec_ac_ms": dec_ac * 1e3,
                       "decodes": decodes, "self_coded_keyframe": key_rec is not None,
                       "launches": launches[f"{name.lower()}_eval_real_bits"]}
                out["families"][name] = row
                log(f"{name} real bits ({smi}): {row}")
                require(decodes == [True], f"{name}: decode != encode {decodes}")
                require(np.isfinite(p_rec).all() and p_rec.shape == (gop - 1, size, size, 3),
                        f"{name}: recon {p_rec.shape}")
                del spec
            from fastvideocodec_torch.cli import train_multiview

            mcvc = "MCVC-IA"
            tree = write_mv_tree(tmp / "mmptracking", size)
            decodes = []
            done = count_from_zero("mcvc_cli_eval_real_bits")
            cwd = os.getcwd()
            os.chdir(tmp)
            try:
                with decode_checks(decodes):
                    train_multiview.main(["--task", "eval", "--real-bits", "--codec", mcvc,
                                          "--dataset-dir", tree, "--category", "1",
                                          "--gop", str(gop), "--frame-size", str(size),
                                          "--level-range", "2", "3", "--device", device])
            finally:
                os.chdir(cwd)
            synchronize(device)
            done()
            row = (tmp / f"{mcvc}.avg.log").read_text().strip().split(",")
            out["mcvc_cli_eval"] = {"row": row, "decodes": decodes}
            log(f"{mcvc} --task eval --real-bits ({smi}): row {row}; decode == encode "
                f"{decodes}; launches {launches['mcvc_cli_eval_real_bits']}")
            require(decodes and all(decodes), f"{mcvc}: decode != encode {decodes}")

        with phase(f"evolve {lsvc} f32 {size}x{size} GOP{gop}, 5 steps; cli/train.py "
                   "--evaluate --evolve"):
            spec = ft.get_codec_model(lsvc, device=device)
            ft.load_asset(spec.module, lsvc_asset)
            receiver = ft.get_codec_model(lsvc, device=device)
            ft.load_asset(receiver.module, lsvc_asset)
            before = {k: v.clone() for k, v in spec.module.state_dict().items()}
            rng = np.random.default_rng(2)
            gops = [synth_gop_multi(rng, size=size, gop=gop) for _ in range(2)]
            calls, starts = {}, []

            def step_clock(fn):
                def loss(*args, **kwargs):  # a step starts where its loss does
                    synchronize(device)
                    starts.append(time.perf_counter())
                    return fn(*args, **kwargs)
                return loss

            done = count_from_zero("lsvc_evolve")
            with plain_calls(calls), patched(evolve_module, "gop_loss", step_clock):
                _, best = evolve_on_video(spec, gops, steps=5, learning_rate=1e-4)
            synchronize(device)
            starts.append(time.perf_counter())
            ms_steps = [(b - a) * 1e3 for a, b in zip(starts, starts[1:])]
            done()
            mask = encoder_mask(spec.module)
            after = spec.module.state_dict()
            frozen_same = all(torch.equal(after[n], before[n]) for n in mask if not mask[n])
            moved = sorted({n.split(".")[0] for n in mask
                            if mask[n] and not torch.equal(after[n], before[n])})
            x = ev._nchw(gops[0], device)
            streams, recon, bits = cv.lsvc_compress(spec, x)
            own = torch.equal(cv.lsvc_decompress(spec, x[0], streams, gop - 1), recon)
            unchanged = torch.equal(cv.lsvc_decompress(receiver, x[0], streams, gop - 1), recon)
            row = {"ms_per_step": ms_steps, "ms_median_after_first": float(np.median(ms_steps[1:])),
                   "best": best, "launches": launches["lsvc_evolve"],
                   "plain_calls": calls, "frozen_unchanged": frozen_same, "moved": moved,
                   "decodes_on_itself": own, "decodes_on_unchanged_receiver": unchanged,
                   "bpp": bits / ((gop - 1) * size * size)}
            out["evolve"] = row
            log(f"evolve ({smi}): {row}")
            require(launches["lsvc_evolve"].get("flow_warp_backward", 0) > 0
                    and launches["lsvc_evolve"].get("flow_warp_s2d_backward", 0) > 0,
                    f"evolve: backward launches {launches['lsvc_evolve']}")
            require(not calls, f"evolve: plain warps or vjps called {calls}")
            require(frozen_same, "evolve moved a parameter outside encoder_mask")
            require({"mv_encoder", "optic_flow", "res_encoder"} <= set(moved),
                    f"evolve: the encoder's moved {moved}")
            require(own and unchanged, "evolve: the evolved stream does not decode")
            del spec, receiver
            if env["cv2"]:
                from fastvideocodec_torch.cli import train as train_cli

                (tmp / "clips").mkdir()
                write_yuv(tmp / "clips" / "clip.yuv",
                          synth_gop_multi(np.random.default_rng(3), size=size, gop=gop + 1))
                done = count_from_zero("cli_train_evaluate_evolve")
                cwd = os.getcwd()
                os.chdir(tmp)
                try:
                    train_cli.main(["--codec", lsvc, "--dataset-dir", "unused", "--evolve",
                                    "--test-dataset-dir", str(tmp / "clips"), "--test-size",
                                    f"{size}x{size}", "--device", device])
                finally:
                    os.chdir(cwd)
                done()
                (header, psnrs), = read_eval_log(str(tmp / f"{lsvc}.clips.True.log"))
                out["cli_evolve"] = {"header": header, "frames": len(psnrs),
                                     "launches": launches["cli_train_evaluate_evolve"]}
                log(f"cli/train.py --evaluate --evolve ({smi}): {out['cli_evolve']}")
                require(len(psnrs) == min(gop + 1, 16), f"cli evolve: {len(psnrs)} frames logged")

        with phase("cli/eval.py --real-bits; cli/train_multiview.py --task speed 1..6 views "
                   f"{size}x{size} bf16; x26x"):
            from fastvideocodec_torch.cli import eval as eval_cli
            from fastvideocodec_torch.cli import train_multiview

            cwd = os.getcwd()
            os.chdir(tmp)
            try:
                if env["cv2"]:
                    spec = ft.get_codec_model(lsvc, device="cpu")
                    ft.load_asset(spec.module, lsvc_asset)
                    save_checkpoint(str(tmp / "ckpt" / f"{lsvc}-2P"),
                                    {"params": dict(spec.module.named_parameters())}, best=True)
                    decodes = []
                    done = count_from_zero("cli_eval_real_bits")
                    with decode_checks(decodes):
                        eval_cli.main(["--codec", lsvc, "--dataset-dir", str(tmp / "clips"),
                                       "--dataset", "clips", "--resolution", str(2 * size),
                                       str(size), "--level-range", "2", "3", "--ckpt-dir",
                                       str(tmp / "ckpt"), "--bf16", "--real-bits",
                                       "--device", device])
                    done()
                    pts = rd_points(str(tmp / f"{lsvc}.clips.0.log"))
                    out["cli_eval"] = {"rd_points": pts, "decodes": decodes,
                                       "launches": launches["cli_eval_real_bits"]}
                    log(f"cli/eval.py --real-bits ({smi}): {out['cli_eval']}")
                    require(decodes and all(decodes), f"cli/eval.py: decode != encode {decodes}")
                done = count_from_zero("mcvc_speed")
                rows = train_multiview.main(["--task", "speed", "--codec", mcvc, "--gop",
                                             str(gop), "--max-views", "6", "--device", device])
                done()
                out["speed"] = {"ms_per_frame": {nv: spf * 1e3 for nv, spf in rows},
                                "launches": launches["mcvc_speed"]}
                log(f"--task speed ({smi}), ms/frame by views at {size}x{size} bf16 GOP {gop}: "
                    f"{out['speed']['ms_per_frame']}")
                if env["ffmpeg"] and env["cv2"]:
                    tree = str(tmp / "mmptracking")
                    train_multiview.main(["--task", "x26x", "--codec", "x264", "--dataset-dir",
                                          tree, "--category", "1", "--gop", str(gop),
                                          "--frame-size", str(size)])
                    eval_cli.main(["--task", "x26x", "--codec", "x264-veryfast",
                                   "--dataset-dir", str(tmp / "clips"), "--resolution",
                                   str(2 * size), str(size)])
                    out["x26x"] = {"multiview": (tmp / "x264.avg.log").read_text().strip(),
                                   "eval": read_eval_log(str(tmp / "x264-veryfast.log"))[0][0]}
                    log(f"x26x ({smi}): {out['x26x']}")
            finally:
                os.chdir(cwd)
    finally:
        if workdir is None:
            shutil.rmtree(tmp, ignore_errors=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("eval_smoke needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from fastvideocodec_torch.ops.kernels import build

    build.load()
    print(json.dumps(run(), default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
