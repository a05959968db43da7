"""Classical codec anchors, ported from fastvideocodec_tpu/anchors: x264 /
x265 through ffmpeg and BPG I-frames, as host subprocess wrappers
(reference models.py:88-224, 412-429).

They run off the card. The binaries are optional; every entry point raises
the JAX package's error when its binary is missing (``have_ffmpeg()`` /
``have_bpg()`` let callers gate). Unlike the JAX package's, every
subprocess here has a timeout (``X26X_TIMEOUT_S``, ``BPG_TIMEOUT_S``): an
encoder that hangs, or stops reading its frames, raises
``subprocess.TimeoutExpired`` and is killed."""

from __future__ import annotations

import os
import shlex
import shutil
import subprocess as sp
import tempfile
import time

import numpy as np

X26X_TIMEOUT_S = 3600  # ffmpeg on a whole clip, feeding its frames included
BPG_TIMEOUT_S = 600  # one bpgenc or bpgdec call on one frame


def have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def have_bpg() -> bool:
    return shutil.which("bpgenc") is not None and shutil.which("bpgdec") is not None


def _x26x_cmd(name: str, width: int, height: int, q: int, gop: int, outfile: str) -> str:
    """ffmpeg command lines matching the reference (models.py:97-110)."""
    fps = 25
    base = (
        f"ffmpeg -y -s {width}x{height} -pixel_format rgb24 -f rawvideo -r {fps} "
        f"-i pipe: -pix_fmt yuv420p "
    )
    if name == "x265-veryfast":
        return base + f'-vcodec libx265 -preset veryfast -tune zerolatency -x265-params "crf={q}:keyint={gop}" {outfile}'
    if name == "x265-medium":
        return base + f'-vcodec libx265 -preset medium -x265-params "crf={q}:keyint={gop}" {outfile}'
    if name == "x265-veryslow":
        return base + f'-vcodec libx265 -preset veryslow -x265-params "crf={q}:bframes=0" {outfile}'
    if name == "x264-veryfast":
        return base + f"-vcodec libx264 -preset veryfast -tune zerolatency -crf {q} -g {gop} -bf 2 -b_strategy 0 -sc_threshold 0 {outfile}"
    if name == "x264-medium":
        return base + f"-vcodec libx264 -preset medium -crf {q} -g {gop} -bf 2 -b_strategy 0 -sc_threshold 0 {outfile}"
    if name == "x264-veryslow":
        return base + f"-vcodec libx264 -preset veryslow -crf {q} -bf 2 -b_strategy 0 -sc_threshold 0 {outfile}"
    raise ValueError(f"codec not supported: {name}")


def compress_whole_video(name: str, frames: np.ndarray, q: int, gop: int = 16):
    """frames: [N, H, W, 3] float32 in [0, 1]. Returns (psnr_list,
    bpp_per_frame, enc_time_per_frame, dec_time_per_frame).

    Mirrors reference models.py:88-224 (the callers flatten views into the
    frame axis, ``multiview_frame_layout``)."""
    if not have_ffmpeg():
        raise RuntimeError("ffmpeg binary not available in this environment")
    import cv2

    n, h, w, _ = frames.shape
    with tempfile.TemporaryDirectory() as td:
        outfile = os.path.join(td, "anchor.mp4")
        cmd = _x26x_cmd(name, w, h, q, gop, outfile)
        raw = np.empty(frames.shape, np.uint8)
        for i in range(n):
            raw[i] = (frames[i] * 255).astype(np.uint8)
        t0 = time.perf_counter()
        proc = sp.Popen(shlex.split(cmd), stdin=sp.PIPE, stdout=sp.DEVNULL, stderr=sp.STDOUT)
        try:
            # the deadline covers feeding the frames too: an ffmpeg that stops
            # reading raises here instead of blocking a write on a full pipe
            proc.communicate(memoryview(raw.reshape(-1)), timeout=X26X_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        enc_t = (time.perf_counter() - t0) / n

        video_bits = os.path.getsize(outfile) * 8
        t0 = time.perf_counter()
        cap = cv2.VideoCapture(outfile)
        rec = []
        while True:
            ret, img = cap.read()
            if not ret:
                break
            rec.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0)
        cap.release()
        dec_t = (time.perf_counter() - t0) / max(len(rec), 1)

    assert len(rec) == n, f"clip size mismatch {len(rec)} vs {n}"
    bpp = video_bits / n / (h * w)
    psnrs = []
    for i in range(n):
        mse = np.mean((frames[i] - rec[i]) ** 2)
        psnrs.append(10 * np.log10(1.0 / max(mse, 1e-12)))
    return psnrs, bpp, enc_t, dec_t


def multiview_frame_layout(clip: np.ndarray, frame_comb: int, gop: int = 16):
    """Arrange a multi-view clip [G, V, H, W, 3] for x26x anchor coding
    (reference frame_comb layouts, models.py:123-151):

    0: view-major order (all frames of view 0, then view 1, ...)
    1: views stitched horizontally into one wide frame per time step
    2: frame-major order (all views of frame 0, then frame 1, ...)
    3: view-major order with keyint scaled by V

    Returns (frames [N, H, W', 3], effective_gop)."""
    g, v, h, w, _ = clip.shape
    if frame_comb == 0:
        return clip.transpose(1, 0, 2, 3, 4).reshape(g * v, h, w, 3), gop
    if frame_comb == 1:
        return clip.transpose(0, 2, 1, 3, 4).reshape(g, h, v * w, 3), gop
    if frame_comb == 2:
        return clip.reshape(g * v, h, w, 3), gop
    if frame_comb == 3:
        return clip.transpose(1, 0, 2, 3, 4).reshape(g * v, h, w, 3), gop * v
    raise ValueError(f"Undefined frame comb: {frame_comb}")


def bpg_compress_iframe(frame: np.ndarray, i_level: int):
    """BPG I-frame coding (reference I_compression, models.py:412-429).

    frame: [H, W, 3] float32. Returns (recon, bpp, psnr)."""
    if not have_bpg():
        raise RuntimeError("bpgenc/bpgdec binaries not available")
    from PIL import Image

    h, w, _ = frame.shape
    with tempfile.TemporaryDirectory() as td:
        pre = os.path.join(td, "pre.jpg")
        binf = os.path.join(td, "out.bin")
        post = os.path.join(td, "post.jpg")
        Image.fromarray((frame * 255).astype(np.uint8)).save(pre, quality=95)
        sp.run(["bpgenc", "-f", "444", "-m", "9", pre, "-o", binf, "-q", str(i_level)],
               check=True, timeout=BPG_TIMEOUT_S)
        sp.run(["bpgdec", binf, "-o", post], check=True, timeout=BPG_TIMEOUT_S)
        bits = os.path.getsize(binf) * 8
        with Image.open(post) as im:
            rec = np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0
    bpp = bits / (h * w)
    mse = np.mean((frame - rec) ** 2)
    return rec, bpp, 10 * np.log10(1.0 / max(mse, 1e-12))
