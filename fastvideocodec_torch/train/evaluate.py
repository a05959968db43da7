"""GOP-based evaluation, ported from fastvideocodec_tpu/train/evaluate.py
(reference eval.py:254-354 static_simulation_model): iterate a
VideoDataset, group its frames into GOPs, I-code frame 0 (BPG when the
binaries are there, else a pass-through flagged at 24 bpp), run the
estimated-bits rollout (and with ``real_bits`` the family's real bitstream
encode and decode), aggregate bpp and per-frame PSNR, and append the
two-line log record that the plotting and BD-rate tools parse.

Frames stay NHWC float32 numpy on the host, as the JAX drivers take them,
and become NCHW tensors on the codec's device at the rollout's edge. The
codec runs where its module lives: on the card unless it was built with
``device="cpu"``. Every timer waits for the card before it reads the
clock (``utils.meters.StageTimers``), and compiles and warm-ups stay
outside the timed regions."""

from __future__ import annotations

import time

import numpy as np
import torch

from fastvideocodec_torch.anchors import bpg_compress_iframe, have_bpg
from fastvideocodec_torch.gop import rollout
from fastvideocodec_torch.models.registry import CodecSpec
from fastvideocodec_torch.utils.logs import write_eval_log
from fastvideocodec_torch.utils.meters import AverageMeter, StageTimers, synchronize


def pad_to_multiple(x: np.ndarray, mult: int = 64):
    """Pad H, W of NHWC frames up to a multiple, repeating the edge (the
    caller computes metrics on the unpadded region)."""
    h, w = x.shape[-3:-1]
    ph = (-h) % mult
    pw = (-w) % mult
    if ph or pw:
        pad = [(0, 0)] * (x.ndim - 3) + [(0, ph), (0, pw), (0, 0)]
        x = np.pad(x, pad, mode="edge")
    return x, (h, w)


def _device(spec: CodecSpec) -> torch.device:
    return next(spec.module.parameters()).device


def _nchw(frames: np.ndarray, device) -> torch.Tensor:
    """NHWC host frames (any leading axes) -> a contiguous NCHW float32
    tensor on ``device``."""
    t = torch.from_numpy(np.ascontiguousarray(frames, dtype=np.float32)).to(device)
    return t.movedim(-1, -3).contiguous()


def _nhwc(t: torch.Tensor) -> np.ndarray:
    """NCHW frames (any leading axes) -> NHWC float32 host numpy."""
    return t.float().movedim(-3, -1).cpu().numpy()


_DEC_GRAPHS: dict = {}


def _time_decode_only(spec: CodecSpec, padded: np.ndarray):
    """Estimated-bits mode decode timing: the family's receiver graph (what
    a receiver runs after the host's entropy decode,
    ``gop.decode_graph.build_lsvc_decode``), so the log's enc_t/dec_t split
    is honest without real bitstreams (reference eval.py:316-337).

    Returns the wall seconds of one GOP's decode, the card waited for, or
    None for a family with no decode graph (the caller then takes the
    rollout's time). One graph is cached, the last shape's: its example
    latents are whole-GOP tensors."""
    if spec.family != "lsvc":
        return None
    from fastvideocodec_torch.gop.decode_graph import build_lsvc_decode

    m = spec.module
    device = _device(spec)
    T, H, W = padded.shape[0], padded.shape[-3], padded.shape[-2]
    key = (id(m), T, H, W)
    entry = _DEC_GRAPHS.get(key)
    if entry is None:
        decode, latents = build_lsvc_decode(m, T, H, W)
        entry = (decode, latents, [False])
        _DEC_GRAPHS.clear()
        _DEC_GRAPHS[key] = entry
    decode, latents, warmed = entry
    with torch.inference_mode():
        iframe = m.fold(_nchw(padded[0:1], device).to(m.dtype))[0][0]
        if not warmed[0]:  # the first call's setup stays outside the timed run
            decode(iframe, *latents)
            warmed[0] = True
        synchronize(device)
        t0 = time.perf_counter()
        out = decode(iframe, *latents)
        _ = (float(out[0]), float(out[1]))  # waits for the card
        synchronize(device)
        return time.perf_counter() - t0


def code_iframe(frame: np.ndarray, i_level: int):
    """BPG I-frame when the binaries exist (models.py:412-429); otherwise a
    null I-codec that passes the frame through and charges 24 bpp (an
    honest upper bound, flagged by its 120 dB in the log)."""
    if have_bpg():
        return bpg_compress_iframe(frame, i_level)
    mse = 1e-12
    return frame.copy(), 24.0, 10 * np.log10(1.0 / mse)


def _real_bits_gop(spec: CodecSpec, gop: np.ndarray, mask=None):
    """One GOP through the family's real-bitstream encode AND decode
    (reference compress_slow/decompress_slow net-vs-AC accounting,
    entropy_models.py:97-148). gop: NHWC host frames [T, H, W, 3]. Returns
    (p_recon [T-1, H, W, 3], key_recon or None, bits, enc_t, dec_t,
    enc_ac_t, dec_ac_t), the recons as NHWC float32 numpy, the times in
    seconds (each stage waits for the card; the AC times are the range
    coder's, ``coder.measure_ac_time``).

    For family 'mcvc' gop is [T, B*V, H, W, 3] and ``mask`` the alive-view
    mask; p_recon is then [T-1, B*V, H, W, 3] and key_recon [B*V, H, W, 3]
    (the jointly coded keyframe)."""
    from fastvideocodec_torch.coder import measure_ac_time
    from fastvideocodec_torch.coder import video as cv

    device = _device(spec)
    x = _nchw(gop, device)
    T = x.shape[0]
    fam = spec.family
    timers = StageTimers(device)

    def timed(name, fn):
        with measure_ac_time() as acc, timers.stage(name):
            out = fn()
        return out, timers.meters[name].val, acc["seconds"]

    if fam == "lsvc":
        (streams, _, bits), enc_t, enc_ac = timed("E-NET", lambda: cv.lsvc_compress(spec, x))
        dec, dec_t, dec_ac = timed("D-NET", lambda: cv.lsvc_decompress(spec, x[0], streams, T - 1))
        return _nhwc(dec), None, bits, enc_t, dec_t, enc_ac, dec_ac
    if fam == "rlvc":
        (streams, _, bits), enc_t, enc_ac = timed("E-NET", lambda: cv.rlvc_compress_gop(spec, x))
        dec, dec_t, dec_ac = timed("D-NET", lambda: cv.rlvc_decompress_gop(spec, x[0], streams))
        return _nhwc(dec), None, bits, enc_t, dec_t, enc_ac, dec_ac
    if fam in ("dvc", "base"):
        compress = cv.dvc_compress_gop if fam == "dvc" else cv.base_compress_gop
        decompress = cv.dvc_decompress_gop if fam == "dvc" else cv.base_decompress_gop
        (streams, _, bits), enc_t, enc_ac = timed("E-NET", lambda: compress(spec, x))
        dec, dec_t, dec_ac = timed("D-NET", lambda: decompress(spec, x[0], streams))
        return _nhwc(dec), None, bits, enc_t, dec_t, enc_ac, dec_ac
    if fam in ("ssf", "elfvc"):
        compress = cv.elfvc_compress_gop if fam == "elfvc" else cv.ssf_compress_gop
        decompress = cv.elfvc_decompress_gop if fam == "elfvc" else cv.ssf_decompress_gop
        (streams, _, bits), enc_t, enc_ac = timed("E-NET", lambda: compress(spec, x[:, None]))
        dec, dec_t, dec_ac = timed("D-NET", lambda: decompress(spec, streams))
        dec = _nhwc(dec)[:, 0]
        return dec[1:], dec[0], bits, enc_t, dec_t, enc_ac, dec_ac
    if fam == "mcvc":
        if mask is None:
            mask = np.ones((x.shape[1],), np.float32)
        (streams, _, bits), enc_t, enc_ac = timed(
            "E-NET", lambda: cv.mcvc_compress_gop(spec, x, mask))
        dec, dec_t, dec_ac = timed("D-NET", lambda: cv.mcvc_decompress_gop(spec, streams))
        dec = _nhwc(dec)
        return dec[1:], dec[0], bits, enc_t, dec_t, enc_ac, dec_ac
    raise ValueError(f"no real-bitstream path for family '{fam}'")


def evaluate_video(
    spec: CodecSpec,
    dataset,
    gop_size: int = 16,
    log_path: str | None = None,
    level: int = 0,
    compress_iframe: bool = True,
    max_gops: int = 0,
    real_bits: bool = False,
):
    """Runs the whole dataset through the codec ``spec`` (its module holds
    the weights); returns a dict of aggregates. Appends one two-line record
    per video to ``log_path`` when its eof is reached. A GOP of one frame
    (a video's tail) is skipped, and its video's record still written (JAX's
    loop skips the record with the tail; ROADMAP.md section 3).

    real_bits=True drives the family's real bitstream encode AND decode:
    bpp becomes the coded bytes', enc_t/dec_t are separate, and the log's
    aux fields carry the net-vs-AC split (aux = enc_ac_t, dec_ac_t,
    bpp_est, msssim_db; reference eval.py:332-337). SSF and ELFVC then
    code their own keyframe (no BPG).

    MS-SSIM is computed per frame beside PSNR where the clip is big enough
    for 5-scale MS-SSIM (min side > 160; reference eval.py:199-220; the
    quality is -10 log10(1 - msssim), models.py:475-487). With
    spec.loss_type == 'M' the log's per-frame quality list is the MS-SSIM
    quality; otherwise PSNR, the mean MS-SSIM riding the aux fields."""
    from fastvideocodec_torch.ops.msssim import msssim_db

    device = _device(spec)
    bpp_meter = AverageMeter()
    bpp_est_meter = AverageMeter()
    psnr_meter = AverageMeter()
    msssim_meter = AverageMeter()
    enc_meter = AverageMeter()
    dec_meter = AverageMeter()
    enc_ac_meter = AverageMeter()
    dec_ac_meter = AverageMeter()
    all_psnr: list[float] = []
    all_msssim: list[float] = []
    buf: list[np.ndarray] = []
    gops_done = 0
    # SSF-family streams self-code the keyframe (neural I-branch); BPG
    # would code frame 0 twice
    if real_bits and spec.family in ("ssf", "elfvc"):
        compress_iframe = False

    def write_record():
        nonlocal all_psnr, all_msssim
        ms_avg = msssim_meter.avg if msssim_meter.count else 0.0
        aux = ((enc_ac_meter.avg, dec_ac_meter.avg, bpp_est_meter.avg, ms_avg)
               if real_bits else (ms_avg,))
        # loss type M logs the MS-SSIM quality list (what the reference's
        # msssim-mode plots parse); PSNR otherwise
        quality_list = all_msssim if spec.loss_type == "M" and all_msssim else all_psnr
        write_eval_log(log_path, level, bpp_meter.avg, enc_meter.avg, dec_meter.avg,
                       quality_list, aux=aux)
        all_psnr, all_msssim = [], []

    for idx in range(len(dataset)):
        frame, eof = dataset[idx]
        buf.append(frame)
        if len(buf) < gop_size and not eof:
            continue
        gop = np.stack(buf)
        buf = []
        T = gop.shape[0]
        if T < 2:
            # a one-frame tail is not coded, but its video's record is
            # written (the JAX package's loop skips the write with the tail)
            if eof and log_path and all_psnr:
                write_record()
            continue
        # 5-scale MS-SSIM needs min(H, W) > 160 (pytorch_msssim's
        # constraint); smaller clips log PSNR only
        do_msssim = min(gop.shape[-3], gop.shape[-2]) > 160

        def quality(x_hat_f: np.ndarray, raw_f: np.ndarray):
            mse = np.mean((x_hat_f - raw_f) ** 2)
            p = 10 * np.log10(1.0 / max(float(mse), 1e-12))
            m = None
            if do_msssim:
                with torch.inference_mode():
                    m = float(msssim_db(_nchw(x_hat_f[None], device),
                                        _nchw(raw_f[None], device)))
            return p, m

        if compress_iframe:
            rec0, i_bpp, i_psnr = code_iframe(gop[0], spec.I_level)
            _, i_ms = quality(rec0, gop[0])
            gop[0] = rec0
            bpp_meter.update(i_bpp)
            psnr_meter.update(i_psnr)
            all_psnr.append(i_psnr)
            if i_ms is not None:
                msssim_meter.update(i_ms)
                all_msssim.append(i_ms)
        padded, (h, w) = pad_to_multiple(gop, 64)
        # estimated-bits rollout (in both modes: bpp_est is logged as an
        # aux field next to the real bpp, so drift is visible)
        x = _nchw(padded, device)
        synchronize(device)
        t0 = time.perf_counter()
        x_hat, metrics = rollout(spec, x)
        synchronize(device)
        dt = time.perf_counter() - t0
        scale = (padded.shape[-3] * padded.shape[-2]) / (h * w)
        bpps = (metrics["bpp_est"] if "bpp_est" in metrics else metrics["bpp"]).float()
        bpps = bpps.cpu().numpy()
        bpp_est_meter.update(float(np.mean(bpps)) * scale, T - 1)

        if real_bits:
            p_rec, key_rec, bits, enc_t, dec_t, enc_ac, dec_ac = _real_bits_gop(spec, padded)
            x_hat = p_rec[:, :h, :w]
            if key_rec is not None:
                kp, km = quality(key_rec[:h, :w], gop[0])
                all_psnr.append(kp)
                psnr_meter.update(kp)
                if km is not None:
                    msssim_meter.update(km)
                    all_msssim.append(km)
            bpp_meter.update(bits / ((T - 1) * h * w), T - 1)
            enc_meter.update(enc_t / (T - 1), T - 1)
            dec_meter.update(dec_t / (T - 1), T - 1)
            enc_ac_meter.update(enc_ac / (T - 1), T - 1)
            dec_ac_meter.update(dec_ac / (T - 1), T - 1)
        else:
            enc_meter.update(dt / (T - 1), T - 1)
            dec_dt = _time_decode_only(spec, padded)
            dec_meter.update((dec_dt if dec_dt is not None else dt) / (T - 1), T - 1)
            x_hat = _nhwc(x_hat)[:, :h, :w]
            bpp_meter.update(float(np.mean(bpps)) * scale, T - 1)

        for i in range(T - 1):
            p, m = quality(x_hat[i], gop[1 + i])
            all_psnr.append(p)
            psnr_meter.update(p)
            if m is not None:
                msssim_meter.update(m)
                all_msssim.append(m)
        gops_done += 1

        if eof and log_path:
            write_record()
        if max_gops and gops_done >= max_gops:
            break

    out = {
        "bpp": bpp_meter.avg,
        "bpp_est": bpp_est_meter.avg,
        "psnr": psnr_meter.avg,
        "msssim_db": msssim_meter.avg if msssim_meter.count else None,
        "sec_per_frame": enc_meter.avg,
        "dec_sec_per_frame": dec_meter.avg,
    }
    if real_bits:
        out["enc_ac_sec_per_frame"] = enc_ac_meter.avg
        out["dec_ac_sec_per_frame"] = dec_ac_meter.avg
    return out
