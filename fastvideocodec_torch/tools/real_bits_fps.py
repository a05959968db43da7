"""Real-bits throughput of the port on one CUDA card: every LSVC form
(LSVC-TPU, its ablations -HF, -RW, -WT, -HU, -QU, attention -A/-S, graphs
-L/-O; the s2d=1 LSVC-128), SSF-Official, SSF-TPU, ELFVC-SP,
ELFVC-SP-TPU, DVC, RLVC, RLVC-HP or Base-EC-ER at 1024x2048, or MCVC-IA
or MCVC-Original on views of 256x256, GOP 16, through
the real bitstream encode AND decode (the networks on the card, range
coding on host threads), with decode == encode checked bit for bit and
the host coder's seconds apart from the rest.

    python -m fastvideocodec_torch.tools.real_bits_fps
        [--codec LSVC-TPU|LSVC-128|LSVC-TPU-RW|...|SSF-Official|SSF-TPU|ELFVC-SP
                 |ELFVC-SP-TPU|MCVC-IA|MCVC-Original|DVC|RLVC|RLVC-HP|Base-EC-ER]
        [--gop 16] [--h H] [--w W]
        [--views 4] [--failed 2] [--reps 3] [--level 2] [--dtype f32|bf16]
        [--json PATH] [--device cuda|cpu]

Weights: an LSVC form with a shipped checkpoint reads
fastvideocodec_tpu/assets/<LSVC_ASSETS[codec]>_l{level}.npz by path
(LSVC-TPU, -L, -O hd_lsvctpuf2; LSVC-128 hd_lsvc128; -RW hd_lsvctpu; -HF
hd_lsvctpuf; -WT hd_lsvctpuwt; -QU hd_lsvctpuqu); -HU, -A, -S and the
others ship no full-width checkpoint and run
``seeded_flat(codec, 0)`` (flagged ``trained: false``), the ELFVC-SP
forms at sp_stage 2 (both SPnets replace y), DVC, RLVC and Base with the
pretrained spynet.npz in their SpyNet. The clip is synth_gop_multi
with numpy seed 123 (1024x2048 unless --h/--w say otherwise); MCVC's
(``mcvc_clip``, 256x256 unless given) is ``--views`` views with the same
seed: MCVC-IA's with the views listed in ``--failed`` (comma-separated
indexes) zeroed, MCVC-Original's coded by stock SSF as a batch of views
(it takes no mask). One warm-up run,
then ``--reps`` timed runs, each printing encode and decode seconds (host
clock around the call, the card synchronised at its end, range coding
included), the AC seconds of each, real bpp and the identity check.
SSF's, ELFVC's and MCVC's bits include their coded keyframe, so their bpp
is over all GOP frames (and all views); LSVC's, DVC's, RLVC's and Base's
is over the P-frames (frame 0 is taken as already coded). The one-hop
graph (-O) reaches 14 P-frames: give it ``--gop 15``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

import fastvideocodec_torch as ft
from fastvideocodec_torch.coder import measure_ac_time
from fastvideocodec_torch.coder import video as cv
from fastvideocodec_torch.data.synthetic import row_views, synth_gop_multi, synth_mv_gop
from fastvideocodec_torch.layers.spynet import load_pretrained_spynet
from fastvideocodec_torch.ops.kernels import warp as kw


SP_STAGE = 2  # ELFVC-SP's stage, the one its tiny checkpoints were trained at
# the LSVC forms with a shipped full-width checkpoint: its name without the level
LSVC_ASSETS = {"LSVC-TPU": "hd_lsvctpuf2", "LSVC-TPU-F": "hd_lsvctpuf2",
               "LSVC-TPU-F2": "hd_lsvctpuf2", "LSVC-TPU-L": "hd_lsvctpuf2",
               "LSVC-TPU-O": "hd_lsvctpuf2", "LSVC-TPU-D": "hd_lsvctpuf2",
               "LSVC": "hd_lsvc128", "LSVC-128": "hd_lsvc128", "LSVC-TPU-RW": "hd_lsvctpu",
               "LSVC-TPU-HF": "hd_lsvctpuf", "LSVC-TPU-WT": "hd_lsvctpuwt",
               "LSVC-TPU-QU": "hd_lsvctpuqu"}
LSVC_SEEDED = ("LSVC-TPU-HU", "LSVC-TPU-A", "LSVC-TPU-S", "LSVC-A", "LSVC-S", "LSVC-L",
               "LSVC-O")
CODECS = (*LSVC_ASSETS, *LSVC_SEEDED, "SSF-Official", "SSF-TPU", "ELFVC-SP", "ELFVC-SP-TPU",
          "MCVC-IA", "MCVC-Original", "DVC", "RLVC", "RLVC-HP", "Base-EC-ER")
CHAINS = ("dvc", "base", "rlvc")  # P-frames coded on the previous recon
IFRAME_GIVEN = ("lsvc", *CHAINS)  # frame 0 taken as already coded, given to the decoder
CODERS = {  # family: (tables, encode, decode)
    "lsvc": (cv.bit_estimator_laplace_codecs, cv.lsvc_compress, cv.lsvc_decompress),
    "ssf": (cv.ssf_codecs, cv.ssf_compress_gop, cv.ssf_decompress_gop),
    "elfvc": (cv.ssf_codecs, cv.elfvc_compress_gop, cv.elfvc_decompress_gop),
    "mcvc": (cv.ssf_codecs, cv.mcvc_compress_gop, cv.mcvc_decompress_gop),
    "dvc": (cv.bit_estimator_laplace_codecs, cv.dvc_compress_gop, cv.dvc_decompress_gop),
    "base": (cv.bit_estimator_laplace_codecs, cv.base_compress_gop, cv.base_decompress_gop),
    "rlvc": (cv.rlvc_codecs, cv.rlvc_compress_gop, cv.rlvc_decompress_gop),
}


def codecs_of(spec):
    """The coder tables of a model, built once for many GOPs."""
    return CODERS[spec.family][0](spec.module)


def code_gop(spec, gop: torch.Tensor, codecs, mask=None) -> dict:
    """Encode, then decode, one GOP: [T, 3, H, W] (frame 0 the I-frame for
    LSVC, DVC, RLVC and Base, the keyframe SSF and ELFVC code), or views [T, V, 3, H, W]: MCVC's
    with its view mask [V], or a batch of views for the SSF family (as
    MCVC-Original); seconds by the host clock with the card synchronised
    at the end of each, the warp launches of each, bits and whether the
    decode equals the encode recon bit for bit."""
    on_card = gop.device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    T, H, W = gop.shape[0], gop.shape[-2], gop.shape[-1]
    iframe_given, mcvc = spec.family in IFRAME_GIVEN, spec.family == "mcvc"
    views = gop.shape[1] if gop.dim() == 5 else 1
    _, compress, decompress = CODERS[spec.family]
    args = ((gop,) if iframe_given else (gop, mask) if mcvc
            else (gop if views > 1 else gop[:, None],))
    sync()
    kw.reset_launches()
    t0 = time.perf_counter()
    with measure_ac_time() as enc_ac:
        streams, recon, bits = compress(spec, *args, codecs)
        sync()
    enc_s = time.perf_counter() - t0
    enc_launches = dict(kw.LAUNCHES)
    kw.reset_launches()
    t0 = time.perf_counter()
    with measure_ac_time() as dec_ac:
        if spec.family == "lsvc":  # the whole-GOP decoder takes the P-frame count
            decoded = decompress(spec, gop[0], streams, T - 1, codecs)
        elif iframe_given:
            decoded = decompress(spec, gop[0], streams, codecs)
        else:
            decoded = decompress(spec, streams, codecs)
        sync()
    dec_s = time.perf_counter() - t0
    frames = T - 1 if iframe_given else T
    out = {
        "enc_s": enc_s, "dec_s": dec_s, "enc_ac_s": enc_ac["seconds"],
        "dec_ac_s": dec_ac["seconds"], "bits": bits, "bpp": bits / (frames * views * H * W),
        "identical": bool(torch.equal(decoded, recon)), "enc_launches": enc_launches,
        "dec_launches": dict(kw.LAUNCHES), "recon": recon,
    }
    if not iframe_given:  # the P-frames' rate, as the rollout estimates it
        inter = sum(len(s[k]["z"]) + len(s[k]["y"])
                    for s in streams["inter"] for k in ("motion", "residual"))
        out["bpp_inter"] = 8 * inter / ((T - 1) * views * H * W)
    return out


def load_model(codec: str, level: int, dtype: torch.dtype, device: str, views: int = 1):
    """(spec, trained): an LSVC form's shipped weights by path, every other
    codec's (MCVC-IA on ``views`` views) seeded, with the pretrained
    SpyNet in DVC's, RLVC's and Base's."""
    spec = ft.get_codec_model(codec, dtype=dtype, device=device, sp_stage=SP_STAGE,
                              num_views=views)
    if codec in LSVC_ASSETS:
        ft.load_asset(spec.module, f"{LSVC_ASSETS[codec]}_l{level}")
        return spec, True
    ft.load_flat(spec.module, ft.seeded_flat(codec, 0))
    if spec.family in CHAINS:
        load_pretrained_spynet(spec.module.optic_flow)
    return spec, False


def mcvc_clip(seed: int, views: int, h: int, w: int, gop: int, failed: str = ""):
    """MCVC's clip [T, V, 3, h, w] (a float32 tensor) and its view mask [V]
    with the comma-separated views ``failed`` zeroed: square views are
    synth_mv_gop's offset crops, wide ones (h < w) the ``row_views`` of a
    synth_gop_multi clip of w x w, as chip_smoke.py's 4 x 1024x2048."""
    rng = np.random.default_rng(seed)
    if h == w:
        clip = synth_mv_gop(rng, views=views, size=h, gop=gop)
    elif h < w:
        clip = row_views(synth_gop_multi(rng, size=w, gop=gop), views, h)
    else:
        raise ValueError(f"MCVC views of {h}x{w}: taller than wide")
    mask = np.ones(views, np.float32)
    for v in filter(None, failed.split(",")):
        mask[int(v)] = 0.0
    return torch.from_numpy(np.ascontiguousarray(clip.transpose(0, 1, 4, 2, 3))), mask


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--codec", choices=CODECS, default="LSVC-TPU")
    ap.add_argument("--gop", type=int, default=16)
    ap.add_argument("--h", type=int, default=None, help="1024 (MCVC: 256)")
    ap.add_argument("--w", type=int, default=None, help="2048 (MCVC: 256)")
    ap.add_argument("--views", type=int, default=4, help="MCVC's views")
    ap.add_argument("--failed", default="", help="MCVC-IA's failed views, e.g. 2 or 1,3")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--level", type=int, default=2, help="an LSVC checkpoint's level")
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="f32")
    ap.add_argument("--json", default="", help="append the summary as one JSON line here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    mcvc = args.codec.startswith("MCVC")
    if args.failed and args.codec != "MCVC-IA":
        raise SystemExit(f"{args.codec} takes no view mask (--failed)")
    if mcvc:
        args.h, args.w, views = args.h or 256, args.w or 256, args.views
        gop, mask = mcvc_clip(123, views, args.h, args.w, args.gop, args.failed)
        mask = mask if args.codec == "MCVC-IA" else None
    else:
        args.h, args.w, views, mask = args.h or 1024, args.w or 2048, 1, None
        clip = synth_gop_multi(np.random.default_rng(123), size=max(args.h, args.w),
                               gop=args.gop)
        gop = torch.from_numpy(np.ascontiguousarray(clip[:, : args.h, : args.w]))
        gop = gop.permute(0, 3, 1, 2)
    spec, trained = load_model(args.codec, args.level, dtype, args.device, views)
    gop = gop.to(args.device, dtype).contiguous()
    device = (torch.cuda.get_device_name(0) if gop.device.type == "cuda" else "cpu")
    t0 = time.perf_counter()
    codecs = codecs_of(spec)
    what = "" if not mcvc else (f"{views} views (mask {mask.tolist()}) of " if mask is not None
                                else f"a batch of {views} views of ")
    print(f"{args.codec} {'trained' if trained else 'seeded'} {what}{args.h}x{args.w} "
          f"GOP{args.gop} {args.dtype} on {device}; tables {time.perf_counter() - t0:.3f} s",
          flush=True)

    frames = (args.gop - 1 if spec.family in IFRAME_GIVEN else args.gop) * views
    results = []
    for rep in range(args.reps + 1):
        r = code_gop(spec, gop, codecs, mask)
        if not r["identical"]:
            raise SystemExit(f"run {rep}: decode != encode recon")
        line = (f"enc {r['enc_s']:.3f} s (AC {r['enc_ac_s']:.3f} s) dec {r['dec_s']:.3f} s "
                f"(AC {r['dec_ac_s']:.3f} s) bpp {r['bpp']:.6f} decode == encode")
        print(f"  {'warm-up' if rep == 0 else f'rep {rep}'}: {line}", flush=True)
        if rep:
            results.append(r)
    enc = min(r["enc_s"] for r in results)
    dec = min(r["dec_s"] for r in results)
    best = min(results, key=lambda r: r["enc_s"] + r["dec_s"])
    print(f"real-bits fps (best of {args.reps}, view-frames for MCVC): encode "
          f"{frames / enc:.2f}, decode "
          f"{frames / dec:.2f}, encode+decode {frames / (best['enc_s'] + best['dec_s']):.2f} "
          f"(bpp {best['bpp']:.6f}, trained={trained})", flush=True)
    if args.json:
        with open(args.json, "a") as f:
            f.write(json.dumps({
                "tool": "fastvideocodec_torch.tools.real_bits_fps", "codec": args.codec,
                "device": device, "dtype": args.dtype, "h": args.h, "w": args.w,
                "views": views, "mask": None if mask is None else mask.tolist(),
                "gop": args.gop, "level": args.level, "trained": trained,
                "enc_s": best["enc_s"], "dec_s": best["dec_s"], "enc_ac_s": best["enc_ac_s"],
                "dec_ac_s": best["dec_ac_s"], "bpp": best["bpp"], "identity": True,
            }) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
