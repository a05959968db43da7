"""Real-bits throughput of the port on one CUDA card: LSVC-TPU, SSF-TPU or
ELFVC-SP-TPU at 1024x2048, GOP 16, through the real bitstream encode AND
decode (the networks on the card, range coding on host threads), with
decode == encode checked bit for bit and the host coder's seconds apart
from the rest.

    python -m fastvideocodec_torch.tools.real_bits_fps [--codec LSVC-TPU|SSF-TPU|ELFVC-SP-TPU]
        [--gop 16] [--h 1024] [--w 2048] [--reps 3] [--level 2]
        [--dtype f32|bf16] [--json PATH] [--device cuda|cpu]

Weights: LSVC-TPU reads fastvideocodec_tpu/assets/hd_lsvctpuf2_l{level}.npz
by path; SSF-TPU and ELFVC-SP-TPU ship no full-width checkpoint and run
``seeded_flat(codec, 0)`` (flagged ``trained: false``), ELFVC-SP-TPU at
sp_stage 2 (both SPnets replace y). The clip is
synth_gop_multi with numpy seed 123. One warm-up run, then ``--reps``
timed runs, each printing encode and decode seconds (host clock around the
call, the card synchronised at its end, range coding included), the AC
seconds of each, real bpp and the identity check. SSF's and ELFVC's bits
include their coded keyframe, so their bpp is over all GOP frames; LSVC's
is over the P-frames (frame 0 is taken as already coded).
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
from fastvideocodec_torch.data.synthetic import synth_gop_multi
from fastvideocodec_torch.ops.kernels import warp as kw


SP_STAGE = 2  # ELFVC-SP-TPU's stage, the one its tiny checkpoints were trained at
CODERS = {  # family: (tables, encode, decode)
    "lsvc": (cv.lsvc_codecs, cv.lsvc_compress, cv.lsvc_decompress),
    "ssf": (cv.ssf_codecs, cv.ssf_compress_gop, cv.ssf_decompress_gop),
    "elfvc": (cv.ssf_codecs, cv.elfvc_compress_gop, cv.elfvc_decompress_gop),
}


def codecs_of(spec):
    """The coder tables of a model, built once for many GOPs."""
    return CODERS[spec.family][0](spec.module)


def code_gop(spec, gop: torch.Tensor, codecs) -> dict:
    """Encode, then decode, one GOP [T, 3, H, W] (frame 0 the I-frame for
    LSVC, the keyframe SSF and ELFVC code); seconds by the host clock with
    the card synchronised at the end of each, the warp launches of each,
    bits and whether the decode equals the encode recon bit for bit."""
    on_card = gop.device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    T, _, H, W = gop.shape
    lsvc = spec.family == "lsvc"
    _, compress, decompress = CODERS[spec.family]
    sync()
    kw.reset_launches()
    t0 = time.perf_counter()
    with measure_ac_time() as enc_ac:
        streams, recon, bits = compress(spec, gop if lsvc else gop[:, None], codecs)
        sync()
    enc_s = time.perf_counter() - t0
    enc_launches = dict(kw.LAUNCHES)
    kw.reset_launches()
    t0 = time.perf_counter()
    with measure_ac_time() as dec_ac:
        if lsvc:
            decoded = decompress(spec, gop[0], streams, T - 1, codecs)
        else:
            decoded = decompress(spec, streams, codecs)
        sync()
    dec_s = time.perf_counter() - t0
    frames = T - 1 if lsvc else T
    out = {
        "enc_s": enc_s, "dec_s": dec_s, "enc_ac_s": enc_ac["seconds"],
        "dec_ac_s": dec_ac["seconds"], "bits": bits, "bpp": bits / (frames * H * W),
        "identical": bool(torch.equal(decoded, recon)), "enc_launches": enc_launches,
        "dec_launches": dict(kw.LAUNCHES), "recon": recon,
    }
    if not lsvc:  # the P-frames' rate, as the rollout estimates it
        inter = sum(len(s[k]["z"]) + len(s[k]["y"])
                    for s in streams["inter"] for k in ("motion", "residual"))
        out["bpp_inter"] = 8 * inter / ((T - 1) * H * W)
    return out


def load_model(codec: str, level: int, dtype: torch.dtype, device: str):
    """(spec, trained): LSVC-TPU's shipped weights by path, SSF-TPU's and
    ELFVC-SP-TPU's seeded."""
    spec = ft.get_codec_model(codec, dtype=dtype, device=device, sp_stage=SP_STAGE)
    if codec == "LSVC-TPU":
        ft.load_asset(spec.module, f"hd_lsvctpuf2_l{level}")
        return spec, True
    ft.load_flat(spec.module, ft.seeded_flat(codec, 0))
    return spec, False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--codec", choices=("LSVC-TPU", "SSF-TPU", "ELFVC-SP-TPU"),
                    default="LSVC-TPU")
    ap.add_argument("--gop", type=int, default=16)
    ap.add_argument("--h", type=int, default=1024)
    ap.add_argument("--w", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--level", type=int, default=2, help="LSVC-TPU's weights level")
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="f32")
    ap.add_argument("--json", default="", help="append the summary as one JSON line here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    spec, trained = load_model(args.codec, args.level, dtype, args.device)
    clip = synth_gop_multi(np.random.default_rng(123), size=max(args.h, args.w), gop=args.gop)
    gop = torch.from_numpy(np.ascontiguousarray(clip[:, : args.h, : args.w]))
    gop = gop.permute(0, 3, 1, 2).to(args.device, dtype).contiguous()
    device = (torch.cuda.get_device_name(0) if gop.device.type == "cuda" else "cpu")
    t0 = time.perf_counter()
    codecs = codecs_of(spec)
    print(f"{args.codec} {'trained' if trained else 'seeded'} {args.h}x{args.w} GOP{args.gop} "
          f"{args.dtype} on {device}; tables {time.perf_counter() - t0:.3f} s", flush=True)

    frames = args.gop - 1 if spec.family == "lsvc" else args.gop
    results = []
    for rep in range(args.reps + 1):
        r = code_gop(spec, gop, codecs)
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
    print(f"real-bits fps (best of {args.reps}): encode {frames / enc:.2f}, decode "
          f"{frames / dec:.2f}, encode+decode {frames / (best['enc_s'] + best['dec_s']):.2f} "
          f"(bpp {best['bpp']:.6f}, trained={trained})", flush=True)
    if args.json:
        with open(args.json, "a") as f:
            f.write(json.dumps({
                "tool": "fastvideocodec_torch.tools.real_bits_fps", "codec": args.codec,
                "device": device, "dtype": args.dtype, "h": args.h, "w": args.w,
                "gop": args.gop, "level": args.level, "trained": trained,
                "enc_s": best["enc_s"], "dec_s": best["dec_s"], "enc_ac_s": best["enc_ac_s"],
                "dec_ac_s": best["dec_ac_s"], "bpp": best["bpp"], "identity": True,
            }) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
