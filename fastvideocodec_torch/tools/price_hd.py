"""Price an LSVC config's BD-rate against LSVC-128 at the 128 px hd rung:
the port's copy of the JAX package's root ``tools/price_hd.py``.

    python -m fastvideocodec_torch.tools.price_hd [NAME FAMILY ...] \\
        [--asset-dir DIR] [--levels 0 2 4] [--device cpu]

JAX's TestHDHeadToHead (tests/test_rd.py:576) in the port: real
bitstreams (``coder/video.py:lsvc_compress``, float32; every GOP's decode
must equal its encode) of the 4 held-out multi-object clips (seed 123;
training draws seed 0), 128x128, GOP 8, for each level's checkpoint
``hd_<FAMILY>_l<level>.npz``; bpp and PSNR averaged over the clips; the
BD-rate and BD-PSNR (``analysis/bdrate.py``) against the LSVC-128 curve
of the shipped ``hd_lsvc128_l{0,2,4}``. The priced configs' checkpoints
are read from ``--asset-dir`` (by default the shipped assets; a
directory ``tools/train_tiny.py`` wrote prices the port's own training).
A config whose checkpoints are not all there prints a JSON skip line
(JAX's tool dies mid-output on -HU, one of its two defaults, which ships
none). A config priced at fewer than two levels prints its points with
null BD numbers.

Prints one JSON line per config; the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from fastvideocodec_torch.analysis.bdrate import bd_psnr, bd_rate
from fastvideocodec_torch.coder import video as cv
from fastvideocodec_torch.data.synthetic import synth_gop_multi
from fastvideocodec_torch.models import get_codec_model
from fastvideocodec_torch.weights import ASSET_DIR, load_flat

SIZE, GOP, LEVELS, CLIPS = 128, 8, (0, 2, 4), 4
HELD_OUT_SEED = 123
REFERENCE = ("LSVC-128", "lsvc128")
DEFAULT_PAIRS = [("LSVC-TPU-QU", "lsvctpuqu"), ("LSVC-TPU-HU", "lsvctpuhu")]


def held_out_clips(n: int = CLIPS, device="cuda") -> list:
    """TestHDHeadToHead._clips: n synth_gop_multi clips of SIZE x SIZE, GOP
    frames, from one generator of seed 123, as [GOP, 3, SIZE, SIZE]
    float32 tensors."""
    rng = np.random.default_rng(HELD_OUT_SEED)
    return [torch.from_numpy(np.ascontiguousarray(synth_gop_multi(rng, size=SIZE, gop=GOP)))
            .permute(0, 3, 1, 2).contiguous().to(device) for _ in range(n)]


def checkpoint(family: str, level: int, asset_dir=None) -> Path:
    return Path(asset_dir or ASSET_DIR) / f"hd_{family}_l{level}.npz"


def missing(family: str, levels=LEVELS, asset_dir=None) -> list:
    """The checkpoints of ``family`` at ``levels`` that are not there."""
    return [str(p) for p in (checkpoint(family, lvl, asset_dir) for lvl in levels)
            if not p.exists()]


def curve(name: str, family: str, clips: list, levels=LEVELS, asset_dir=None,
          device="cuda", check=None) -> tuple:
    """(bpps, psnrs) of ``name`` on each level's checkpoint over ``clips``:
    real bits, float32, the I-frame uncoded as in JAX's test. ``check`` is
    called with (what, decoded == recon) for every GOP."""
    denom = (GOP - 1) * SIZE * SIZE
    bpps, psnrs = [], []
    for level in levels:
        spec = get_codec_model(name, device=device)
        with np.load(checkpoint(family, level, asset_dir)) as data:
            load_flat(spec.module, {k: data[k] for k in data.files})
        codecs = cv.bit_estimator_laplace_codecs(spec.module)
        bs, ps = [], []
        for c in clips:
            streams, recon, bits = cv.lsvc_compress(spec, c, codecs)
            decoded = cv.lsvc_decompress(spec, c[0], streams, GOP - 1, codecs)
            same = bool(torch.equal(decoded, recon))
            if check is not None:
                check(f"hd {name} l{level}", same)
            elif not same:
                raise RuntimeError(f"hd {name} l{level}: decode != encode")
            bs.append(bits / denom)
            mse = float(torch.mean((recon.float() - c[1:].float()) ** 2))
            ps.append(10 * np.log10(1.0 / max(mse, 1e-12)))
        bpps.append(float(np.mean(bs)))
        psnrs.append(float(np.mean(ps)))
        del spec, codecs
    return bpps, psnrs


def price(ref: tuple, name: str, family: str, bpp: list, psnr: list) -> dict:
    """A config's JSON row: its curve and, at two levels or more, its
    BD-rate (%) and BD-PSNR (dB) against ``ref``, rounded as JAX's tool
    rounds them."""
    row = {"config": name, "fam": family, "bpp": bpp, "psnr": psnr,
           "bd_rate_vs_128": None, "bd_psnr_vs_128": None}
    if len(bpp) >= 2:
        row["bd_rate_vs_128"] = round(bd_rate(*ref, bpp, psnr), 2)
        row["bd_psnr_vs_128"] = round(bd_psnr(*ref, bpp, psnr), 3)
    return row


def parse_args(argv=None):
    p = argparse.ArgumentParser("fvc-price-hd")
    p.add_argument("pairs", nargs="*", help="NAME FAMILY ... (default: -QU and -HU)")
    p.add_argument("--asset-dir", default=None,
                   help="where the priced configs' hd_<FAMILY>_l<level>.npz are "
                   "(default: the shipped assets); LSVC-128's are always the shipped")
    p.add_argument("--levels", type=int, nargs="+", default=list(LEVELS))
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if len(args.pairs) % 2:
        p.error("pairs come as NAME FAMILY")
    return args


def main(argv=None) -> list:
    """Prints and returns the JSON rows: LSVC-128's curve, then each
    config's row or its skip line."""
    args = parse_args(argv)
    pairs = list(zip(args.pairs[0::2], args.pairs[1::2])) or DEFAULT_PAIRS
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    gone = missing(REFERENCE[1])
    if gone:
        emit({"config": REFERENCE[0], "skipped": "missing assets", "missing": gone})
        return rows
    clips = held_out_clips(device=args.device)
    ref = curve(*REFERENCE, clips, device=args.device)
    emit({"config": REFERENCE[0], "bpp": ref[0], "psnr": ref[1]})
    for name, family in pairs:
        gone = missing(family, args.levels, args.asset_dir)
        if gone:
            emit({"config": name, "fam": family, "skipped": "missing assets", "missing": gone})
            continue
        bpp, psnr = curve(name, family, clips, args.levels, args.asset_dir, args.device)
        emit(price(ref, name, family, bpp, psnr))
    return rows


if __name__ == "__main__":
    main()
