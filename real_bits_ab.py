#!/usr/bin/env python3
"""Whether the real-bits paths' non-blocking host copies pay, on one CUDA card.

    python3 real_bits_ab.py [--codec LSVC-TPU SSF-TPU] [--turns 8]

For each codec (bfloat16, 1024x2048, GOP 16; LSVC-TPU on hd_lsvctpuf2_l2,
SSF-TPU on ``seeded_flat("SSF-TPU", 0)``; the synth_gop_multi clip of
numpy seed 0, as chip_smoke.py codes it) it codes one warm-up GOP, then
GOPs in turns: with the shipped host copies (``coder.video.HostCopy``: a
non-blocking copy into pinned memory that the coder's thread waits on) and
with synchronous ones (``.cpu()`` on the dispatching thread, which waits
for the card there), in the order shipped, synchronous, synchronous,
shipped, ``--turns`` times. decode == encode is checked on every GOP. It
prints the encode and decode ms of every GOP, the medians of each mode,
the two-sided Mann-Whitney p of each difference, and, over the shipped
GOPs, the host's seconds per GOP by codec call (summed over the coder's
threads) beside the range coder's (AC).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import statistics
import threading
import time

import numpy as np
import torch
from scipy.stats import mannwhitneyu

from fastvideocodec_torch.coder import video as cv
from fastvideocodec_torch.data.synthetic import synth_gop_multi
from fastvideocodec_torch.tools.real_bits_fps import code_gop, codecs_of, load_model

MODES = ("shipped", "synchronous")


class _SyncCopy:
    """HostCopy's interface, copying on the calling thread."""

    def __init__(self, t: torch.Tensor):
        self._host = t.cpu()

    def numpy(self) -> np.ndarray:
        return self._host.numpy()


@contextlib.contextmanager
def copies(mode: str):
    """The coder's host copies of ``mode`` for the scope."""
    saved = cv.HostCopy
    if mode == "synchronous":
        cv.HostCopy = _SyncCopy
    try:
        yield
    finally:
        cv.HostCopy = saved


def time_codec_calls(codecs, seconds: dict, on: threading.Event) -> None:
    """Wrap the methods of these codec objects (the tool's own) so that
    each call adds its seconds to ``seconds[type.method]`` while ``on``."""
    lock = threading.Lock()

    def timed(key, fn):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                if on.is_set():
                    with lock:
                        seconds[key] += time.perf_counter() - t0
        return wrapped

    flat = []
    for c in codecs:
        flat += [c.z_codec, c.y_codec] if isinstance(c, cv.HyperpriorCoder) else [c]
    for c in flat:
        for method in ("compress", "decompress", "encode", "decode"):
            if hasattr(c, method):
                key = f"{type(c).__name__}.{method}"
                setattr(c, method, timed(key, getattr(c, method)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--codec", nargs="+", default=["LSVC-TPU", "SSF-TPU"])
    ap.add_argument("--turns", type=int, default=8)
    args = ap.parse_args(argv)

    clip = synth_gop_multi(np.random.default_rng(0), size=2048, gop=16)[:, :1024, :2048]
    gop = torch.from_numpy(np.ascontiguousarray(clip)).permute(0, 3, 1, 2)
    gop = gop.to("cuda", torch.bfloat16).contiguous()
    for name in args.codec:
        spec, _ = load_model(name, 2, torch.bfloat16, "cuda")
        codecs = codecs_of(spec)
        seconds, on = collections.defaultdict(float), threading.Event()
        time_codec_calls(codecs, seconds, on)
        code_gop(spec, gop, codecs)  # warm-up
        ms = {m: {"encode": [], "decode": []} for m in MODES}
        ac = []
        order = ["shipped", "synchronous", "synchronous", "shipped"] * args.turns
        for mode in order:
            if mode == "shipped":
                on.set()
            with copies(mode):
                r = code_gop(spec, gop, codecs)
            on.clear()
            if not r["identical"]:
                raise SystemExit(f"{name} {mode}: decode != encode recon")
            ms[mode]["encode"].append(r["enc_s"] * 1e3)
            ms[mode]["decode"].append(r["dec_s"] * 1e3)
            if mode == "shipped":
                ac.append(r["enc_ac_s"] + r["dec_ac_s"])
        print(f"{name} bf16 1024x2048 GOP16, ms/GOP, {args.turns} turns of {order[:4]}",
              flush=True)
        for way in ("encode", "decode"):
            a, b = ms["shipped"][way], ms["synchronous"][way]
            for mode in MODES:
                t = ms[mode][way]
                print(f"  {way} {mode}: {[round(x, 3) for x in t]} median "
                      f"{statistics.median(t):.3f}", flush=True)
            p = mannwhitneyu(a, b, alternative="two-sided").pvalue
            print(f"  {way}: synchronous / shipped medians "
                  f"{statistics.median(b) / statistics.median(a):.4f}, Mann-Whitney p {p:.2g}",
                  flush=True)
        n = len(ac)
        print(f"  host seconds per GOP over the {n} shipped GOPs, summed over threads: "
              f"AC {sum(ac) / n:.4f}", flush=True)
        for key in sorted(seconds):
            print(f"    {key}: {seconds[key] / n:.4f}", flush=True)
    print(f"{torch.cuda.get_device_name(0)}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
