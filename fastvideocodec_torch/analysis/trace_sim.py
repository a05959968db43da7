"""Network-trace adaptive-level simulation for multi-camera streaming,
ported from fastvideocodec_tpu/analysis/trace_sim.py (reference
train_multiview.py:417-479, simulation()).

Per GOP the sender picks the highest compression level whose bpp fits the
current per-view bandwidth budget; the result is the mean bpp, PSNR and
SSIM and the 1% and 0.1% low-percentile bpp (the reference's
bpp99/bpp999 tails). Host numpy over the per-(category, level) records of
the ``{codec}.avg.log`` files the multi-camera evaluators write
(cli/train_multiview.py --task eval and x26x).
"""

from __future__ import annotations

import numpy as np


def read_avg_log(path: str):
    """Parses 'cat,lvl,bpp,psnr[,ssim]' lines into
    {cat: {lvl: [(bpp, psnr, ssim), ...]}} (train_multiview.py:345-390)."""
    table: dict = {}
    with open(path) as f:
        for ln in f:
            ln = ln.strip()
            if not ln:
                continue
            parts = ln.split(",")
            cat, lvl = int(float(parts[0])), int(float(parts[1]))
            bpp, psnr = float(parts[2]), float(parts[3])
            ssim = float(parts[4]) if len(parts) > 4 else 0.0
            table.setdefault(cat, {}).setdefault(lvl, []).append((bpp, psnr, ssim))
    return table


def simulate_over_trace(
    level_records: dict,
    bw_trace,
    num_views: int,
    pixels_per_view: int = 1920 * 1080,
):
    """level_records: {lvl: [(bpp, psnr, ssim), ...]}, per-GOP records, as
    many for every level; bw_trace: the bits/s available a GOP across the
    views.

    For GOP g with budget bw_trace[g] it picks the highest level whose bpp
    fits bw/(num_views*pixels), as the JAX package does: the reference's
    loop keeps the first level that exceeds the cap
    (train_multiview.py:470-473), one level over the budget. Returns the
    aggregates with the low-percentile bpp tails."""
    levels = sorted(level_records)
    n = min(len(level_records[l]) for l in levels)
    bw = np.asarray(bw_trace, dtype=np.float64)
    chosen_bpp, chosen_psnr, chosen_ssim = [], [], []
    for g in range(n):
        max_bpp = bw[g % len(bw)] / num_views / pixels_per_view
        pick = levels[0]
        for lvl in levels:
            if level_records[lvl][g][0] > max_bpp:
                break
            pick = lvl
        bpp, psnr, ssim = level_records[pick][g]
        chosen_bpp.append(bpp)
        chosen_psnr.append(psnr)
        chosen_ssim.append(ssim)
    b = np.asarray(chosen_bpp)
    srt = np.sort(b)
    return {
        "bpp": float(b.mean()),
        "psnr": float(np.mean(chosen_psnr)),
        "ssim": float(np.mean(chosen_ssim)),
        "bpp_p1": float(srt[max(0, int(len(srt) * 0.01))]),
        "bpp_p01": float(srt[max(0, int(len(srt) * 0.001))]),
        "gops": n,
    }
