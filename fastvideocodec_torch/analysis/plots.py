"""Chart generation over the 2-line eval logs, ported from
fastvideocodec_tpu/analysis/plots.py (the reference's
plot_hermes.py / plot_vesper.py / plot_mcvc.py capability — RD curves,
speed bars, BD-rate tables — without the authors' hardcoded measured
arrays; everything here derives from logs this framework writes).

All functions take parsed log records ({level: {...}} via `rd_points`) or
log paths, and return matplotlib figures / plain dicts so they are testable
headless (Agg backend)."""

from __future__ import annotations

import os

import numpy as np

from fastvideocodec_torch.analysis.bdrate import bd_psnr, bd_rate
from fastvideocodec_torch.utils.logs import read_eval_log


def rd_points(log_path: str):
    """Aggregates a 2-line log into per-level RD points.

    Returns {level: {"bpp", "psnr", "enc_t", "dec_t"}} (means across
    records; psnr averaged over all frames)."""
    by_level: dict = {}
    for header, psnrs in read_eval_log(log_path):
        d = by_level.setdefault(
            header["level"], {"bpp": [], "psnr": [], "enc_t": [], "dec_t": []}
        )
        d["bpp"].append(header["bpp"])
        d["psnr"].extend(psnrs)
        d["enc_t"].append(header["enc_t"])
        d["dec_t"].append(header["dec_t"])
    return {
        lvl: {k: float(np.mean(v)) for k, v in d.items()}
        for lvl, d in sorted(by_level.items())
    }


def _label(log_path: str) -> str:
    return os.path.basename(log_path).split(".")[0]


def plot_rd_curves(log_paths, out_path: str | None = None, title: str = "RD"):
    """One RD curve per log (codec); returns the figure
    (plot_hermes.py:482-499 / plot_vesper.py:679-680 equivalent)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4.5))
    for lp in log_paths:
        pts = rd_points(lp)
        bpps = [pts[l]["bpp"] for l in pts]
        psnrs = [pts[l]["psnr"] for l in pts]
        ax.plot(bpps, psnrs, marker="o", label=_label(lp))
    ax.set_xlabel("bpp")
    ax.set_ylabel("PSNR (dB)")
    ax.set_title(title)
    ax.grid(True, alpha=0.3)
    ax.legend()
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=150)
    return fig


def plot_speed(log_paths, out_path: str | None = None):
    """Encode/decode ms-per-frame bars per codec (plot_hermes.py:735-737
    speed chart equivalent; uses the logs' own measured times)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    names, enc, dec = [], [], []
    for lp in log_paths:
        pts = rd_points(lp)
        names.append(_label(lp))
        enc.append(1e3 * float(np.mean([pts[l]["enc_t"] for l in pts])))
        dec.append(1e3 * float(np.mean([pts[l]["dec_t"] for l in pts])))
    x = np.arange(len(names))
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.bar(x - 0.2, enc, width=0.4, label="encode")
    ax.bar(x + 0.2, dec, width=0.4, label="decode")
    ax.set_xticks(x, names)
    ax.set_ylabel("ms / frame")
    ax.grid(True, axis="y", alpha=0.3)
    ax.legend()
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=150)
    return fig


def bd_rate_table(anchor_log: str, test_logs) -> dict:
    """BD-rate / BD-PSNR of each test codec vs the anchor
    (plot_mcvc.py:299-390 equivalent). Returns {codec: {"bd_rate_pct",
    "bd_psnr_db"}}; needs >=4 RD points per log for the cubic fit."""
    a = rd_points(anchor_log)
    ra = [a[l]["bpp"] for l in a]
    pa = [a[l]["psnr"] for l in a]
    out = {}
    for lp in test_logs:
        t = rd_points(lp)
        rt = [t[l]["bpp"] for l in t]
        pt = [t[l]["psnr"] for l in t]
        out[_label(lp)] = {
            "bd_rate_pct": bd_rate(ra, pa, rt, pt),
            "bd_psnr_db": bd_psnr(ra, pa, rt, pt),
        }
    return out
