"""Streaming-simulation CLI of the port, ported from
fastvideocodec_tpu/cli/simulate.py (reference simulation.py): BOLA
adaptive bitrate over bandwidth traces, with each level's PSNR, bpp and
decode-time tables read from the two-line eval logs that ``cli/eval.py``
and ``train/evaluate.py:evaluate_video`` write (``--task abr``), or the
multi-camera adaptive-level simulation over the ``{codec}.avg.log`` that
``cli/train_multiview.py --task eval`` writes (``--task trace``).

Usage:
  python -m fastvideocodec_torch.cli.simulate --logs LSVC-TPU.UVG.0.log \\
      --trace-csv traces.csv --num-traces 20
  python -m fastvideocodec_torch.cli.simulate --task trace --logs MCVC-IA.avg.log

Traces CSV: columns downthrpt (bits/s) and, optionally, latency (s); without
``--trace-csv`` a seeded lognormal trace set is made (in the 1-100 Mbps
band the reference filters for, simulation.py:55). A log's ``dec_t`` is
the decode time in seconds a frame; a record whose ``dec_t`` reads 0 takes
``--decode-time``. Host numpy: it needs no card. It prints the JAX CLI's
lines, and ``main`` also returns each log's result.
"""

from __future__ import annotations

import argparse
import csv

import numpy as np

from fastvideocodec_torch.analysis import (
    AbrConfig,
    bola_simulate,
    read_avg_log,
    segment_tables,
    simulate_over_trace,
)
from fastvideocodec_torch.utils.logs import read_eval_log


def parse_args(argv=None):
    p = argparse.ArgumentParser("fvc-simulate")
    p.add_argument("--logs", nargs="+", required=True,
                   help="2-line eval logs, one per codec")
    p.add_argument("--trace-csv", default=None)
    p.add_argument("--num-traces", type=int, default=20)
    p.add_argument("--trace-len", type=int, default=500)
    p.add_argument("--trace-dur", type=float, default=10.0)
    p.add_argument("--gop", type=int, default=16)
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--decode-time", type=float, default=0.01,
                   help="s/frame decode table entry when logs carry none")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--task", default="abr", choices=["abr", "trace"],
                   help="abr: BOLA over 2-line eval logs; trace: multicam "
                        "adaptive-level simulation over {codec}.avg.log "
                        "(reference train_multiview.py:417-479)")
    p.add_argument("--num-views", type=int, default=4)
    p.add_argument("--pixels-per-view", type=int, default=1920 * 1080)
    return p.parse_args(argv)


def load_traces(args):
    """(downthrpt bits/s, latency s) arrays: the CSV's rows inside the
    1-100 Mbps band, at most trace_len * num_traces of them, or seeded
    lognormal traces around 8 Mbps clipped to that band."""
    if args.trace_csv:
        down, lat = [], []
        with open(args.trace_csv) as f:
            for row in csv.DictReader(f):
                d = float(row["downthrpt"])
                if 1e6 < d < 100e6:  # the band filter of simulation.py:55
                    down.append(d)
                    lat.append(float(row.get("latency", 0.0)))
                if len(down) >= args.trace_len * args.num_traces:
                    break
        return np.asarray(down), np.asarray(lat)
    rng = np.random.default_rng(args.seed)
    n = args.trace_len * args.num_traces
    down = np.clip(rng.lognormal(np.log(8e6), 0.8, n), 1e6, 100e6)
    return down, np.zeros(n)


def trace_main(args) -> list:
    """The multi-camera simulation of each ``{codec}.avg.log``, by
    category: [(log, category, result)]."""
    down, _ = load_traces(args)
    out = []
    for log_path in args.logs:
        table = read_avg_log(log_path)
        for cat, level_records in sorted(table.items()):
            res = simulate_over_trace(
                level_records, down, args.num_views, args.pixels_per_view
            )
            print(
                f"{log_path} cat {cat}: bpp {res['bpp']:.4f} "
                f"psnr {res['psnr']:.2f} bpp_p1 {res['bpp_p1']:.4f} "
                f"bpp_p01 {res['bpp_p01']:.4f} ({res['gops']} gops)"
            )
            out.append((log_path, cat, res))
    return out


def main(argv=None) -> list:
    """``--task trace``: ``trace_main``'s rows. ``--task abr``: [(log,
    {qoe, quality, rebuffer, stall, bw: arrays over the traces, tables:
    (psnr, bitrate, decode time)})] of every log with 2 levels or more."""
    args = parse_args(argv)
    if args.task == "trace":
        return trace_main(args)
    down, lat = load_traces(args)
    cfg = AbrConfig(gop=args.gop, fps=args.fps, trace_dur=args.trace_dur)
    out = []
    for log_path in args.logs:
        records = read_eval_log(log_path)
        by_level: dict = {}
        for header, psnrs in records:
            by_level.setdefault(header["level"], {"psnr": [], "bpp": [], "dect": []})
            by_level[header["level"]]["psnr"].extend(psnrs)
            by_level[header["level"]]["bpp"].append(header["bpp"])
            by_level[header["level"]]["dect"].append(
                header["dec_t"] or args.decode_time
            )
        levels = sorted(by_level)
        psnr_tbl = [by_level[l]["psnr"] for l in levels]
        bpp_tbl = [float(np.mean(by_level[l]["bpp"])) for l in levels]
        dect_tbl = [float(np.mean(by_level[l]["dect"])) for l in levels]
        all_psnr, all_rate, all_dect = segment_tables(psnr_tbl, bpp_tbl, dect_tbl, cfg)
        if all_psnr.shape[0] < 2:
            print(f"{log_path}: need >=2 levels for BOLA, found {all_psnr.shape[0]}")
            continue
        results = []
        for t in range(args.num_traces):
            s = t * args.trace_len
            results.append(
                bola_simulate(
                    all_psnr, all_rate, all_dect,
                    down[s : s + args.trace_len], lat[s : s + args.trace_len], cfg,
                )
            )
        qoe, q, rb, st, bw = map(np.asarray, zip(*results))
        print(
            f"{log_path}: QoE {qoe.mean():.2f}±{qoe.std():.2f} "
            f"quality {q.mean():.2f} rebuffer {rb.mean():.4f} "
            f"stall {st.mean():.3f} bw {bw.mean()/1e6:.1f}Mbps"
        )
        out.append((log_path, {"qoe": qoe, "quality": q, "rebuffer": rb, "stall": st,
                               "bw": bw, "tables": (all_psnr, all_rate, all_dect)}))
    return out


if __name__ == "__main__":
    main()
