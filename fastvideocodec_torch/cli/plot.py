"""Chart CLI over 2-line eval logs, ported from
fastvideocodec_tpu/cli/plot.py (the offline-analysis layer the
reference implements in plot_hermes.py / plot_vesper.py / plot_mcvc.py).

Usage:
  python -m fastvideocodec_torch.cli.plot --logs LSVC-TPU.UVG.0.log DVC.UVG.0.log \
      --rd rd.png --speed speed.png --bd-anchor DVC.UVG.0.log
"""

from __future__ import annotations

import argparse

from fastvideocodec_torch.analysis.plots import (
    bd_rate_table,
    plot_rd_curves,
    plot_speed,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser("fvc-plot")
    p.add_argument("--logs", nargs="+", required=True)
    p.add_argument("--rd", default="", help="output RD-curve png")
    p.add_argument("--speed", default="", help="output speed-bars png")
    p.add_argument("--bd-anchor", default="",
                   help="anchor log for a BD-rate/BD-PSNR table")
    p.add_argument("--title", default="RD")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.rd:
        plot_rd_curves(args.logs, args.rd, title=args.title)
        print(f"wrote {args.rd}")
    if args.speed:
        plot_speed(args.logs, args.speed)
        print(f"wrote {args.speed}")
    if args.bd_anchor:
        tests = [l for l in args.logs if l != args.bd_anchor]
        table = bd_rate_table(args.bd_anchor, tests)
        for name, row in table.items():
            print(f"{name}: BD-rate {row['bd_rate_pct']:+.2f}% "
                  f"BD-PSNR {row['bd_psnr_db']:+.3f} dB")


if __name__ == "__main__":
    main()
