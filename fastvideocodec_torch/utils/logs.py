"""Eval logs in the reference's two-line format, ported from
fastvideocodec_tpu/utils/logs.py, so the plotting and simulation tools
keep parsing them (reference eval.py:332-337, plot_vesper.py:520-537):

line 1: 'level,bpp,enc_t,dec_t[,aux,...]'
line 2: the Python repr of the list of per-frame PSNRs
"""

from __future__ import annotations

import ast
import os


def write_eval_log(path: str, level: int, bpp: float, enc_t: float, dec_t: float,
                   psnr_list: list, aux: tuple = ()):
    """Appends one record (two lines) to ``path``, making its directory."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as f:
        line = f"{level},{bpp:.4f},{enc_t:.3f},{dec_t:.3f}"
        for a in aux:
            line += f",{a:.4f}"
        f.write(line + "\n")
        f.write(str([float(p) for p in psnr_list]) + "\n")


def read_eval_log(path: str):
    """The records of ``path``: [(header dict, psnr list), ...], the header
    {level, bpp, enc_t, dec_t, aux: [...]}."""
    records = []
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    for i in range(0, len(lines) - 1, 2):
        parts = lines[i].split(",")
        header = {
            "level": int(float(parts[0])),
            "bpp": float(parts[1]),
            "enc_t": float(parts[2]),
            "dec_t": float(parts[3]),
            "aux": [float(p) for p in parts[4:]],
        }
        records.append((header, ast.literal_eval(lines[i + 1])))
    return records
