#!/usr/bin/env python3
"""Time versions of the warp kernels side by side on one CUDA card.

    python3 warp_ab.py NAME=path/to/warp.cu [NAME=path/to/warp.cu ...] [--rounds 3]

Each source is a version of fastvideocodec_torch/ops/kernels/csrc/warp.cu
with its C interface (``fvc_flow_warp``, ``fvc_flow_warp_s2d``,
``fvc_pixel_warp``, ``fvc_pixel_warp_s2d``); all are built at once with
the repository's nvcc flags, and ptxas's report of their kernels is
printed. Four kernels are timed, on the inputs the rollouts give them at
bfloat16, 1024x2048, GOP 16, on the synth_gop_multi clip that
chip_smoke.py drives: ``flow_warp`` and ``flow_warp_s2d`` from one
LSVC-TPU rollout (weights hd_lsvctpuf2_l2), ``pixel_warp`` and
``pixel_warp_s2d_sflow`` from one SSF-TPU rollout (numpy-seeded weights
``seeded_flat("SSF-TPU", 0)``). Beside the path's flows, each kernel runs
on smooth flows of the same shapes (a shift plus a slow wave: a trained
codec's) and on +-200 px random ones, drawn once from a seed. Every
version must equal the plain version bit for bit on all of them. Then each
round times the versions in order and in reverse order (A B C, C B A); a
version's time of a kernel is the sum over one GOP's launches, warm
(chip_smoke.py's ``cuda_ms``) and with the L2 flushed before each launch
(``cold_ms``). It prints every pass, the median over the passes, the
card's name and power limit, and a JSON line of the medians. Comparing
versions within one run keeps the card, its power limit and the host the
same.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import chip_smoke as cs

KERNELS = ("flow_warp", "flow_warp_s2d", "pixel_warp", "pixel_warp_s2d_sflow")
FLOWS = ("path", "smooth", "random")
CLOCKS = ("warm", "cold")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("versions", nargs="+", help="NAME=path of a version of warp.cu")
    ap.add_argument("--rounds", type=int, default=3, help="rounds of two passes each")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("warp_ab: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, str(cs.ROOT))
    import numpy as np

    from fastvideocodec_torch import get_codec_model, load_asset, rollout
    from fastvideocodec_torch.data.synthetic import synth_gop_multi
    from fastvideocodec_torch.ops.kernels import build
    from fastvideocodec_torch.ops.warp import PLAIN, grid_norm
    from fastvideocodec_torch.weights import load_flat, seeded_flat

    sources = {}
    for v in args.versions:
        name, sep, path = v.partition("=")
        cs.require(bool(sep and name) and Path(path).is_file(), f"want NAME=path, got {v!r}")
        sources[name] = Path(path).resolve()
    with ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(build.build, sources.values())))
    libs = {name: build.open_library(path) for name, path in built.items()}
    for name, source in sources.items():
        for entry, report in cs.ptxas_report(build.build_log(source), "warp"):
            cs.log(f"{name} ptxas {entry}: {report}")

    dtypes = {torch.float32: 0, torch.bfloat16: 1}

    def launcher(lib, kernel):
        def launch(img, flow):
            out = torch.empty_like(img)
            B, C, h, w = img.shape
            fh, fw = flow.shape[2:]
            ptrs = (img.data_ptr(), flow.data_ptr(), out.data_ptr())
            dtype, stream = dtypes[img.dtype], torch.cuda.current_stream().cuda_stream
            if kernel == "flow_warp":
                rc = lib.fvc_flow_warp(*ptrs, B, C, h, w, grid_norm(fw), grid_norm(fh), dtype,
                                       stream)
            elif kernel == "flow_warp_s2d":
                rc = lib.fvc_flow_warp_s2d(*ptrs, B, C // 4, h, w, grid_norm(fw), grid_norm(fh),
                                           dtype, stream)
            elif kernel == "pixel_warp":
                rc = lib.fvc_pixel_warp(*ptrs, B, C, h, w, dtype, stream)
            else:  # pixel_warp_s2d_sflow: the c-major phase flow
                rc = lib.fvc_pixel_warp_s2d(*ptrs, B, C // 4, h, w, 1, dtype, stream)
            cs.require(rc == 0, f"{kernel} launch failed: cudaError {rc}")
            return out
        return launch

    launches = {name: {k: launcher(lib, k) for k in KERNELS} for name, lib in libs.items()}

    clip = synth_gop_multi(np.random.default_rng(0), size=max(cs.H, cs.W), gop=cs.GOP)
    gop = torch.from_numpy(np.ascontiguousarray(clip[:, :cs.H, :cs.W])).permute(0, 3, 1, 2)
    gop = gop.to("cuda", torch.bfloat16).contiguous()
    captured = {}
    spec = get_codec_model("LSVC-TPU", dtype=torch.bfloat16, device="cuda")
    load_asset(spec.module, "hd_lsvctpuf2_l2")
    with cs.capture_warp_inputs(captured):
        rollout(spec, gop)
    spec = get_codec_model("SSF-TPU", dtype=torch.bfloat16, device="cuda")
    load_flat(spec.module, seeded_flat("SSF-TPU", 0))
    with cs.capture_warp_inputs(captured):
        rollout(spec, gop)
    del spec, gop, clip
    want = [4, 4, cs.GOP - 1, cs.GOP - 1]
    cs.require([len(captured.get(k, [])) for k in KERNELS] == want, "captured launches")
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = {k: {"path": captured[k],
                 "smooth": [(img, cs.flow_like(torch, gen, cs.smooth_flow, flow))
                            for img, flow in captured[k]],
                 "random": [cs.warp_inputs(torch, gen, img.shape, flow.shape, img.dtype,
                                           flow.dtype)
                            for img, flow in captured[k]]}
             for k in KERNELS}

    for k in KERNELS:
        for flows, pairs in cases[k].items():
            for img, flow in pairs:
                want = PLAIN[k](img, flow)
                for name in libs:
                    got = launches[name][k](img, flow)
                    cs.require(torch.equal(got, want), f"{name} {k} {flows} {tuple(img.shape)}: "
                               f"{(got.float() - want.float()).abs().max().item()}")
    cs.log(f"every version equals the plain versions bit for bit on {len(KERNELS)} kernels "
           f"x {len(FLOWS)} flows x one GOP's launches")

    flush = torch.empty(cs.FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    times = {name: {(k, f, c): [] for k in KERNELS for f in FLOWS for c in CLOCKS}
             for name in libs}
    order = list(libs)
    for rnd in range(args.rounds):
        for names in (order, order[::-1]):
            for name in names:
                for k in KERNELS:
                    launch = launches[name][k]
                    for f in FLOWS:
                        pairs = cases[k][f]
                        warm = sum(cs.cuda_ms(torch, launch, i, fl) for i, fl in pairs)
                        cold = sum(cs.cold_ms(torch, launch, i, fl, flush=flush)
                                   for i, fl in pairs)
                        times[name][k, f, "warm"].append(warm)
                        times[name][k, f, "cold"].append(cold)
                        cs.log(f"round {rnd} {name} {k} {f}: warm {warm} cold {cold} ms/GOP")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    ).stdout.strip().splitlines()[0]
    medians = {name: {f"{k} {f} {c}": statistics.median(v) for (k, f, c), v in t.items()}
               for name, t in times.items()}
    cs.log("median ms/GOP over the passes (path: the rollouts' flows; smooth: a shift plus "
           "a slow wave; random: +-200 px):")
    for name, m in medians.items():
        cs.log(f"  {name}: " + "; ".join(f"{key} {v:.4f}" for key, v in m.items()))
    cs.log(smi)
    print(json.dumps({"card": smi, "passes": 2 * args.rounds, "median_ms": medians}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
