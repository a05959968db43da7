#!/usr/bin/env python3
"""Time versions of the two tiled warp kernels side by side on one CUDA card.

    python3 warp_ab.py NAME=path/to/warp.cu [NAME=path/to/warp.cu ...] [--rounds 3]

Each source is a version of fastvideocodec_torch/ops/kernels/csrc/warp.cu
with its C interface (``fvc_flow_warp``, ``fvc_flow_warp_s2d``); all are
built at once with the repository's nvcc flags, and ptxas's report of
their tiled kernels is printed. The inputs of the two kernels are those of
the main path, from one LSVC-TPU rollout (bfloat16, 1024x2048, GOP 16,
weights hd_lsvctpuf2_l2, the synth_gop_multi clip that chip_smoke.py
drives), and +-200 px random flows of the same shapes drawn once from a
seed. Every version must equal the plain version bit for bit on all of
them. Then each round times the versions in order and in reverse order
(A B C, C B A); a version's time of a kernel is the sum over one GOP's
launches, warm (chip_smoke.py's ``cuda_ms``) and with the L2 flushed
before each launch (``cold_ms``), on the path's flows and on the random
ones. It prints every pass, the median over the passes, the card's name
and power limit, and a JSON line of the medians. Comparing versions
within one run keeps the card, its power limit and the host the same.
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

KERNELS = ("flow_warp", "flow_warp_s2d")
FLOWS = ("path", "random")
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
    from fastvideocodec_torch.ops.warp import grid_norm, plain_flow_warp, plain_flow_warp_s2d

    sources = {}
    for v in args.versions:
        name, sep, path = v.partition("=")
        cs.require(bool(sep and name) and Path(path).is_file(), f"want NAME=path, got {v!r}")
        sources[name] = Path(path).resolve()
    with ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(build.build, sources.values())))
    libs = {name: build.open_library(path) for name, path in built.items()}
    for name, source in sources.items():
        for entry, report in cs.ptxas_report(build.build_log(source), "flow_warp"):
            cs.log(f"{name} ptxas {entry}: {report}")

    dtypes = {torch.float32: 0, torch.bfloat16: 1}

    def launcher(lib, kernel):
        s2d = kernel == "flow_warp_s2d"
        fn = lib.fvc_flow_warp_s2d if s2d else lib.fvc_flow_warp

        def launch(img, flow):
            out = torch.empty_like(img)
            B, C, h, w = img.shape
            fh, fw = flow.shape[2:]
            rc = fn(img.data_ptr(), flow.data_ptr(), out.data_ptr(), B, C // 4 if s2d else C,
                    h, w, grid_norm(fw), grid_norm(fh), dtypes[img.dtype],
                    torch.cuda.current_stream().cuda_stream)
            cs.require(rc == 0, f"{kernel} launch failed: cudaError {rc}")
            return out
        return launch

    launches = {name: {k: launcher(lib, k) for k in KERNELS} for name, lib in libs.items()}

    spec = get_codec_model("LSVC-TPU", dtype=torch.bfloat16, device="cuda")
    load_asset(spec.module, "hd_lsvctpuf2_l2")
    clip = synth_gop_multi(np.random.default_rng(0), size=max(cs.H, cs.W), gop=cs.GOP)
    gop = torch.from_numpy(np.ascontiguousarray(clip[:, :cs.H, :cs.W])).permute(0, 3, 1, 2)
    captured = {}
    with cs.capture_warp_inputs(captured):
        rollout(spec, gop.to("cuda", torch.bfloat16).contiguous())
    del spec, gop, clip
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = {k: {"path": captured[k],
                 "random": [cs.warp_inputs(torch, gen, img.shape, flow.shape, img.dtype)
                            for img, flow in captured[k]]}
             for k in KERNELS}
    cs.require([len(cases[k]["path"]) for k in KERNELS] == [4, 4], "captured launches")

    plains = {"flow_warp": plain_flow_warp, "flow_warp_s2d": plain_flow_warp_s2d}
    for k in KERNELS:
        for flows, pairs in cases[k].items():
            for img, flow in pairs:
                want = plains[k](img, flow)
                for name in libs:
                    got = launches[name][k](img, flow)
                    cs.require(torch.equal(got, want), f"{name} {k} {flows} {tuple(img.shape)}: "
                               f"{(got.float() - want.float()).abs().max().item()}")
    cs.log(f"every version equals the plain versions bit for bit on {len(KERNELS)} kernels "
           f"x {len(FLOWS)} flows x 4 launches")

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
    cs.log("median ms/GOP over the passes (path: the main path's flows; random: +-200 px):")
    for name, m in medians.items():
        cs.log(f"  {name}: " + "; ".join(f"{key} {v:.4f}" for key, v in m.items()))
    cs.log(smi)
    print(json.dumps({"card": smi, "passes": 2 * args.rounds, "median_ms": medians}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
