#!/usr/bin/env python3
"""Time versions of the warp kernels side by side on one CUDA card.

    python3 warp_ab.py NAME=path/to/warp.cu[@tiled|@small] [NAME=...] [--rounds 3]
        [--cells CELL,CELL,...]

Each source is a version of fastvideocodec_torch/ops/kernels/csrc/warp.cu
with its C interface (``fvc_flow_warp``, ``fvc_flow_warp_s2d``,
``fvc_pixel_warp``, ``fvc_pixel_warp_s2d``); all are built at once with
the repository's nvcc flags, and ptxas's report of their kernels is
printed. A version whose library has pixel_warp's small-frame plan
(``fvc_pixel_warp_small``) takes, by default, the plan that
ops/kernels/warp.py:pixel_warp_plan picks from that version's own
constants; ``@tiled`` or ``@small`` after the path pins one plan for every
pixel_warp launch (so one source can be timed in both plans). An older
version has the tiled plan alone.

The kernels are timed on the inputs the rollouts give them (bfloat16,
GOP 16, seeded or shipped weights as chip_smoke.py drives them), in cells:

- ``lsvc-tpu spynet`` and ``lsvc-tpu mc``: flow_warp's 4 and flow_warp_s2d's
  4 launches of one LSVC-TPU rollout (hd_lsvctpuf2_l2) at 1024x2048;
- ``ssf-tpu stack`` and ``ssf-tpu level0``: pixel_warp's and
  pixel_warp_s2d_sflow's 15 of one SSF-TPU rollout (seeded_flat) at
  1024x2048;
- ``dvc spynet HxW`` (the four SpyNet levels, 128x256 to 1024x2048) and
  ``dvc mc``: the 75 flow_warp launches of one DVC rollout (seeded_flat,
  the pretrained SpyNet) at 1024x2048, 15 a cell;
- ``lsvc-128 spynet``, ``lsvc-128 mc``: LSVC-128's 4 + 4 (hd_lsvc128_l2);
  ``lsvc-tpu-rw mc``: LSVC-TPU-RW's 4 rigid MC warps at C = 12
  (hd_lsvctpu_l2);
- ``ssf-official volume``: SSF-Official's 15 pixel_warp at 1 x 18 x
  1024x2048 (seeded_flat, sp_stage 2);
- ``mcvc 4x256x256`` and ``mcvc 4x1024x2048``: MCVC-IA's 15 pixel_warp at
  C = 18 on 4 views (seeded_flat), the synth_mv_gop views of 256x256 and
  the row-offset views of the 2048x2048 clip, every view alive;
- ``ssf-tpu stack 256x256`` and ``ssf-official volume 256x256``: the
  pixel_warp forwards of the SSF and ELFVC training steps at 256x256
  (SSF-TPU's and ELFVC-SP-TPU's 1 x 15 x 128x128 stack, ELFVC-SP's 1 x 18
  x 256x256 volume), from one rollout of SSF-TPU and of SSF-Official
  (seeded_flat) on the top-left 256x256 of the clip.

Beside the path's flows, each cell runs on smooth flows of the same
shapes (a shift plus a slow wave: a trained codec's) and on +-200 px
random ones, drawn once from a seed. Every version must equal the plain
version bit for bit on all of them. Then each round times the versions in
order and in reverse order (A B C, C B A); a version's time of a cell is
the sum over its launches, warm (chip_smoke.py's ``cuda_ms``), with the
L2 flushed before each launch (``cold_ms``) and, on the path's flows, the
device time under torch.profiler (``device_ms``: the host's calls left
out, which set the warm time of a small frame). It prints every pass,
the median over the passes, each version's path medians against the
first version's, the card's name and power limit, and a JSON line of the
medians. Comparing versions within one run keeps the card, its power
limit and the host the same.
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

CELLS = ("lsvc-tpu spynet", "lsvc-tpu mc", "ssf-tpu stack", "ssf-tpu level0",
         "dvc spynet 128x256", "dvc spynet 256x512", "dvc spynet 512x1024",
         "dvc spynet 1024x2048", "dvc mc", "lsvc-128 spynet", "lsvc-128 mc", "lsvc-tpu-rw mc",
         "ssf-official volume", "mcvc 4x256x256", "mcvc 4x1024x2048", "ssf-tpu stack 256x256",
         "ssf-official volume 256x256")
FLOWS = ("path", "smooth", "random")
CLOCKS = ("warm", "cold")  # every flow; the path's flows also "device"
NCHW = ("flow_warp", "pixel_warp")  # F.grid_sample computes these two
TRAIN = 256  # the training steps' frame size


def open_version(path):
    """A built version's library, with the C entry points this script calls
    declared: the forwards', and fvc_pixel_warp_small where the version has
    it (build.open_library declares the current source's alone)."""
    import ctypes

    lib = ctypes.CDLL(str(path))
    ptrs_shape = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4  # img, flow, out, B, C, H, W
    grid = [*ptrs_shape, ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    pixel = [*ptrs_shape, ctypes.c_int, ctypes.c_void_p]  # dtype, stream
    for name, args in (("fvc_flow_warp", grid), ("fvc_flow_warp_s2d", grid),
                       ("fvc_pixel_warp", pixel), ("fvc_pixel_warp_small", pixel),
                       ("fvc_pixel_warp_s2d", [*ptrs_shape, ctypes.c_int, *pixel[-2:]])):
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes, fn.restype = args, ctypes.c_int
    return lib


def capture_cells(torch, np, wanted) -> dict:
    """label -> (kernel, [(img, flow), ...]) of each wanted cell, from one
    rollout of each model that feeds one (see the module's docstring)."""
    from fastvideocodec_torch import get_codec_model, load_asset, rollout
    from fastvideocodec_torch.data.synthetic import row_views, synth_gop_multi, synth_mv_gop
    from fastvideocodec_torch.layers.spynet import load_pretrained_spynet
    from fastvideocodec_torch.weights import load_flat, seeded_flat

    H, W, GOP = cs.H, cs.W, cs.GOP
    clip = synth_gop_multi(np.random.default_rng(0), size=max(H, W), gop=GOP)
    gop = torch.from_numpy(np.ascontiguousarray(clip[:, :H, :W])).permute(0, 3, 1, 2)
    gop = gop.to("cuda", torch.bfloat16).contiguous()

    def warps(name, weights, frames, mask=None, **kw):
        spec = get_codec_model(name, dtype=torch.bfloat16, device="cuda", **kw)
        if weights == "seeded":
            load_flat(spec.module, seeded_flat(name, 0))
        else:
            load_asset(spec.module, weights)
        if name == "DVC":
            load_pretrained_spynet(spec.module.optic_flow)
        captured = {}
        with cs.capture_warp_inputs(captured):
            if mask is None:
                rollout(spec, frames)
            else:
                rollout(spec, frames, mask)
        return captured

    def views(frames):  # numpy [T, V, h, w, 3] -> [T, V, 3, h, w] bf16 on the card
        frames = torch.from_numpy(np.ascontiguousarray(frames.transpose(0, 1, 4, 2, 3)))
        return frames.to("cuda", torch.bfloat16).contiguous()

    cells = {}
    if {"lsvc-tpu spynet", "lsvc-tpu mc"} & wanted:
        c = warps("LSVC-TPU", "hd_lsvctpuf2_l2", gop)
        cells["lsvc-tpu spynet"] = ("flow_warp", c["flow_warp"])
        cells["lsvc-tpu mc"] = ("flow_warp_s2d", c["flow_warp_s2d"])
    if {"ssf-tpu stack", "ssf-tpu level0"} & wanted:
        c = warps("SSF-TPU", "seeded", gop)
        cells["ssf-tpu stack"] = ("pixel_warp", c["pixel_warp"])
        cells["ssf-tpu level0"] = ("pixel_warp_s2d_sflow", c["pixel_warp_s2d_sflow"])
    if any(label.startswith("dvc") for label in wanted):
        fw = warps("DVC", "seeded", gop)["flow_warp"]
        cs.require(len(fw) == 5 * (GOP - 1), f"DVC captured {len(fw)} warps")
        # each P-frame warps 4 SpyNet levels, coarsest first, then the MC warp
        for k in range(4):
            cells[f"dvc spynet {H >> (3 - k)}x{W >> (3 - k)}"] = ("flow_warp", fw[k::5])
        cells["dvc mc"] = ("flow_warp", fw[4::5])
    if {"lsvc-128 spynet", "lsvc-128 mc"} & wanted:
        fw = warps("LSVC-128", "hd_lsvc128_l2", gop)["flow_warp"]
        cells["lsvc-128 spynet"] = ("flow_warp", fw[:4])
        cells["lsvc-128 mc"] = ("flow_warp", fw[4:])
    if "lsvc-tpu-rw mc" in wanted:
        cells["lsvc-tpu-rw mc"] = ("flow_warp",
                                   warps("LSVC-TPU-RW", "hd_lsvctpu_l2", gop)["flow_warp"][-4:])
    if "ssf-official volume" in wanted:
        c = warps("SSF-Official", "seeded", gop, sp_stage=cs.ELFVC_SP_STAGE)
        cells["ssf-official volume"] = ("pixel_warp", c["pixel_warp"])
    alive = np.ones(cs.MCVC_VIEWS, np.float32)
    if "mcvc 4x256x256" in wanted:
        frames = views(synth_mv_gop(np.random.default_rng(0), views=cs.MCVC_VIEWS,
                                    size=cs.MCVC_SIZE, gop=GOP))
        c = warps("MCVC-IA", "seeded", frames, alive, num_views=cs.MCVC_VIEWS)
        cells["mcvc 4x256x256"] = ("pixel_warp", c["pixel_warp"])
    if "mcvc 4x1024x2048" in wanted:
        frames = views(row_views(clip[:, :, :W], cs.MCVC_VIEWS, H))
        c = warps("MCVC-IA", "seeded", frames, alive, num_views=cs.MCVC_VIEWS)
        cells["mcvc 4x1024x2048"] = ("pixel_warp", c["pixel_warp"])
    crop = gop[:, :, :TRAIN, :TRAIN].contiguous()
    if f"ssf-tpu stack {TRAIN}x{TRAIN}" in wanted:
        cells[f"ssf-tpu stack {TRAIN}x{TRAIN}"] = ("pixel_warp",
                                                   warps("SSF-TPU", "seeded", crop)["pixel_warp"])
    if f"ssf-official volume {TRAIN}x{TRAIN}" in wanted:
        c = warps("SSF-Official", "seeded", crop, sp_stage=cs.ELFVC_SP_STAGE)
        cells[f"ssf-official volume {TRAIN}x{TRAIN}"] = ("pixel_warp", c["pixel_warp"])
    return {label: cells[label] for label in CELLS if label in wanted}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("versions", nargs="+", help="NAME=path[@tiled|@small] of a version of warp.cu")
    ap.add_argument("--rounds", type=int, default=3, help="rounds of two passes each")
    ap.add_argument("--cells", default=",".join(CELLS), help="comma-separated cells to time")
    ap.add_argument("--references", action="store_true",
                    help="also time F.grid_sample (prepared grids, the NCHW cells) and a copy "
                         "of the image (img.clone(), every cell) beside the versions")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("warp_ab: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, str(cs.ROOT))
    import numpy as np

    from fastvideocodec_torch.ops.kernels import build
    from fastvideocodec_torch.ops.kernels import warp as kw
    from fastvideocodec_torch.ops.warp import PLAIN, grid_norm

    wanted = set(args.cells.split(","))
    cs.require(wanted <= set(CELLS), f"unknown cells {sorted(wanted - set(CELLS))}")
    sources, pins = {}, {}
    for v in args.versions:
        name, sep, spec = v.partition("=")
        path, _, pin = spec.partition("@")
        cs.require(bool(sep and name) and Path(path).is_file() and pin in ("", "tiled", "small"),
                   f"want NAME=path[@tiled|@small], got {v!r}")
        sources[name], pins[name] = Path(path).resolve(), pin or None
    unique = sorted(set(sources.values()))
    with ThreadPoolExecutor(len(unique)) as pool:
        built = dict(zip(unique, pool.map(build.build, unique)))
    libs = {name: open_version(built[source]) for name, source in sources.items()}
    for source in unique:
        for entry, report in cs.ptxas_report(build.build_log(source), "warp"):
            cs.log(f"{source.name} ptxas {entry}: {report}")

    dtypes = {torch.float32: 0, torch.bfloat16: 1}

    s2d_entry = {"flow_warp_s2d": "fvc_flow_warp_s2d",
                 "pixel_warp_s2d_sflow": "fvc_pixel_warp_s2d"}

    def launcher(name, kernel):
        lib, pin = libs[name], pins[name]
        planned = hasattr(lib, "fvc_pixel_warp_small")
        cs.require(planned or pin != "small", f"{name}: its library has no small-frame plan")
        consts = kw.tile_constants(sources[name]) if planned else None
        entries = {}  # by image shape: the host's cost the same for every version

        def plan_of(shape):
            if kernel != "pixel_warp":
                return "one"
            return pin or (kw.pixel_warp_plan(*shape, constants=consts) if planned else "tiled")

        def entry(shape):
            if shape not in entries:
                symbol = {"flow_warp": "fvc_flow_warp", "flow_warp_s2d": "fvc_flow_warp_s2d",
                          "pixel_warp_s2d_sflow": "fvc_pixel_warp_s2d"}.get(kernel)
                entries[shape] = getattr(lib, symbol or kw.PIXEL_ENTRIES[plan_of(shape)])
            return entries[shape]

        def launch(img, flow):
            out = torch.empty_like(img)
            B, C, h, w = img.shape
            fh, fw = flow.shape[2:]
            ptrs = (img.data_ptr(), flow.data_ptr(), out.data_ptr())
            dtype, stream = dtypes[img.dtype], torch.cuda.current_stream().cuda_stream
            fn = entry(img.shape)
            if kernel == "flow_warp":
                rc = fn(*ptrs, B, C, h, w, grid_norm(fw), grid_norm(fh), dtype, stream)
            elif kernel == "flow_warp_s2d":
                rc = fn(*ptrs, B, C // 4, h, w, grid_norm(fw), grid_norm(fh), dtype, stream)
            elif kernel == "pixel_warp":
                rc = fn(*ptrs, B, C, h, w, dtype, stream)
            else:  # pixel_warp_s2d_sflow: the c-major phase flow
                rc = fn(*ptrs, B, C // 4, h, w, 1, dtype, stream)
            cs.require(rc == 0, f"{name} {kernel} launch failed: cudaError {rc}")
            return out

        launch.plans = lambda pairs: sorted({plan_of(img.shape) for img, _ in pairs})
        return launch

    cells = capture_cells(torch, np, wanted)
    launches = {name: {label: launcher(name, kernel) for label, (kernel, _) in cells.items()}
                for name in libs}
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = {label: {"path": pairs,
                     "smooth": [(img, cs.flow_like(torch, gen, cs.smooth_flow, flow))
                                for img, flow in pairs],
                     "random": [cs.warp_inputs(torch, gen, img.shape, flow.shape, img.dtype,
                                               flow.dtype)
                                for img, flow in pairs]}
             for label, (_, pairs) in cells.items()}

    for label, (kernel, pairs) in cells.items():
        shapes = sorted({tuple(img.shape) for img, _ in pairs})
        plans = {name: launches[name][label].plans(pairs) for name in libs}
        cs.log(f"cell {label}: {kernel}, {len(pairs)} launches of {shapes}; plans {plans}")
        for flows, fpairs in cases[label].items():
            for img, flow in fpairs:
                want = PLAIN[kernel](img, flow)
                for name in libs:
                    got = launches[name][label](img, flow)
                    cs.require(torch.equal(got, want), f"{name} {label} {flows} "
                               f"{tuple(img.shape)}: "
                               f"{(got.float() - want.float()).abs().max().item()}")
    cs.log(f"every version equals the plain versions bit for bit on {len(cells)} cells x "
           f"{len(FLOWS)} flows")

    order = list(libs)
    if args.references:  # timed like the versions, not held to the plain versions
        import torch.nn.functional as F

        from fastvideocodec_torch.ops.warp import _linspace

        def grid_of(kernel, img, flow):
            """The normalized grid of F.grid_sample: chip_smoke.py's
            sample_grid (flow_warp) and pixel_grid (pixel_warp)."""
            _, _, h, w = flow.shape
            if kernel == "flow_warp":
                xs = _linspace(w, flow.device)[None, None, :] + flow[:, 0].float() * grid_norm(w)
                ys = _linspace(h, flow.device)[None, :, None] + flow[:, 1].float() * grid_norm(h)
                return torch.stack([xs, ys], dim=-1).to(flow.dtype)
            xs = torch.arange(w, device=flow.device, dtype=torch.float32) + flow[:, 0]
            ys = torch.arange(h, device=flow.device, dtype=torch.float32)[:, None] + flow[:, 1]
            return torch.stack([(2 * xs + 1) / w - 1, (2 * ys + 1) / h - 1], -1).to(img.dtype)

        grids = {id(flow): grid_of(cells[label][0], img, flow)
                 for label in cells if cells[label][0] in NCHW
                 for pairs in cases[label].values() for img, flow in pairs}

        def grid_sample(img, flow):
            return F.grid_sample(img, grids[id(flow)], mode="bilinear", padding_mode="border",
                                 align_corners=False)

        launches["F.grid_sample"] = {label: grid_sample for label in cells
                                     if cells[label][0] in NCHW}
        launches["copy"] = {label: lambda img, flow: img.clone() for label in cells}
        order += ["F.grid_sample", "copy"]

    flush = torch.empty(cs.FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    times = {name: {**{(c, f, k): [] for c in launches[name] for f in FLOWS for k in CLOCKS},
                    **{(c, "path", "device"): [] for c in launches[name]}}
             for name in order}
    for rnd in range(args.rounds):
        for names in (order, order[::-1]):
            for name in names:
                for label in launches[name]:
                    launch = launches[name][label]
                    for f in FLOWS:
                        pairs = cases[label][f]
                        warm = sum(cs.cuda_ms(torch, launch, i, fl) for i, fl in pairs)
                        cold = sum(cs.cold_ms(torch, launch, i, fl, flush=flush)
                                   for i, fl in pairs)
                        times[name][label, f, "warm"].append(warm)
                        times[name][label, f, "cold"].append(cold)
                        cs.log(f"round {rnd} {name} {label} {f}: warm {warm} cold {cold} ms/GOP")
                    device, _ = cs.device_ms(torch, launch, cases[label]["path"])
                    times[name][label, "path", "device"].append(
                        float("nan") if device is None else device)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    ).stdout.strip().splitlines()[0]
    medians = {name: {f"{c} {f} {k}": statistics.median(v) for (c, f, k), v in t.items()}
               for name, t in times.items()}
    cs.log("median ms/GOP over the passes (path: the rollouts' flows; smooth: a shift plus "
           "a slow wave; random: +-200 px):")
    for name, m in medians.items():
        cs.log(f"  {name}: " + "; ".join(f"{key} {v:.4f}" for key, v in m.items()))
    first = order[0]
    clocks = ("warm", "cold", "device")
    cs.log(f"path flows, each version's median and its ratio to {first}'s (warm / L2 flushed "
           f"/ device time under the profiler):")
    for label in cells:
        row = "; ".join(name + " " + " / ".join(
            f"{medians[name][f'{label} path {k}']:.4f} "
            f"({medians[name][f'{label} path {k}'] / medians[first][f'{label} path {k}']:.3f})"
            for k in clocks) for name in order if label in launches[name])
        cs.log(f"  {label}: {row}")
    cs.log(smi)
    print(json.dumps({"card": smi, "passes": 2 * args.rounds, "median_ms": medians}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
