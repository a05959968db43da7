"""The host's cost of one warp launch, piece by piece, on one CUDA card.

    python -m fastvideocodec_torch.tools.launch_cost [--calls 4000] [--json PATH]
        [--parent PATH [--rounds 5]]

On DVC's coarsest SpyNet level (1 x 3 x 128x256, bfloat16, a +-8 px flow),
where the card's work is a few microseconds and the host's call sets the
warm time, the host clock times over ``--calls`` calls each piece of
``ops.warp.flow_warp`` (the dispatcher) and of the launcher under it
(``ops.kernels.warp.launch_flow_warp``): the checks, the shape's cached
arguments, the output's allocation, the device and stream queries, the
library call (which enqueues the kernel) and the count; beside them the
whole launcher, the whole dispatcher and ``F.grid_sample``'s call on the
same inputs (its grid built beforehand). The card is synchronised before
each piece's loop and after it; every number is microseconds a call. It
prints a line a piece, the card's name and power limit, the host's
architecture and cores, and a JSON line of the pieces; ``chip_smoke.py``
calls ``pieces`` in its DVC timing phase.

``--parent`` names another version of ``ops/kernels/warp.py`` (e.g. the
parent commit's, from ``git show``), loaded as a module of its own over
this package's library: its ``launch_flow_warp`` and this one's are then
timed in turns, ``--rounds`` times each (this, parent, parent, this, ...),
on the same inputs and the same C entry point, and the medians printed.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import platform
import statistics
import subprocess
import sys
import time


def _inputs(torch):
    """DVC's coarsest SpyNet level: img [1, 3, 128, 256] and a +-8 px flow,
    bfloat16, on the first card."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = (1, 3, 128, 256)
    img = torch.rand(shape, generator=gen, device="cuda").to(torch.bfloat16)
    flow = ((torch.rand((1, 2, *shape[2:]), generator=gen, device="cuda") - 0.5) * 16.0).to(
        torch.bfloat16)
    return img, flow


def _per_call_us(torch, fn, calls: int) -> float:
    """Host microseconds a call of fn() over ``calls`` calls, after 100 to
    warm up, the card synchronised before and after."""
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t * 1e6 / calls


def pieces(torch, calls: int = 4000) -> dict:
    """Microseconds a call of each piece of one flow_warp launch (see the
    module's docstring), on this process's first card."""
    import torch.nn.functional as F

    from fastvideocodec_torch.ops import warp as ow
    from fastvideocodec_torch.ops.kernels import build
    from fastvideocodec_torch.ops.kernels import warp as kw

    img, flow = _inputs(torch)
    B, C, H, W = img.shape
    xs = ow._linspace(W, img.device)[None, None, :] + flow[:, 0].float() * kw.grid_norm(W)
    ys = ow._linspace(H, img.device)[None, :, None] + flow[:, 1].float() * kw.grid_norm(H)
    grid = torch.stack([xs, ys], dim=-1).to(img.dtype)
    lib = build.load()
    entry = lib.fvc_flow_warp
    shape_args = kw._flow_args(B, C, H, W)
    current, stream = kw._cuda_calls()
    index = img.get_device()
    out = torch.empty_like(img)
    ptrs = (img.data_ptr(), flow.data_ptr(), out.data_ptr())
    dtype, raw = 1, stream(index)
    refused = (0, *shape_args[1:])  # B = 0: the entry point returns before launching

    steps = {
        "dispatcher ops.warp.flow_warp (whole)": lambda: ow.flow_warp(img, flow),
        "launcher launch_flow_warp (whole)": lambda: kw.launch_flow_warp(img, flow),
        "_check": lambda: kw._check(img, flow, (B, 2, H, W)),
        "shape arguments (_flow_args, cached)": lambda: kw._flow_args(B, C, H, W),
        "build.load() and the entry point": lambda: build.load().fvc_flow_warp,
        "torch.empty_like": lambda: torch.empty_like(img),
        "data_ptr() x 3": lambda: (img.data_ptr(), flow.data_ptr(), out.data_ptr()),
        "device index (get_device, current)": lambda: img.get_device() == current(),
        "raw current stream": lambda: stream(index),
        "library call (enqueues the kernel)": lambda: entry(*ptrs, *shape_args, dtype, raw),
        "library call refused (B = 0: the ctypes call alone)": lambda: entry(
            *ptrs, *refused, dtype, raw),
        "launch count": lambda: kw.LAUNCHES.__setitem__("flow_warp",
                                                        kw.LAUNCHES["flow_warp"] + 1),
        "dispatcher's tests (is_cpu, requires_grad)": lambda: (
            (img.is_cpu and flow.is_cpu) or img.requires_grad or flow.requires_grad),
        "F.grid_sample (grid prepared)": lambda: F.grid_sample(
            img, grid, mode="bilinear", padding_mode="border", align_corners=False),
    }
    return {what: _per_call_us(torch, fn, calls) for what, fn in steps.items()}


def against_parent(torch, parent_path: str, calls: int, rounds: int) -> dict:
    """Microseconds a call of this package's launch_flow_warp and of the one
    in the file ``parent_path`` (another version of ops/kernels/warp.py,
    loaded as a module of its own; it loads this package's library), timed
    in turns on the same inputs: {"change": [...], "parent": [...]}, one
    entry a turn."""
    from fastvideocodec_torch.ops.kernels import warp as kw

    spec = importlib.util.spec_from_file_location("parent_kernel_launchers", parent_path)
    parent = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(parent)
    img, flow = _inputs(torch)
    torch.testing.assert_close(parent.launch_flow_warp(img, flow), kw.launch_flow_warp(img, flow),
                               rtol=0, atol=0)
    fns = {"change": lambda: kw.launch_flow_warp(img, flow),
           "parent": lambda: parent.launch_flow_warp(img, flow)}
    times = {name: [] for name in fns}
    for r in range(rounds):
        for name in (("change", "parent") if r % 2 == 0 else ("parent", "change")):
            times[name].append(_per_call_us(torch, fns[name], calls))
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=4000, help="calls timed per piece")
    ap.add_argument("--json", help="also write the pieces to this file")
    ap.add_argument("--parent", help="another version of ops/kernels/warp.py whose "
                                     "launch_flow_warp to time in turns with this one's")
    ap.add_argument("--rounds", type=int, default=5, help="turns of each launcher (--parent)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("launch_cost: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    costs = pieces(torch, args.calls)
    for what, us in costs.items():
        print(f"{what}: {us:.3f} us a call", flush=True)
    turns = against_parent(torch, args.parent, args.calls, args.rounds) if args.parent else None
    for name, us in (turns or {}).items():
        print(f"launch_flow_warp, {name}: median {statistics.median(us):.3f} us a call over "
              f"{len(us)} turns ({', '.join(f'{u:.3f}' for u in us)})", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}; host: {platform.machine()}, {os.cpu_count()} logical cores; "
          f"torch {torch.__version__}", flush=True)
    line = json.dumps({"card": smi, "calls": args.calls, "host_us": costs,
                       "launcher_turns_us": turns})
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
