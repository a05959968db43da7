"""Warp kernel micro-bench on the card: the port's copy of the JAX
package's root ``tools/warp_bench.py``.

    python -m fastvideocodec_torch.tools.warp_bench [CASE_SUBSTRING]

JAX's four ``CASES``, through the port's kernels (``ops/kernels/warp.py``):
full-resolution RGB (SpyNet's level warp, ``flow_warp``), LSVC-TPU's s2d
MC shape (``flow_warp`` on 15 x 12 x 512x1024), SSF's volume in pixel
mode (``pixel_warp`` at C = 18), and the RGB case in float32. Each case
prints its warm ms (CUDA events over REPS launches), its L2-flushed
ms (one launch after a 256 MB write) and its byte bound (each input read
once, the output written once, over the HBM rate: ``timing.bound_ms``).
``bench_null`` is the floor: an empty kernel launched on the null case's
grid (``launch_backward_floor``), warm and flushed.

The displacement bound R of JAX's cases was a limit of the TPU kernel:
the port's warps are exact, so the flows here span the same +-R/2 pixels
but nothing bounds them. JAX's ``bench_formatting`` times the TPU
kernel's tile relayouts around the Pallas call; the CUDA kernels read
NCHW in place, with no formatting copy, so it has no counterpart.
"""

from __future__ import annotations

import argparse
import json

import torch

from fastvideocodec_torch.ops.kernels import warp as kw
from fastvideocodec_torch.tools.timing import FLUSH_BYTES, bound_ms, cold_ms, cuda_ms

# (name, B, H, W, C, R, pixel_mode, dtype): JAX's CASES; R sets the flows'
# span (uniform in +-R/2 pixels), not a bound
CASES = [
    ("rgb_1080p_R56", 4, 1024, 2048, 3, 56, False, torch.bfloat16),
    ("s2d_lsvctpu_R28", 15, 512, 1024, 12, 28, False, torch.bfloat16),
    ("ssf_vol_R8", 4, 1024, 2048, 18, 8, True, torch.bfloat16),
    ("rgb_1080p_R56_f32", 4, 1024, 2048, 3, 56, False, torch.float32),
]


def inputs(B, H, W, C, R, pixel_mode, dtype, device="cuda", seed=0):
    """The case's image [B, C, H, W] in [0, 1) and flow [B, 2, H, W] in
    pixels, uniform in +-R/2 (float32 for the pixel warp, as its callers
    pass it; the image's dtype for flow_warp)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    img = torch.rand((B, C, H, W), generator=gen, device=device).to(dtype)
    flow = (torch.rand((B, 2, H, W), generator=gen, device=device) - 0.5) * R
    return img, flow if pixel_mode else flow.to(dtype)


REPS = 20


def bench(name, B, H, W, C, R, pixel_mode, dtype, flush) -> dict:
    img, flow = inputs(B, H, W, C, R, pixel_mode, dtype)
    launch = kw.launch_pixel_warp if pixel_mode else kw.launch_flow_warp
    return {"case": name, "kernel": "pixel_warp" if pixel_mode else "flow_warp",
            "ms": cuda_ms(torch, launch, img, flow, iters=REPS),
            "cold_ms": cold_ms(torch, launch, img, flow, flush=flush),
            "bound_ms": bound_ms(img, flow)}


def bench_null(flush) -> dict:
    """The floor: an empty kernel on the grid of the null case's image (4 x
    3 x 1024x2048 bf16)."""
    img = torch.zeros((4, 3, 1024, 2048), dtype=torch.bfloat16, device="cuda")
    floor = lambda x: kw.launch_backward_floor("flow_warp", x)  # noqa: E731
    return {"case": "null_floor", "kernel": "empty",
            "ms": cuda_ms(torch, floor, img, iters=REPS),
            "cold_ms": cold_ms(torch, floor, img, flush=flush), "bound_ms": 0.0}


def run(only: str = "", out=print) -> list:
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    rows = [bench_null(flush)]
    for case in CASES:
        if only and only not in case[0]:
            continue
        rows.append(bench(*case, flush=flush))
    for row in rows:
        if out is not None:
            out(json.dumps(row))
    return rows


def main(argv=None) -> list:
    p = argparse.ArgumentParser("fvc-warp-bench")
    p.add_argument("only", nargs="?", default="", help="run the cases whose name holds this")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("warp_bench needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    return run(args.only)


if __name__ == "__main__":
    main()
