#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (fastvideocodec_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each timed on its own line:

1. device: the card's name and power limit, the host's CPU; TF32 off for
   cuDNN and matmul;
2. build: nvcc builds the warp kernels (ops/kernels/csrc/warp.cu); ptxas's
   report (registers, spills, shared memory) of the two tiled kernels;
3. kernels: each of the five kernels against its plain PyTorch version on
   the card, float32 and bfloat16 images (float32 flows for the pixel
   warps), at the shapes of the LSVC-TPU and SSF-TPU paths, with large and
   off-border displacements; the two tiled kernels (flow_warp,
   flow_warp_s2d) must equal their plain versions bit for bit, here and
   on ragged shapes with smooth flows (every tile of flow_warp_s2d staged
   in shared memory), +-200 px random flows (none) and flows smooth on one
   half and random on the other (both in one launch); then each kernel's
   gradient (its autograd Function) against autograd through its plain
   version;
4. card vs CPU: LSVC-TPU in float32 at 64x128, GOP 4, shipped weights, on
   the card (kernels) and on the CPU (plain versions); then bfloat16 on the
   card against that float32 result;
5. rollout: LSVC-TPU in bfloat16 at 1024x2048, GOP 16, weights
   hd_lsvctpuf2_l2, on a synth_gop_multi clip (seed 0): one run with the
   launch counts zeroed before it, then 3 runs timed with CUDA events,
   each beside its host enqueue time (host clock until the call returns,
   before the card is waited for): when the two are close, the host's
   launches bound the run;
6. decode graph: the receiver's graph at the same setup, same timing;
7. kernel timing: each LSVC kernel, its plain version and the nearest
   single PyTorch call (grid_sample), on the inputs the main path gives it
   in one GOP, beside the least time the card could take (the bytes the
   warp must move over 3.35 TB/s); the kernel also with the L2 cache
   flushed before each launch, and on random flows of the same shapes,
   its worst case; for flow_warp_s2d the share of tiles whose footprint
   fits the shared-memory budget (the host's copy of the kernel's rule,
   ops/warp.py:staged_tiles);
8. SSF card vs CPU: SSF-TPU-TINY in float32 at 64x128, GOP 4, shipped
   weights tiny_ssftpu_l2, card against CPU; then bfloat16 on the card
   against that float32 result;
9. SSF rollout: SSF-TPU at its full widths in bfloat16, 1024x2048, GOP 16
   (15 chained P-frames), numpy-seeded weights seeded_flat("SSF-TPU", 0),
   the same clip: one run with the launch counts zeroed, then 3 timed
   runs with their host enqueue times; its bpp and PSNR are printed, not
   gated (random weights);
10. SSF kernel timing: the three pixel warps as in phase 7, on the inputs
   the SSF rollout gives them (pixel_warp_s2d, which no codec calls, on
   the level-0 inputs with the phase flow unpacked to full resolution).

It then prints a JSON line of the kernels, the card's name and power limit,
and last the line ``{"ok": true, "device": {...}}``. Any failed phase
raises, so the run exits non-zero without that line. It needs no JAX and
nothing of the JAX package; it exits non-zero when no CUDA device is found.
"""

from __future__ import annotations

import contextlib
import json
import os
import platform
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
SSF_BF16_PSNR_DB = 0.11  # SSF-TPU-TINY bf16 card vs f32 CPU: max per-frame PSNR gap
SSF_BF16_BPP_REL = 0.095  # and relative bpp gap (an H100 measured 0.0222 dB, 0.019)
GOP, H, W = 16, 1024, 2048
SPYNET_SHAPES = [(64, 128), (128, 256), (256, 512), (512, 1024)]  # per GOP
TOL = {"float32": 1e-5, "bfloat16": 4e-3}  # kernel vs plain, max abs
TILED = ("flow_warp", "flow_warp_s2d")  # these must equal their plain versions exactly
# gradients through the Function vs autograd through the plain version: the
# image gradient is a scatter-add whose atomic order may change per run
GRAD_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-2)}  # rtol, atol x max |grad|
FLUSH_BYTES = 256 * 2**20  # written between launches: five times the 50 MB L2
KERNEL_SOURCE = "fastvideocodec_torch/ops/kernels/csrc/warp.cu"
REPLACES = {
    "flow_warp": "fastvideocodec_tpu/ops/pallas/warp_kernel.py:502",
    "flow_warp_s2d": "fastvideocodec_tpu/ops/pallas/warp_kernel.py:548",
    "pixel_warp": "fastvideocodec_tpu/ops/pallas/warp_kernel.py:577",
    "pixel_warp_s2d": "fastvideocodec_tpu/ops/pallas/warp_kernel.py:618",
    "pixel_warp_s2d_sflow": "fastvideocodec_tpu/ops/pallas/warp_kernel.py:673",
}
LSVC_KERNELS = ("flow_warp", "flow_warp_s2d")
SSF_KERNELS = ("pixel_warp", "pixel_warp_s2d", "pixel_warp_s2d_sflow")


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    log(f"== phase {name}")
    yield
    log(f"== phase {name}: {time.perf_counter() - t0:.3f} s")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke failed: {msg}")


def cuda_ms(torch, fn, *args, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of fn(*args) on the card, by CUDA events."""
    for _ in range(warmup):
        fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def tol_of(name: str, dname: str) -> float:
    return 0.0 if name in TILED else TOL[dname]


def cold_ms(torch, fn, *args, flush, reps: int = 5) -> float:
    """Mean milliseconds of one launch of fn(*args) on the card with the L2
    cache flushed first: a write of ``flush`` (FLUSH_BYTES) before each
    launch, the launch alone between two CUDA events. A spin of the card
    (torch.cuda._sleep, about 0.2 ms) after the flush lets the host enqueue
    the launch before the start event fires, so the events time the kernel
    and not the host's call."""
    fn(*args)
    total = 0.0
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush.zero_()
        torch.cuda._sleep(400_000)
        start.record()
        fn(*args)
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def ptxas_report(build_log: str, part: str) -> list:
    """(entry, "spills; registers and shared memory") from ptxas's -v report
    in build_log, for each kernel entry whose name holds ``part``."""
    lines = build_log.splitlines()
    return [(line.split("'")[1],
             f"{lines[i + 2].strip()}; {lines[i + 3].split(':', 1)[1].strip()}")
            for i, line in enumerate(lines)
            if "Compiling entry function" in line and part in line]


def bound_ms(img, flow) -> float:
    """Least milliseconds for one warp on the card: each input read once and
    the output written once (each tensor at its own element size), over the
    HBM rate. The arithmetic (about 40 float ops of coordinates per output
    pixel and 9 per channel) is far below the float32 rate, so bytes bound
    it."""
    nbytes = 2 * img.numel() * img.element_size() + flow.numel() * flow.element_size()
    pixels = flow.numel() // 2  # full-resolution output pixels, for every flow layout
    flops = pixels * (40 + 9 * img.numel() // pixels)
    require(flops / F32_FLOPS < nbytes / HBM_BYTES_PER_S, "warp bound by operations")
    return nbytes / HBM_BYTES_PER_S * 1e3


@contextlib.contextmanager
def capture_warp_inputs(captured: dict):
    """Record a clone of the inputs of every warp the models call, by kernel
    name (the attributes the LSVC and SSF paths look the dispatchers up by)."""
    from fastvideocodec_torch.layers import spynet
    from fastvideocodec_torch.models import lsvc
    from fastvideocodec_torch.ops import warp

    sites = [(spynet, "flow_warp", "flow_warp"),
             (lsvc, "flow_warp_fullres_s2d", "flow_warp_s2d"),
             (warp, "pixel_warp", "pixel_warp"),
             (warp, "pixel_warp_s2d_sflow", "pixel_warp_s2d_sflow")]

    def grab(name, fn):
        def wrapped(img, flow):
            captured.setdefault(name, []).append((img.clone(), flow.clone()))
            return fn(img, flow)
        return wrapped

    saved = [getattr(module, attr) for module, attr, _ in sites]
    for (module, attr, name), fn in zip(sites, saved):
        setattr(module, attr, grab(name, fn))
    try:
        yield
    finally:
        for (module, attr, _), fn in zip(sites, saved):
            setattr(module, attr, fn)


def host_cpu() -> str:
    """The host CPU's model name (from /proc/cpuinfo, else lscpu), its
    architecture and core count: host-bound times follow it."""
    lines = []
    with contextlib.suppress(OSError):
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    with contextlib.suppress(OSError, subprocess.SubprocessError):
        lines += subprocess.run(["lscpu"], capture_output=True, text=True,
                                timeout=10).stdout.splitlines()
    models = [ln.split(":", 1)[1].strip() for ln in lines
              if ln.lower().startswith("model name")]
    model = models[0] if models else "unknown"
    return f"{model} ({platform.machine()}), {os.cpu_count()} logical cores"


def warp_inputs(torch, gen, img_shape, flow_shape, dtype, flow_dtype=None):
    """Image in [0, 1) and a flow mixing small motion with displacements
    far past 56 px and samples far outside the frame; the flow in
    ``flow_dtype`` (default: the image's)."""
    img = torch.rand(img_shape, generator=gen, device="cuda")
    flow = torch.randn(flow_shape, generator=gen, device="cuda") * 8.0
    flow += (torch.rand(flow_shape, generator=gen, device="cuda") - 0.5) * 400.0
    return img.to(dtype).contiguous(), flow.to(flow_dtype or dtype).contiguous()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch.nn.functional as F

    from fastvideocodec_torch import build_lsvc_decode, get_codec_model, load_asset, rollout
    from fastvideocodec_torch.data.synthetic import synth_gop_multi
    from fastvideocodec_torch.ops.kernels import build
    from fastvideocodec_torch.ops.kernels import warp as kw
    from fastvideocodec_torch.ops import warp as ow
    from fastvideocodec_torch.ops.warp import (
        _linspace,
        depth_to_space,
        grid_norm,
        plain_flow_warp,
        plain_flow_warp_s2d,
        plain_pixel_warp,
        plain_pixel_warp_s2d,
        plain_pixel_warp_s2d_sflow,
        space_to_depth,
        staged_tiles,
    )
    from fastvideocodec_torch.weights import load_flat, seeded_flat

    def sample_grid(flow):
        """The normalized sampling grid of a flow, in the flow's dtype."""
        _, _, h, w = flow.shape
        xs = _linspace(w, flow.device)[None, None, :] + flow[:, 0].float() * grid_norm(w)
        ys = _linspace(h, flow.device)[None, :, None] + flow[:, 1].float() * grid_norm(h)
        return torch.stack([xs, ys], dim=-1).to(flow.dtype)

    def grid_sample(img, grid):
        return F.grid_sample(img, grid, mode="bilinear", padding_mode="border",
                             align_corners=False)

    def pixel_grid(flow):
        """The normalized sampling grid of a pixel flow: (2*(i + f) + 1)/n - 1."""
        _, _, h, w = flow.shape
        xs = torch.arange(w, device=flow.device, dtype=torch.float32) + flow[:, 0]
        ys = torch.arange(h, device=flow.device, dtype=torch.float32)[:, None] + flow[:, 1]
        return torch.stack([(2 * xs + 1) / w - 1, (2 * ys + 1) / h - 1], dim=-1)

    def full_res_flow(flow_s2d):
        """The c-major s2d phase flow [B, 8, h, w] at full resolution [B, 2, 2h, 2w]."""
        return torch.cat([depth_to_space(flow_s2d[:, 0:4]),
                          depth_to_space(flow_s2d[:, 4:8])], dim=1).contiguous()

    kernels = {
        "flow_warp": kw.launch_flow_warp,
        "flow_warp_s2d": kw.launch_flow_warp_s2d,
        "pixel_warp": kw.launch_pixel_warp,
        "pixel_warp_s2d": kw.launch_pixel_warp_s2d,
        "pixel_warp_s2d_sflow": kw.launch_pixel_warp_s2d_sflow,
    }
    plains = {
        "flow_warp": plain_flow_warp,
        "flow_warp_s2d": plain_flow_warp_s2d,
        "pixel_warp": plain_pixel_warp,
        "pixel_warp_s2d": plain_pixel_warp_s2d,
        "pixel_warp_s2d_sflow": plain_pixel_warp_s2d_sflow,
    }
    dispatchers = {
        "flow_warp": ow.flow_warp,
        "flow_warp_s2d": ow.flow_warp_fullres_s2d,
        "pixel_warp": ow.pixel_warp,
        "pixel_warp_s2d": ow.pixel_warp_s2d,
        "pixel_warp_s2d_sflow": ow.pixel_warp_s2d_sflow,
    }
    require(set(kernels) == set(kw.LAUNCHES) == set(REPLACES) == set(dispatchers),
            "kernel tables disagree")
    max_err = {k: 0.0 for k in kernels}
    zero_counts = {k: 0 for k in kernels}

    with phase("device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip().splitlines()[0]
        card_name = torch.cuda.get_device_name(0)
        log(f"card: {smi}")
        log(f"host: {host_cpu()}")
        log(f"torch {torch.__version__} cuda {torch.version.cuda} device {card_name} "
            f"count {torch.cuda.device_count()}")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    with phase("build"):
        build.load()
        log(f"nvcc seconds: {build.last_build_seconds} (None: library already built) "
            f"library {build.library_path().relative_to(ROOT)}")
        for entry, report in ptxas_report(build.build_log(), "flow_warp"):
            log(f"ptxas {entry}: {report}")

    def spynet_inputs(gen, dtype):
        return [warp_inputs(torch, gen, (15, 3, h, w), (15, 2, h, w), dtype)
                for h, w in SPYNET_SHAPES]

    def s2d_inputs(gen, n, dtype):
        return warp_inputs(torch, gen, (n, 12, H // 2, W // 2), (n, 2, H, W), dtype)

    def ssf_inputs(gen, dtype):
        """The SSF-TPU path's shapes, float32 flows: the half-res blurred
        stack (5 levels x 3 colours), the level-0 sample with its c-major
        phase flow, and that sample with a full-res flow."""
        f32 = torch.float32
        return [
            ("pixel_warp", *warp_inputs(torch, gen, (1, 15, H // 2, W // 2),
                                        (1, 2, H // 2, W // 2), dtype, f32)),
            ("pixel_warp_s2d_sflow", *warp_inputs(torch, gen, (1, 12, H // 2, W // 2),
                                                  (1, 8, H // 2, W // 2), dtype, f32)),
            ("pixel_warp_s2d", *warp_inputs(torch, gen, (1, 12, H // 2, W // 2),
                                            (1, 2, H, W), dtype, f32)),
        ]

    with phase("kernels vs plain"):
        gen = torch.Generator(device="cuda").manual_seed(0)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            cases = [("flow_warp", *io) for io in spynet_inputs(gen, dtype)]
            cases.append(("flow_warp_s2d", *s2d_inputs(gen, 8, dtype)))
            cases += ssf_inputs(gen, dtype)
            for name, img, flow in cases:
                got = kernels[name](img, flow)
                want = plains[name](img, flow)
                torch.cuda.synchronize()
                d = (got.float() - want.float()).abs()
                err, mean = d.max().item(), d.mean().item()
                tol = tol_of(name, dname)
                log(f"{name} {dname} img {tuple(img.shape)} flow {tuple(flow.shape)} "
                    f"{str(flow.dtype).split('.')[1]}: max abs {err:.3e} "
                    f"mean abs {mean:.3e} (tolerance {tol:.0e})")
                require(err <= tol, f"{name} {dname} disagrees with plain: {err}")
                max_err[name] = max(max_err[name], err)
                del got, want, d

    def smooth_flow(gen, shape):
        """A shift of up to 10 px plus a slow wave of 3 px: every tile's
        footprint fits its budget."""
        B, _, h, w = shape
        yy = torch.arange(h, device="cuda", dtype=torch.float32)[:, None]
        xx = torch.arange(w, device="cuda", dtype=torch.float32)[None, :]
        shift = (torch.rand(B, 2, 1, 1, generator=gen, device="cuda") - 0.5) * 20.0
        phase = torch.rand(B, 2, 1, 1, generator=gen, device="cuda") * 6.2832
        return shift + 3.0 * torch.sin(xx / 17.0 + phase) * torch.cos(yy / 13.0)

    def random_flow(gen, shape):
        return (torch.rand(shape, generator=gen, device="cuda") - 0.5) * 400.0

    def mixed_flow(gen, shape):
        """Smooth on the top half of the frame, +-200 px random on the bottom."""
        flow = smooth_flow(gen, shape)
        h = shape[2]
        flow[:, :, h // 2:] = random_flow(gen, flow[:, :, h // 2:].shape)
        return flow

    # full-res [B, C, H, W]: rows odd, even but off a multiple of 8, and on
    # it; tiles ragged at the bottom and right; the last holds whole tiles
    ragged = {"flow_warp": [(2, 3, 37, 141), (1, 3, 40, 268), (3, 3, 18, 34), (1, 3, 64, 512)],
              "flow_warp_s2d": [(2, 3, 38, 150), (1, 3, 40, 264), (3, 3, 18, 36),
                                (1, 3, 64, 512)]}
    flows = {"smooth": smooth_flow, "random": random_flow, "mixed": mixed_flow}
    with phase("tiled kernels: ragged shapes, smooth, random and mixed flows"):
        gen = torch.Generator(device="cuda").manual_seed(2)
        for name in TILED:
            for dtype in (torch.float32, torch.bfloat16):
                for pattern, make in flows.items():
                    for shape in ragged[name]:
                        img = torch.rand(shape, generator=gen, device="cuda")
                        if name == "flow_warp_s2d":
                            img = space_to_depth(img)
                        img = img.to(dtype).contiguous()
                        flow = make(gen, (shape[0], 2, *shape[2:])).to(dtype).contiguous()
                        got = kernels[name](img, flow)
                        want = plains[name](img, flow)
                        torch.cuda.synchronize()
                        err = (got.float() - want.float()).abs().max().item()
                        require(err == 0.0, f"{name} {dtype} {pattern} {shape}: max abs {err}")
                        max_err[name] = max(max_err[name], err)
                        if name != "flow_warp_s2d":  # the one kernel that stages
                            continue
                        staged, tiles = staged_tiles(img, flow)
                        if pattern == "smooth":
                            require(staged == tiles, f"{name} {pattern} {shape}: {staged}/{tiles}")
                        if shape == ragged[name][-1]:
                            want_share = {"smooth": 1.0, "random": 0.0, "mixed": 0.5}[pattern]
                            require(staged == want_share * tiles,
                                    f"{name} {pattern} {shape}: {staged}/{tiles} staged")
                    share = (f"; staged tiles of the last {staged}/{tiles}"
                             if name == "flow_warp_s2d" else "")
                    log(f"{name} {str(dtype).split('.')[1]} {pattern} flows on "
                        f"{len(ragged[name])} shapes: max abs 0 (tolerance 0){share}")

    grad_shapes = {"flow_warp": ((2, 3, 12, 20), (2, 2, 12, 20)),
                   "flow_warp_s2d": ((2, 12, 6, 10), (2, 2, 12, 20)),
                   "pixel_warp": ((2, 5, 12, 20), (2, 2, 12, 20)),
                   "pixel_warp_s2d": ((2, 12, 6, 10), (2, 2, 12, 20)),
                   "pixel_warp_s2d_sflow": ((2, 12, 6, 10), (2, 8, 6, 10))}
    # The image gradient is a scatter-add whose rounding follows the order of
    # its atomics: deterministic algorithms where PyTorch has them, and in
    # bf16 flows of a few pixels, so that no source pixel sums the hundreds
    # of samples that +-150 px flows pile onto the border (each sum a few
    # bf16 roundings, far inside the bar)
    torch.use_deterministic_algorithms(True, warn_only=True)
    with phase("gradients through the kernels"):
        gen = torch.Generator(device="cuda").manual_seed(3)
        for name, (img_shape, flow_shape) in grad_shapes.items():
            for dtype in (torch.float32, torch.bfloat16):
                dname = str(dtype).split(".")[1]
                spread = 300.0 if dtype == torch.float32 else 16.0
                img = torch.rand(img_shape, generator=gen, device="cuda").to(dtype)
                flow = (torch.randn(flow_shape, generator=gen, device="cuda") * 3.0
                        + (torch.rand(flow_shape, generator=gen, device="cuda") - 0.5) * spread)
                flow = flow.to(torch.float32 if name.startswith("pixel") else dtype)
                g = torch.randn(img_shape, generator=gen, device="cuda").to(dtype)
                res = {}
                for how, fn in (("kernel", dispatchers[name]), ("plain", plains[name])):
                    kw.reset_launches()
                    i = img.detach().requires_grad_()
                    f = flow.detach().requires_grad_()
                    (fn(i, f).float() * g.float()).sum().backward()
                    res[how] = (i.grad, f.grad, kw.LAUNCHES[name])
                torch.cuda.synchronize()
                (gi, gf, n), (pi, pf, _) = res["kernel"], res["plain"]
                require(n == 1, f"{name}: the forward launched its kernel {n} times")
                rtol, atol = GRAD_TOL[dname]
                errs = []
                for got, want in ((gi, pi), (gf, pf)):
                    require(got is not None and got.dtype == want.dtype, f"{name}: no gradient")
                    d = (got.float() - want.float()).abs()
                    scale = want.float().abs().max().item()
                    errs.append(d.max().item() / max(scale, 1e-30))
                    require(bool((d <= atol * max(scale, 1.0) + rtol * want.float().abs()).all()),
                            f"{name} {dname} gradient off: max abs {d.max().item()}")
                log(f"{name} {dname} gradients of image and flow vs plain: max abs / max "
                    f"|grad| {errs[0]:.2e} and {errs[1]:.2e} (rtol {rtol:.0e}, atol "
                    f"{atol:.0e} x max |grad|)")
    torch.use_deterministic_algorithms(False)

    with phase("card vs cpu port"):
        clip = synth_gop_multi(np.random.default_rng(0), size=128, gop=4)[:, :64, :128]
        small = torch.from_numpy(np.ascontiguousarray(clip)).permute(0, 3, 1, 2).contiguous()
        res = {}
        for device in ("cuda", "cpu"):
            spec = get_codec_model("LSVC-TPU", device=device)
            load_asset(spec.module, "hd_lsvctpuf2_l2")
            com, m = rollout(spec, small.to(device))
            res[device] = (com.float().cpu(), float(m["bpp"]), m["psnr"].float().cpu())
        (cg, bg, pg), (cc, bc, pc) = res["cuda"], res["cpu"]
        dmax = (cg - cc).abs().max().item()
        dmean = (cg - cc).abs().mean().item()
        dpsnr = (pg - pc).abs().max().item()
        dbpp = abs(bg - bc) / bc
        log(f"card vs cpu: recon max abs {dmax:.3e} mean abs {dmean:.3e} (tolerance mean "
            f"1e-4); psnr card {pg.tolist()} cpu {pc.tolist()} max diff {dpsnr:.2e} dB "
            f"(tolerance 0.01); bpp card {bg:.6f} cpu {bc:.6f} rel {dbpp:.2e} (tolerance 1e-3)")
        require(dmean <= 1e-4 and dpsnr <= 0.01 and dbpp <= 1e-3, "card disagrees with cpu")
        # the bf16 path on the same input, held to the f32 result: bf16 rounding
        # moved PSNR by 0.010 dB and bpp by 5e-4 relative on an H100
        spec = get_codec_model("LSVC-TPU", dtype=torch.bfloat16, device="cuda")
        load_asset(spec.module, "hd_lsvctpuf2_l2")
        _, m = rollout(spec, small.to("cuda", torch.bfloat16))
        pb, bb = m["psnr"].float().cpu(), float(m["bpp"])
        dpsnr, dbpp = (pb - pc).abs().max().item(), abs(bb - bc) / bc
        log(f"bf16 card vs f32 cpu: psnr {pb.tolist()} max diff {dpsnr:.3f} dB (tolerance "
            f"0.05); bpp {bb:.6f} rel {dbpp:.2e} (tolerance 0.005)")
        require(dpsnr <= 0.05 and dbpp <= 0.005, "bf16 path far from f32")

    spec = get_codec_model("LSVC-TPU", dtype=torch.bfloat16, device="cuda")
    load_asset(spec.module, "hd_lsvctpuf2_l2")
    clip = synth_gop_multi(np.random.default_rng(0), size=max(H, W), gop=GOP)[:, :H, :W]
    gop = torch.from_numpy(np.ascontiguousarray(clip)).permute(0, 3, 1, 2)
    gop = gop.to("cuda", torch.bfloat16).contiguous()
    del clip

    def timed_runs(fn, *args, runs: int = 3):
        """(card ms, host enqueue ms) of each run: CUDA events around the
        call, and the host clock until the call returns, before waiting for
        the card."""
        times, enqueue = [], []
        for _ in range(runs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            t0 = time.perf_counter()
            fn(*args)
            enqueue.append((time.perf_counter() - t0) * 1e3)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return times, enqueue

    with phase("rollout 1024x2048 GOP16 bf16"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kw.reset_launches()
        com, m = rollout(spec, gop)
        torch.cuda.synchronize()
        rollout_launches = dict(kw.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"launches in one GOP: {rollout_launches}")
        require(rollout_launches == {**zero_counts, "flow_warp": 4, "flow_warp_s2d": 4},
                f"rollout launch counts {rollout_launches}, want 4 and 4")
        psnr = m["psnr"].float().cpu()
        bpp = float(m["bpp"])
        require(tuple(com.shape) == (GOP - 1, 3, H, W), f"recon shape {tuple(com.shape)}")
        require(bool(torch.isfinite(com).all()), "recon not finite")
        require(bool(torch.isfinite(psnr).all()) and float(psnr.min()) > 20.0,
                f"psnr {psnr.tolist()}")
        require(np.isfinite(bpp) and bpp > 0.0, f"bpp {bpp}")
        del com, m
        times, enqueue = timed_runs(rollout, spec, gop)
        require(dict(kw.LAUNCHES) == {**zero_counts, "flow_warp": 16, "flow_warp_s2d": 16},
                f"counts after 4 GOPs {kw.LAUNCHES}")
        ms = sum(times) / len(times)
        log(f"rollout: ms/GOP {times} mean {ms:.3f}; host enqueue ms/GOP "
            f"{[round(t, 3) for t in enqueue]}; fps {1000.0 * (GOP - 1) / ms:.3f}; "
            f"bpp {bpp:.6f}; psnr mean {float(psnr.mean()):.4f} per frame "
            f"{[round(v, 4) for v in psnr.tolist()]}; peak memory {peak:.3f} GiB")

    with phase("decode graph 1024x2048 GOP16 bf16"):
        decode, (mv_q, z_qs, feat_qs) = build_lsvc_decode(spec.module, GOP, H, W)
        iframe_s2d = space_to_depth(gop[0:1], 2)[0].contiguous()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kw.reset_launches()
        mean, sigma, out = decode(iframe_s2d, mv_q, z_qs, feat_qs)
        torch.cuda.synchronize()
        decode_launches = dict(kw.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"launches in one GOP: {decode_launches}")
        require(decode_launches == {**zero_counts, "flow_warp_s2d": 4},
                f"decode launch counts {decode_launches}, want s2d warp 4")
        require(tuple(out.shape) == (GOP - 1, 3, H, W) and bool(torch.isfinite(out).all()),
                "decode output not finite or misshapen")
        require(np.isfinite(float(mean)) and np.isfinite(float(sigma)), "decode scalars")
        del out
        times, enqueue = timed_runs(decode, iframe_s2d, mv_q, z_qs, feat_qs)
        ms = sum(times) / len(times)
        log(f"decode: ms/GOP {times} mean {ms:.3f}; host enqueue ms/GOP "
            f"{[round(t, 3) for t in enqueue]}; fps {1000.0 * (GOP - 1) / ms:.3f}; "
            f"recon mean {float(mean):.6f} sigma sum {float(sigma):.6f}; "
            f"peak memory {peak:.3f} GiB")

    def time_kernels(names, captured, rows, lib, library_call=None):
        """Sum over one GOP's captured launches of each kernel's time, its
        plain version's, its bound and its time on random flows of the same
        shapes; ``library_call(name, img, flow)`` gives the library time
        where one PyTorch call computes the same function."""
        gen = torch.Generator(device="cuda").manual_seed(1)
        flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
        for name in names:
            r = rows[name] = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "random_ms": 0.0,
                              "cold_ms": 0.0, "staged": 0, "tiles": 0, "launches": []}
            lib[name] = None
            for img, flow in captured[name]:
                err = (kernels[name](img, flow).float() - plains[name](img, flow).float())
                err = err.abs().max().item()
                require(err <= tol_of(name, "bfloat16"), f"{name} on main-path inputs: {err}")
                max_err[name] = max(max_err[name], err)
                if name == "flow_warp_s2d":
                    staged, tiles = staged_tiles(img, flow)
                    r["staged"] += staged
                    r["tiles"] += tiles
                warm = cuda_ms(torch, kernels[name], img, flow)
                cold = cold_ms(torch, kernels[name], img, flow, flush=flush)
                r["ms"] += warm
                r["cold_ms"] += cold
                r["launches"].append(f"{tuple(img.shape)}: {warm:.4f} / {cold:.4f}")
                r["plain_ms"] += cuda_ms(torch, plains[name], img, flow, iters=5)
                r["bound_ms"] += bound_ms(img, flow)
                rimg, rflow = warp_inputs(torch, gen, img.shape, flow.shape, img.dtype,
                                          flow.dtype)
                r["random_ms"] += cuda_ms(torch, kernels[name], rimg, rflow)
                t = library_call(name, img, flow) if library_call else None
                if t is not None:
                    lib[name] = (lib[name] or 0.0) + t
            staged = (f"; tiles staged {r['staged']}/{r['tiles']} "
                      f"({r['staged'] / r['tiles']:.4f})" if r["tiles"] else "")
            log(f"{name}: kernel {r['ms']:.4f} ms/GOP over {len(captured[name])} launches "
                f"(L2 flushed before each launch: {r['cold_ms']:.4f}; on uniform random "
                f"flows of +-200 px: {r['random_ms']:.4f}), plain {r['plain_ms']:.4f}, bound "
                f"{r['bound_ms']:.4f} (bytes), library {lib[name]}{staged}")
            log(f"{name} per launch, img shape: warm / L2-flushed ms: {r['launches']}")

    rows, lib = {}, {}
    with phase("kernel timing (bf16, one GOP's launches)"):
        # the kernels' inputs from one more rollout of the clip: the main
        # path's shapes and its real (smooth) flows
        captured = {}
        with capture_warp_inputs(captured):
            rollout(spec, gop)
        require([len(captured.get(k, [])) for k in LSVC_KERNELS] == [4, 4],
                f"captured {[len(v) for v in captured.values()]} launches")

        def lsvc_library(name, img, flow):
            if name == "flow_warp":
                return cuda_ms(torch, grid_sample, img, sample_grid(flow))
            return None

        time_kernels(LSVC_KERNELS, captured, rows, lib, lsvc_library)
        del captured, spec

    with phase("ssf card vs cpu port"):
        clip = synth_gop_multi(np.random.default_rng(0), size=128, gop=4)[:, :64, :128]
        small = torch.from_numpy(np.ascontiguousarray(clip)).permute(0, 3, 1, 2).contiguous()
        res = {}
        for device, dtype in (("cuda", torch.float32), ("cpu", torch.float32),
                              ("cuda", torch.bfloat16)):
            sspec = get_codec_model("SSF-TPU-TINY", dtype=dtype, device=device)
            load_asset(sspec.module, "tiny_ssftpu_l2")
            com, m = rollout(sspec, small.to(device, dtype))
            res[device, dtype] = (com.float().cpu(), m["psnr"].float().cpu(),
                                  float(m["bpp_est"].sum()))
        (cg, pg, bg), (cc, pc, bc) = res["cuda", torch.float32], res["cpu", torch.float32]
        dmax = (cg - cc).abs().max().item()
        dmean = (cg - cc).abs().mean().item()
        dpsnr = (pg - pc).abs().max().item()
        dbpp = abs(bg - bc) / bc
        log(f"ssf card vs cpu: recon max abs {dmax:.3e} mean abs {dmean:.3e} (tolerance mean "
            f"1e-4); psnr card {pg.tolist()} cpu {pc.tolist()} max diff {dpsnr:.2e} dB "
            f"(tolerance 0.01); bpp card {bg:.6f} cpu {bc:.6f} rel {dbpp:.2e} (tolerance 1e-3)")
        require(dmean <= 1e-4 and dpsnr <= 0.01 and dbpp <= 1e-3, "ssf card disagrees with cpu")
        # the bf16 path on the same input, held to the f32 result; the bar is
        # about five times the gap an H100 measured
        _, pb, bb = res["cuda", torch.bfloat16]
        dpsnr, dbpp = (pb - pc).abs().max().item(), abs(bb - bc) / bc
        log(f"ssf bf16 card vs f32 cpu: psnr {pb.tolist()} max diff {dpsnr:.4f} dB "
            f"(tolerance {SSF_BF16_PSNR_DB}); bpp {bb:.6f} rel {dbpp:.3e} (tolerance "
            f"{SSF_BF16_BPP_REL})")
        require(dpsnr <= SSF_BF16_PSNR_DB and dbpp <= SSF_BF16_BPP_REL, "ssf bf16 far from f32")

    sspec = get_codec_model("SSF-TPU", dtype=torch.bfloat16, device="cuda")
    t0 = time.perf_counter()
    load_flat(sspec.module, seeded_flat("SSF-TPU", 0))
    log(f"SSF-TPU seeded weights: {sum(p.numel() for p in sspec.module.parameters())} "
        f"parameters in {time.perf_counter() - t0:.3f} s")

    with phase("ssf rollout 1024x2048 GOP16 bf16"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kw.reset_launches()
        com, m = rollout(sspec, gop)
        torch.cuda.synchronize()
        ssf_launches = dict(kw.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"launches in one GOP: {ssf_launches}")
        want = {**zero_counts, "pixel_warp": GOP - 1, "pixel_warp_s2d_sflow": GOP - 1}
        require(ssf_launches == want, f"ssf launch counts {ssf_launches}, want {want}")
        psnr = m["psnr"].float().cpu()
        bpp = m["bpp_est"].float().cpu()
        require(tuple(com.shape) == (GOP - 1, 3, H, W), f"recon shape {tuple(com.shape)}")
        require(bool(torch.isfinite(com).all()), "ssf recon not finite")
        require(bool(torch.isfinite(psnr).all() and torch.isfinite(bpp).all())
                and float(bpp.min()) > 0.0, f"ssf psnr {psnr.tolist()} bpp {bpp.tolist()}")
        del com, m
        times, enqueue = timed_runs(rollout, sspec, gop)
        ms = sum(times) / len(times)
        log(f"ssf rollout: ms/GOP {times} mean {ms:.3f}; host enqueue ms/GOP "
            f"{[round(t, 3) for t in enqueue]}; fps {1000.0 * (GOP - 1) / ms:.3f}; "
            f"bpp (random weights, not gated) mean {float(bpp.mean()):.6f}; psnr mean "
            f"{float(psnr.mean()):.4f}; peak memory {peak:.3f} GiB")

    with phase("ssf kernel timing (bf16, one GOP's launches)"):
        captured = {}
        with capture_warp_inputs(captured):
            rollout(sspec, gop)
        require([len(captured.get(k, [])) for k in ("pixel_warp", "pixel_warp_s2d_sflow")]
                == [GOP - 1, GOP - 1], f"captured {[len(v) for v in captured.values()]}")
        # no codec calls pixel_warp_s2d: time it on the level-0 sample's
        # inputs, its phase flow unpacked to full resolution
        captured["pixel_warp_s2d"] = [(img, full_res_flow(flow))
                                      for img, flow in captured["pixel_warp_s2d_sflow"]]

        def ssf_library(name, img, flow):
            if name == "pixel_warp":
                return cuda_ms(torch, grid_sample, img, pixel_grid(flow).to(img.dtype))
            return None

        time_kernels(SSF_KERNELS, captured, rows, lib, ssf_library)
        del captured

    launches = {**{k: rollout_launches[k] for k in LSVC_KERNELS},
                **{k: ssf_launches[k] for k in SSF_KERNELS}}
    report = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": max_err[name],
            "ms": rows[name]["ms"],
            "plain_ms": rows[name]["plain_ms"],
            "bound_ms": rows[name]["bound_ms"],
            "bound_by": "bytes",
            "library_ms": lib[name],
        }
        for name in kernels
    ]}
    log(json.dumps(report))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card_name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
