"""Where a rollout's time goes on one CUDA card: by module, and by kernel.

    python -m fastvideocodec_torch.tools.profile_rollout
        [--codec ELFVC-SP-TPU|ELFVC-SP|SSF-TPU|SSF-Official|LSVC-TPU|LSVC-128|LSVC-TPU-RW
                 |...|MCVC-IA|MCVC-Original|DVC|RLVC|RLVC-HP|Base-EC-ER]
        [--views 4] [--h 256 --w 256] [--json PATH] [--train]

``--train`` profiles one training step in place of a rollout (an LSVC,
SSF or ELFVC form, float32, --h x --w, 256x256 unless given, GOP 16 of
synth_gop_multi
seed 0, the step of ``train.make_train_step`` at lr 1e-4 after a warm-up
step): its card ms beside its host enqueue ms, and the kernel section
below; no module split.

The cell of ``chip_smoke.py``: bf16, 1024x2048, GOP 16, synth_gop_multi
seed 0, with ``real_bits_fps``'s weights (seeded full widths, the
ELFVC-SP forms at sp_stage 2, the pretrained SpyNet in DVC's, RLVC's and
Base's; the shipped level-2 checkpoint of an LSVC form that has one,
``real_bits_fps.LSVC_ASSETS``; the one-hop -O forms run GOP 15, the
graph's reach); MCVC's is
``--views`` views of --h x --w (256x256 unless given) from
``real_bits_fps.mcvc_clip`` with seed 0, all alive (``--views 4 --h 1024
--w 2048``: chip_smoke.py's 4 x 1024x2048), MCVC-Original's the same
views as a batch. After a warm-up rollout it
reports:

- the GOP's card ms by CUDA events beside its host enqueue ms;
- by module: every child of the codec, every child of its hyperpriors and
  of RLVC's Coder2Ds (``*_codec``, whose own methods are not forward) and
  every module of their SPnets is hooked during one rollout, and each call's
  inputs are kept; each module is then run again alone on the inputs of
  its calls, and its card ms (CUDA events around the whole set of calls)
  and its host ms (the host clock around the same calls, with a
  synchronise before the start only) are summed per GOP. A module whose
  host ms is close to its card ms is bound by its launches;
- by kernel: one rollout under torch.profiler, the device's busy share
  (the union of kernel intervals over the GOP's wall time), the number of
  kernels launched, and the kernels with the most device time; then the
  kernels of one call of the module with the most card time (the SPnet on
  the ELFVC-SP forms) in launch order, with the profiler's durations beside the
  call's time by CUDA events without the profiler.

A number the profiler did not give is printed as "not measured".
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

import fastvideocodec_torch as ft
from fastvideocodec_torch.data.synthetic import synth_gop_multi
from fastvideocodec_torch.tools.real_bits_fps import CODECS, load_model, mcvc_clip

GOP, H, W = 16, 1024, 2048
TOP = 15  # kernels listed by device time


def hooked_calls(module: torch.nn.Module, run):
    """{name: [(args, kwargs), ...]} of every call, during ``run()``, of the
    codec's children, of its hyperpriors' and Coder2Ds' children and of
    every module of their SPnets."""
    names = {name: m for name, m in module.named_modules()
             if name and (name.count(".") == 0 or ".y_predictor" in name
                          or name.split(".")[0].endswith(("hyperprior", "_codec"))
                          and name.count(".") == 1)}
    calls = {name: [] for name in names}
    handles = [m.register_forward_hook(
        lambda _m, args, kwargs, _out, n=name: calls[n].append((args, kwargs)), with_kwargs=True)
        for name, m in names.items()]
    try:
        run()
    finally:
        for h in handles:
            h.remove()
    return names, {n: c for n, c in calls.items() if c}


def by_module(spec, run, reps: int = 3):
    """([(name, calls, card ms, host ms) per GOP for each hooked module of
    the rollout ``run()``, by the card's time, largest first], (the largest
    module, the args and kwargs of its first call))."""
    names, calls = hooked_calls(spec.module, run)
    rows = []
    with torch.inference_mode():
        for name, cs in calls.items():
            m = names[name]
            card = host = 0.0
            for _ in range(reps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                start.record()
                for args, kwargs in cs:
                    m(*args, **kwargs)
                end.record()
                host += (time.perf_counter() - t0) * 1e3
                torch.cuda.synchronize()
                card += start.elapsed_time(end)
            rows.append((name, len(cs), card / reps, host / reps))
    rows.sort(key=lambda r: -r[2])
    heaviest = rows[0][0]
    return rows, (names[heaviest], *calls[heaviest][0])


def by_kernel(run, top: int) -> dict:
    """One rollout ``run()`` under torch.profiler: busy share, kernel count,
    top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, -float("inf")
    for s, e in spans:  # union of intervals, in microseconds
        if e > end:
            busy += e - max(s, end)
            end = e
    totals: dict = {}
    for e in kernels:
        n, t = totals.get(e.name, (0, 0.0))
        totals[e.name] = (n + 1, t + (e.time_range.end - e.time_range.start) / 1e3)
    ranked = sorted(totals.items(), key=lambda kv: -kv[1][1])[:top]
    return {"wall_ms": wall_ms, "kernels": len(kernels),
            "busy_ms": busy / 1e3 if kernels else None,
            "top": [(name[:90], n, ms) for name, (n, ms) in ranked]}


def call_kernels(module, args, kwargs) -> dict:
    """One call of ``module`` under torch.profiler: its kernels in launch
    order (name, ms), and the same call's ms by CUDA events without it."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        module(*args, **kwargs)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        module(*args, **kwargs)
        end.record()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            module(*args, **kwargs)
            torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    return {"event_ms": start.elapsed_time(end),
            "kernels": [(e.name[:90], (e.time_range.end - e.time_range.start) / 1e3)
                        for e in kernels]}


def profile_train_step(args) -> int:
    """``--train``: one training step, timed and profiled."""
    from fastvideocodec_torch.gop.engine import TRAINED
    from fastvideocodec_torch.ops.math import UniformNoise
    from fastvideocodec_torch.train import TrainConfig, make_train_step, ready_for_training

    spec, trained = load_model(args.codec, 2, torch.float32, "cuda", 1)
    if spec.family not in TRAINED:
        raise SystemExit(f"--train: {args.codec} does not train in the port yet")
    h, w = args.h, args.w
    rng = np.random.default_rng(0)
    clips = [torch.from_numpy(np.ascontiguousarray(synth_gop_multi(rng, size=max(h, w), gop=GOP)
                                                   [:, :h, :w])).permute(0, 3, 1, 2)
             .contiguous().cuda() for _ in range(4)]
    params = ready_for_training(spec)
    init_fn, step_fn = make_train_step(spec, TrainConfig(learning_rate=1e-4))
    state = {"params": params, "opt": init_fn(params), "noise": UniformNoise(0), "i": 0}
    name = torch.cuda.get_device_name(0)
    print(f"{args.codec} {'trained' if trained else 'seeded'} training step {h}x{w} GOP{GOP} "
          f"f32 on {name}", flush=True)

    def step():
        clip = clips[state["i"] % len(clips)]
        state["i"] += 1
        state["params"], state["opt"], _ = step_fn(state["params"], state["opt"], clip,
                                                   state["noise"])

    step()  # warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    t0 = time.perf_counter()
    step()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end)
    print(f"training step: card {step_ms:.3f} ms, host enqueue {enqueue_ms:.3f} ms", flush=True)
    k = by_kernel(step, TOP)
    busy = "not measured" if k["busy_ms"] is None else f"{k['busy_ms']:.3f} ms"
    share = ("not measured" if k["busy_ms"] is None
             else f"{1 - k['busy_ms'] / k['wall_ms']:.4f}")
    print(f"profiled step: wall {k['wall_ms']:.3f} ms, {k['kernels']} kernels, device busy "
          f"{busy}, idle share {share}", flush=True)
    for kname, n, ms in k["top"]:
        print(f"  {ms:.3f} ms in {n} launches: {kname}", flush=True)
    if args.json:
        with open(args.json, "a") as f:
            f.write(json.dumps({
                "tool": "fastvideocodec_torch.tools.profile_rollout", "codec": args.codec,
                "train": True, "device": name, "dtype": "f32", "h": h, "w": w, "gop": GOP,
                "step_ms": step_ms, "enqueue_ms": enqueue_ms, **k}) + "\n")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--codec", choices=CODECS, default="ELFVC-SP-TPU")
    ap.add_argument("--views", type=int, default=4, help="MCVC's views")
    ap.add_argument("--h", type=int, default=256, help="MCVC's view height")
    ap.add_argument("--w", type=int, default=256, help="MCVC's view width")
    ap.add_argument("--json", default="", help="append the summary as one JSON line here")
    ap.add_argument("--train", action="store_true",
                    help="profile one training step (float32) in place of a rollout")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_rollout needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.train:
        return profile_train_step(args)

    if args.codec.startswith("MCVC"):
        views, h, w = args.views, args.h, args.w
        gop, mask = mcvc_clip(0, views, h, w, GOP)
        mask = mask if args.codec == "MCVC-IA" else None  # MCVC-Original: a batch
        what = f"{views} views of "
    else:
        views, h, w, mask, what = 1, H, W, None, ""
        clip = synth_gop_multi(np.random.default_rng(0), size=max(H, W), gop=GOP)
        gop = torch.from_numpy(np.ascontiguousarray(clip[:, :H, :W])).permute(0, 3, 1, 2)
    spec, trained = load_model(args.codec, 2, torch.bfloat16, "cuda", views)
    if spec.family == "lsvc" and spec.module.graph == "onehop":
        gop = gop[:15]  # the one-hop graph reaches 14 P-frames
    gop = gop.to("cuda", torch.bfloat16).contiguous()
    name = torch.cuda.get_device_name(0)
    print(f"{args.codec} {'trained' if trained else 'seeded'} {what}{h}x{w} GOP{gop.shape[0]} "
          f"bf16 on {name}", flush=True)

    def run():
        return ft.rollout(spec, gop, mask)

    run()  # warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    t0 = time.perf_counter()
    run()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    gop_ms = start.elapsed_time(end)
    print(f"rollout: card {gop_ms:.3f} ms/GOP, host enqueue {enqueue_ms:.3f} ms/GOP", flush=True)

    rows, (heaviest, args0, kwargs0) = by_module(spec, run)
    print("by module (per GOP): name, calls, card ms, host ms", flush=True)
    for mod, n, card, host in rows:
        print(f"  {mod}: {n} calls, card {card:.3f} ms, host {host:.3f} ms", flush=True)
    # the codec's children; a hyperprior called through another method than
    # forward (ELFVC's forward_with_prior) is counted by its children
    called = {r[0] for r in rows}

    def ancestors(name):
        parts = name.split(".")
        return {".".join(parts[:i]) for i in range(1, len(parts))}

    top_level = [r for r in rows if not ancestors(r[0]) & called]
    print(f"  children of the codec: card {sum(r[2] for r in top_level):.3f} ms, host "
          f"{sum(r[3] for r in top_level):.3f} ms; the rest of the GOP (warps, volumes, "
          f"glue) card {gop_ms - sum(r[2] for r in top_level):.3f} ms", flush=True)

    k = by_kernel(run, TOP)
    busy = "not measured" if k["busy_ms"] is None else f"{k['busy_ms']:.3f} ms"
    share = ("not measured" if k["busy_ms"] is None
             else f"{1 - k['busy_ms'] / k['wall_ms']:.4f}")
    print(f"profiled GOP: wall {k['wall_ms']:.3f} ms, {k['kernels']} kernels, device busy "
          f"{busy}, idle share {share}", flush=True)
    for kname, n, ms in k["top"]:
        print(f"  {ms:.3f} ms in {n} launches: {kname}", flush=True)
    one = call_kernels(heaviest, args0, kwargs0)
    k["heaviest"] = {"name": rows[0][0], **one}
    print(f"one call of {rows[0][0]}: {one['event_ms']:.3f} ms by CUDA events, "
          f"{len(one['kernels'])} kernels summing to "
          f"{sum(ms for _, ms in one['kernels']):.3f} ms under the profiler:", flush=True)
    for kname, ms in one["kernels"]:
        print(f"  {ms:.4f} ms {kname}", flush=True)
    if args.json:
        with open(args.json, "a") as f:
            f.write(json.dumps({
                "tool": "fastvideocodec_torch.tools.profile_rollout", "codec": args.codec,
                "device": name, "dtype": "bf16", "h": h, "w": w, "views": views,
                "gop": gop.shape[0],
                "gop_ms": gop_ms, "enqueue_ms": enqueue_ms,
                "modules": [dict(zip(("name", "calls", "card_ms", "host_ms"), r)) for r in rows],
                **k}) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
