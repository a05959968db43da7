"""Two probes of the card-against-CPU training gradient, for the faults
that ROADMAP.md section 3 lists.

    python -m fastvideocodec_torch.tools.fault_probe wgrad [--repeat 10]
    python -m fastvideocodec_torch.tools.fault_probe submodules [--codec ELFVC-SP]

``wgrad``: chip_smoke.py phase 42's step (LSVC-TPU on hd_lsvctpuf2_l2,
float32, 64x128 GOP 4, the noise drawn on the host from seed 0)
``--repeat`` times on the card under cuDNN's defaults (deterministic off,
benchmark off), each run's step then once on the CPU on that run's own
ReLU branches and clamp sides (``tools/train_parity.py:CardBranches``:
the Laplace scale's clamp, the ``abs`` before AnalysisPriorNet, the
warps' floor and border clamp) and held against it and against run 0's
CPU step; it prints the elements of each clamp whose side the CPU's own
values put elsewhere; every other card run holds all but 2
GiB of the card's free memory, so that cuDNN's heuristics meet a small
workspace. Each card run is traced by ``torch.profiler``: it prints the
CUDA kernels below the ``aten::convolution_backward`` whose weight has
``--layer``'s shape (default res_encoder.Conv_2), that layer's gradient
gap from the CPU's (max abs over the CPU's max |grad|), the worst gap of
the whole model, the activation elements whose ReLU branch differs from
run 0's, and the CUDA kernels that the run launched and run 0 did not
(and the reverse).

``submodules``: one step of ``--codec`` at full width on
seeded_flat(name, 0) (sp_stage 1 for the ELFVC-SP forms), the worst
gradient gap in each top-level submodule: the card's against the CPU's on
the card's branches, and on the CPU its float32
against its float64 (the float64 run on the float32 run's branches,
every ``Tensor.float()`` of the rate paths kept in float64 for its scope).
Where the CPU's float32 stands as far from float64 at a submodule as the
card stands from the CPU, the gap is the float32 conditioning of that
submodule's gradient and not a fault of either device.
"""

from __future__ import annotations

import argparse
import contextlib
import json

import numpy as np
import torch

from fastvideocodec_torch import get_codec_model
from fastvideocodec_torch.data.synthetic import synth_gop_multi
from fastvideocodec_torch.layers.blocks import cast_once
from fastvideocodec_torch.ops.math import UniformNoise
from fastvideocodec_torch.tools.train_parity import CardBranches, own_gaps
from fastvideocodec_torch.train import TrainConfig, gop_loss, ready_for_training
from fastvideocodec_torch.weights import load_asset, load_flat, seeded_flat


CROWD_SPARE = 2 * 2**30  # bytes left free in the crowded runs of ``wgrad``


def phase42_clip(h: int = 64, w: int = 128, gop: int = 4) -> torch.Tensor:
    frames = synth_gop_multi(np.random.default_rng(0), size=max(h, w), gop=gop)[:, :h, :w]
    return torch.from_numpy(np.ascontiguousarray(frames)).permute(0, 3, 1, 2).contiguous()


def build(name: str, device: str, asset: str | None = None):
    spec = get_codec_model(name, device=device)
    if asset:
        load_asset(spec.module, asset)
    else:
        load_flat(spec.module, seeded_flat(name, 0))
    return spec


@contextlib.contextmanager
def float64_rates():
    """``Tensor.float()`` leaves a float64 tensor in float64 for the scope
    (the rate paths cast to float32 by ``.float()``)."""
    orig = torch.Tensor.float

    def keep(self, *args, **kwargs):
        return self if self.dtype == torch.float64 else orig(self, *args, **kwargs)

    torch.Tensor.float = keep
    try:
        yield
    finally:
        torch.Tensor.float = orig


def step(spec, clip: torch.Tensor, device: str, replay=None, dtype=torch.float32):
    """One backward of gop_loss: (gradients as float64 on the host, the
    CardBranches)."""
    if dtype == torch.float64:
        spec.module.to(dtype).train().requires_grad_(True)
        params = dict(spec.module.named_parameters())
    else:
        params = ready_for_training(spec)
    for p in params.values():
        p.grad = None
    with CardBranches(replay) as branches, cast_once():
        loss, _ = gop_loss(spec, clip.to(device, dtype), True, UniformNoise(0, device="cpu"),
                           TrainConfig(learning_rate=1e-4))
        loss.backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().double().cpu()
             for n, p in params.items()}
    return grads, branches


def by_submodule(gaps: dict) -> dict:
    """{top-level submodule: (worst gap, parameter)}, the worst first."""
    out = {}
    for name, gap in gaps.items():
        sub = name.split(".")[0]
        out[sub] = max(out.get(sub, (0.0, "")), (gap, name))
    return dict(sorted(out.items(), key=lambda kv: -kv[1][0]))


def layer_kernels(prof, weight_shape: tuple) -> list:
    """The CUDA kernels under each ``aten::convolution_backward`` whose
    weight input has ``weight_shape``, in order."""
    found = []

    def kernels_below(evt):
        names = [k.name for k in getattr(evt, "kernels", [])]
        for child in evt.cpu_children:
            names += kernels_below(child)
        return names

    for evt in prof.events():
        if evt.name != "aten::convolution_backward" or not evt.input_shapes:
            continue
        if any(tuple(s) == weight_shape for s in evt.input_shapes if s):
            found.append(kernels_below(evt))
    return found


def kernel_names(prof) -> set:
    """The names of the CUDA kernels a trace holds, cut to 90 characters."""
    return {e.name[:90] for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and "Memset" not in e.name}


def wgrad(args) -> dict:
    from torch.profiler import ProfilerActivity, profile

    clip = phase42_clip()
    shape = tuple(dict(build("LSVC-TPU", "cpu").module.named_parameters())[
        args.layer + ".weight"].shape)
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = False
    runs, first = [], None
    for i in range(args.repeat):
        # odd runs with all but CROWD_SPARE bytes of the card held, so that
        # cuDNN's heuristics meet a small free workspace
        hold = None
        if i % 2:
            torch.cuda.empty_cache()
            free = torch.cuda.mem_get_info()[0]
            hold = torch.empty(max(free - CROWD_SPARE, 0), dtype=torch.uint8, device="cuda")
        card = build("LSVC-TPU", "cuda", "hd_lsvctpuf2_l2")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            grads, branches = step(card, clip, "cuda", replay=None)
            torch.cuda.synchronize()
        free_during = torch.cuda.mem_get_info()[0]
        del hold, card
        # the CPU on this run's own ReLU branches, and (run 0's CPU step) on
        # run 0's: a card run whose branches differ from run 0's meets the
        # latter's gradient through its flipped elements
        cpu, cpu_branches = step(build("LSVC-TPU", "cpu", "hd_lsvctpuf2_l2"), clip, "cpu",
                                 replay=branches.masks)
        if first is None:
            first = branches.masks, cpu, kernel_names(prof)
        own, vs_first = own_gaps(grads, cpu), own_gaps(grads, first[1])
        worst = max((v, n) for n, v in own.items())
        names = kernel_names(prof)
        row = {"run": i, "crowded": bool(i % 2), "free_gib": free_during / 2**30,
               "layer_gap": own[args.layer + ".weight"], "worst": worst,
               "layer_gap_on_run0_branches": vs_first[args.layer + ".weight"],
               "branch_diffs": sum(int((a != b).sum()) for a, b in zip(first[0], branches.masks)),
               "cpu_flips": cpu_branches.flips, "cpu_clamp_flips": cpu_branches.clamp_flips,
               "kernels": layer_kernels(prof, shape),
               "kernels_not_in_run0": sorted(names - first[2]),
               "run0_kernels_not_here": sorted(first[2] - names)}
        runs.append(row)
        print(f"run {i} ({'crowded' if i % 2 else 'free'}, {row['free_gib']:.2f} GiB free after "
              f"the step): {args.layer}.weight gap {row['layer_gap']:.3e} on its own branches "
              f"({row['layer_gap_on_run0_branches']:.3e} on run 0's, {row['branch_diffs']} "
              f"elements differ); the CPU on its branches: {row['cpu_flips']} activation "
              f"elements and clamps {row['cpu_clamp_flips']} took the other side; "
              f"worst {worst[0]:.3e} at {worst[1]}; its "
              f"convolution_backward kernels {[k[:60] for ks in row['kernels'] for k in ks]}; "
              f"kernels not in run 0 {row['kernels_not_in_run0']}; run 0's not here "
              f"{row['run0_kernels_not_here']}", flush=True)
    return {"layer": args.layer, "weight_shape": shape, "runs": runs}


def submodules(args) -> dict:
    clip = phase42_clip()
    out = {"codec": args.codec}
    card, branches = step(build(args.codec, "cuda"), clip, "cuda")
    cpu, cpu_branches = step(build(args.codec, "cpu"), clip, "cpu", replay=branches.masks)
    out["card_vs_cpu"] = by_submodule(own_gaps(card, cpu))
    out["card_vs_cpu_flips"] = cpu_branches.flips
    print(f"{args.codec} card vs cpu (cpu on the card's branches, {cpu_branches.flips} "
          f"flips): {out['card_vs_cpu']}", flush=True)
    f32, branches = step(build(args.codec, "cpu"), clip, "cpu")
    with float64_rates():
        f64, b64 = step(build(args.codec, "cpu"), clip, "cpu", replay=branches.masks,
                        dtype=torch.float64)
    out["cpu_f32_vs_f64"] = by_submodule(own_gaps(f32, f64))
    out["f64_flips"] = b64.flips
    print(f"{args.codec} cpu float32 vs float64 (float64 on float32's branches, {b64.flips} "
          f"flips): {out['cpu_f32_vs_f64']}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("probe", choices=["wgrad", "submodules"])
    ap.add_argument("--repeat", type=int, default=10)
    ap.add_argument("--layer", default="res_encoder.Conv_2")
    ap.add_argument("--codec", default="ELFVC-SP")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fault_probe needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {torch.cuda.get_device_name(0)}", flush=True)
    out = wgrad(args) if args.probe == "wgrad" else submodules(args)
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
