"""One training step on the CUDA card against the same step on the CPU,
and where the two part.

    python -m fastvideocodec_torch.tools.train_parity
        [--codec ELFVC-SP-TPU ELFVC-SP] [--h 64 --w 128 --gop 4] [--bf16]

Each codec at full width on seeded_flat(name, 0) (sp_stage 1 for the
ELFVC-SP forms, as cli/train.py builds them; DVC, RLVC and Base with the
pretrained SpyNet but in their -TINY forms, Base-ER's forms with the soft2hard three passes),
float32 with TF32 off (with ``--bf16``, both devices in bf16 mixed
precision, as ``cli/train.py --bf16`` trains): one backward of ``gop_loss`` on the top-left h x w
of a synth_gop_multi clip (seed 0), the noise drawn on the host from seed
0 for both devices (``chip_smoke.py`` phase 46's step). It prints:

- each parameter's gradient gap (max abs over its max |grad|), the worst
  first, each device on its own ReLU branches;
- the motion decoder's backward frame by frame: for each layer, the gap
  of the gradient at its output between the devices, each device's
  gradient against a float64 recompute from that device's own captured
  tensors (the layer above's output gradient and this layer's output),
  and the elements whose ReLU mask differs between the devices;
- the same gaps with the CPU on the card's ReLU and leaky ReLU branches,
  RLVC's clip of the recon and the clamps' sides (``CardBranches``), and
  how many activation and clamp elements took the other branch on the
  CPU.

A pre-activation within float32 noise of 0 may pass its gradient on one
device and not on the other; that is a branch, not an error of either
device's arithmetic, and the float64 recomputes tell the two apart.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from fastvideocodec_torch import get_codec_model
from fastvideocodec_torch.data.synthetic import synth_gop_multi
from fastvideocodec_torch.layers.blocks import cast_once
from fastvideocodec_torch.layers.spynet import load_pretrained_spynet
from fastvideocodec_torch.layers.transforms import AnalysisPriorNet, SSFHyperDecoder
from fastvideocodec_torch.models import lsvc, rlvc
from fastvideocodec_torch.ops import math as om
from fastvideocodec_torch.ops import warp as ow
from fastvideocodec_torch.ops.math import UniformNoise
from fastvideocodec_torch.train import olft
from fastvideocodec_torch.train import TrainConfig, gop_loss, ready_for_training
from fastvideocodec_torch.weights import load_flat, seeded_flat


# the clamps whose sides CardBranches records beside the activations' branches
CLAMPS = ("laplace_scale", "prior_abs", "warp_floor", "warp_border")
LAPLACE_SCALE = (1e-5, 1e10)  # ops/math.py:laplace_likelihood's clamp of the scale


class CardBranches:
    """F.relu and F.leaky_relu wrapped (the SSF hyper decoders' ReLU too,
    a class attribute), RLVC's clip of the recon to [0, 1]
    (``models.rlvc.clip_recon``) and the clamps, as a context: LSVC's
    Laplace scale clamp (``laplace_likelihood``), the ``abs`` before
    ``AnalysisPriorNet``, and each warp's floor of its sampling coordinate
    and the coordinate's border clamp (``ops/warp.py:_border_taps``; on the
    card, where the kernels compute them, the same coordinates computed in
    torch before each launch: the kernels are bit for bit their plain
    versions). Without ``replay`` each call records its branch in
    ``masks``: the activations' positive one (x > 0), the clip's inside
    one (0 <= x <= 1, where its gradient passes), a clamp's side (-1
    below, 0 inside, 1 above), abs's sign, a warp axis's (side, floor);
    with the masks another run recorded (the card's) each call takes that
    run's branch, its value and its gradient, and counts the elements
    whose own branch differed: the activations' and the clip's in
    ``flips``, each clamp's in ``clamp_flips``. Both runs must make the
    same calls in the same order (the same model and clip)."""

    def __init__(self, replay=None):
        self.orig = (F.relu, F.leaky_relu, rlvc.clip_recon)
        self.orig_clamps = (lsvc.laplace_likelihood, AnalysisPriorNet.abs, ow._border_taps,
                            ow._dispatch)
        self.masks, self.replay, self.flips = [], replay, 0
        self.clamp_flips = dict.fromkeys(CLAMPS, 0)

    def branch(self, mine: torch.Tensor, clamp: str | None = None):
        """The card's branch of this call where replaying and it differs
        from ``mine``, else None; records ``mine`` and counts the flips."""
        self.masks.append(mine.cpu())
        if self.replay is None:
            return None
        want = self.replay[len(self.masks) - 1].to(mine.device)
        if want.shape != mine.shape:
            raise RuntimeError("the two runs called the activations apart")
        flipped = int((want != mine).sum())
        if clamp is None:
            self.flips += flipped
        else:
            self.clamp_flips[clamp] += flipped
        return want if flipped else None

    def take(self, x, out, slope):
        want = self.branch((x > 0).detach())
        return out if want is None else x * torch.where(want, 1.0, slope).to(x.dtype)

    def clip(self, x):
        out = self.orig[2](x)
        want = self.branch(((x >= 0) & (x <= 1)).detach())
        return out if want is None else torch.where(want, x, out.detach())

    @staticmethod
    def _side(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
        return ((x > hi).to(torch.int8) - (x < lo).to(torch.int8)).detach()

    def laplace(self, x, scale):
        lo, hi = LAPLACE_SCALE
        want = self.branch(self._side(scale, lo, hi), "laplace_scale")
        if want is None:
            return self.orig_clamps[0](x, scale)
        scale = torch.where(want < 0, lo, torch.where(want > 0, hi, scale))
        return om.laplace_cdf(x + 0.5, scale) - om.laplace_cdf(x - 0.5, scale)

    def abs(self, x):
        want = self.branch(torch.sign(x).to(torch.int8).detach(), "prior_abs")
        return torch.abs(x) if want is None else x * want.to(x.dtype)

    def border_taps(self, u: torch.Tensor, size: int):
        """``_border_taps`` on the recorded floor and clamp side of each
        element (the taps and the weight's gradient follow them)."""
        side = self._side(u, 0.0, size - 1)
        floor = torch.floor(u.clamp(0.0, size - 1)).to(torch.int32).detach()
        self.masks.append(torch.stack([side.to(torch.int32), floor]).cpu())
        if self.replay is None:
            return self.orig_clamps[2](u, size)
        want = self.replay[len(self.masks) - 1].to(u.device)
        if want.shape[1:] != u.shape:
            raise RuntimeError("the two runs called the warps apart")
        border = int((want[0] != side).sum())
        self.clamp_flips["warp_border"] += border
        self.clamp_flips["warp_floor"] += int(((want[1] != floor) & (want[0] == side)).sum())
        if not border and torch.equal(want[1], floor):
            return self.orig_clamps[2](u, size)
        uc = torch.where(want[0] < 0, 0.0, torch.where(want[0] > 0, float(size - 1), u))
        u0 = want[1].to(u.dtype)
        i0 = want[1].long().clamp(0, size - 1)
        return i0, (i0 + 1).clamp(max=size - 1), uc - u0

    def dispatch(self, name: str, img: torch.Tensor, flow: torch.Tensor):
        """On the card, the coordinates of the warp's plain version,
        computed before the launch, through ``border_taps`` (x, then y, as
        the plain version takes them)."""
        if not (img.is_cpu and flow.is_cpu):
            with torch.no_grad():
                full = ow._full_res_flow(flow) if name == "pixel_warp_s2d_sflow" else flow
                H, W = full.shape[-2:]
                if name.startswith("flow_warp"):
                    ow._taps(full[:, 0], ow._linspace(W, full.device)[None, None, :], W)
                    ow._taps(full[:, 1], ow._linspace(H, full.device)[None, :, None], H)
                else:
                    ow._pixel_taps(full[:, 0], ow._arange(W, full.device)[None, None, :], W)
                    ow._pixel_taps(full[:, 1], ow._arange(H, full.device)[None, :, None], H)
        return self.orig_clamps[3](name, img, flow)

    def __enter__(self):
        relu, leaky, _ = self.orig
        F.relu = lambda x, inplace=False: self.take(x, relu(x), 0.0)
        F.leaky_relu = lambda x, negative_slope=0.01, inplace=False: self.take(
            x, leaky(x, negative_slope), negative_slope)
        SSFHyperDecoder.act = staticmethod(F.relu)  # the hyper decoders' ReLU
        rlvc.clip_recon = self.clip
        lsvc.laplace_likelihood = self.laplace
        AnalysisPriorNet.abs = staticmethod(self.abs)
        ow._border_taps, ow._dispatch = self.border_taps, self.dispatch
        return self

    def __exit__(self, *exc):
        F.relu, F.leaky_relu, rlvc.clip_recon = self.orig
        SSFHyperDecoder.act = staticmethod(self.orig[0])
        lsvc.laplace_likelihood = self.orig_clamps[0]
        AnalysisPriorNet.abs = staticmethod(self.orig_clamps[1])
        ow._border_taps, ow._dispatch = self.orig_clamps[2], self.orig_clamps[3]


class CardTouchups:
    """``train.olft.touchup_labels`` wrapped, as a context: without
    ``replay`` each call records its touch-up mask in ``masks``; with the
    masks another run recorded (the card's) each call takes that run's
    mask (the label raw there, the recon elsewhere), and counts in
    ``flips`` the elements whose own mask differed. The mask is a top-k
    threshold of |recon - raw|: an error within float32 noise of the
    threshold may fall on either side on two devices, as a ReLU input
    near 0 may."""

    def __init__(self, replay=None):
        self.orig = olft.touchup_labels
        self.masks, self.replay, self.flips = [], replay, 0

    def take(self, recon, raw, ratio):
        label, mask = self.orig(recon, raw, ratio)
        self.masks.append(mask.cpu())
        if self.replay is None:
            return label, mask
        want = self.replay[len(self.masks) - 1].to(mask.device)
        self.flips += int((want != mask).sum())
        return torch.where(want, raw, recon), want

    def __enter__(self):
        olft.touchup_labels = self.take
        return self

    def __exit__(self, *exc):
        olft.touchup_labels = self.orig


def own_gaps(got: dict, want: dict) -> dict:
    """Each tensor's gap, max abs over ``want``'s max |value|."""
    return {n: (got[n].double() - want[n].double()).abs().max().item()
            / max(want[n].double().abs().max().item(), 1e-300) for n in want}


def step(name: str, clip: torch.Tensor, device: str, replay=None, dtype=torch.float32):
    """One gop_loss backward of ``name`` on ``device`` in ``dtype`` (bf16:
    the mixed-precision build, its masters cast once as make_train_step
    casts them): (float32 gradients on the host, the motion decoder's
    layers by frame {layer: (output, gradient at the output)}, the module,
    the CardBranches)."""
    spec = get_codec_model(name, device=device)
    load_flat(spec.module, seeded_flat(name, 0))
    if spec.family in ("dvc", "rlvc", "base") and "-TINY" not in name:
        load_pretrained_spynet(spec.module.optic_flow)
    params = ready_for_training(spec, dtype)
    frames = []
    hooks = []
    decoder = getattr(spec.module, "motion_decoder", None)
    if decoder is not None:
        hooks.append(decoder.register_forward_pre_hook(lambda m, i: frames.append({})))

        def capture(layer, out):
            rec = frames[-1][layer] = [out.detach().cpu().clone(), None]
            out.register_hook(lambda g: rec.__setitem__(1, g.detach().cpu().clone()))

        hooks += [mod.register_forward_hook(lambda m, i, o, n=n: capture(n, o))
                  for n, mod in decoder.named_children()]
    with CardBranches(replay) as branches, cast_once():
        loss, _ = gop_loss(spec, clip.to(device), True, UniformNoise(0, device="cpu"),
                           TrainConfig(learning_rate=1e-4, soft2hard="-ER" in name))
        loss.backward()
    for h in hooks:
        h.remove()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().float().cpu()
             for n, p in params.items()}
    return grads, frames, spec.module, branches


def data_grad_f64(layer: torch.nn.Module, below: torch.Tensor, grad: torch.Tensor):
    """The gradient at ``below`` (the previous layer's output, before its
    ReLU) of layer(relu(below)) for the output gradient ``grad``, in float64."""
    x = below.double().requires_grad_(True)
    w = layer.weight.detach().cpu().double()
    if isinstance(layer, torch.nn.ConvTranspose2d):
        y = F.conv_transpose2d(torch.relu(x), w, None, layer.stride, layer.padding,
                               layer.output_padding)
    else:
        y = F.conv2d(torch.relu(x), w, None, layer.stride, layer.padding)
    return torch.autograd.grad(y, [x], grad.double())[0]


def worst(gaps: dict, n: int = 6) -> list:
    return [(k, float(f"{v:.3g}")) for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:n]]


def compare(name: str, clip: torch.Tensor, dtype=torch.float32) -> dict:
    card, card_frames, module, branches = step(name, clip, "cuda", dtype=dtype)
    cpu, cpu_frames, _, _ = step(name, clip, "cpu", dtype=dtype)
    replayed, _, _, cpu_branches = step(name, clip, "cpu", replay=branches.masks, dtype=dtype)
    out = {"codec": name, "own_branches": worst(own_gaps(card, cpu)),
           "card_branches": worst(own_gaps(card, replayed)), "flips": cpu_branches.flips,
           "activation_elements": sum(m.numel() for m in branches.masks), "decoder": []}
    print(f"{name}: worst gradient gaps, each device on its own branches: "
          f"{out['own_branches']}")
    for t, (a, b) in enumerate(zip(card_frames, cpu_frames), start=1):
        layers = list(a)
        for lo, hi in zip(layers, layers[1:]):
            layer = getattr(module.motion_decoder, hi)
            row = {"frame": t, "layer": lo,
                   "card_vs_cpu": own_gaps({0: a[lo][1]}, {0: b[lo][1]})[0],
                   "card_vs_f64": own_gaps({0: a[lo][1]}, {0: data_grad_f64(
                       layer, a[lo][0], a[hi][1])})[0],
                   "cpu_vs_f64": own_gaps({0: b[lo][1]}, {0: data_grad_f64(
                       layer, b[lo][0], b[hi][1])})[0],
                   "relu_masks_differ": int(((a[lo][0] > 0) != (b[lo][0] > 0)).sum())}
            out["decoder"].append(row)
            print(f"  P-frame {t} motion_decoder.{lo} output gradient: card vs cpu "
                  f"{row['card_vs_cpu']:.2e}; card vs float64 of its own tensors "
                  f"{row['card_vs_f64']:.2e}, cpu {row['cpu_vs_f64']:.2e}; ReLU masks "
                  f"differ at {row['relu_masks_differ']} elements")
    out["clamp_flips"] = cpu_branches.clamp_flips
    print(f"{name}: with the CPU on the card's ReLU branches ({out['flips']} of "
          f"{out['activation_elements']} activation and clamp elements took the other branch; "
          f"clamps {out['clamp_flips']}): worst gradient gaps {out['card_branches']}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--codec", nargs="+", default=["ELFVC-SP-TPU", "ELFVC-SP"])
    ap.add_argument("--h", type=int, default=64)
    ap.add_argument("--w", type=int, default=128)
    ap.add_argument("--gop", type=int, default=4)
    ap.add_argument("--bf16", action="store_true", help="both devices in bf16 mixed precision")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("train_parity needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    frames = synth_gop_multi(np.random.default_rng(0), size=max(args.h, args.w),
                             gop=args.gop)[:, :args.h, :args.w]
    clip = torch.from_numpy(np.ascontiguousarray(frames)).permute(0, 3, 1, 2).contiguous()
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    rows = [compare(name, clip, dtype) for name in args.codec]
    print(json.dumps({"card": torch.cuda.get_device_name(0), "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
