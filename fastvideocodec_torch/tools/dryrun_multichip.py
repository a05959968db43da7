"""The port's multi-device dry run: JAX's ``__graft_entry__.dryrun_multichip``
on torch.distributed, N ranks started on this machine.

    python -m fastvideocodec_torch.tools.dryrun_multichip N [--device cpu|cuda] [--tiny]
        [--steps K] [--timeout S] [--json PATH]

Four halves, as JAX's, each one training step of a codec on a mesh of the
N ranks held against the same step in one process (rank 0 runs it first,
the others waiting), from the same weights, clips and noise:

- ``mcvc``: MCVC-IA over (data x view), the views split over 'view' (4 if
  N allows, else 2 or 1), view 2 failed, not batched: its B*V rows split
  over both axes, the cross-view attention's keys and values gathered;
- ``lsvc_dp``: LSVC-TPU data parallel, a batch of N clips over 'data';
- ``ssf_dp``: SSF-TPU data parallel, N clips;
- ``lsvc_frame``: LSVC-TPU over (data x frame), frame 2 if N is even: each
  clip's tree layers split over 'frame' (``parallel.frame_sharded_spec``).

At full width by default, on ``chip_smoke.py``'s shapes: LSVC-TPU from
hd_lsvctpuf2_l2, MCVC-IA and SSF-TPU from ``seeded_flat(name, 0)``; data
parallel N clips of 7 frames at 256x256, the frame half N / 2 clips of
GOP 16, MCVC one item of 4 views of 256x256, GOP MCVC_GOP (cut from 16 for
the time). ``--tiny``: the -TINY models from their shipped weights at
64x64, GOP 4 (MCVC GOP 3), a run of seconds on the CPU. Each clip
draws its quantizers' noise from its own ``UniformNoise`` (seed 1000 a
half plus its index), as JAX splits its key a clip.

The gates of each half: the sharded loss within LOSS_REL = 1e-4 relative
of the single-process step's (JAX's dry run's bar); every gradient within
GRAD_REL = 5e-3 of its own max |grad| (the card's bar against the CPU:
the ranks' weight gradients, summed by the all_reduce, add in another
order than one batch's); the ranks' parameters after the step equal bit
for bit; on the card no plain warp and no plain vjp, and each rank's warp
launches those of the calls on which it holds rows (``want_launches``):
in the data parallel halves the ranks' launches sum to the
single-process step's, while a view or frame rank launches a kernel for
each call as one process does, on its rows. Every step runs under
``coder.video.deterministic_convs``: under cuDNN's defaults the
single-process step differs from itself from run to run (MCVC-IA's motion
decoder by 3.3e-3 of its max, LSVC-TPU's res_encoder by 1.5e-3, on an
H100), which is not the sharding's. On the card the single-process step
runs twice and that gap is reported beside (LSVC-TPU's MC warp sums its
image gradient by atomicAdd, so its steps differ by about 2e-5 even so). On
the CPU the tight comparison is tests/test_torch_parallel.py's, on JAX's
draws and ReLU branches. ``--steps K``: K - 1 more steps of each, timed.
It prints, on the last line, the halves' numbers as JSON (``--json`` also
writes them): each loss, the worst gradient gap, ms a step sharded and in
one process (CUDA events; with ranks sharing one card these are its time
shared among them, not a scaling), each rank's launches and host enqueue
ms.

The launcher takes a free port on localhost, starts the N ranks as
processes of this module (``--rank``) and waits for them within
``--timeout``; when a rank fails or the time runs out it kills every rank,
prints the failed ranks' output and exits non-zero. Each rank turns TF32
off (cuDNN and matmul), as tools/train_parity.py does, runs on one torch
thread on the CPU, imports nothing of JAX, and joins the process group
over gloo (so several ranks may share one card; NCCL refuses that).
``--cases FILE --out DIR`` runs the cases ``save_cases``
wrote in place of the halves and writes each rank's results and rank 0's
tensors to DIR (tests/test_torch_parallel.py). ``run_case`` runs a case
in a process that already holds a group (``chip_smoke.py``'s world of one
over NCCL).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

HALVES = ("mcvc", "lsvc_dp", "ssf_dp", "lsvc_frame")
LOSS_REL = 1e-4
GRAD_REL = 5e-3
SIZE, CLIP_FRAMES, FRAME_GOP, MCVC_GOP = 256, 7, 16, 4
TINY_SIZE, TINY_GOP, TINY_MCVC_GOP = 64, 4, 3
MCVC_FAILED = 2
LR = 1e-4
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "fastvideocodec_tpu")


@dataclass
class Case:
    """One sharded training step and its single-process twin. ``gop``: NCHW
    frames, batched [B, T, 3, H, W] or MCVC's [T, B*V, 3, H, W]; ``mask``
    MCVC's view mask ([B*V], or [B, B*V] batched); ``weights`` an asset
    name, "seeded" (``seeded_flat``) or flat arrays; ``draws`` (else
    ``UniformNoise(seed + clip)``) a list of draws a clip to replay in
    order; ``branches`` a list a clip of another run's ReLU branches to
    take (``RowBranches``); ``module_args`` builds an LSVC from its
    arguments in place of the registry name."""

    name: str
    codec: str
    mesh: tuple
    gop: np.ndarray
    weights: object = "seeded"
    batched: bool = True
    frame_sharded: bool = False
    mask: np.ndarray | None = None
    num_views: int = 0
    seed: int = 0
    draws: list | None = None
    branches: list | None = None
    module_args: dict | None = None


class Replay:
    """A noise source that gives recorded draws (NCHW arrays) in order."""

    def __init__(self, draws):
        self.draws, self.used = list(draws), 0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        u = torch.from_numpy(np.array(self.draws[self.used])).to(x.device, x.dtype)
        self.used += 1
        if u.shape != x.shape:
            raise RuntimeError(f"replayed draw {tuple(u.shape)} for {tuple(x.shape)}")
        return u


class RowBranches:
    """The ReLUs (``F.relu`` and the SSF hyper decoders' ``act``) on another
    run's branches, as a context: each call takes the next recorded mask
    (x > 0 over the whole batch, NHWC, or NHW(4C) before a polyphase
    deconv's depth-to-space, as JAX's ReLU sees it), its value and its
    gradient, the mask's rows of this rank when the step splits the batch
    (``parallel.collectives.gop_share``), and counts in ``flips`` the
    elements whose own branch differed. A pre-activation within float32
    noise of 0 may take the other branch in another run; that is a
    branch, not an error of either run's arithmetic. Both runs must make
    the same calls in the same order."""

    def __init__(self, masks: list, frame_axis: str = ""):
        self.masks, self.frame_axis, self.calls, self.flips = masks, frame_axis, 0, 0

    def _mask(self, x: torch.Tensor) -> torch.Tensor:
        from fastvideocodec_torch.parallel.collectives import gop_share

        m = np.asarray(self.masks[self.calls])
        self.calls += 1
        if m.shape[0] != x.shape[0]:
            lo, hi = gop_share(self.frame_axis).span(m.shape[0])
            m = m[lo:hi]
        B, C, H, W = x.shape
        if m.shape == (B, H, W, C):
            m = m.transpose(0, 3, 1, 2)
        elif m.shape == (B, H // 2, W // 2, 4 * C):
            m = m.reshape(B, H // 2, W // 2, 2, 2, C).transpose(0, 5, 1, 3, 2, 4)
        else:
            raise RuntimeError(f"ReLU call {self.calls - 1}: mask {m.shape}, x {tuple(x.shape)}")
        return torch.from_numpy(np.ascontiguousarray(m.reshape(B, C, H, W))).to(x.device)

    def relu(self, x, inplace=False):
        want = self._mask(x)
        self.flips += int((want != (x > 0)).sum())
        return x * want.to(x.dtype)

    def __enter__(self):
        from fastvideocodec_torch.layers.transforms import SSFHyperDecoder

        self.saved = torch.nn.functional.relu, SSFHyperDecoder.act
        torch.nn.functional.relu = self.relu
        SSFHyperDecoder.act = staticmethod(self.relu)
        return self

    def __exit__(self, *exc):
        from fastvideocodec_torch.layers.transforms import SSFHyperDecoder

        torch.nn.functional.relu = self.saved[0]
        SSFHyperDecoder.act = staticmethod(self.saved[1])
        if exc[0] is None and self.calls != len(self.masks):
            raise RuntimeError(f"{self.calls} ReLU calls of {len(self.masks)} recorded")


def nchw_clip(frames: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(frames.transpose(0, 3, 1, 2))


def lsvc_clips(n: int, gop: int, size: int, seed: int, tiny: bool) -> np.ndarray:
    from fastvideocodec_torch.data.synthetic import synth_gop, synth_gop_multi

    rng = np.random.default_rng(seed)
    make = synth_gop if tiny else synth_gop_multi
    return np.stack([nchw_clip(make(rng, size=size, gop=gop)) for _ in range(n)])


def halves(world: int, tiny: bool, names=HALVES) -> list:
    """The dry run's cases on ``world`` ranks."""
    from fastvideocodec_torch.data.synthetic import synth_mv_gop

    size = TINY_SIZE if tiny else SIZE
    out = []
    for i, name in enumerate(names):
        seed = 1000 * (i + 1)
        if name == "mcvc":
            view = 4 if world % 4 == 0 else (2 if world % 2 == 0 else 1)
            data, gop = world // view, TINY_MCVC_GOP if tiny else MCVC_GOP
            rng = np.random.default_rng(seed)
            clip = np.concatenate([synth_mv_gop(rng, views=view, size=size, gop=gop)
                                   for _ in range(data)], axis=1)  # [T, B*V, H, W, 3]
            mask = np.tile(np.where(np.arange(view) == MCVC_FAILED, 0.0, 1.0), data)
            out.append(Case(name, "MCVC-IA-TINY" if tiny else "MCVC-IA", (data, view, 1),
                            np.ascontiguousarray(clip.transpose(0, 1, 4, 2, 3)),
                            "tiny_mcvc_l3" if tiny else "seeded", batched=False,
                            mask=mask.astype(np.float32), num_views=view, seed=seed))
        elif name in ("lsvc_dp", "ssf_dp"):
            lsvc = name == "lsvc_dp"
            codec = ("LSVC-TPU" if lsvc else "SSF-TPU") + ("-TINY" if tiny else "")
            weights = (("tiny_lsvctpu_l2" if lsvc else "tiny_ssftpu_l2") if tiny
                       else ("hd_lsvctpuf2_l2" if lsvc else "seeded"))
            gop = TINY_GOP if tiny else CLIP_FRAMES
            out.append(Case(name, codec, (world, 1, 1), lsvc_clips(world, gop, size, seed, tiny),
                            weights, seed=seed))
        elif name == "lsvc_frame":
            frame = 2 if world % 2 == 0 else 1
            data, gop = world // frame, TINY_GOP if tiny else FRAME_GOP
            out.append(Case(name, "LSVC-TPU-TINY" if tiny else "LSVC-TPU", (data, 1, frame),
                            lsvc_clips(data, gop, size, seed, tiny),
                            "tiny_lsvctpu_l2" if tiny else "hd_lsvctpuf2_l2",
                            frame_sharded=True, seed=seed))
        else:
            raise ValueError(f"no half {name!r}: {HALVES}")
    return out


def save_cases(cases: list, path) -> None:
    torch.save([c.__dict__ for c in cases], path)


def load_cases(path) -> list:
    return [Case(**c) for c in torch.load(path, weights_only=False)]


def build(case: Case, device: str):
    """(spec, params): the case's codec on ``device`` with its weights,
    readied for training."""
    from fastvideocodec_torch import get_codec_model, load_asset, load_flat, seeded_flat
    from fastvideocodec_torch.models import CodecSpec
    from fastvideocodec_torch.models.lsvc import LSVC
    from fastvideocodec_torch.train import ready_for_training

    if case.module_args is not None:
        spec = CodecSpec(case.codec, "lsvc", LSVC(**case.module_args).to(device))
    else:
        kw = {"num_views": case.num_views} if case.num_views else {}
        spec = get_codec_model(case.codec, device=device, **kw)
    if isinstance(case.weights, dict):
        load_flat(spec.module, case.weights)
    elif case.weights == "seeded":
        load_flat(spec.module, seeded_flat(case.codec, 0))
    else:
        load_asset(spec.module, case.weights)
    return spec, ready_for_training(spec)


def sources(case: Case, device: str):
    """The case's noise: one source a clip (batched) or one source."""
    if case.draws is not None:
        made = [Replay(d) for d in case.draws]
    else:
        from fastvideocodec_torch.ops.math import UniformNoise

        clips = case.gop.shape[0] if case.batched else 1
        made = [UniformNoise(case.seed + b, device=device) for b in range(clips)]
    return made if case.batched else made[0]


def want_launches(case: Case, module, coord: tuple | None) -> dict:
    """The warp launches of the case's step on the rank at mesh ``coord``
    (None: the single-process step), from the code: LSVC-TPU's SpyNet
    warps flow_warp at its 4 levels and its backward at the 3 finer ones,
    and each tree layer warps flow_warp_s2d forward and backward; SSF-TPU
    warps pixel_warp and pixel_warp_s2d_sflow once a P-frame forward and
    backward, MCVC-IA pixel_warp. A rank launches a kernel on a call only
    when it holds rows of it."""
    from fastvideocodec_torch.parallel.collectives import split_rows

    data, view, frame = case.mesh
    if case.batched:
        clips = case.gop.shape[0] // (data if coord is not None else 1)
        p_frames = case.gop.shape[1] - 1
    else:
        clips, p_frames = 1, case.gop.shape[0] - 1
    if case.codec.startswith("MCVC"):
        per = {"pixel_warp": p_frames, "pixel_warp_backward": p_frames}
    elif case.codec.startswith("SSF"):
        per = {f"{k}{part}": p_frames for k in ("pixel_warp", "pixel_warp_s2d_sflow")
               for part in ("", "_backward")}
    else:
        parts = frame if (coord is not None and case.frame_sharded) else 1
        index = coord[2] if parts > 1 else 0

        def held(n):
            return split_rows(n, parts)[index] > 0

        layers = sum(held(len(part)) for layer in module.schedule(p_frames).layers
                     for part in module.chunks(layer))
        spynet = held(p_frames)
        per = {"flow_warp": 4 * spynet, "flow_warp_backward": 3 * spynet,
               "flow_warp_s2d": layers, "flow_warp_s2d_backward": layers}
    return {k: v * clips for k, v in per.items() if v}


@contextlib.contextmanager
def counted_warps(device: str):
    """The launch counts zeroed for the scope, and the plain warps and vjps
    counted (on the CPU they are the path): yields (launches, plain calls),
    filled at the end."""
    from fastvideocodec_torch.ops import warp as ow
    from fastvideocodec_torch.ops.kernels import warp as kw

    launches, calls = {}, {}
    saved = dict(ow.PLAIN), dict(ow.PLAIN_BACKWARD)

    def counting(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        return wrapped

    if device == "cuda":
        ow.PLAIN.update({n: counting(n, f) for n, f in saved[0].items()})
        ow.PLAIN_BACKWARD.update({n: counting(f"{n} vjp", f) for n, f in saved[1].items()})
    kw.reset_launches()
    try:
        yield launches, calls
    finally:
        ow.PLAIN.update(saved[0])
        ow.PLAIN_BACKWARD.update(saved[1])
        if device == "cuda":
            torch.cuda.synchronize()
        launches.update({k: v for k, v in kw.LAUNCHES.items() if v})


def run_steps(step_fn, params, opt_state, gop, noise, mask, steps: int, device: str,
              branches: RowBranches | None = None):
    """``steps`` steps on the same inputs (each with fresh noise from
    ``noise()``, the first on ``branches`` when given): the first's
    metrics, gradients and parameters after it, each step's ms (CUDA
    events on the card, else the host clock) and host enqueue ms, and the
    first step's launches, plain calls and branch flips."""
    times, enqueue, first = [], [], None
    for i in range(steps):
        if device == "cuda":
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        on_branches = branches if i == 0 and branches is not None else contextlib.nullcontext()
        with counted_warps(device) if i == 0 else contextlib.nullcontext((None, None)) as (
                launches, calls), on_branches:
            t0 = time.perf_counter()
            args = (gop, noise()) if mask is None else (gop, noise(), mask)
            params, opt_state, metrics = step_fn(params, opt_state, *args)
            enqueue.append((time.perf_counter() - t0) * 1e3)
            if device == "cuda":
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            else:
                times.append(enqueue[-1])
        if i == 0:
            first = {"metrics": {k: float(v) for k, v in metrics.items()},
                     "grads": {n: g.detach().float().cpu()
                               for n, g in step_fn.optimizer.grads.items()},
                     "params": {n: p.detach().cpu().clone() for n, p in params.items()},
                     "launches": launches, "plain_calls": calls,
                     "flips": None if branches is None else branches.flips}
    first.update(ms=times, enqueue_ms=enqueue)
    return first


def recording_optimizer(cfg):
    """The trainer's optimizer, keeping the gradients of its last update."""
    from fastvideocodec_torch.train.trainer import Optimizer

    class Recording(Optimizer):
        def update(self, grads, state, params):
            self.grads = {n: g.detach().clone() for n, g in grads.items()}
            return super().update(grads, state, params)

    return Recording(cfg)


def make_step(spec, case: Case, mesh):
    from fastvideocodec_torch.train import TrainConfig, make_train_step

    cfg = TrainConfig(learning_rate=LR)
    tx = recording_optimizer(cfg)
    init_fn, step_fn = make_train_step(spec, cfg, optimizer=tx, batched=case.batched, mesh=mesh)
    step_fn.optimizer = tx
    return init_fn, step_fn


def case_branches(case: Case, clips, frame_axis: str = "") -> RowBranches | None:
    """The case's recorded branches of ``clips``, in order, or None."""
    if case.branches is None:
        return None
    return RowBranches([m for b in clips for m in case.branches[b]], frame_axis)


def grad_gaps(got: dict, want: dict) -> dict:
    """Each gradient's max abs gap over its own max |grad|."""
    return {n: float((got[n].double() - want[n].double()).abs().max())
            / max(float(want[n].double().abs().max()), 1e-300) for n in want}


def compare(got: dict, want: dict, top: int = 3) -> dict:
    """``got``'s step against ``want``'s (``run_steps``'s results): the
    losses and their relative gap, the worst gradient gap (``grad_gaps``)
    and where, the ``top`` worst with each one's max |grad| over the
    largest of all (a gradient far below the largest is a sum that cancels,
    its float32 rounding large beside it), and the parameters' max abs gap
    after the step."""
    loss, loss_ref = got["metrics"]["loss"], want["metrics"]["loss"]
    gaps = grad_gaps(got["grads"], want["grads"])
    scale = {n: float(g.double().abs().max()) for n, g in want["grads"].items()}
    largest = max(max(scale.values()), 1e-300)
    worst = sorted(gaps, key=gaps.get, reverse=True)
    return {"loss": loss, "loss_ref": loss_ref,
            "loss_rel": abs(loss - loss_ref) / max(1.0, abs(loss_ref)),
            "grad_gap": gaps[worst[0]], "grad_gap_at": worst[0],
            "worst_grads": [[n, gaps[n], scale[n] / largest] for n in worst[:top]],
            "param_abs": max(float((got["params"][n] - want["params"][n]).abs().max())
                             for n in want["params"])}


def run_case(case: Case, device: str, reference: bool = True, steps: int = 1,
             tensors: bool = False, rerun: bool = False) -> dict:
    """The case on this rank (every rank of the group calls it): rank 0's
    single-process step first when ``reference`` (with ``rerun``, a second
    time: the device's own run-to-run gap), then the sharded step on
    every rank. Returns this rank's results: the sharded step's metrics,
    launches, plain calls, ms and enqueue ms, whether its parameters after
    the step equal rank 0's bit for bit, and on rank 0 the gaps to the
    reference (its loss, the worst gradient gaps, those of the rerun) and,
    with ``tensors``, both steps' gradients and parameters."""
    from fastvideocodec_torch.parallel import frame_sharded_spec, make_mesh, replicate
    from fastvideocodec_torch.parallel.mesh import GopSharding

    rank = dist.get_rank()
    mesh = make_mesh(*case.mesh, device_type=device)
    spec, params = build(case, device)
    replicate(mesh, params)
    gop = torch.from_numpy(case.gop).to(device)
    mask = None if case.mask is None else torch.from_numpy(case.mask).to(device)
    initial = {n: p.detach().clone() for n, p in params.items()}

    def restore():
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(initial[n])

    out = {}
    if reference and rank == 0:
        init_fn, step_fn = make_step(spec, case, None)
        clips = range(gop.shape[0] if case.batched else 1)
        runs = []
        for n in (steps, 1)[:1 + rerun]:  # the rerun: its first step only
            runs.append(run_steps(step_fn, params, init_fn(params), gop,
                                  lambda: sources(case, device), mask, n, device,
                                  case_branches(case, clips)))
            restore()
        out["reference"] = runs[0]
        out["reference"]["want_launches"] = want_launches(case, spec.module, None)
        if rerun:
            out["rerun"] = compare(runs[1], runs[0])
    dist.barrier()
    if case.batched:
        local = GopSharding(mesh, 0, ("data",))
    elif case.codec.startswith("MCVC"):
        local = GopSharding(mesh, 1, ("data", "view"))
    else:
        local = GopSharding(mesh, 0, ())
    part_mask = None
    if mask is not None:
        part_mask = GopSharding(mesh, 1 if case.batched else 0, local.axes)(mask)
    init_fn, step_fn = make_step(frame_sharded_spec(spec) if case.frame_sharded else spec,
                                 case, mesh)
    own = local(gop)
    clips = range(local.rows(gop.shape[0]).start, local.rows(gop.shape[0]).stop) \
        if case.batched else range(1)
    sharded = run_steps(step_fn, params, init_fn(params), own, lambda: sources(case, device),
                        part_mask, steps, device,
                        case_branches(case, clips, "frame" if case.frame_sharded else ""))
    flat = torch.cat([p.reshape(-1) for p in sharded["params"].values()]).to(device)
    first = flat.clone()
    dist.broadcast(first, src=0)
    sharded["identical"] = bool(torch.equal(flat, first))
    sharded["coord"] = list(mesh.get_coordinate())
    sharded["want_launches"] = want_launches(case, spec.module, tuple(sharded["coord"]))
    sharded["blocked_modules"] = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    ref = out.get("reference")
    if ref is not None:
        out["gaps"] = compare(sharded, ref)
    if not tensors or rank != 0:
        sharded.pop("grads")
        sharded.pop("params")
        if ref is not None:
            ref.pop("grads")
            ref.pop("params")
    out["sharded"] = sharded
    del spec, params
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def launch_on_card(world: int = 4, timeout: float = 300.0, steps: int = 3) -> tuple:
    """This tool's launcher in a process of its own session, the four halves
    on ``world`` ranks sharing the card over gloo, ``steps`` steps each:
    (its exit code, its output, its JSON report or None). At ``timeout``
    seconds the session, launcher and ranks, is killed and RuntimeError
    raised; the launcher's own timeout is 20 s shorter."""
    import signal

    with tempfile.TemporaryDirectory(prefix="dryrun_multichip_") as d:
        path = Path(d) / "dryrun.json"
        cmd = [sys.executable, "-m", "fastvideocodec_torch.tools.dryrun_multichip", str(world),
               "--device", "cuda", "--steps", str(steps), "--json", str(path),
               "--timeout", str(timeout - 20)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                start_new_session=True, cwd=str(Path(__file__).parents[2]))
        try:
            out, _ = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            out, _ = proc.communicate()
            raise RuntimeError(f"the dry run did not end within {timeout} s:\n{out[-6000:]}")
        return proc.returncode, out, json.loads(path.read_text()) if path.exists() else None


def nccl_world_of_one(half: str = "lsvc_dp") -> dict:
    """A data-parallel half's batch at N = 4 (4 clips) on a mesh of one rank
    over NCCL on cuda:0, in this process, under
    ``coder.video.deterministic_convs``: ``run_case``'s results, the
    single-process step run twice. The process group is brought up and
    torn down here."""
    import dataclasses

    from fastvideocodec_torch.coder.video import deterministic_convs

    case = dataclasses.replace(halves(4, False, (half,))[0], mesh=(1, 1, 1))
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", world_size=1,
                            rank=0)
    try:
        with deterministic_convs():
            return run_case(case, "cuda", rerun=True)
    finally:
        dist.destroy_process_group()


def rank_main(args) -> int:
    from fastvideocodec_torch.coder.video import deterministic_convs

    device = args.device
    if device == "cpu":
        torch.set_num_threads(1)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from fastvideocodec_torch.parallel import initialize

    initialize(f"localhost:{args.port}", args.world, args.rank, backend="gloo")
    cases = load_cases(args.cases) if args.cases else halves(args.world, args.tiny)
    results = {}
    for case in cases:
        t0 = time.perf_counter()
        with deterministic_convs():
            results[case.name] = run_case(case, device, reference=not args.no_reference,
                                          steps=args.steps, tensors=args.out is not None,
                                          rerun=device == "cuda")
        results[case.name]["seconds"] = time.perf_counter() - t0
    if args.out is not None:
        torch.save(results, Path(args.out) / f"rank{args.rank}.pt")
    else:
        print("RESULTS " + json.dumps(results), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Launch:
    """N ranks of this module started as processes (``start``); ``wait``
    joins them within the timeout, kills them all when one fails or the
    time runs out, and returns each rank's stdout or raises RuntimeError
    with the failed ranks' output."""

    def __init__(self, world: int, argv: list, timeout: float, env: dict | None = None):
        self.world, self.timeout = world, timeout
        self.dir = tempfile.TemporaryDirectory(prefix="dryrun_multichip_")
        port = free_port()
        env = dict(os.environ if env is None else env)
        env.setdefault("OMP_NUM_THREADS", "1")
        self.start = time.monotonic()
        self.procs, self.logs = [], []
        for rank in range(world):
            out = open(Path(self.dir.name) / f"rank{rank}.log", "w+")
            cmd = [sys.executable, "-m", "fastvideocodec_torch.tools.dryrun_multichip",
                   str(world), "--rank", str(rank), "--port", str(port), *argv]
            self.procs.append(subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT,
                                               env=env, cwd=str(Path(__file__).parents[2])))
            self.logs.append(out)

    def _read(self, rank: int) -> str:
        self.logs[rank].flush()
        self.logs[rank].seek(0)
        return self.logs[rank].read()

    def wait(self) -> list:
        try:
            while True:
                codes = [p.poll() for p in self.procs]
                failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
                late = time.monotonic() - self.start > self.timeout
                if failed or late:
                    for p in self.procs:
                        p.kill()
                    for p in self.procs:
                        p.wait()
                    why = (f"rank(s) {failed} failed" if failed
                           else f"the ranks did not end within {self.timeout} s")
                    shown = failed or range(self.world)
                    raise RuntimeError(why + "".join(
                        f"\n--- rank {r} ---\n{self._read(r)[-6000:]}" for r in shown))
                if all(c == 0 for c in codes):
                    return [self._read(r) for r in range(self.world)]
                time.sleep(0.2)
        finally:
            for f in self.logs:
                f.close()
            self.dir.cleanup()


def summary(results: dict, device: str, world: int) -> dict:
    """The halves' numbers from rank 0's results and every rank's sharded
    results ({rank: results}), with the gates each failed."""
    out = {}
    for name, res0 in results[0].items():
        ref, gaps = res0["reference"], res0["gaps"]
        ranks = [results[r][name]["sharded"] for r in range(world)]
        steady = lambda ms: ms[1:] or ms  # noqa: E731 (the steps after the first)
        row = {**gaps, "grad_bar": GRAD_REL, "loss_bar": LOSS_REL,
               "ms_sharded_by_rank": [s["ms"] for s in ranks],
               "ms_single": ref["ms"],
               "ms_sharded_median": float(np.median(steady(ranks[0]["ms"]))),
               "ms_single_median": float(np.median(steady(ref["ms"]))),
               "enqueue_ms_by_rank": [s["enqueue_ms"] for s in ranks],
               "launches_by_rank": [s["launches"] for s in ranks],
               "want_launches_by_rank": [s["want_launches"] for s in ranks],
               "launches_single": ref["launches"], "want_launches_single": ref["want_launches"],
               "plain_calls": [s["plain_calls"] for s in ranks] + [ref["plain_calls"]],
               "identical": all(s["identical"] for s in ranks),
               "blocked_modules": sorted({m for s in ranks for m in s["blocked_modules"]}),
               "seconds": res0["seconds"], "rerun": res0.get("rerun")}
        fails = []
        if not row["loss_rel"] <= LOSS_REL:
            fails.append("loss")
        if not row["grad_gap"] <= GRAD_REL:
            fails.append("gradient")
        if not row["identical"]:
            fails.append("ranks not bit-identical")
        if row["blocked_modules"]:
            fails.append("a rank imported JAX")
        if device == "cuda":
            if any(row["plain_calls"]):
                fails.append("plain warps")
            if row["launches_by_rank"] != row["want_launches_by_rank"] or \
                    row["launches_single"] != row["want_launches_single"]:
                fails.append("launches")
        row["failed"] = fails
        out[name] = row
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("world", type=int, help="ranks")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--tiny", action="store_true", help="the -TINY models at 64x64")
    ap.add_argument("--steps", type=int, default=1, help="steps of each, the first compared")
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--json", default=None, help="also write the numbers here")
    ap.add_argument("--cases", default=None, help="a save_cases file in place of the halves")
    ap.add_argument("--out", default=None, help="write each rank's results here (with --cases)")
    ap.add_argument("--no-reference", action="store_true",
                    help="skip the single-process step (the caller runs it)")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def forwarded(args) -> list:
    """The options a rank takes from the launcher's."""
    out = ["--device", args.device, "--steps", str(args.steps)]
    out += ["--tiny"] * args.tiny + ["--no-reference"] * args.no_reference
    for opt in ("cases", "out"):
        if getattr(args, opt) is not None:
            out += [f"--{opt}", str(getattr(args, opt))]
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.rank is not None:
        return rank_main(args)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("dryrun_multichip --device cuda needs a CUDA card")
    t0 = time.perf_counter()
    outputs = Launch(args.world, forwarded(args), args.timeout).wait()
    if args.out is not None:
        return 0
    results = {}
    for rank, text in enumerate(outputs):
        lines = [ln for ln in text.splitlines() if ln.startswith("RESULTS ")]
        results[rank] = json.loads(lines[-1][len("RESULTS "):])
    rows = summary(results, args.device, args.world)
    for name, row in rows.items():
        print(f"{name}: loss {row['loss']:.6f} (single process {row['loss_ref']:.6f}, rel "
              f"{row['loss_rel']:.2e}); worst gradient gap {row['grad_gap']:.2e} at "
              f"{row['grad_gap_at']}; ranks identical {row['identical']}; ms a step sharded "
              f"{row['ms_sharded_median']:.3f}, single {row['ms_single_median']:.3f}; "
              f"launches by rank {row['launches_by_rank']}; failed {row['failed']}", flush=True)
    report = {"world": args.world, "device": args.device, "tiny": args.tiny,
              "seconds": time.perf_counter() - t0, "halves": rows}
    if args.json:
        Path(args.json).write_text(json.dumps(report))
    print(json.dumps(report), flush=True)
    return 1 if any(row["failed"] for row in rows.values()) else 0


if __name__ == "__main__":
    raise SystemExit(main())
