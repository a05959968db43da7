"""The offline tools and the last library modules on the card:
``chip_smoke.py``'s phases 65-68, also runnable alone on a CUDA card.

    python -m fastvideocodec_torch.tools.tools_smoke

65. ``tools/train_tiny.py`` on the card: LSVC-TPU (``lsvctpuf2_hd``: full
    reference widths, 128x128, GOP 8) 10 steps at level 2; SSF-TPU-TINY,
    ELFVC-SP-TPU-TINY (the default stage and sp_stages 0-2) and
    MCVC-IA-TINY 2 steps each through their recipes, from the port's seeded
    initialisers. Every loss is finite; each LSVC-TPU step launches both
    flow warps' forward and backward kernels (4 + 3 forward, 3 + 3 backward
    at GOP 8), no plain warp and no plain vjp; each written npz has exactly
    the keys, shapes and float16 dtype of the shipped asset of its name and
    loads back to the float16-rounded parameters bit for bit. ms/step
    beside the host's enqueue ms/step.
66. The streaming simulation on the card's decode times: ``evaluate_video``
    estimated-bits records of LSVC-TPU at levels 0 and 4 (hd_lsvctpuf2_l0,
    _l4) on phase 61's 33-frame 1024x2048 clip, bf16, GOP 16, the decode
    graph timed, appended to phase 61's log; ``cli/simulate.py`` over it
    (three levels, 20 seeded traces), and ``--task trace`` over phase 62's
    ``MCVC-IA.avg.log``. The decode times read back are the card's
    (nonzero), and both runs print finite QoE, quality and bpp.
67. The library modules: ``warp_volume_pyramid`` at 1 x (3 + 15) x
    1024x2048 bf16, bit for bit its plain version, exactly 2 ``pixel_warp``
    launches; ``ContextVP`` (4 views, 16x16, 48 wide, seeded) on the card
    against the CPU within CVP_REL; ``flow_to_image`` of LSVC-TPU's SpyNet
    flow (hd_lsvctpuf2_l2) between frames 1 and 0 of the seed-0 clip, and a
    ``.flo`` round trip; the three knobs (``GaussianConditional`` without
    means, ``ScaleSpaceFlow(s2d=2, pipeline_s2d=False)``, MCVC-IA with
    ``use_attn=False``), each built and run once.
68. ``tools/speed_sweep.py``: LSVC-TPU's GOP sweep 2/4/8/16/30 and the SSF
    family's encode sweep at 1024x2048 bf16, JAX's keys on their lines.

The hd head-to-head (``tools/price_hd.py``) runs in ``chip_smoke.py``'s
own phase of LSVC's forms.
"""

from __future__ import annotations

import contextlib
import json
import math
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import fastvideocodec_torch as ft
from fastvideocodec_torch.cli import simulate
from fastvideocodec_torch.data.synthetic import synth_gop, synth_gop_multi
from fastvideocodec_torch.layers import ContextVP
from fastvideocodec_torch.ops import warp as ow
from fastvideocodec_torch.ops.kernels import warp as kw
from fastvideocodec_torch.tools import eval_smoke, speed_sweep
from fastvideocodec_torch.tools import train_tiny as tt
from fastvideocodec_torch.tools.eval_smoke import H, W, plain_calls
from fastvideocodec_torch.train import evaluate as ev
from fastvideocodec_torch.utils.flowviz import flow_to_image, read_flo, write_flo
from fastvideocodec_torch.utils.logs import read_eval_log
from fastvideocodec_torch.weights import asset_path, load_flat, seeded_params

# (family, level, steps, the shipped asset whose layout its npz must have)
TRAIN_TINY = [("lsvctpuf2_hd", 2, 10, "hd_lsvctpuf2_l2"), ("ssftpu", 2, 2, "tiny_ssftpu_l2"),
              ("elfvctpu", 3, 2, "tiny_elfvctpu_l3"), ("mcvc", 3, 2, "tiny_mcvc_l3")]
# LSVC-TPU's launches a training step at GOP 8 (a tree of 3 layers): each
# SpyNet level and tree layer forward, the 3 finer levels' and every
# layer's backward (chip_smoke.py:train_launches_of)
LSVC_GOP8_STEP = {"flow_warp": 4, "flow_warp_s2d": 3, "flow_warp_backward": 3,
                  "flow_warp_s2d_backward": 3}
SIM_LEVELS = (0, 4)  # beside phase 61's level 2
CVP_REL = 1e-4  # ContextVP card (SDPA) against CPU (two matmuls), of the output's max
GOP = 16


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"tools smoke failed: {msg}")


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    log(f"== phase {name}")
    yield
    log(f"== phase {name}: {time.perf_counter() - t0:.3f} s")


def counted(launches: dict, path: str):
    """Zeroes the launch counts; the returned callable stores the nonzero
    ones under ``path``."""
    kw.reset_launches()
    return lambda: launches.__setitem__(path, {k: v for k, v in kw.LAUNCHES.items() if v})


def train_tiny_phase(out: dict, launches: dict, tmp: Path, smi: str) -> None:
    rows = out["train_tiny"] = {}
    for family, level, steps, asset in TRAIN_TINY:
        calls = {}
        done = counted(launches, f"train_tiny_{family}")
        with plain_calls(calls):
            spec, trained = tt.train_family(family, level, steps=steps, device="cuda", out=log)
        torch.cuda.synchronize()
        done()
        losses = [float(v) for v in trained.losses]
        path = tt.save_f16(spec, tmp / "assets", family, level)
        with np.load(path) as written, np.load(asset_path(asset)) as shipped:
            layout = {k: (written[k].shape, written[k].dtype) for k in written.files}
            want = {k: (shipped[k].shape, shipped[k].dtype) for k in shipped.files}
            reloaded = tt.FAMILIES[family].spec(level, "cuda")
            load_flat(reloaded.module, {k: written[k] for k in written.files})
        trained_params = dict(spec.module.named_parameters())
        exact = all(torch.equal(p, trained_params[n].detach().half().float())
                    for n, p in reloaded.module.named_parameters())
        row = {"codec": spec.name, "level": level, "steps": trained.steps,
               "ms_per_step": trained.ms_per_step,
               "enqueue_ms_per_step": trained.enqueue_ms_per_step, "losses": losses,
               "launches": launches[f"train_tiny_{family}"], "plain_calls": calls,
               "npz": path.name, "layout_is_shipped": layout == want, "reload_exact": exact}
        rows[family] = row
        log(f"train_tiny {family} l{level} ({smi}): {trained.steps} steps, "
            f"{trained.ms_per_step:.3f} ms/step (host enqueue {trained.enqueue_ms_per_step:.3f}); "
            f"losses {[round(v, 3) for v in losses]}; launches {row['launches']}; "
            f"{path.name} in {asset}'s layout {row['layout_is_shipped']}, reloads exactly {exact}")
        require(all(math.isfinite(v) for v in losses), f"{family}: a loss is not finite")
        require(not calls, f"{family}: plain warps or vjps called {calls}")
        require(row["layout_is_shipped"], f"{family}: {path.name} is not in {asset}'s layout")
        require(exact, f"{family}: {path.name} does not reload to the float16-rounded parameters")
        if family == "lsvctpuf2_hd":
            want_launches = {k: v * steps for k, v in LSVC_GOP8_STEP.items()}
            require(row["launches"] == want_launches,
                    f"{family}: launches {row['launches']}, want {want_launches}")
        del spec, reloaded, trained


def simulation_phase(out: dict, launches: dict, tmp: Path, smi: str) -> None:
    env = out["environment"]
    log_path = tmp / "estimated.log"
    frames = 2 * GOP + 1
    for level in SIM_LEVELS:
        spec = ft.get_codec_model("LSVC-TPU", dtype=torch.bfloat16, device="cuda")
        ft.load_asset(spec.module, f"hd_lsvctpuf2_l{level}")
        ds, source = eval_smoke.eval_clip(tmp, env, frames)
        done = counted(launches, f"lsvc_eval_estimated_l{level}")
        stats = ev.evaluate_video(spec, ds, gop_size=GOP, log_path=str(log_path), level=level,
                                  compress_iframe=False)
        done()
        log(f"eval level {level} ({smi}; {source}): bpp {stats['bpp']:.6f} psnr "
            f"{stats['psnr']:.4f}; dec {stats['dec_sec_per_frame'] * 1e3:.3f} ms/frame")
        del spec, ds
    headers = [h for h, _ in read_eval_log(str(log_path))]
    out["eval_log"] = headers
    levels = sorted({h["level"] for h in headers})
    log(f"phase 61's log now holds levels {levels}: dec_t {[h['dec_t'] for h in headers]} "
        "s/frame")
    require(levels == [0, 2, 4], f"the log's levels {levels}")
    require(all(h["dec_t"] > 0 for h in headers), "a decode time reads 0 s/frame")
    (_, abr), = simulate.main(["--logs", str(log_path), "--num-traces", "20"])
    out["abr"] = {k: [float(x) for x in abr[k]] for k in ("qoe", "quality", "rebuffer",
                                                          "stall", "bw")}
    out["abr"]["decode_s_per_gop"] = [float(x) for x in abr["tables"][2][:, 0]]
    require(all(np.isfinite(abr[k]).all() for k in ("qoe", "quality", "rebuffer", "bw")),
            "BOLA's numbers are not finite")
    mv_log = tmp / "MCVC-IA.avg.log"
    rows = simulate.main(["--task", "trace", "--logs", str(mv_log)])
    out["trace"] = [(cat, res) for _, cat, res in rows]
    require(rows and all(math.isfinite(res["bpp"]) and math.isfinite(res["psnr"])
                         for _, _, res in rows), f"the trace simulation's rows {rows}")


def modules_phase(out: dict, launches: dict, tmp: Path, smi: str) -> None:
    rows = out["modules"] = {}
    gen = torch.Generator(device="cuda").manual_seed(7)
    C, levels = 3, 5
    level0 = torch.rand((1, C, H, W), generator=gen, device="cuda").to(torch.bfloat16)
    vol_half = torch.rand((1, levels * C, H // 2, W // 2), generator=gen,
                          device="cuda").to(torch.bfloat16)
    flow = (torch.rand((1, 2, H, W), generator=gen, device="cuda") - 0.5) * 0.1
    scale = torch.rand((1, 1, H, W), generator=gen, device="cuda") * 2.2 - 1.1
    calls = {}
    done = counted(launches, "warp_volume_pyramid")
    with plain_calls(calls):
        got = ow.warp_volume_pyramid(level0, vol_half, flow, scale, levels)
    torch.cuda.synchronize()
    done()
    saved = ow._dispatch
    ow._dispatch = lambda name, img, f: ow.PLAIN[name](img, f)
    try:
        want = ow.warp_volume_pyramid(level0, vol_half, flow, scale, levels)
    finally:
        ow._dispatch = saved
    same = bool(torch.equal(got, want))
    rows["warp_volume_pyramid"] = {"launches": launches["warp_volume_pyramid"],
                                   "bit_for_bit": same, "plain_calls": calls}
    log(f"warp_volume_pyramid 1 x (3 + 15) x {H}x{W} bf16 ({smi}): bit for bit {same}; "
        f"launches {launches['warp_volume_pyramid']}")
    require(same, "warp_volume_pyramid differs from its plain version")
    require(launches["warp_volume_pyramid"] == {"pixel_warp": 2} and not calls,
            f"warp_volume_pyramid launches {launches['warp_volume_pyramid']}, plain {calls}")
    del level0, vol_half, flow, scale, got, want

    cvp = ContextVP(in_channels=48, out_channels=48, num_views=4, width=16, height=16)
    load_flat(cvp, seeded_params(cvp, 0))
    x = torch.randn((4, 48, 16, 16), generator=torch.Generator().manual_seed(8))
    with torch.no_grad():
        cpu = cvp(x)
        card = cvp.cuda()(x.cuda()).cpu()
    rel = float((card - cpu).abs().max() / cpu.abs().max())
    rows["contextvp"] = {"card_vs_cpu_rel": rel, "tolerance": CVP_REL}
    log(f"ContextVP 4 views x 16x16 x 48 ({smi}): card (SDPA) against the CPU {rel:.2e} of the "
        f"output's max (tolerance {CVP_REL})")
    require(rel <= CVP_REL, "ContextVP card vs CPU")

    spec = ft.get_codec_model("LSVC-TPU", device="cuda")
    ft.load_asset(spec.module, "hd_lsvctpuf2_l2")
    clip = ev._nchw(synth_gop_multi(np.random.default_rng(0), size=256, gop=2), "cuda")
    with torch.no_grad():
        _, x_flow = spec.module.fold(clip)
        flo = spec.module.optic_flow(x_flow[1:2], x_flow[0:1])[0].permute(1, 2, 0).float().cpu()
    img = flow_to_image(flo.numpy())
    write_flo(str(tmp / "spynet.flo"), flo.numpy())
    round_trip = bool(np.array_equal(read_flo(str(tmp / "spynet.flo")), flo.numpy()))
    rows["flowviz"] = {"flow_shape": list(flo.shape), "image_shape": list(img.shape),
                       "max_px": float(flo.abs().max()), "flo_round_trip": round_trip}
    log(f"flow_to_image of LSVC-TPU's SpyNet flow ({smi}): {rows['flowviz']}")
    require(img.dtype == np.uint8 and img.shape == (*flo.shape[:2], 3) and round_trip,
            "flowviz")
    del spec, clip

    from fastvideocodec_torch.entropy.gaussian import GaussianConditional
    from fastvideocodec_torch.models.ssf import ScaleSpaceFlow

    y = torch.randn((1, 48, 8, 8), device="cuda") * 3
    y_hat, lik = GaussianConditional()(y, torch.full_like(y, 1.5), None)
    ssf = ScaleSpaceFlow(mid_planes=32, planes=48, s2d=2, pipeline_s2d=False).cuda().eval()
    load_flat(ssf, seeded_params(ssf, 0))
    frames = ev._nchw(synth_gop(np.random.default_rng(0), size=64, gop=3), "cuda")[:, None]
    with torch.no_grad():
        recon, _ = ssf(frames)
    mcvc = ft.get_codec_model("MCVC-IA-TINY", device="cuda", num_views=3, use_attn=False)
    load_flat(mcvc.module, seeded_params(mcvc.module, 0))
    mv = torch.from_numpy(tt._mv_gen(np.random.default_rng(0))).permute(0, 1, 4, 2, 3).cuda()
    _, m = ft.rollout(mcvc, mv.contiguous(), torch.ones(3, device="cuda"))
    rows["knobs"] = {"gaussian_no_means": bool(torch.equal(y_hat, torch.round(y))
                                               and torch.isfinite(lik).all()),
                     "ssf_s2d_no_pipeline": bool(torch.isfinite(recon).all()),
                     "mcvc_no_attention_psnr": float(m["psnr"].float().mean())}
    log(f"the three knobs ({smi}): {rows['knobs']}")
    require(rows["knobs"]["gaussian_no_means"] and rows["knobs"]["ssf_s2d_no_pipeline"]
            and math.isfinite(rows["knobs"]["mcvc_no_attention_psnr"]), "a knob")


def run(smi: str = "", eval_dir: Path | None = None) -> dict:
    """Phases 65-68 on the CUDA card, its kernels built; ``eval_dir`` holds
    phases 61-62's files (``eval_smoke.run(workdir=...)``; without it they
    run here first). Returns the numbers, the launch counts by path
    (``launches``) among them."""
    out = {"launches": {}, "card": smi, "environment": eval_smoke.environment()}
    launches = out["launches"]
    tmp = Path(tempfile.mkdtemp(prefix="tools_smoke_"))
    try:
        if eval_dir is None:
            eval_dir = tmp / "eval"
            eval_smoke.run(smi, workdir=eval_dir)
        with phase("train_tiny on the card: lsvctpuf2_hd 128x128 GOP8 full width 10 steps; "
                   "ssftpu, elfvctpu (4 stages), mcvc 2 steps"):
            train_tiny_phase(out, launches, tmp, smi)
        with phase(f"streaming simulation on the card's decode times: LSVC-TPU levels 0, 2, 4 "
                   f"at {H}x{W} GOP{GOP} bf16; cli/simulate.py abr and trace"):
            simulation_phase(out, launches, Path(eval_dir), smi)
        with phase("library modules: warp_volume_pyramid, ContextVP, flowviz, the three knobs"):
            modules_phase(out, launches, tmp, smi)
        with phase(f"speed_sweep: LSVC-TPU GOP 2/4/8/16/30 and the SSF encode sweep, {H}x{W} "
                   "bf16"):
            done = counted(launches, "speed_sweep")
            out["speed_sweep"] = speed_sweep.main(["--device", "cuda"])
            done()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("tools_smoke needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from fastvideocodec_torch.ops.kernels import build

    build.load()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps(run(smi), default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
