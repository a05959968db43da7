"""Multi-view MCVC trainer CLI of the port, ported from
fastvideocodec_tpu/cli/train_multiview.py (reference train_multiview.py):
per-category training of MCVC on the MMPTracking cameras, with
MCVC-IA-OLFT's online fine-tuning (touch-up labels priced on the host),
view-failure masks (``--resilience``) and the category-keyed checkpoint
directory (train_multiview.py:107-303, 570-894). Vimeo-style pretraining
is ``cli.train``'s.

Usage:
  python -m fastvideocodec_torch.cli.train_multiview --dataset-dir /data/MMPTRACKING \\
      --codec MCVC-IA-OLFT --category 0 --steps 200

It runs on the card unless ``--device cpu``, in float32. Weights start from
the numpy-seeded initialisers of ``weights.seeded_flat`` (``--seed``), the
quantization noise from a generator seeded likewise, and a host
``default_rng(--seed)`` draws each step's clip and then its view mask, as
the JAX CLI's does. ``--task train`` only: ``speed``, ``eval`` and ``x26x``
wait for a later slice (ROADMAP.md queue 1, items 7.6 and 9).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from fastvideocodec_torch.cli.train import init_params, on_device
from fastvideocodec_torch.data import MultiViewVideoDataset
from fastvideocodec_torch.models import get_codec_model, sample_view_mask
from fastvideocodec_torch.ops.math import UniformNoise
from fastvideocodec_torch.train import (
    TrainConfig,
    load_checkpoint,
    make_olft_step,
    make_train_step,
    probe_sample_interval,
    ready_for_training,
    save_checkpoint,
)
from fastvideocodec_torch.train.olft import touchup_bytes
from fastvideocodec_torch.utils import AverageMeter, write_eval_log

# the tasks of the JAX CLI that wait for a later slice, and the ROADMAP.md
# items (queue 1) that bring them
LATER_TASKS = {"speed": "7.6", "eval": "7.6", "x26x": "7.6 and 9"}


def parse_args(argv=None):
    p = argparse.ArgumentParser("fvc-train-multiview")
    p.add_argument("--codec", default="MCVC-IA-OLFT")
    p.add_argument("--dataset-dir", default="")
    p.add_argument("--category", type=int, default=0)
    p.add_argument("--compression-level", type=int, default=2)
    p.add_argument("--loss-type", default="P", choices=["P", "M"])
    p.add_argument("--gop", type=int, default=16)
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--resilience", type=int, default=0)
    p.add_argument("--force-resilience", type=int, default=-1)
    p.add_argument("--sample-ratio", type=float, default=0.1)
    p.add_argument("--c2s-ratio", type=float, default=1.0)
    p.add_argument("--sample-interval", type=int, default=0)
    p.add_argument("--max-pool-size", type=int, default=0)
    p.add_argument("--ckpt-dir", default="backup")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--debug", action="store_true", help="exit after 10 batches")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--frame-size", type=int, default=256)
    p.add_argument("--task", default="train", choices=["train", "speed", "x26x", "eval"],
                   help="train (speed, x26x and eval are not ported yet)")
    p.add_argument("--log-key", default="",
                   help="per-experiment log family key (cat/c2s/sr/si/mps/dr/sisr/ablation/"
                        "longterm): a '<value>,<level>,<bpp>,<psnr>,<touch bpp>' row is "
                        "appended to {codec}.{key}.log (train_multiview.py:603-894)")
    p.add_argument("--log-key-value", default="",
                   help="the swept variable's value in the --log-key row (default: the "
                        "category's name)")
    p.add_argument("--probe-bw-limit", type=float, default=0.0,
                   help=">0: probe the OLFT touch-up rate (bits/s) and set the frame "
                        "sampling interval to fit this budget")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p.parse_args(argv)


def _later(task: str):
    return SystemExit(f"--task {task} is not ported yet (ROADMAP.md queue 1, item "
                      f"{LATER_TASKS[task]})")


def main(argv=None):
    args = parse_args(argv)
    if args.task == "speed":  # JAX's runs on synthetic frames, with no dataset
        raise _later(args.task)
    if not args.dataset_dir:
        raise SystemExit("--dataset-dir is required for this task")
    if args.task != "train":
        raise _later(args.task)
    device = torch.device(args.device)
    train_ds = MultiViewVideoDataset(
        args.dataset_dir, args.category, gop_size=args.gop, split="train",
        frame_size=args.frame_size, c2s_ratio=args.c2s_ratio,
        sample_interval=args.sample_interval, max_pool_size=args.max_pool_size)
    V = train_ds.num_views
    spec = get_codec_model(args.codec, device=device, loss_type=args.loss_type,
                           compression_level=args.compression_level, num_views=V)
    init_params(spec, args.seed)
    params = ready_for_training(spec)
    host_rng = np.random.default_rng(args.seed)

    # category-keyed checkpoint name (train_multiview.py:292-303)
    ckpt_dir = (f"{args.ckpt_dir}/{args.codec}-{args.compression_level}"
                f"{args.loss_type}-{train_ds.category}")
    cfg = TrainConfig(learning_rate=args.lr)
    if spec.olft:
        init_fn, step_fn = make_olft_step(spec, cfg, args.sample_ratio)
    else:
        init_fn, step_fn = make_train_step(spec, cfg)
    opt_state = init_fn(params)
    if args.resume:
        try:
            state = load_checkpoint(ckpt_dir)
        except FileNotFoundError:
            pass
        else:
            with torch.no_grad():
                for name, p in params.items():
                    p.copy_(state["params"][name])
            opt_state = on_device(state["opt_state"], device)

    if spec.olft and args.probe_bw_limit > 0:
        interval = probe_sample_interval(spec, train_ds, args.sample_ratio,
                                         args.probe_bw_limit, rng=host_rng)
        train_ds.sample_interval = interval
        print(f"bandwidth probe: sample_interval={interval} "
              f"(budget {args.probe_bw_limit / 1e6:.2f} Mbps)")

    noise = UniformNoise(args.seed)
    psnr_m, bpp_m, touch_m = AverageMeter(), AverageMeter(), AverageMeter()
    progress_log = f"{args.codec}.{train_ds.category}.log"
    t0 = time.time()
    for step in range(args.steps):
        pool = train_ds.sample(step)
        idx = int(host_rng.integers(0, max(1, pool - args.gop)))
        gop = torch.from_numpy(train_ds[idx]).to(device)  # [GOP, V, 3, S, S]
        mask = sample_view_mask(host_rng, 1, V, max_failed=args.resilience,
                                force_resilience=args.force_resilience)
        params, opt_state, metrics = step_fn(params, opt_state, gop, noise, mask)
        if spec.olft:
            # the step takes the raw frames and builds the touch-up labels
            # from the detached references; their bandwidth is priced here:
            # bytes * 8 over the GOP's pixels (models.py:2218-2233)
            touch = touchup_bytes(metrics.pop("touch_refs"), metrics.pop("touch_labels"),
                                  metrics.pop("touch_mask"))
            touch_m.update(touch * 8 / (gop.numel() // 3))
        psnr_m.update(float(metrics["psnr"]))
        bpp_m.update(float(metrics["bpp"]))
        if step % 20 == 0:
            print(f"step {step}/{args.steps} psnr {psnr_m.avg:.2f} bpp {bpp_m.avg:.4f} "
                  f"touch_bpp {touch_m.avg:.4f} ({(time.time() - t0) / (step + 1):.2f}s/it)",
                  flush=True)
        if args.debug and step >= 9:
            break
    save_checkpoint(ckpt_dir, {"params": {n: p.detach() for n, p in params.items()},
                               "opt_state": opt_state}, best=True)
    write_eval_log(progress_log, args.compression_level, bpp_m.avg, 0.0, 0.0, [psnr_m.avg],
                   aux=(touch_m.avg,))
    if args.log_key:
        val = args.log_key_value or str(train_ds.category)
        with open(f"{args.codec}.{args.log_key}.log", "a") as f:
            f.write(f"{val},{args.compression_level},{bpp_m.avg:.4f},{psnr_m.avg:.4f},"
                    f"{touch_m.avg:.4f}\n")
    print(f"done: psnr {psnr_m.avg:.2f} bpp {bpp_m.avg:.4f} -> {ckpt_dir}")


if __name__ == "__main__":
    main()
