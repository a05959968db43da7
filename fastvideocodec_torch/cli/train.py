"""Single-view RD trainer CLI of the port, ported from
fastvideocodec_tpu/cli/train.py (reference train.py).

Trains a codec on Vimeo-90k septuplets with the rate-distortion Lagrangian
L = r*D + R: per-epoch learning-rate decay, a checkpoint every
``--test-every`` steps and at each epoch's end (``best`` when the RD score
bpp + distortion improves), ``--resume`` from the checkpoint directory.
It runs on the card unless ``--device cpu``. Weights start from the
numpy-seeded initialisers of ``weights.seeded_flat`` (``--seed``), the
quantization noise from a generator seeded likewise.

Usage:
  python -m fastvideocodec_torch.cli.train --codec LSVC-TPU \\
      --dataset-dir /data/vimeo_septuplet --epochs 10

Every single-view name trains (the LSVC, SSF, ELFVC, DVC, RLVC and Base
families; the default is the JAX CLI's ELFVC-SP), under loss type P (MSE)
or M (1 - MS-SSIM, frames above 160 px), in float32 or with ``--bf16`` in
flax's mixed precision as JAX's ``--bf16`` trains (float32 parameters,
Adam state and checkpoints; convs and Denses in bfloat16; no loss
scaling); MCVC trains through ``cli/train_multiview.py``. Base-ER's
soft2hard schedule is a ``TrainConfig`` field with no flag, as in the JAX
CLI. ``--evaluate`` and ``--evolve`` wait for a later slice (ROADMAP.md
queue 1, item 7.6).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from fastvideocodec_torch.data import FrameDataset, prefetch_batches
from fastvideocodec_torch.models import get_codec_model
from fastvideocodec_torch.ops.math import UniformNoise
from fastvideocodec_torch.train import (
    TrainConfig,
    exponential_decay,
    load_checkpoint,
    make_optimizer,
    make_train_step,
    ready_for_training,
    save_checkpoint,
)
from fastvideocodec_torch.train.trainer import ROADMAP_TRAINING
from fastvideocodec_torch.utils import AverageMeter
from fastvideocodec_torch.weights import load_flat, seeded_flat


def parse_args(argv=None):
    p = argparse.ArgumentParser("fvc-train")
    p.add_argument("--codec", default="ELFVC-SP")
    p.add_argument("--dataset-dir", required=True)
    p.add_argument("--loss-type", default="P", choices=["P", "M"])
    p.add_argument("--compression-level", type=int, default=2)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--frame-size", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lr-decay", type=float, default=0.5)
    p.add_argument("--grad-clip", type=float, default=1.0)
    p.add_argument("--alpha", type=float, default=1.0, help="SP pred_err weight")
    p.add_argument("--ckpt-dir", default="backup")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--test-every", type=int, default=5000)
    p.add_argument("--steps-per-epoch", type=int, default=0)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--evaluate", action="store_true",
        help="skip training; sweep 8 compression levels over --test-dataset-dir "
        "(reference train.py:431-436; not ported yet)",
    )
    p.add_argument(
        "--evolve", action="store_true",
        help="per-video encoder overfitting before each eval video "
        "(reference train.py:315-401); implies --evaluate (not ported yet)",
    )
    p.add_argument("--test-dataset-dir", default=None)
    p.add_argument("--test-size", default="1024x2048")
    p.add_argument("--max-files", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p.parse_args(argv)


def init_params(spec, seed: int) -> None:
    """The module's weights from the JAX modules' initialisers, drawn with
    numpy from ``seed`` (``weights.seeded_flat``)."""
    load_flat(spec.module, seeded_flat(spec.name, seed))


def _state(params: dict, opt_state: dict, epoch: int, score: float) -> dict:
    return {"params": {n: p.detach() for n, p in params.items()}, "opt_state": opt_state,
            "epoch": epoch, "score": score}


def on_device(tree, device):
    """A checkpoint's optimizer state moved to ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: on_device(v, device) for k, v in tree.items()}
    return tree


def main(argv=None):
    args = parse_args(argv)
    if args.evaluate or args.evolve:
        raise SystemExit("--evaluate and --evolve need train/evaluate.py and train/evolve.py, "
                         f"not ported yet ({ROADMAP_TRAINING}.6: evaluation and evolve)")
    device = torch.device(args.device)
    spec = get_codec_model(args.codec, device=device, loss_type=args.loss_type,
                           compression_level=args.compression_level)
    train_ds = FrameDataset(args.dataset_dir, args.frame_size, split="train")
    init_params(spec, args.seed)
    params = ready_for_training(spec, torch.bfloat16 if args.bf16 else torch.float32)

    ckpt_dir = f"{args.ckpt_dir}/{args.codec}-{args.compression_level}{args.loss_type}"
    cfg = TrainConfig(learning_rate=args.lr, grad_clip=args.grad_clip, alpha=args.alpha)
    steps = args.steps_per_epoch or max(1, len(train_ds) // args.batch_size)
    # per-epoch LR decay (reference train.py:403-409) through the staircase
    # schedule of the main group's updates
    schedule = exponential_decay(args.lr, steps, args.lr_decay, staircase=True)
    tx = make_optimizer(cfg, learning_rate=schedule)
    init_fn, step_fn = make_train_step(spec, cfg, optimizer=tx, batched=args.batch_size > 1)
    opt_state = init_fn(params)
    start_epoch, best_score = 0, float("inf")
    if args.resume:
        try:
            state = load_checkpoint(ckpt_dir)
        except FileNotFoundError:
            print("no checkpoint; training from scratch")
        else:
            with torch.no_grad():
                for name, p in params.items():
                    p.copy_(state["params"][name])
            opt_state = on_device(state["opt_state"], device)
            start_epoch = int(state["epoch"]) + 1
            best_score = float(state["score"])
            print(f"resumed from epoch {start_epoch - 1}, score {best_score:.4f}")

    noise = UniformNoise(args.seed)
    for epoch in range(start_epoch, args.epochs):
        loss_m, psnr_m, bpp_m = AverageMeter(), AverageMeter(), AverageMeter()
        img_m = AverageMeter()
        order = np.random.RandomState(epoch).permutation(len(train_ds))[
            : steps * args.batch_size
        ]
        t0 = time.time()
        for step, batch in enumerate(
            prefetch_batches(train_ds, order, batch_size=args.batch_size, device=device)
        ):
            # [B, 7, S, S, 3] NHWC clips -> [B, 7, 3, S, S]; B == 1 squeezes
            gop = batch.permute(0, 1, 4, 2, 3).contiguous()
            params, opt_state, metrics = step_fn(
                params, opt_state, gop if args.batch_size > 1 else gop[0], noise
            )
            loss_m.update(float(metrics["loss"]))
            psnr_m.update(float(metrics["psnr"]))
            bpp_m.update(float(metrics["bpp"]))
            img_m.update(float(metrics["img_loss"]))
            if step % 100 == 0:
                print(
                    f"epoch {epoch} step {step}/{steps} "
                    f"loss {loss_m.avg:.3f} psnr {psnr_m.avg:.2f} "
                    f"bpp {bpp_m.avg:.4f} ({(time.time() - t0) / (step + 1):.2f}s/it)",
                    flush=True,
                )
            if args.test_every and step and step % args.test_every == 0:
                # RD score = bpp + distortion (reference test() returns
                # ba_loss.avg + img_loss.avg, train.py:313)
                score = bpp_m.avg + img_m.avg
                save_checkpoint(ckpt_dir, _state(params, opt_state, epoch, score),
                                best=score < best_score)
                best_score = min(best_score, score)
        score = bpp_m.avg + img_m.avg
        save_checkpoint(ckpt_dir, _state(params, opt_state, epoch, score),
                        best=score < best_score)
        best_score = min(best_score, score)
        print(f"epoch {epoch} done: loss {loss_m.avg:.3f} psnr {psnr_m.avg:.2f}", flush=True)


if __name__ == "__main__":
    main()
