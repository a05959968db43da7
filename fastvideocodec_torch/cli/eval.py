"""Evaluator CLI of the port, ported from fastvideocodec_tpu/cli/eval.py
(reference eval.py): GOP-based evaluation over UVG / MCL-JCV videos,
writing ``{codec}.{dataset}.{evolve}.log`` in the two-line format, and the
x26x anchors when ffmpeg is present (``--task x26x``).

Usage:
  python -m fastvideocodec_torch.cli.eval --codec LSVC-TPU \\
      --dataset-dir /data/UVG --dataset UVG --bf16 --real-bits

It runs on the card unless ``--device cpu``. Each level's weights come
from ``{ckpt-dir}/{codec}-{level}{loss type}`` (``train/checkpoint.py``,
``best`` first); without one it warns and evaluates the numpy-seeded
initialisers (``weights.seeded_flat``, seed 0), as the JAX CLI evaluates
its random init. ``--torch-ckpt`` loads a reference DVC snapshot instead
(``utils/torch_import.py``).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from fastvideocodec_torch.cli.train import init_params
from fastvideocodec_torch.data import VideoDataset
from fastvideocodec_torch.models import get_codec_model
from fastvideocodec_torch.train import load_checkpoint
from fastvideocodec_torch.train.evaluate import evaluate_video
from fastvideocodec_torch.utils.logs import write_eval_log


def parse_args(argv=None):
    p = argparse.ArgumentParser("fvc-eval")
    p.add_argument("--codec", default="LSVC-128")
    p.add_argument("--dataset", default="UVG")
    p.add_argument("--dataset-dir", required=True)
    p.add_argument("--resolution", type=int, nargs=2, default=(2048, 1024),
                   help="width height (eval.py:495-496 default 2048x1024)")
    p.add_argument("--level-range", type=int, nargs=2, default=(0, 1))
    p.add_argument("--fP", type=int, default=15)
    p.add_argument("--ckpt-dir", default="backup")
    p.add_argument("--evolve", type=int, default=0)
    p.add_argument("--max-gops", type=int, default=0)
    p.add_argument("--task", default="model", choices=["model", "x26x"])
    p.add_argument("--Q", type=int, default=27, help="x26x crf")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--real-bits", action="store_true",
                   help="drive the real bitstream encode+decode: bpp_act, "
                        "separate enc/dec times, net-vs-AC split in aux")
    p.add_argument("--torch-ckpt", default="",
                   help="DVC only: import a reference torch snapshot "
                        "(DVC/snapshot/*.model) via utils.torch_import")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p.parse_args(argv)


def eval_x26x(args):
    from fastvideocodec_torch.anchors import compress_whole_video

    ds = VideoDataset(args.dataset_dir, tuple(args.resolution))
    buf = []
    for i in range(len(ds)):
        f, eof = ds[i]
        buf.append(f)
        if eof:
            frames = np.stack(buf)
            psnrs, bpp, enc_t, dec_t = compress_whole_video(
                args.codec, frames, args.Q, gop=args.fP + 1
            )
            write_eval_log(f"{args.codec}.log", args.Q, bpp, enc_t, dec_t, psnrs)
            print(f"{args.codec} Q={args.Q}: bpp {bpp:.4f} psnr {np.mean(psnrs):.2f}")
            buf = []


def load_weights(spec, args, lvl: int) -> None:
    """The level's checkpoint (or ``--torch-ckpt``) onto ``spec.module``,
    over its seeded initialisers."""
    init_params(spec, 0)
    if args.torch_ckpt:
        from fastvideocodec_torch.utils.torch_import import load_torch_dvc_checkpoint
        from fastvideocodec_torch.weights import flatten_params, load_flat

        load_flat(spec.module, flatten_params(load_torch_dvc_checkpoint(args.torch_ckpt)))
        print(f"imported torch snapshot {args.torch_ckpt}")
        return
    ckpt = f"{args.ckpt_dir}/{args.codec}-{lvl}{spec.loss_type}"
    try:
        state = load_checkpoint(ckpt, prefer_best=True)
    except FileNotFoundError:
        print(f"WARNING: no checkpoint at {ckpt}; evaluating random init")
        return
    with torch.no_grad():
        for name, p in spec.module.named_parameters():
            p.copy_(state["params"][name])
    print(f"loaded weights from {ckpt}")


def main(argv=None):
    args = parse_args(argv)
    if args.task == "x26x":
        eval_x26x(args)
        return
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    device = torch.device(args.device)
    gop = args.fP + 1
    for lvl in range(args.level_range[0], args.level_range[1]):
        spec = get_codec_model(args.codec, dtype=dtype, device=device, compression_level=lvl)
        ds = VideoDataset(args.dataset_dir, tuple(args.resolution))
        load_weights(spec, args, lvl)
        log_path = f"{args.codec}.{args.dataset}.{args.evolve}.log"
        stats = evaluate_video(
            spec, ds, gop_size=gop, log_path=log_path, level=lvl,
            max_gops=args.max_gops, real_bits=args.real_bits,
        )
        msg = (
            f"level {lvl}: bpp {stats['bpp']:.4f} psnr {stats['psnr']:.2f} "
            f"(enc {stats['sec_per_frame']*1e3:.1f} / "
            f"dec {stats['dec_sec_per_frame']*1e3:.1f} ms/frame)"
        )
        if args.real_bits:
            msg += (
                f" [bpp_est {stats['bpp_est']:.4f}; AC enc "
                f"{stats['enc_ac_sec_per_frame']*1e3:.1f} / dec "
                f"{stats['dec_ac_sec_per_frame']*1e3:.1f} ms/frame]"
            )
        print(msg, flush=True)


if __name__ == "__main__":
    main()
