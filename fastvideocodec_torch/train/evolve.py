"""Per-video encoder overfitting ("evolve"), ported from
fastvideocodec_tpu/train/evolve.py.

Reference train.py:315-401 / eval.py:357-473: before a video is coded, the
encoder-side parameters are fine-tuned on its frames, then the video is
coded with the evolved encoder. JAX masks the update with
``optax.multi_transform`` ({"train": adam, "freeze": set_to_zero}); here
Adam runs on the parameters ``encoder_mask`` selects and every other
parameter is not touched (it takes no gradient and keeps its bits).

The mask is JAX's, name for name, so that the two packages evolve the
same parameters. Every name it selects is sender-side in the real coder
(ELFVC's ``flow_predictor`` too: it runs on decoded context, but only to
build the motion encoder's input), so the un-evolved receiver decodes an
evolved encoder's stream bit for bit.
"""

from __future__ import annotations

import torch

from fastvideocodec_torch.layers.blocks import cast_once
from fastvideocodec_torch.models.registry import CodecSpec
from fastvideocodec_torch.ops.math import UniformNoise
from fastvideocodec_torch.train.trainer import TrainConfig, _adam, gop_loss

# parameter subtrees considered encoder-side per family (sender-only),
# matched as substrings of each component of a parameter's path
ENCODER_KEYS = (
    "optic_flow", "mv_encoder", "res_encoder", "prior_encoder",
    "img_encoder", "motion_encoder", "flow_predictor", "enc",
)


def _is_encoder_path(path) -> bool:
    return any(any(k in str(n) for k in ENCODER_KEYS) for n in path)


def encoder_mask(module: torch.nn.Module) -> dict:
    """{parameter name: True where it belongs to an encoder-side subtree}.
    A name's components are the flax path's (its leaf aside, which holds
    no key)."""
    return {name: _is_encoder_path(name.split(".")[:-1])
            for name, _ in module.named_parameters()}


def evolve_on_video(
    spec: CodecSpec,
    gops,
    steps: int = 50,
    learning_rate: float = 1e-5,
    noise=None,
    cfg: TrainConfig | None = None,
):
    """Fine-tunes ``spec.module``'s encoder-side parameters, in place, on
    this video's GOPs.

    gops: a list of NHWC host clips [T, H, W, 3] (float32 numpy), taken in
    turn, one a step. ``noise``: the quantizers' noise source (default
    ``UniformNoise(0)``). The module must be a float32 build, as for
    training; it is left in eval mode with no parameter requiring grad.
    Returns (the module's parameters {name: tensor}, the best RD score
    seen, bpp + r * img_loss of a step's metrics, as JAX scores it)."""
    cfg = cfg or TrainConfig(learning_rate=learning_rate)
    module = spec.module
    for name, p in module.named_parameters():
        if p.dtype != torch.float32:
            raise ValueError(f"{spec.name}: parameter {name} is {p.dtype}: evolve a float32 "
                             "build (get_codec_model's default dtype)")
    mask = encoder_mask(module)
    params = dict(module.named_parameters())
    module.train()
    for name, p in params.items():
        p.requires_grad_(mask[name])
    trained = {n: p for n, p in params.items() if mask[n]}
    state = {"count": 0, "mu": {n: torch.zeros_like(p) for n, p in trained.items()},
             "nu": {n: torch.zeros_like(p) for n, p in trained.items()}}
    noise = noise if noise is not None else UniformNoise(0)
    device = next(module.parameters()).device
    gops = list(gops)
    best = float("inf")
    try:
        for i in range(steps):
            gop = torch.from_numpy(gops[i % len(gops)]).to(device).permute(0, 3, 1, 2)
            with cast_once():
                loss, metrics = gop_loss(spec, gop.contiguous(), True, noise, cfg)
                loss.backward()
            with torch.no_grad():
                grads = {}
                for n, p in trained.items():
                    grads[n] = p.grad if p.grad is not None else torch.zeros_like(p)
                    p.grad = None
                updates, state = _adam(grads, state, learning_rate)
                for n, u in updates.items():
                    trained[n].add_(u)
            score = float(metrics["bpp"].detach()) + float(metrics["img_loss"].detach()) * spec.r
            best = min(best, score)
    finally:
        module.eval().requires_grad_(False)
    return params, best
