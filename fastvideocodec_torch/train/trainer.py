"""RD training of the port, ported from fastvideocodec_tpu/train/trainer.py.

The loss is the reference's rate-distortion Lagrangian per family
(``gop_loss``: r * distortion + bpp, plus the family's extras and the
entropy bottlenecks' aux loss). The optimizer is JAX's
``optax.multi_transform`` written in torch (``Optimizer``): a main group
(``clip_by_global_norm`` over the main group's gradients, then Adam, or
AdamW with weight decay, at the scheduled learning rate), an aux group
(Adam at ``aux_learning_rate`` for every parameter whose path holds
``quantile``) and a frozen group (parameters outside ``trainable``: no
update and no state). Parameters and gradients travel as ``{name:
tensor}`` dicts keyed by the module's parameter names, which carry the
flax module names (a name split on "." is the flax path without its
``params`` root).

``make_train_step`` returns ``(init_fn, step_fn)`` as JAX's does. The step
runs autograd over ``spec.module``'s own parameters, readied by
``ready_for_training`` (float32, requiring grad), and updates them in
place. Every warp's backward on the card is a hand-written backward
kernel (ops/warp.py:KernelWarp), exact like JAX's training warp
(``exact_warp``). Every family trains, under loss type "P" (MSE) or "M"
(1 - MS-SSIM): LSVC, SSF, ELFVC, MCVC (MCVC-IA-OLFT's online fine-tuning
step is ``train/olft.py``), DVC, RLVC and Base (Base-ER with the soft2hard
three passes under ``TrainConfig.soft2hard``); ELFVC-SP's staged recipe
freezes by ``make_elfvc_stage_optimizer``. In float32, or in bfloat16 as
JAX's ``--bf16`` trains (flax's mixed precision): a spec readied by
``ready_for_training(spec, torch.bfloat16)`` keeps every parameter, gradient and Adam moment in float32, its convs and Denses
compute in bfloat16 from copies cast once a step (``layers.blocks.
cast_once``), each use's gradient widened to float32 before the uses add
up, and there is no loss scaling, as in JAX.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import numpy as np
import torch

from fastvideocodec_torch.gop.engine import rollout
from fastvideocodec_torch.layers.blocks import cast_once, mixed_precision
from fastvideocodec_torch.models.registry import CodecSpec
from fastvideocodec_torch.ops.msssim import ms_ssim

ROADMAP_TRAINING = "ROADMAP.md queue 1, item 7"


@dataclass
class TrainConfig:
    """JAX's TrainConfig but for ``r_img``, which no code reads."""

    learning_rate: float = 1e-4
    aux_learning_rate: float = 1e-3
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    alpha: float = 1.0       # ELFVC-SP pred_err weight
    r_bpp: float = 1.0
    r_aux: float = 1.0
    soft2hard: bool = False  # Base-ER's s2h three-pass schedule (reference models.py:318-344)


def ready_for_training(spec: CodecSpec, compute_dtype: torch.dtype | None = None) -> dict:
    """Ready a float32 build for training: its module in train mode with
    every parameter requiring grad, computing in ``compute_dtype`` (None
    or float32: as it computes). Returns its parameters, {name:
    Parameter}, every one float32: the master weights. ``torch.bfloat16``
    is flax's mixed precision, JAX's
    ``--bf16`` training (``layers.blocks.mixed_precision``): the convs and
    Denses compute as ``get_codec_model(..., dtype=torch.bfloat16)``'s do,
    from float32 weights. The bfloat16 inference build, whose conv weights
    were rounded, raises."""
    module = spec.module
    for name, p in module.named_parameters():
        if p.dtype != torch.float32:
            raise ValueError(f"{spec.name}: parameter {name} is {p.dtype}, not a float32 master: "
                             "train a float32 build (get_codec_model's default dtype)")
    if compute_dtype not in (None, torch.float32):
        mixed_precision(module, compute_dtype)
    module.train().requires_grad_(True)
    return dict(module.named_parameters())


class RecordedNoise:
    """A noise source that keeps each of its draws, in order, for
    ``replay``."""

    def __init__(self, noise):
        self.noise, self.draws = noise, []

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        u = self.noise(x)
        self.draws.append(u)
        return u

    def replay(self):
        """A noise source that gives the recorded draws again, in order."""
        draws = iter(self.draws)

        def again(x: torch.Tensor) -> torch.Tensor:
            u = next(draws)
            if u.shape != x.shape:
                raise RuntimeError(f"replayed draw {tuple(u.shape)} for {tuple(x.shape)}")
            return u

        return again


@contextlib.contextmanager
def s2h_stage(module, stage: int):
    """Base-ER's soft2hard stage set on ``module`` for the context."""
    saved = module.s2h_stage
    module.s2h_stage = stage
    try:
        yield module
    finally:
        module.s2h_stage = saved


def msssim_distortion(spec: CodecSpec, x_hat: torch.Tensor, gop: torch.Tensor) -> torch.Tensor:
    """1 - ms_ssim of the recon against its frames (loss type "M"): the
    whole GOP for MCVC, whose recon holds the keyframe, the P-frames
    otherwise; every frame of every item in one batch."""
    target = gop if spec.family == "mcvc" else gop[1:]
    return 1.0 - ms_ssim(x_hat.float().reshape((-1,) + x_hat.shape[-3:]),
                         target.float().reshape((-1,) + target.shape[-3:]))


def gop_loss(spec: CodecSpec, gop: torch.Tensor, training: bool, noise, cfg: TrainConfig,
             mask=None):
    """(scalar loss, metrics) of one GOP, as the JAX package composes them:
    LSVC r * rec_loss + r_bpp * bpp; MCVC sum(r * img_loss) (+ sum(bpp_est)
    unless OLFT); the others sum(r * img_loss + bpp_est), plus Base-ER's
    sum(pred_err) and ELFVC-SP's alpha * sum(pred_err_norm); then r_aux
    times the model's aux loss. Metrics: loss, mean psnr, mean bpp, mean
    img_loss (LSVC's rec_loss), aux.

    Loss type "M": d = 1 - MS-SSIM over the GOP (``msssim_distortion``)
    replaces LSVC's rec_loss and everyone's img_loss, broadcast to the
    shape of psnr (so the summed loss counts r * d once a frame, as JAX's
    does). Base-ER with ``cfg.soft2hard`` in training reruns the GOP at
    s2h_stage 1 and 2 under pass 0's draws (recorded and replayed: JAX
    reuses one key) and takes r times the mean of the three passes'
    img_loss (their MSE) with pass 0's rates."""
    r = spec.r
    module = spec.module
    soft2hard = training and cfg.soft2hard and spec.family == "base" and module.use_er
    if soft2hard:
        noise = RecordedNoise(noise)
    x_hat, m = rollout(spec, gop, mask, training=training, noise=noise)
    if spec.loss_type == "M":
        d = msssim_distortion(spec, x_hat, gop)
        m = dict(m)
        m["img_loss"] = d.expand(m["psnr"].shape) if m["psnr"].dim() > 0 else d
        if "rec_loss" in m:
            m["rec_loss"] = d
    img = m["img_loss"] if "img_loss" in m else m["rec_loss"]
    if spec.family == "lsvc":
        loss = r * m["rec_loss"] + cfg.r_bpp * m["bpp"]
    elif spec.family == "mcvc":
        loss = torch.sum(r * m["img_loss"])
        if not spec.olft:
            loss = loss + torch.sum(m["bpp_est"])
    else:
        loss = torch.sum(r * m["img_loss"] + m["bpp_est"])
        if soft2hard:
            mses = [m["img_loss"]]
            for stage in (1, 2):
                with s2h_stage(module, stage):
                    mses.append(rollout(spec, gop, mask, training=True,
                                        noise=noise.replay())[1]["img_loss"])
            loss = torch.sum(r * ((mses[0] + mses[1] + mses[2]) / 3.0) + m["bpp_est"])
        if spec.family == "base" and module.use_er:
            loss = loss + torch.sum(m["pred_err"])
        if spec.family == "elfvc" and module.super_prec:
            loss = loss + cfg.alpha * torch.sum(m["pred_err_norm"])
    aux = module.aux_loss()
    loss = loss + cfg.r_aux * aux
    metrics = {
        "loss": loss,
        "psnr": torch.mean(m["psnr"]),
        "bpp": torch.mean(m["bpp_est"] if "bpp_est" in m else m["bpp"]),
        "img_loss": torch.mean(img),
        "aux": aux,
    }
    return loss, metrics


def _is_quantile_path(path) -> bool:
    return any("quantile" in str(k) for k in path)


# ELFVC staged-training parameter groups (reference optim_parameters,
# models.py:2055-2075): which submodule subtrees receive updates per spstage.
# Stage 0 warms up the SPnet predictors alone; stage 1 trains the motion SP
# path + residual autoencoder; stage 2 fine-tunes the residual SPnet +
# decoder. Any other stage trains everything.
ELFVC_STAGE_PARAM_GROUPS = {
    0: (
        ("res_hyperprior", "y_predictor"),
        ("motion_hyperprior", "y_predictor"),
    ),
    1: (
        ("motion_hyperprior", "y_predictor"),
        ("motion_decoder",),
        ("res_encoder",),
        ("res_decoder",),
        ("res_hyperprior",),
    ),
    2: (
        ("res_hyperprior", "y_predictor"),
        ("res_decoder",),
    ),
}


def elfvc_stage_trainable(sp_stage: int):
    """Returns path-filter(path)->bool for the stage's trainable set, or
    None when every parameter trains (reference 'Default stage')."""
    groups = ELFVC_STAGE_PARAM_GROUPS.get(sp_stage)
    if groups is None:
        return None

    def trainable(path) -> bool:
        keys = tuple(str(k) for k in path)
        if keys and keys[0] == "params":  # a flax path's collection root
            keys = keys[1:]
        return any(keys[: len(g)] == g for g in groups)

    return trainable


def exponential_decay(init_value: float, transition_steps: int, decay_rate: float,
                      staircase: bool = False):
    """optax.exponential_decay: count -> init_value * decay_rate **
    (count / transition_steps), the exponent floored when ``staircase``."""

    def schedule(count: int) -> float:
        p = count / transition_steps
        return init_value * decay_rate ** (math.floor(p) if staircase else p)

    return schedule


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    total = None
    for t in tensors:
        s = torch.sum(t.float() ** 2)
        total = s if total is None else total + s
    return torch.sqrt(total) if total is not None else torch.zeros(())


def _adam(grads: dict, group: dict, lr: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0, params: dict | None = None):
    """One optax adam (adamw with ``weight_decay``) update of the named
    gradients: (updates, the group's new state)."""
    count = group["count"] + 1
    bc1 = float(1.0 - np.float32(b1) ** np.float32(count))
    bc2 = float(1.0 - np.float32(b2) ** np.float32(count))
    mu, nu, updates = {}, {}, {}
    for name, g in grads.items():
        mu[name] = (1 - b1) * g + b1 * group["mu"][name]
        nu[name] = (1 - b2) * g ** 2 + b2 * group["nu"][name]
        u = (mu[name] / bc1) / (torch.sqrt(nu[name] / bc2) + eps)
        if weight_decay:
            u = u + weight_decay * params[name]
        updates[name] = -lr * u
    return updates, {"count": count, "mu": mu, "nu": nu}


class Optimizer:
    """JAX's make_optimizer in torch: optax.multi_transform of
    {"main": chain(clip_by_global_norm(grad_clip), adam or adamw(lr)),
    "aux": adam(aux_learning_rate), "frozen": set_to_zero()}, labelled by
    parameter path. ``learning_rate`` is a float or a schedule of the main
    group's update count. Functional like optax: ``init(params)`` gives
    the state ({"main": {count, mu, nu}, "aux": {...}}: the frozen group has
    none), ``update(grads, state, params)`` gives (updates, new state) and
    ``apply_updates`` adds the updates to the parameters in place."""

    def __init__(self, cfg: TrainConfig, learning_rate=None, trainable=None):
        self.cfg = cfg
        self.learning_rate = cfg.learning_rate if learning_rate is None else learning_rate
        self.trainable = trainable

    def label(self, name: str) -> str:
        path = tuple(name.split("."))  # the flax path without its params root
        if self.trainable is not None and not self.trainable(path):
            return "frozen"
        return "aux" if _is_quantile_path(path) else "main"

    def init(self, params: dict) -> dict:
        state = {}
        for group in ("main", "aux"):
            names = [n for n in params if self.label(n) == group]
            state[group] = {"count": 0,
                            "mu": {n: torch.zeros_like(params[n]) for n in names},
                            "nu": {n: torch.zeros_like(params[n]) for n in names}}
        return state

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict):
        main = {n: grads[n] for n in state["main"]["mu"]}
        # clip_by_global_norm over the main group's gradients alone:
        # where(norm < max, g, g / norm * max), as optax (not
        # clip_grad_norm_, which divides by norm + 1e-6)
        norm = global_norm(main.values())
        clip = self.cfg.grad_clip
        main = {n: torch.where(norm < clip, g, (g / norm) * clip) for n, g in main.items()}
        lr = self.learning_rate
        lr = lr(state["main"]["count"]) if callable(lr) else lr
        updates, main_state = _adam(main, state["main"], lr, weight_decay=self.cfg.weight_decay,
                                    params=params)
        aux = {n: grads[n] for n in state["aux"]["mu"]}
        aux_updates, aux_state = _adam(aux, state["aux"], self.cfg.aux_learning_rate)
        updates.update(aux_updates)
        return updates, {"main": main_state, "aux": aux_state}


@torch.no_grad()
def apply_updates(params: dict, updates: dict) -> None:
    """params += updates, in place (frozen parameters have no update)."""
    for name, u in updates.items():
        params[name].add_(u)


def make_optimizer(cfg: TrainConfig, learning_rate=None, trainable=None) -> Optimizer:
    """Main Adam (scheduled lr) for the model's parameters and a dedicated
    Adam at cfg.aux_learning_rate for the entropy bottlenecks' quantiles
    (the aux loss's gradient reaches only them); ``trainable(path)``
    freezes every parameter outside the filter."""
    return Optimizer(cfg, learning_rate, trainable)


def make_elfvc_stage_optimizer(cfg: TrainConfig, sp_stage: int,
                               learning_rate=None) -> Optimizer:
    """The spstage-keyed optimizer of the Vesper training recipe
    (reference models.py:2026-2078)."""
    return make_optimizer(cfg, learning_rate=learning_rate,
                          trainable=elfvc_stage_trainable(sp_stage))


def make_train_step(spec: CodecSpec, cfg: TrainConfig, optimizer=None,
                    batched: bool = False) -> tuple:
    """Returns (init_fn(params) -> opt_state, step_fn).

    step_fn(params, opt_state, gop, noise[, mask]) -> (params, opt_state,
    metrics): ``params`` are spec.module's parameters
    (``ready_for_training``), updated in place and returned; ``noise`` the
    quantizers' source (``ops.math.UniformNoise``); gop [T, 3, H, W], or
    MCVC's [T, B*V, 3, H, W] with its view mask [B*V] (``mask``). With
    ``batched=True`` gop (and mask) carry a leading batch axis; the loss
    and the metrics are the means over the clips (JAX vmaps the loss;
    here each clip's loss / B is backpropagated in turn, so one clip's
    graph is alive at a time). ``grad_norm`` is the norm of all
    gradients (frozen ones too); a parameter the loss does not reach has a
    zero gradient, as in JAX."""
    tx = make_optimizer(cfg) if optimizer is None else optimizer

    def init_fn(params: dict) -> dict:
        return tx.init(params)

    def step_fn(params: dict, opt_state: dict, gop: torch.Tensor, noise, mask=None):
        for p in params.values():
            p.grad = None
        with cast_once():  # one cast a master a step
            if batched:
                n = gop.shape[0]
                metrics = {}
                for b in range(n):
                    loss, m = gop_loss(spec, gop[b], True, noise, cfg,
                                       None if mask is None else mask[b])
                    (loss / n).backward()
                    for k, v in m.items():
                        metrics[k] = metrics.get(k, 0.0) + v.detach() / n
            else:
                loss, metrics = gop_loss(spec, gop, True, noise, cfg, mask)
                loss.backward()
                metrics = {k: v.detach() for k, v in metrics.items()}
        params, opt_state, metrics["grad_norm"] = descend(tx, params, opt_state)
        return params, opt_state, metrics

    return init_fn, step_fn


def descend(tx: Optimizer, params: dict, opt_state: dict):
    """``tx``'s step on the gradients a backward left in ``params``, which
    it clears (a parameter the loss does not reach has a zero gradient, as
    in JAX): (params, the new optimizer state, the norm of all gradients,
    frozen ones too)."""
    grads = {}
    for name, p in params.items():
        grads[name] = p.grad if p.grad is not None else torch.zeros_like(p)
        p.grad = None
    updates, opt_state = tx.update(grads, opt_state, params)
    apply_updates(params, updates)
    return params, opt_state, global_norm(grads.values())


def make_eval_step(spec: CodecSpec, cfg: TrainConfig | None = None):
    """eval_fn(gop[, mask]) -> metrics of gop_loss in eval mode (no noise,
    no gradient)."""
    cfg = cfg or TrainConfig()

    def eval_fn(gop: torch.Tensor, mask=None) -> dict:
        with torch.no_grad(), cast_once():
            _, metrics = gop_loss(spec, gop, False, None, cfg, mask)
        return metrics

    return eval_fn
