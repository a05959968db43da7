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
(``exact_warp``). The LSVC, SSF and ELFVC families train; ELFVC-SP's staged
recipe freezes by ``make_elfvc_stage_optimizer``. Float32 only; MCVC, DVC,
RLVC and Base wait (ROADMAP.md queue 1, item 7).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from fastvideocodec_torch.gop.engine import rollout
from fastvideocodec_torch.models.registry import CodecSpec

ROADMAP_TRAINING = "ROADMAP.md queue 1, item 7: training for the ported codecs"


@dataclass
class TrainConfig:
    """JAX's TrainConfig but for ``r_img``, which no code reads, and
    ``soft2hard``, Base-ER's three-pass schedule, which comes with Base's
    training (ROADMAP.md queue 1, item 7)."""

    learning_rate: float = 1e-4
    aux_learning_rate: float = 1e-3
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    alpha: float = 1.0       # ELFVC-SP pred_err weight
    r_bpp: float = 1.0
    r_aux: float = 1.0


def ready_for_training(spec: CodecSpec) -> dict:
    """Ready a built spec for training: its module in train mode with every
    parameter requiring grad. Returns its parameters, {name: Parameter}.
    Float32 only: ``get_codec_model`` builds bfloat16 modules with bfloat16
    conv weights, and flax's mixed precision (float32 parameters, bfloat16
    compute: JAX's --bf16) waits for a later slice."""
    module = spec.module
    if getattr(module, "dtype", torch.float32) != torch.float32 or any(
            p.dtype != torch.float32 for p in module.parameters()):
        raise NotImplementedError(f"bfloat16 training is not ported yet ({ROADMAP_TRAINING})")
    module.train().requires_grad_(True)
    return dict(module.named_parameters())


def gop_loss(spec: CodecSpec, gop: torch.Tensor, training: bool, noise, cfg: TrainConfig,
             mask=None):
    """(scalar loss, metrics) of one GOP, as the JAX package composes them:
    LSVC r * rec_loss + r_bpp * bpp; MCVC sum(r * img_loss) (+ sum(bpp_est)
    unless OLFT); the others sum(r * img_loss + bpp_est), plus Base-ER's
    sum(pred_err) and ELFVC-SP's alpha * sum(pred_err_norm); then r_aux
    times the model's aux loss. Metrics: loss, mean psnr, mean bpp, mean
    img_loss (LSVC's rec_loss), aux. Loss type "M" (MS-SSIM) waits for
    ops/msssim.py (ROADMAP.md queue 1, item 8)."""
    if spec.loss_type == "M":
        raise NotImplementedError("loss type 'M' needs ops/msssim.py, not ported yet "
                                  "(ROADMAP.md queue 1, item 8)")
    r = spec.r
    _, m = rollout(spec, gop, mask, training=training, noise=noise)
    img = m["img_loss"] if "img_loss" in m else m["rec_loss"]
    module = spec.module
    if spec.family == "lsvc":
        loss = r * m["rec_loss"] + cfg.r_bpp * m["bpp"]
    elif spec.family == "mcvc":
        loss = torch.sum(r * m["img_loss"])
        if "OLFT" not in spec.name:
            loss = loss + torch.sum(m["bpp_est"])
    else:
        loss = torch.sum(r * m["img_loss"] + m["bpp_est"])
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
    quantizers' source (``ops.math.UniformNoise``); gop [T, 3, H, W].
    With ``batched=True`` gop (and mask) carry a leading batch axis; the
    loss and the metrics are the means over the clips (JAX vmaps the
    loss; here each clip's loss / B is backpropagated in turn, so one
    clip's graph is alive at a time). ``grad_norm`` is the norm of all
    gradients (frozen ones too); a parameter the loss does not reach has a
    zero gradient, as in JAX."""
    tx = make_optimizer(cfg) if optimizer is None else optimizer

    def init_fn(params: dict) -> dict:
        return tx.init(params)

    def step_fn(params: dict, opt_state: dict, gop: torch.Tensor, noise, mask=None):
        for p in params.values():
            p.grad = None
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
        grads = {}
        for name, p in params.items():
            grads[name] = p.grad if p.grad is not None else torch.zeros_like(p)
            p.grad = None
        updates, opt_state = tx.update(grads, opt_state, params)
        apply_updates(params, updates)
        metrics["grad_norm"] = global_norm(grads.values())
        return params, opt_state, metrics

    return init_fn, step_fn


def make_eval_step(spec: CodecSpec, cfg: TrainConfig | None = None):
    """eval_fn(gop[, mask]) -> metrics of gop_loss in eval mode (no noise,
    no gradient)."""
    cfg = cfg or TrainConfig()

    def eval_fn(gop: torch.Tensor, mask=None) -> dict:
        with torch.no_grad():
            _, metrics = gop_loss(spec, gop, False, None, cfg, mask)
        return metrics

    return eval_fn
