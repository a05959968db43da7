"""Training of the port: the RD loss, the optimizer, the train and eval
steps (trainer.py), MCVC-IA-OLFT's online fine-tuning (olft.py) and
checkpoints (checkpoint.py)."""

from fastvideocodec_torch.train.checkpoint import (
    asset_params,
    load_checkpoint,
    load_whatever,
    load_with_copy,
    save_checkpoint,
)
from fastvideocodec_torch.train.olft import (
    make_olft_step,
    olft_loss,
    probe_sample_interval,
    touchup_bits,
    touchup_labels,
)
from fastvideocodec_torch.train.trainer import (
    TrainConfig,
    apply_updates,
    elfvc_stage_trainable,
    exponential_decay,
    gop_loss,
    make_elfvc_stage_optimizer,
    make_eval_step,
    make_optimizer,
    make_train_step,
    ready_for_training,
)

__all__ = [
    "TrainConfig",
    "apply_updates",
    "asset_params",
    "elfvc_stage_trainable",
    "exponential_decay",
    "gop_loss",
    "load_checkpoint",
    "load_whatever",
    "load_with_copy",
    "make_elfvc_stage_optimizer",
    "make_eval_step",
    "make_olft_step",
    "make_optimizer",
    "make_train_step",
    "olft_loss",
    "probe_sample_interval",
    "ready_for_training",
    "save_checkpoint",
    "touchup_bits",
    "touchup_labels",
]
