"""Checkpoint and resume, ported from fastvideocodec_tpu/train/checkpoint.py,
with the reference's tolerant loaders.

- ``save_checkpoint``/``load_checkpoint``: {params, opt_state, epoch,
  score} as one ``torch.save`` file per name (``ckpt``, and ``best`` when
  the score is the best), each written to a temporary name and
  ``os.replace``d into place, so a crash leaves the last whole file; the
  tensors are saved on the CPU and loaded with ``weights_only``. Loading
  prefers ``best`` (the reference's resume precedence). orbax's format is
  not read: the JAX package's trained weights reach the port through their
  npz assets and ``weights.load_flat``.
- ``load_whatever``: copy the leaves whose name and shape match
  (load_state_dict_whatever); ``load_with_copy``: also seed the
  ``backup_*`` branches from their primaries (MCVC-IA's warm start).
  Both take and return flat ``{name: tensor}`` dicts, the names split on
  "." (a module's parameter names).
- ``asset_params``: a shipped npz checkpoint as ``load_flat`` takes it.
"""

from __future__ import annotations

import os
from collections.abc import Mapping

import numpy as np
import torch

from fastvideocodec_torch.weights import asset_path

NAMES = ("best", "ckpt")


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, Mapping):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def save_checkpoint(directory: str, state: dict, best: bool = False) -> None:
    """Writes 'ckpt' (and 'best' when best=True) under directory: the
    state's tensors copied to the CPU."""
    os.makedirs(directory, exist_ok=True)
    state = _to_cpu(state)
    for name in ("ckpt", "best") if best else ("ckpt",):
        path = os.path.join(directory, name)
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            torch.save(state, tmp)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)


def load_checkpoint(directory: str, prefer_best: bool = True) -> dict:
    """Loads 'best' if present else 'ckpt' (with ``prefer_best=False`` the
    other way round), on the CPU; raises FileNotFoundError if neither
    exists."""
    for name in NAMES if prefer_best else NAMES[::-1]:
        path = os.path.join(directory, name)
        if os.path.exists(path):
            return torch.load(path, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"no checkpoint under {directory}")


def asset_params(name: str) -> dict:
    """The shipped checkpoint ``fastvideocodec_tpu/assets/<name>.npz`` as
    {'params/...': float32 array}, as ``weights.load_flat`` takes it."""
    with np.load(asset_path(name)) as data:
        return {k: data[k].astype(np.float32) for k in data.files}


def load_whatever(params: Mapping, source: Mapping) -> dict:
    """A copy of ``params`` with every leaf whose name and shape match one
    of ``source`` taken from it (models.py:438-442)."""
    out = {k: v.clone() for k, v in params.items()}
    for name, value in source.items():
        if name in out and tuple(out[name].shape) == tuple(value.shape):
            out[name] = torch.as_tensor(value).to(out[name]).clone()
    return out


def load_with_copy(params: Mapping, source: Mapping) -> dict:
    """load_whatever, then each leaf under a ``backup_*`` module (the first
    such key of its name) seeded from its primary's leaf, the name with
    that key's ``backup_`` dropped, where the shapes match
    (models.py:451-458)."""
    out = load_whatever(params, source)
    for name in list(out):
        parts = name.split(".")
        for i, part in enumerate(parts):
            if part.startswith("backup_"):
                primary = ".".join(parts[:i] + [part[len("backup_"):]] + parts[i + 1:])
                if primary in out and out[primary].shape == out[name].shape:
                    out[name] = out[primary].clone()
                break
    return out
