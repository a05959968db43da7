"""Carry the JAX package's parameters onto the port's modules.

The shipped checkpoints are ``fastvideocodec_tpu/assets/<name>.npz``, read
here by path as data files: their keys are '/'-joined flax paths under
``params/``, stored as float16. The port's child modules carry the flax
names, so a path maps to a ``state_dict`` key by its leaf alone:

- a conv ``kernel`` (HWIO) becomes ``weight`` (OIHW);
- a ``PolyphaseDeconv`` ``kernel`` [k, k, I, O] becomes the
  ``ConvTranspose2d`` ``weight`` [I, O, k, k], with no spatial flip;
- ``bias``, GDN ``beta``/``gamma`` and BitEstimator ``h``/``b``/``a`` keep
  their names and shapes.

Loading raises on any key that maps nowhere and on any parameter left
unset.
"""

from __future__ import annotations

from collections.abc import Mapping
from pathlib import Path

import numpy as np
import torch
from torch import nn

ASSET_DIR = Path(__file__).resolve().parents[1] / "fastvideocodec_tpu" / "assets"


def asset_path(name: str) -> Path:
    return ASSET_DIR / f"{name}.npz"


def flatten_params(tree: Mapping, prefix: str = "") -> dict:
    """A nested params pytree (as ``module.init`` returns) -> {'a/b/c': array}."""
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(flatten_params(v, path))
        else:
            flat[path] = np.asarray(v)
    return flat


def load_flat(module: nn.Module, flat: Mapping) -> nn.Module:
    """Copy {'params/a/b/leaf': array} onto ``module``'s parameters."""
    state = module.state_dict()
    done = set()
    for key, value in flat.items():
        parts = key.split("/")
        if parts[0] != "params" or len(parts) < 2:
            raise KeyError(f"unmapped parameter {key!r}")
        mod_path, leaf = ".".join(parts[1:-1]), parts[-1]
        arr = np.asarray(value, dtype=np.float32)
        if leaf == "kernel":
            try:
                sub = module.get_submodule(mod_path)
            except AttributeError as e:
                raise KeyError(f"unmapped parameter {key!r}") from e
            if isinstance(sub, nn.ConvTranspose2d):
                arr = arr.transpose(2, 3, 0, 1)
            elif isinstance(sub, nn.Conv2d):
                arr = arr.transpose(3, 2, 0, 1)
            else:
                raise KeyError(f"unmapped parameter {key!r}: {type(sub).__name__}")
            leaf = "weight"
        tkey = f"{mod_path}.{leaf}" if mod_path else leaf
        if tkey not in state:
            raise KeyError(f"unmapped parameter {key!r}")
        if tuple(state[tkey].shape) != arr.shape:
            raise ValueError(
                f"{key!r}: shape {arr.shape} does not fit {tkey} {tuple(state[tkey].shape)}"
            )
        with torch.no_grad():
            state[tkey].copy_(torch.from_numpy(np.ascontiguousarray(arr)))
        done.add(tkey)
    missing = sorted(set(state) - done)
    if missing:
        raise KeyError(f"parameters not set by the checkpoint: {missing}")
    return module


def load_params(module: nn.Module, params: Mapping) -> nn.Module:
    """Load a flax params pytree ({'params': {...}} of numpy/JAX arrays)."""
    return load_flat(module, flatten_params(params))


def load_asset(module: nn.Module, name: str) -> nn.Module:
    """Load the shipped checkpoint ``fastvideocodec_tpu/assets/<name>.npz``."""
    with np.load(asset_path(name)) as data:
        return load_flat(module, {k: data[k] for k in data.files})
