"""Carry the JAX package's parameters onto the port's modules.

The shipped checkpoints are ``fastvideocodec_tpu/assets/<name>.npz``, read
here by path as data files: their keys are '/'-joined flax paths under
``params/``, stored as float16. The port's child modules carry the flax
names, so a path maps to a ``state_dict`` key by its leaf alone:

- a conv ``kernel`` (HWIO) becomes ``weight`` (OIHW);
- a ``PolyphaseDeconv`` ``kernel`` [k, k, I, O] becomes the
  ``ConvTranspose2d`` ``weight`` [I, O, k, k], with no spatial flip;
- a ``WSConvBlock`` ``kernel`` (HWIO) becomes its ``weight`` (OIHW), like a
  conv's;
- a ``Dense`` ``kernel`` [in, out] becomes the ``nn.Linear`` ``weight``
  [out, in]: the leaf alone does not say which, the module type does;
- ``bias``, GDN ``beta``/``gamma``, BitEstimator ``h``/``b``/``a``, GroupNorm
  and LayerNorm ``scale``/``bias``, ChannelLayerNorm ``g`` and VPCT's
  ``wpe``/``param_token`` keep their names and shapes.

Loading raises on any key that maps nowhere and on any parameter left
unset. ``seeded_flat`` makes a flax-keyed, flax-layout checkpoint of
numpy-seeded values for a registry name, for the configurations that ship
no trained weights; the same dict loads into both packages.
"""

from __future__ import annotations

from collections.abc import Mapping
from pathlib import Path

import numpy as np
import torch
from torch import nn

from fastvideocodec_torch.entropy.factorized import FILTERS
from fastvideocodec_torch.layers.blocks import WSConvBlock
from fastvideocodec_torch.models.registry import get_codec_model

ASSET_DIR = Path(__file__).resolve().parents[1] / "fastvideocodec_tpu" / "assets"
CONVS = (nn.Conv2d, WSConvBlock)  # modules whose flax ``kernel`` is HWIO


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
            elif isinstance(sub, CONVS):
                arr = arr.transpose(3, 2, 0, 1)
            elif isinstance(sub, nn.Linear):
                arr = arr.T
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


def _flax_layout(module: nn.Module):
    """(flax path, parameter, the permutation that takes it to flax's
    layout or None) of every parameter of ``module``: the inverse of the
    mapping ``load_flat`` applies."""
    for tkey, p in module.named_parameters():
        mod_path, leaf = tkey.rsplit(".", 1) if "." in tkey else ("", tkey)
        perm = None
        if leaf == "weight":
            sub = module.get_submodule(mod_path)
            if isinstance(sub, nn.ConvTranspose2d):
                perm = (2, 3, 0, 1)  # [I, O, k, k] -> [k, k, I, O]
            elif isinstance(sub, CONVS):
                perm = (2, 3, 1, 0)  # OIHW -> HWIO
            elif isinstance(sub, nn.Linear):
                perm = (1, 0)  # [out, in] -> [in, out]
            else:
                raise KeyError(f"no flax layout for {tkey!r}: {type(sub).__name__}")
            leaf = "kernel"
        path = "/".join(["params", *mod_path.split("."), leaf]) if mod_path else f"params/{leaf}"
        yield path, p, perm


def flax_shapes(module: nn.Module) -> dict:
    """{'params/a/b/leaf': flax shape} of every parameter of ``module``."""
    return {path: tuple(p.shape[i] for i in perm) if perm else tuple(p.shape)
            for path, p, perm in _flax_layout(module)}


def flax_flat(module: nn.Module) -> dict:
    """{'params/a/b/leaf': float32 array in flax layout} of ``module``'s
    parameters: what ``load_flat`` loads back, and what the JAX package's
    ``apply`` takes (``flatten_params`` of its variables)."""
    out = {}
    for path, p, perm in _flax_layout(module):
        arr = p.detach().float().cpu().numpy()
        out[path] = np.ascontiguousarray(arr.transpose(perm) if perm else arr)
    return out


# flax lecun_normal: a normal truncated to +-2 standard deviations, scaled
# so that its variance is 1/fan_in
_TRUNCATED_STD = 0.87962566103423978


def _lecun_normal(rng: np.random.Generator, shape: tuple) -> np.ndarray:
    v = rng.standard_normal(shape)
    while (bad := np.abs(v) >= 2.0).any():
        v[bad] = rng.standard_normal(int(bad.sum()))
    return v * (np.sqrt(1.0 / np.prod(shape[:-1])) / _TRUNCATED_STD)


def _xavier_normal(rng: np.random.Generator, shape: tuple) -> np.ndarray:
    """flax variance_scaling(2.0, "fan_avg", "normal") of an HWIO (or a
    transposed conv's [k, k, in, out]) kernel: untruncated, variance
    2 / fan_avg."""
    receptive = np.prod(shape[:-2])
    fan_avg = 0.5 * receptive * (shape[-2] + shape[-1])
    return rng.standard_normal(shape) * np.sqrt(2.0 / fan_avg)


def seeded_flat(name: str, seed: int) -> dict:
    """``seeded_params`` of the registry codec ``name``."""
    # the weights of MCVC do not depend on its number of views
    return seeded_params(get_codec_model(name, device="meta", num_views=1).module, seed)


def seeded_params(module: nn.Module, seed: int) -> dict:
    """Random parameters for ``module``, drawn from
    ``np.random.default_rng(seed)`` in sorted key order with the JAX
    modules' own initialisers: flax ``lecun_normal`` for conv, deconv,
    Dense and weight-standardized kernels, zero conv and Dense biases, U(-fan_in^-1/2,
    +fan_in^-1/2) for the WSConvBlock biases (blocks.py:362-370 of the JAX
    package), ones for GroupNorm and LayerNorm ``scale`` and ChannelLayerNorm
    ``g``, zero GroupNorm and LayerNorm biases, EntropyBottleneck.setup's formulas
    (softplus-inverse matrices, U(-0.5, 0.5) biases, zero factors,
    quantiles (-10, 0, 10)), GDN's sqrt(1 + pedestal) ``beta`` and
    sqrt(0.1 I + pedestal) ``gamma``, N(0, 0.01) BitEstimator ``h``, ``b``
    and ``a``, and the CodecNet convs' Xavier-normal (gain sqrt 2) kernels
    with 0.01 biases. Returns {'params/...': float32 array} in flax
    layout, for ``load_flat`` here and for the JAX package's ``apply``."""
    shapes = flax_shapes(module)
    xavier = {"params/" + path.replace(".", "/") for path, sub in module.named_modules()
              if getattr(sub, "xavier_init", False)}
    rng = np.random.default_rng(seed)
    init_scale = 10.0
    K = len(FILTERS) + 1
    pedestal = (2.0 ** -18) ** 2
    flat = {}
    for key in sorted(shapes):
        shape, (parent, leaf) = shapes[key], key.rsplit("/", 1)
        if parent in xavier:
            value = _xavier_normal(rng, shape) if leaf == "kernel" else np.full(shape, 0.01)
        elif leaf == "kernel":
            value = _lecun_normal(rng, shape)
        elif leaf.startswith("matrix_"):
            scale = init_scale ** (1.0 / K)
            value = np.full(shape, np.log(np.expm1(1.0 / scale / shape[1])))
        elif leaf.startswith("bias_"):
            value = rng.uniform(-0.5, 0.5, shape)
        elif leaf == "quantiles":
            value = np.tile(np.asarray([-init_scale, 0.0, init_scale]), (shape[0], 1, 1))
        elif leaf == "bias" and parent.rsplit("/", 1)[-1].startswith("WSConvBlock_"):
            bound = float(np.prod(shapes[key[: -len("bias")] + "kernel"][:-1])) ** -0.5
            value = rng.uniform(-bound, bound, shape)
        elif leaf in ("scale", "g"):
            value = np.ones(shape)
        elif leaf in ("bias",) or leaf.startswith("factor_"):
            value = np.zeros(shape)
        elif leaf == "beta":
            value = np.sqrt(np.ones(shape) + pedestal)
        elif leaf == "gamma":
            value = np.sqrt(0.1 * np.eye(shape[0]) + pedestal)
        elif leaf in ("h", "b", "a"):
            value = rng.normal(0.0, 0.01, shape)
        elif leaf == "wpe":  # VPCT's position table and start token
            value = rng.normal(0.0, 0.02, shape)
        elif leaf == "param_token":
            value = rng.normal(0.0, 1.0, shape)
        else:
            raise KeyError(f"no initialiser for {key!r}")
        flat[key] = value.astype(np.float32)
    return flat
