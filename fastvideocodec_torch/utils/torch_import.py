"""torch -> flax checkpoint converter for DVC-family snapshots, the port's own
copy of fastvideocodec_tpu/utils/torch_import.py.

The reference ships/loads torch state dicts for its DVC models
(`DVC/snapshot/{256,512,1024,2048}.model`, models.py:1438-1444; torch module
attribute names at DVC/net.py:39-56). This converter maps those key names
and tensor layouts onto the JAX package's `models.DVC` flax parameter tree, which the port
loads by flax name (`weights.load_flat`), so
"DVC-pretrained" is a real capability, not a name alias.

Layout rules:
- Conv2d weight [O, I, kh, kw]      -> flax Conv kernel [kh, kw, I, O]
- ConvTranspose2d weight [I, O, kh, kw] -> flax ConvTranspose-SAME kernel
  [kh, kw, I, O] (the PolyphaseDeconv 'kernel' param uses the identical
  convention; torch's transposed conv applies the kernel un-flipped in the
  transposed indexing, which is exactly lax.conv_transpose's default —
  verified against torch in tests/test_torch_import.py)
- stride-1 ConvTranspose2d (respriorDecoder.deconv3) -> plain flax Conv:
  spatially FLIPPED kernel (a stride-1 transposed conv is a correlation
  with the flipped kernel)
- GDN beta [ch], gamma [ch, ch]     -> copied directly (same sqrt reparam)
- Bitparm h/b/a [1, C, 1, 1]        -> reshaped to [C]
"""

from __future__ import annotations

import re

import numpy as np


def _conv_w(w):
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def _deconv_w(w):
    return np.transpose(np.asarray(w), (2, 3, 0, 1))


def _deconv_w_as_conv(w):
    # stride-1 transposed conv == conv with the spatially flipped kernel
    return np.transpose(np.asarray(w), (2, 3, 0, 1))[::-1, ::-1]


def _vec(w):
    return np.asarray(w).reshape(-1)


def _set(tree: dict, path: tuple, value):
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def convert_dvc_state_dict(sd: dict) -> dict:
    """sd: {torch_key: array-like} (a VideoCompressor state dict, tensors
    already on CPU / numpy). Returns {"params": flax_tree} for models.DVC.

    Raises KeyError listing any unmapped source keys, so silent partial
    imports cannot happen."""
    params: dict = {}
    used = set()

    def take(key):
        used.add(key)
        return np.asarray(sd[key])

    # SpyNet: opticFlow.moduleBasic.{L}.conv{j} -> optic_flow/level{L+1}/Conv_{j-1}
    for L in range(4):
        for j in range(1, 6):
            src = f"opticFlow.moduleBasic.{L}.conv{j}"
            dst = ("optic_flow", f"level{L + 1}", f"Conv_{j - 1}")
            _set(params, dst + ("kernel",), _conv_w(take(src + ".weight")))
            _set(params, dst + ("bias",), _vec(take(src + ".bias")))

    # mvEncoder.conv{1..8} -> mv_encoder/Conv_{0..7}
    for j in range(1, 9):
        src = f"mvEncoder.conv{j}"
        dst = ("mv_encoder", f"Conv_{j - 1}")
        _set(params, dst + ("kernel",), _conv_w(take(src + ".weight")))
        _set(params, dst + ("bias",), _vec(take(src + ".bias")))

    # mvDecoder.deconv{1..8}: odd = stride-2 transposed convs, even = convs
    dec_i = conv_i = 0
    for j in range(1, 9):
        src = f"mvDecoder.deconv{j}"
        if j % 2 == 1 and j < 8:
            dst = ("mv_decoder", f"PolyphaseDeconv_{dec_i}")
            dec_i += 1
            _set(params, dst + ("kernel",), _deconv_w(take(src + ".weight")))
        else:
            dst = ("mv_decoder", f"Conv_{conv_i}")
            conv_i += 1
            _set(params, dst + ("kernel",), _conv_w(take(src + ".weight")))
        _set(params, dst + ("bias",), _vec(take(src + ".bias")))

    # warpnet: feature_ext -> Conv_0; conv{0..5} ResBlocks; conv6 -> Conv_1
    _set(params, ("warpnet", "Conv_0", "kernel"),
         _conv_w(take("warpnet.feature_ext.weight")))
    _set(params, ("warpnet", "Conv_0", "bias"),
         _vec(take("warpnet.feature_ext.bias")))
    for i in range(6):
        for j in (1, 2):
            src = f"warpnet.conv{i}.conv{j}"
            dst = ("warpnet", f"ResBlock_{i}", f"Conv_{j - 1}")
            _set(params, dst + ("kernel",), _conv_w(take(src + ".weight")))
            _set(params, dst + ("bias",), _vec(take(src + ".bias")))
    _set(params, ("warpnet", "Conv_1", "kernel"),
         _conv_w(take("warpnet.conv6.weight")))
    _set(params, ("warpnet", "Conv_1", "bias"),
         _vec(take("warpnet.conv6.bias")))

    # resEncoder: conv1..4 + gdn1..3
    for j in range(1, 5):
        src = f"resEncoder.conv{j}"
        dst = ("res_encoder", f"Conv_{j - 1}")
        _set(params, dst + ("kernel",), _conv_w(take(src + ".weight")))
        _set(params, dst + ("bias",), _vec(take(src + ".bias")))
    for j in range(1, 4):
        src = f"resEncoder.gdn{j}"
        dst = ("res_encoder", f"GDN_{j - 1}")
        _set(params, dst + ("beta",), _vec(take(src + ".beta")))
        _set(params, dst + ("gamma",), np.asarray(take(src + ".gamma")))

    # resDecoder: deconv1..4 + igdn1..3
    for j in range(1, 5):
        src = f"resDecoder.deconv{j}"
        dst = ("res_decoder", f"PolyphaseDeconv_{j - 1}")
        _set(params, dst + ("kernel",), _deconv_w(take(src + ".weight")))
        _set(params, dst + ("bias",), _vec(take(src + ".bias")))
    for j in range(1, 4):
        src = f"resDecoder.igdn{j}"
        dst = ("res_decoder", f"GDN_{j - 1}")
        _set(params, dst + ("beta",), _vec(take(src + ".beta")))
        _set(params, dst + ("gamma",), np.asarray(take(src + ".gamma")))

    # respriorEncoder.conv1..3 -> prior_encoder/Conv_0..2
    for j in range(1, 4):
        src = f"respriorEncoder.conv{j}"
        dst = ("prior_encoder", f"Conv_{j - 1}")
        _set(params, dst + ("kernel",), _conv_w(take(src + ".weight")))
        _set(params, dst + ("bias",), _vec(take(src + ".bias")))

    # respriorDecoder: deconv1/2 stride-2; deconv3 stride-1 -> plain Conv_0
    for j in (1, 2):
        src = f"respriorDecoder.deconv{j}"
        dst = ("prior_decoder", f"PolyphaseDeconv_{j - 1}")
        _set(params, dst + ("kernel",), _deconv_w(take(src + ".weight")))
        _set(params, dst + ("bias",), _vec(take(src + ".bias")))
    _set(params, ("prior_decoder", "Conv_0", "kernel"),
         _deconv_w_as_conv(take("respriorDecoder.deconv3.weight")))
    _set(params, ("prior_decoder", "Conv_0", "bias"),
         _vec(take("respriorDecoder.deconv3.bias")))

    # bit estimators: f1..f4 Bitparm h/b(/a) [1,C,1,1] -> [C]
    for torch_name, flax_name in (
        ("bitEstimator_z", "bit_estimator_z"),
        ("bitEstimator_mv", "bit_estimator_mv"),
    ):
        for j in range(1, 5):
            for p in ("h", "b") + (("a",) if j < 4 else ()):
                _set(
                    params,
                    (flax_name, f"f{j}", p),
                    _vec(take(f"{torch_name}.f{j}.{p}")),
                )

    ignore = re.compile(r"\.(num_batches_tracked|running_mean|running_var)$")
    unmapped = [k for k in sd if k not in used and not ignore.search(k)]
    if unmapped:
        raise KeyError(f"unmapped torch keys: {unmapped[:10]}"
                       f"{'...' if len(unmapped) > 10 else ''}")
    return {"params": params}


def load_torch_dvc_checkpoint(path: str) -> dict:
    """Loads a reference DVC snapshot (torch .model/.pth) and converts it.
    Accepts either a bare state dict or a {'state_dict': ...} wrapper."""
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    sd = {k: v.detach().cpu().numpy() for k, v in sd.items()
          if hasattr(v, "detach")}
    return convert_dvc_state_dict(sd)
