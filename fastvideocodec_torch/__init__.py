"""PyTorch / CUDA port of fastvideocodec_tpu, for one NVIDIA H100.

Imports torch, numpy and (for the Gaussian coder tables) scipy: nothing of
JAX and nothing of the JAX package, which stays the reference. Ported:
every codec of the JAX registry's rollout (``rollout`` dispatches on the
codec family), the LSVC decode graph, the real bitstreams
(``coder.video``: the networks on the card, a C++ range coder on host
threads), and LSVC's training (``train``, ``cli.train``). Tensors are
NCHW; space-to-depth keeps the JAX channel order (ry, rx, c). Entry points
run on the card unless the caller passes ``device="cpu"``. The bilinear
warps are hand-written CUDA kernels (ops/kernels/csrc/warp.cu, built with
nvcc at first use); CPU tensors take their plain PyTorch versions.
"""

from fastvideocodec_torch.gop import build_lsvc_decode, rollout
from fastvideocodec_torch.models import CodecSpec, get_codec_model
from fastvideocodec_torch.weights import load_asset, load_flat, load_params, seeded_flat

__all__ = [
    "CodecSpec",
    "build_lsvc_decode",
    "get_codec_model",
    "load_asset",
    "load_flat",
    "load_params",
    "rollout",
    "seeded_flat",
]
