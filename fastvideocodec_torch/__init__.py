"""PyTorch / CUDA port of fastvideocodec_tpu, for one NVIDIA H100.

Imports torch and numpy only: nothing of JAX and nothing of the JAX
package, which stays the reference. Tensors are NCHW; space-to-depth keeps
the JAX channel order (ry, rx, c). Entry points run on the card unless the
caller passes ``device="cpu"``. The bilinear warps of the main path are
hand-written CUDA kernels (ops/kernels/csrc/warp.cu, built with nvcc at
first use); CPU tensors take their plain PyTorch versions.
"""

from fastvideocodec_torch.gop import build_lsvc_decode, rollout
from fastvideocodec_torch.models import CodecSpec, get_codec_model
from fastvideocodec_torch.weights import load_asset, load_params

__all__ = [
    "CodecSpec",
    "build_lsvc_decode",
    "get_codec_model",
    "load_asset",
    "load_params",
    "rollout",
]
