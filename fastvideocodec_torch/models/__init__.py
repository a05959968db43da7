from fastvideocodec_torch.models.lsvc import LSVC
from fastvideocodec_torch.models.registry import CodecSpec, get_codec_model
from fastvideocodec_torch.models.ssf import ScaleSpaceFlow

__all__ = ["LSVC", "CodecSpec", "ScaleSpaceFlow", "get_codec_model"]
