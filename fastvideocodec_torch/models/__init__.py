from fastvideocodec_torch.models.lsvc import LSVC
from fastvideocodec_torch.models.registry import CodecSpec, get_codec_model

__all__ = ["LSVC", "CodecSpec", "get_codec_model"]
