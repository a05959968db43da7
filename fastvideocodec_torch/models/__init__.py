from fastvideocodec_torch.models.elfvc import ELFVC, ElfvcState
from fastvideocodec_torch.models.lsvc import LSVC
from fastvideocodec_torch.models.registry import CodecSpec, get_codec_model
from fastvideocodec_torch.models.ssf import ScaleSpaceFlow

__all__ = ["ELFVC", "LSVC", "CodecSpec", "ElfvcState", "ScaleSpaceFlow", "get_codec_model"]
