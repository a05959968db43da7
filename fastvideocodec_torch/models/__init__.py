from fastvideocodec_torch.models.base import Base
from fastvideocodec_torch.models.dvc import DVC
from fastvideocodec_torch.models.elfvc import ELFVC, ElfvcState
from fastvideocodec_torch.models.lsvc import LSVC
from fastvideocodec_torch.models.mcvc import MCVC, sample_view_mask
from fastvideocodec_torch.models.registry import CodecSpec, get_codec_model
from fastvideocodec_torch.models.rlvc import RLVC, RlvcHidden
from fastvideocodec_torch.models.ssf import ScaleSpaceFlow

__all__ = ["DVC", "ELFVC", "LSVC", "MCVC", "RLVC", "Base", "CodecSpec", "ElfvcState",
           "RlvcHidden", "ScaleSpaceFlow", "get_codec_model", "sample_view_mask"]
