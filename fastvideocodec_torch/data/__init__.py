from fastvideocodec_torch.data.loader import prefetch_batches
from fastvideocodec_torch.data.multiview import MultiViewVideoDataset
from fastvideocodec_torch.data.synthetic import (
    row_views,
    synth_gop,
    synth_gop_lowrate,
    synth_gop_multi,
    synth_mv_gop,
)
from fastvideocodec_torch.data.vimeo import FrameDataset

__all__ = ["FrameDataset", "MultiViewVideoDataset", "prefetch_batches", "row_views", "synth_gop",
           "synth_gop_lowrate", "synth_gop_multi", "synth_mv_gop"]
