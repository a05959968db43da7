from fastvideocodec_torch.data.synthetic import (
    row_views,
    synth_gop,
    synth_gop_lowrate,
    synth_gop_multi,
    synth_mv_gop,
)

__all__ = ["row_views", "synth_gop", "synth_gop_lowrate", "synth_gop_multi", "synth_mv_gop"]
