from fastvideocodec_torch.data.synthetic import synth_gop_multi

__all__ = ["synth_gop_multi"]
