"""Host-side analysis of the port's results: the Bjøntegaard deltas."""

from fastvideocodec_torch.analysis.bdrate import bd_psnr, bd_rate

__all__ = ["bd_psnr", "bd_rate"]
