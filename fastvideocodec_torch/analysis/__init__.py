"""Host-side analysis of the port's results: the Bjøntegaard deltas and
the RD points, BD-rate tables and charts of the eval logs."""

from fastvideocodec_torch.analysis.bdrate import bd_psnr, bd_rate
from fastvideocodec_torch.analysis.plots import bd_rate_table, plot_rd_curves, plot_speed, rd_points

__all__ = ["bd_psnr", "bd_rate", "bd_rate_table", "plot_rd_curves", "plot_speed", "rd_points"]
