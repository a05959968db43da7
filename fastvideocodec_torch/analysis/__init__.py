"""Host-side analysis of the port's results: the Bjøntegaard deltas, the
RD points, BD-rate tables and charts of the eval logs, and the streaming
simulations over them (BOLA adaptive bitrate, the multi-camera trace)."""

from fastvideocodec_torch.analysis.abr import AbrConfig, bola_simulate, segment_tables
from fastvideocodec_torch.analysis.bdrate import bd_psnr, bd_rate
from fastvideocodec_torch.analysis.plots import bd_rate_table, plot_rd_curves, plot_speed, rd_points
from fastvideocodec_torch.analysis.trace_sim import read_avg_log, simulate_over_trace

__all__ = [
    "AbrConfig",
    "bd_psnr",
    "bd_rate",
    "bd_rate_table",
    "bola_simulate",
    "plot_rd_curves",
    "plot_speed",
    "rd_points",
    "read_avg_log",
    "segment_tables",
    "simulate_over_trace",
]
