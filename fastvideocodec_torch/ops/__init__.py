"""Tensor ops of the port (NCHW)."""

from fastvideocodec_torch.ops.gdn import GDN
from fastvideocodec_torch.ops.math import (
    bits_estimate,
    laplace_cdf,
    laplace_likelihood,
    lower_bound,
    psnr_from_mse,
    quantize,
)
from fastvideocodec_torch.ops.warp import (
    avg_pool2,
    bilinear_upsample_x2,
    bilinear_upsample_x2_ac,
    depth_to_space,
    flow_warp,
    flow_warp_fullres_s2d,
    plain_flow_warp,
    plain_flow_warp_s2d,
    space_to_depth,
)

__all__ = [
    "GDN",
    "avg_pool2",
    "bilinear_upsample_x2",
    "bilinear_upsample_x2_ac",
    "bits_estimate",
    "depth_to_space",
    "flow_warp",
    "flow_warp_fullres_s2d",
    "laplace_cdf",
    "laplace_likelihood",
    "lower_bound",
    "plain_flow_warp",
    "plain_flow_warp_s2d",
    "psnr_from_mse",
    "quantize",
    "space_to_depth",
]
