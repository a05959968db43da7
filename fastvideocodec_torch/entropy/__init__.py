from fastvideocodec_torch.entropy.bit_estimator import BitEstimator, Bitparm

__all__ = ["BitEstimator", "Bitparm"]
