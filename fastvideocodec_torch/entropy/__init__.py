from fastvideocodec_torch.entropy.bit_estimator import BitEstimator, Bitparm
from fastvideocodec_torch.entropy.factorized import EntropyBottleneck
from fastvideocodec_torch.entropy.gaussian import GaussianConditional, LaplaceConditional
from fastvideocodec_torch.entropy.hyperprior import MeanScaleHyperPriors, SSFHyperprior
from fastvideocodec_torch.entropy.rpm import RPM, RecProbModel

__all__ = ["BitEstimator", "Bitparm", "EntropyBottleneck", "GaussianConditional",
           "LaplaceConditional", "MeanScaleHyperPriors", "RPM", "RecProbModel",
           "SSFHyperprior"]
