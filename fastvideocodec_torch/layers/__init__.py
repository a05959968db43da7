from fastvideocodec_torch.layers.blocks import MEBasic, ResBlock, WarpNet, qrelu
from fastvideocodec_torch.layers.spynet import SpyNet
from fastvideocodec_torch.layers.transforms import (
    AnalysisMVNet,
    AnalysisNet,
    AnalysisPriorNet,
    SSFDecoder,
    SSFEncoder,
    SSFHyperDecoder,
    SSFHyperDecoderQReLU,
    SynthesisMVNet,
    SynthesisNet,
    SynthesisPriorNet,
)

__all__ = [
    "AnalysisMVNet",
    "AnalysisNet",
    "AnalysisPriorNet",
    "MEBasic",
    "ResBlock",
    "SSFDecoder",
    "SSFEncoder",
    "SSFHyperDecoder",
    "SSFHyperDecoderQReLU",
    "SpyNet",
    "SynthesisMVNet",
    "SynthesisNet",
    "SynthesisPriorNet",
    "WarpNet",
    "qrelu",
]
