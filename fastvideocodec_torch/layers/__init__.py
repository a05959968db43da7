from fastvideocodec_torch.layers.blocks import MEBasic, ResBlock, WarpNet
from fastvideocodec_torch.layers.spynet import SpyNet
from fastvideocodec_torch.layers.transforms import (
    AnalysisMVNet,
    AnalysisNet,
    AnalysisPriorNet,
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
    "SpyNet",
    "SynthesisMVNet",
    "SynthesisNet",
    "SynthesisPriorNet",
    "WarpNet",
]
