"""Config-list-driven conv stack (the reference's ``CodecNet``,
models.py:1492-1546), ported from fastvideocodec_tpu/layers/codecnet.py.

A config is a tuple whose entries are either an int, a parameter-free op
code, or a 5-tuple ``(type, kernel, stride, ch_in, ch_out)``, a layer:

====  =============================================================
0     conv ``k x k`` stride ``s`` (padding k//2)          ``conv_{i}``
1     transposed conv: at stride 2 the polyphase deconv,  ``deconv_{i}``
      else flax's ``ConvTranspose(padding="SAME")``
2     ReLU
3     LeakyReLU(0.1)
4     GDN                                                 ``gdn_{i}``
5     inverse GDN                                         ``igdn_{i}``
7     Tanh
8     strided basic residual block                        ``basic_{i}``
10    average pool ``k x k`` stride ``s``
11    conv attention block                                ``attn_{i}``
13    residual block (stride 1)                           ``res_{i}``
====  =============================================================

Children keep the JAX module's names (right column), so its checkpoints
load with no renaming. The codes' convs and non-stride-2 deconvs carry
the reference's init in the JAX package (Xavier-normal with gain sqrt(2),
bias 0.01); they are marked ``xavier_init`` for ``weights.seeded_flat``.
Codes 6, 9 and 12 raise, as in the JAX package.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from fastvideocodec_torch.layers.blocks import ConvAttention, ResBlock, SameConvTranspose, conv
from fastvideocodec_torch.layers.transforms import polyphase_deconv
from fastvideocodec_torch.ops.gdn import GDN


class StridedBasicBlock(nn.Module):
    """Code 8: relu(shortcut(x) + conv(relu(conv_s(x)))), the shortcut a
    stride-s 1x1 conv where the stride or the width changes."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = conv(in_channels, out_channels, 3, stride)
        self.Conv_1 = conv(out_channels, out_channels, 3)
        self.Conv_2 = (nn.Conv2d(in_channels, out_channels, 1, stride=stride)
                       if stride != 1 or in_channels != out_channels else None)

    def forward(self, x):
        h = self.Conv_1(F.relu(self.Conv_0(x)))
        if self.Conv_2 is not None:
            x = self.Conv_2(x)
        return F.relu(x + h)


def _xavier(module: nn.Module) -> nn.Module:
    module.xavier_init = True
    return module


class CodecNet(nn.Module):
    """The stack of ``cfgs`` on ``in_channels`` input channels."""

    def __init__(self, cfgs: tuple, in_channels: int):
        super().__init__()
        self.steps = []  # (code, child name or None, kernel, stride)
        ch = in_channels
        for i, cfg in enumerate(cfgs):
            if isinstance(cfg, int):
                code, k, s, ch1, ch2 = cfg, None, None, ch, ch
            else:
                code, k, s, ch1, ch2 = cfg
                if ch1 != ch:
                    raise ValueError(f"cfg[{i}] expects {ch1} input channels, got {ch}")
            name = None
            if code == 0:
                name, child = f"conv_{i}", _xavier(conv(ch1, ch2, k, s))
            elif code == 1:
                name = f"deconv_{i}"
                child = (polyphase_deconv(ch1, ch2, k) if s == 2
                         else _xavier(SameConvTranspose(ch1, ch2, k, s)))
            elif code == 4:
                name, child = f"gdn_{i}", GDN(ch2)
            elif code == 5:
                name, child = f"igdn_{i}", GDN(ch2, inverse=True)
            elif code == 8:
                name, child = f"basic_{i}", StridedBasicBlock(ch1, ch2, s)
            elif code == 11:
                if ch1 != ch2:
                    raise ValueError(f"cfg[{i}]: attention keeps the width, {ch1} -> {ch2}")
                name, child = f"attn_{i}", ConvAttention(ch2)
            elif code == 13:
                name, child = f"res_{i}", ResBlock(ch1, ch2)
            elif code not in (2, 3, 7, 10):
                raise ValueError(f"conv type {code} not supported (cfg[{i}])")
            if name is not None:
                self.add_module(name, child)
            self.steps.append((code, name, k, s))
            ch = ch2

    def forward(self, x):
        for code, name, k, s in self.steps:
            if name is not None:
                x = getattr(self, name)(x)
            elif code == 2:
                x = F.relu(x)
            elif code == 3:
                x = F.leaky_relu(x, 0.1)
            elif code == 7:
                x = x.tanh()
            else:  # 10
                x = F.avg_pool2d(x, k, s)
        return x


def er_gen_config(channels: int, hidden: int, kernel: int = 5, act: int = 3) -> tuple:
    """The Base-ER error-restoration stack (reference models.py:1587-1589):
    four stride-1 convs channels -> hidden -> hidden -> hidden -> channels,
    each followed by the activation code (LeakyReLU, 3)."""
    k = kernel
    return (
        (0, k, 1, channels, hidden), act,
        (0, k, 1, hidden, hidden), act,
        (0, k, 1, hidden, hidden), act,
        (0, k, 1, hidden, channels), act,
    )
