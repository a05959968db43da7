"""Analysis/synthesis transforms (NCHW), ported from
fastvideocodec_tpu/layers/transforms.py for the LSVC, SSF-TPU,
ELFVC(-SP)-TPU and MCVC configurations, stock SSF's and ELFVC's
(``s2d=1``), and the stock DVC transforms of DVC, Base and LSVC's ``s2d=1``
form (``stages=4``, the mv decoder without a polyphase output:
``polyphase_factor=None``).

With ``attn_depth`` > 0 (LSVC's -A analysis and -S synthesis forms) each of
the six LSVC transforms holds a ``SpaceTimeAttention_0`` of that depth
where the JAX package places it: after the last conv of AnalysisNet and
AnalysisMVNet, before the first deconv of SynthesisNet and
SynthesisMVNet, after the first conv of AnalysisPriorNet, and between the
two deconvs of SynthesisPriorNet.

Child modules carry the flax auto-names of the JAX modules (``Conv_0``,
``GDN_1``, ``PolyphaseDeconv_2``...), so a flax parameter path maps onto
the port's ``state_dict`` key by renaming only its leaf (weights.py).

``PolyphaseDeconv`` is ``nn.ConvTranspose2d(k, 2, k//2, output_padding=1)``:
the JAX polyphase form computes the same map as this transposed conv on the
un-flipped ``[I, O, k, k]`` kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fastvideocodec_torch.layers.blocks import SpaceTimeAttention, conv, qrelu
from fastvideocodec_torch.ops.gdn import GDN
from fastvideocodec_torch.ops.warp import depth_to_space

OUT_CHANNEL_N = 64
OUT_CHANNEL_M = 96
OUT_CHANNEL_MV = 128
STAGES = 3  # the default: stride-2 stages of each transform in the LSVC-TPU s2d domain
POLYPHASE_FACTOR = 4  # the default: LSVC-TPU's mv decoder emits the full-resolution flow


def polyphase_deconv(cin: int, cout: int, k: int) -> nn.ConvTranspose2d:
    """Stride-2 transposed conv doubling H and W (the JAX PolyphaseDeconv)."""
    return nn.ConvTranspose2d(cin, cout, k, stride=2, padding=k // 2, output_padding=1)


def leaky01(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


def _attend(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """x through the module's SpaceTimeAttention_0 where it has one."""
    attn = getattr(module, "SpaceTimeAttention_0", None)
    return x if attn is None else attn(x)


def _add_attention(module: nn.Module, dim: int, depth: int) -> None:
    if depth:
        module.add_module("SpaceTimeAttention_0", SpaceTimeAttention(dim, depth))


class AnalysisNet(nn.Module):
    """``stages`` x (5x5 s2 conv + GDN), no GDN after the last conv."""

    def __init__(self, in_channels: int, conv_channels: int = OUT_CHANNEL_N,
                 out_channels: int = OUT_CHANNEL_M, stages: int = STAGES, attn_depth: int = 0):
        super().__init__()
        self.stages = stages
        cin = in_channels
        for i in range(stages - 1):
            self.add_module(f"Conv_{i}", conv(cin, conv_channels, 5, 2))
            self.add_module(f"GDN_{i}", GDN(conv_channels))
            cin = conv_channels
        self.add_module(f"Conv_{stages - 1}", conv(cin, out_channels, 5, 2))
        _add_attention(self, out_channels, attn_depth)

    def forward(self, x):
        for i in range(self.stages - 1):
            x = getattr(self, f"GDN_{i}")(getattr(self, f"Conv_{i}")(x))
        return _attend(self, getattr(self, f"Conv_{self.stages - 1}")(x))


class SynthesisNet(nn.Module):
    """``stages`` x (5x5 s2 deconv + inverse GDN), no GDN after the last."""

    def __init__(self, in_channels: int = OUT_CHANNEL_M, conv_channels: int = OUT_CHANNEL_N,
                 out_channels: int = 3, stages: int = STAGES, attn_depth: int = 0):
        super().__init__()
        self.stages = stages
        _add_attention(self, in_channels, attn_depth)
        cin = in_channels
        for i in range(stages - 1):
            self.add_module(f"PolyphaseDeconv_{i}", polyphase_deconv(cin, conv_channels, 5))
            self.add_module(f"GDN_{i}", GDN(conv_channels, inverse=True))
            cin = conv_channels
        self.add_module(
            f"PolyphaseDeconv_{stages - 1}", polyphase_deconv(cin, out_channels, 5)
        )

    def forward(self, x):
        x = _attend(self, x)
        for i in range(self.stages - 1):
            x = getattr(self, f"GDN_{i}")(getattr(self, f"PolyphaseDeconv_{i}")(x))
        return getattr(self, f"PolyphaseDeconv_{self.stages - 1}")(x)


class AnalysisMVNet(nn.Module):
    """3x3 convs with LeakyReLU(0.1): strides [2, 1] * (stages-1) + [2],
    then a stride-1 output conv."""

    def __init__(self, in_channels: int = 2, conv_channels: int = OUT_CHANNEL_MV,
                 out_channels: int = OUT_CHANNEL_MV, stages: int = STAGES, attn_depth: int = 0):
        super().__init__()
        strides = [2, 1] * (stages - 1) + [2]
        self.n = len(strides)
        cin = in_channels
        for i, s in enumerate(strides):
            self.add_module(f"Conv_{i}", conv(cin, conv_channels, 3, s))
            cin = conv_channels
        self.add_module(f"Conv_{self.n}", conv(cin, out_channels, 3))
        _add_attention(self, out_channels, attn_depth)

    def forward(self, x):
        for i in range(self.n):
            x = leaky01(getattr(self, f"Conv_{i}")(x))
        return _attend(self, getattr(self, f"Conv_{self.n}")(x))


class SynthesisMVNet(nn.Module):
    """Motion synthesis, the mirrored stack of 3x3 layers with
    LeakyReLU(0.1). With a ``polyphase_factor`` f (LSVC-TPU's 4) the stack
    stops one doubling short, and a final 3x3 conv emits f*f*out_channels
    channels in (ry, rx, c) order that depth-to-space by f into the
    full-resolution flow; with None (stock DVC and Base) the last stride-2
    deconv runs too and a 3x3 conv emits ``out_channels``."""

    def __init__(self, in_channels: int = OUT_CHANNEL_MV, conv_channels: int = OUT_CHANNEL_MV,
                 out_channels: int = 2, stages: int = STAGES,
                 polyphase_factor: int | None = POLYPHASE_FACTOR, attn_depth: int = 0):
        super().__init__()
        self.factor = polyphase_factor
        _add_attention(self, in_channels, attn_depth)
        self.ups = [True, False] * (stages - 1) + [True]
        if polyphase_factor is not None:
            self.ups = self.ups[:-1]
        cin, n_deconv, n_conv = in_channels, 0, 0
        for up in self.ups:
            if up:
                self.add_module(
                    f"PolyphaseDeconv_{n_deconv}", polyphase_deconv(cin, conv_channels, 3)
                )
                n_deconv += 1
            else:
                self.add_module(f"Conv_{n_conv}", conv(cin, conv_channels, 3))
                n_conv += 1
            cin = conv_channels
        self.n_conv = n_conv
        f = polyphase_factor or 1
        self.add_module(f"Conv_{n_conv}", conv(cin, f * f * out_channels, 3))

    def forward(self, x):
        x = _attend(self, x)
        n_deconv = n_conv = 0
        for up in self.ups:
            if up:
                x = leaky01(getattr(self, f"PolyphaseDeconv_{n_deconv}")(x))
                n_deconv += 1
            else:
                x = leaky01(getattr(self, f"Conv_{n_conv}")(x))
                n_conv += 1
        x = getattr(self, f"Conv_{self.n_conv}")(x)
        return x if self.factor is None else depth_to_space(x, self.factor)


class AnalysisPriorNet(nn.Module):
    """abs -> conv3 s1 -> relu -> conv5 s2 -> relu -> conv5 s2 (``abs`` a
    class attribute, as SSFHyperDecoder's ``act``)."""

    abs = staticmethod(torch.abs)

    def __init__(self, in_channels: int = OUT_CHANNEL_M, conv_channels: int = OUT_CHANNEL_N,
                 attn_depth: int = 0):
        super().__init__()
        c = conv_channels
        self.Conv_0 = conv(in_channels, c, 3)
        _add_attention(self, c, attn_depth)
        self.Conv_1 = conv(c, c, 5, 2)
        self.Conv_2 = conv(c, c, 5, 2)

    def forward(self, x):
        x = _attend(self, F.relu(self.Conv_0(self.abs(x))))
        x = F.relu(self.Conv_1(x))
        return self.Conv_2(x)


class SynthesisPriorNet(nn.Module):
    """deconv5 s2 -> relu -> deconv5 s2 -> relu -> conv3 -> exp (sigma)."""

    def __init__(self, conv_channels: int = OUT_CHANNEL_N, out_channels: int = OUT_CHANNEL_M,
                 attn_depth: int = 0):
        super().__init__()
        c = conv_channels
        self.PolyphaseDeconv_0 = polyphase_deconv(c, c, 5)
        _add_attention(self, c, attn_depth)
        self.PolyphaseDeconv_1 = polyphase_deconv(c, c, 5)
        self.Conv_0 = conv(c, out_channels, 3)

    def forward(self, x):
        x = _attend(self, F.relu(self.PolyphaseDeconv_0(x)))
        x = F.relu(self.PolyphaseDeconv_1(x))
        return torch.exp(self.Conv_0(x))


# ---------------------------------------------------------------------------
# SSF-family conv stacks: ``s2d=2`` is the SSF-TPU configuration (input and
# output kept in the s2d domain), ``s2d=1`` stock SSF's full-resolution one
# ---------------------------------------------------------------------------


class SSFEncoder(nn.Module):
    """5x5 stride-2 convs, ReLU between, the latent at /16 of full
    resolution. ``s2d=2``: the branch with ``input_s2d``, three convs on
    a frame already in s2d form (the motion encoder's input phase-blocked,
    cat(s2d(cur), s2d(ref))); the same stack is the JAX package's
    ``SSFHyperEncoder``, which the hyperprior uses. ``s2d=1``: four convs
    on the full-resolution frame (``Conv_0..3``)."""

    def __init__(self, in_channels: int, mid_planes: int = 128, out_planes: int = 192,
                 s2d: int = 2):
        super().__init__()
        if s2d not in (1, 2):
            raise ValueError(f"s2d must be 1 or 2, got {s2d}")
        self.n = 5 - s2d
        cin = in_channels
        for i in range(self.n - 1):
            self.add_module(f"Conv_{i}", conv(cin, mid_planes, 5, 2))
            cin = mid_planes
        self.add_module(f"Conv_{self.n - 1}", conv(cin, out_planes, 5, 2))

    def forward(self, x):
        for i in range(self.n - 1):
            x = F.relu(getattr(self, f"Conv_{i}")(x))
        return getattr(self, f"Conv_{self.n - 1}")(x)


class SSFDecoder(nn.Module):
    """5x5 stride-2 deconvs from the /16 latent, ReLU after each but the
    last layer. ``s2d=2``: the branch with ``output_s2d``: two deconvs lift
    the latent to /4, a third emits ``4*mid_planes//8`` channels at /2, and
    a 3x3 conv emits ``4*out_planes`` channels at /2 in (ry, rx, c) order,
    returned without depth-to-space (the SSF-TPU motion decoder's 12
    channels are read in c-major phase order by the warp). ``s2d=1``: four
    deconvs (``PolyphaseDeconv_0..3``), the last to ``out_planes`` at full
    resolution."""

    def __init__(self, in_channels: int, mid_planes: int = 128, out_planes: int = 3,
                 s2d: int = 2):
        super().__init__()
        if s2d not in (1, 2):
            raise ValueError(f"s2d must be 1 or 2, got {s2d}")
        m = mid_planes
        self.s2d = s2d
        self.PolyphaseDeconv_0 = polyphase_deconv(in_channels, m, 5)
        self.PolyphaseDeconv_1 = polyphase_deconv(m, m, 5)
        if s2d == 2:
            self.PolyphaseDeconv_2 = polyphase_deconv(m, 4 * m // 8, 5)
            self.Conv_0 = conv(4 * m // 8, 4 * out_planes, 3)
        else:
            self.PolyphaseDeconv_2 = polyphase_deconv(m, m, 5)
            self.PolyphaseDeconv_3 = polyphase_deconv(m, out_planes, 5)

    def forward(self, x):
        x = F.relu(self.PolyphaseDeconv_0(x))
        x = F.relu(self.PolyphaseDeconv_1(x))
        x = F.relu(self.PolyphaseDeconv_2(x))
        return self.Conv_0(x) if self.s2d == 2 else self.PolyphaseDeconv_3(x)


class SSFHyperDecoder(nn.Module):
    """3 x (5x5 s2 deconv), all ``planes`` wide, ``act`` between (ReLU)
    and, when ``act_last``, after the last."""

    act = staticmethod(F.relu)
    act_last = False

    def __init__(self, planes: int = 192):
        super().__init__()
        self.PolyphaseDeconv_0 = polyphase_deconv(planes, planes, 5)
        self.PolyphaseDeconv_1 = polyphase_deconv(planes, planes, 5)
        self.PolyphaseDeconv_2 = polyphase_deconv(planes, planes, 5)

    def forward(self, x):
        x = self.act(self.PolyphaseDeconv_0(x))
        x = self.act(self.PolyphaseDeconv_1(x))
        x = self.PolyphaseDeconv_2(x)
        return self.act(x) if self.act_last else x


class SSFHyperDecoderQReLU(SSFHyperDecoder):
    """SSFHyperDecoder with QReLU after every deconv (the scale decoder)."""

    act = staticmethod(qrelu)
    act_last = True


class FlowPredictor(nn.Module):
    """ELFVC's local motion prediction from the decoded context (four 5x5
    convs, ReLU after the first three). ``s2d=2``: the ``input_s2d,
    output_s2d, quarter_trunk`` branch of the '-TPU' codecs: a stride-2
    stem from the s2d context to /4 of full resolution, two convs there,
    and a conv to ``4*f*f*out_planes`` channels whose depth-to-space by 2
    (the JAX (ry, rx, c) order) gives the /2 motion field in s2d form.
    ``s2d=1``: the stock branch, all four stride-1 at full resolution, to
    ``out_planes`` channels."""

    def __init__(self, in_channels: int, mid_planes: int = 128, out_planes: int = 3,
                 s2d: int = 2):
        super().__init__()
        if s2d not in (1, 2):
            raise ValueError(f"s2d must be 1 or 2, got {s2d}")
        m = mid_planes
        self.s2d = s2d
        self.Conv_0 = conv(in_channels, m, 5, s2d)
        self.Conv_1 = conv(m, m, 5)
        self.Conv_2 = conv(m, m, 5)
        # s2d=2: 4 phases of the s2d motion field's 4 * out_planes channels
        self.Conv_3 = conv(m, 16 * out_planes if s2d == 2 else out_planes, 5)

    def forward(self, x):
        x = F.relu(self.Conv_0(x))
        x = F.relu(self.Conv_1(x))
        x = F.relu(self.Conv_2(x))
        x = self.Conv_3(x)
        return depth_to_space(x, 2) if self.s2d == 2 else x
