"""Building blocks (NCHW), ported from fastvideocodec_tpu/layers/blocks.py:
ResBlock, the WarpNet motion-compensation U-net, the strided-trunk
WarpNetTPU (LSVC-TPU-WT) and the MEBasic SpyNet level of the LSVC path,
the factorized space/time attention of LSVC's -A/-S forms
(SpaceTimeAttention over TokenAttention and GEGLUFeedForward), RLVC's
ConvLSTM and flax's transposed conv with ``padding="SAME"``
(``SameConvTranspose``), QReLU with its surrogate gradient for the SSF
hyper decoders, the super-precision SPnet of ELFVC-SP with its blocks
(ChannelLayerNorm, WSConvBlock, ResnetBlock, ConvAttention), and
ConvAttention across views for MCVC-IA, and the training build's mixed
precision (``mixed_precision``, ``cast_once``, ``frame_dtype``).

The SPnet blocks keep the flax names of their parameters (``g``,
GroupNorm ``scale``/``bias``, the WSConvBlock's ``weight`` (its flax
``kernel``) and ``bias``) and, as flax does, keep them in float32 whatever
the activation dtype: the weight-standardized kernel is standardized in
float32 and cast to the activation dtype only for its conv, and the norms
reduce in float32."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from fastvideocodec_torch.ops.warp import avg_pool2, bilinear_upsample_x2_ac, depth_to_space


def conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    """k x k conv with the flax ``padding=k//2`` geometry."""
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2)


def same_transpose_padding(k: int, s: int) -> tuple:
    """(before, after) padding of the stride-dilated input in flax's
    ``ConvTranspose(padding="SAME")`` (jax.lax's conv_transpose)."""
    pad_len = k + s - 2
    before = k - 1 if s > k - 1 else -(-pad_len // 2)
    return before, pad_len - before


# ---------------------------------------------------------------------------
# Mixed precision for training: flax's float32 parameters, bfloat16 compute
# ---------------------------------------------------------------------------

_CASTS = None  # inside cast_once(): {id(master): (master, its compute-dtype copy)}


class _Widen(torch.autograd.Function):
    """One use of a master's cached copy: forward the copy; backward this
    use's cotangent widened to the master's dtype, so that the uses'
    gradients add up in float32, as flax's cast at each call gives them."""

    @staticmethod
    def forward(ctx, master, copy):
        ctx.dtype = master.dtype
        return copy

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.dtype), None


def at_use(master: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``master`` in ``dtype`` for one use, as flax's ``promote_dtype``
    casts a kernel or bias, its gradient this use's cotangent widened to
    the master's dtype: inside ``cast_once`` one cast serves every use
    until the context ends, each use widening its own cotangent; else cast
    at this use."""
    if master.dtype == dtype:
        return master
    if _CASTS is None:
        return master.to(dtype)
    entry = _CASTS.get(id(master))
    if entry is None:
        entry = _CASTS[id(master)] = (master, master.detach().to(dtype))
    if master.requires_grad and torch.is_grad_enabled():
        return _Widen.apply(master, entry[1])
    return entry[1]


@contextlib.contextmanager
def cast_once():
    """Within the context each float32 master of a ``mixed_precision``
    module is cast to its compute dtype at its first use and the copy
    serves every later use: one cast a weight a step, not one a call (the
    recurrent codecs call each conv once a P-frame, and a training step is
    bound by the host's launches). The parameters must not change inside
    it."""
    global _CASTS
    saved, _CASTS = _CASTS, {}
    try:
        yield
    finally:
        _CASTS = saved


def compute_params(m: nn.Module) -> tuple:
    """(weight, bias) of a conv or Dense as its call takes them: the
    parameters, or in a ``mixed_precision`` module their copies in its
    compute dtype."""
    dtype = getattr(m, "compute_dtype", None)
    if dtype is None:
        return m.weight, m.bias
    return at_use(m.weight, dtype), None if m.bias is None else at_use(m.bias, dtype)


def low_precision(fn, x: torch.Tensor, w: torch.Tensor, b, *args) -> torch.Tensor:
    """``fn(x, w, b, *args)``, a conv or Dense of operands in one dtype. On
    the CPU a bfloat16 one that needs a gradient runs in float32 on its
    bfloat16 operands and rounds its result once, as cuDNN and XLA compute
    it (their gradients then round once to bfloat16 at the casts):
    PyTorch's CPU bfloat16 convolutions are not fit to train on (in 2.13
    oneDNN's weight gradient is garbage on some small inputs, up to 1e34
    for a 5x5 stride-2 conv of a 1x1 input, and the native path
    accumulates in bfloat16). Anything else, eval included, runs ``fn``
    as it is."""
    if (x.is_cpu and x.dtype == torch.bfloat16 and torch.is_grad_enabled()
            and (x.requires_grad or w.requires_grad)):
        return fn(x.float(), w.float(), None if b is None else b.float(), *args).to(x.dtype)
    return fn(x, w, b, *args)


class _CastConv2d(nn.Conv2d):
    def forward(self, x):
        w, b = compute_params(self)
        return low_precision(self._conv_forward, x.to(w.dtype), w, b)


class _CastConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x):
        w, b = compute_params(self)
        return low_precision(F.conv_transpose2d, x.to(w.dtype), w, b, self.stride, self.padding,
                             self.output_padding, self.groups, self.dilation)


class _CastLinear(nn.Linear):
    def forward(self, x):
        w, b = compute_params(self)
        return low_precision(F.linear, x.to(w.dtype), w, b)


def mixed_precision(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """flax's mixed precision on a float32 build, in place: the codecs
    compute in ``dtype`` as that dtype's build does, and each conv,
    transposed conv and Dense keeps its weight and bias in float32 and
    casts them and its input to ``dtype`` at its call (``compute_params``);
    the parameters keep their names. Every other layer already computes as
    the bf16 build does (GDN, the entropy models, the rates, the SPnet's
    weight-standardized kernels and norms in float32)."""
    swap = {nn.Conv2d: _CastConv2d, nn.ConvTranspose2d: _CastConvTranspose2d,
            nn.Linear: _CastLinear}
    for m in module.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):  # a codec's model dtype
            m.dtype = dtype
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            if type(m) in swap:
                m.__class__ = swap[type(m)]
            elif not isinstance(m, (SameConvTranspose, *swap.values())):
                raise TypeError(f"no mixed-precision form of {type(m).__name__}")
            m.compute_dtype = dtype
    return module


def frame_dtype(module, frames: torch.Tensor, training: bool) -> torch.dtype:
    """The dtype a codec takes its frames in: the model dtype in eval (the
    bf16 build rounds its frames once, at the start); in training the
    frames' own promoted with it, as JAX's modules keep them: a flax conv
    casts its input at the call, so in a bf16 run on float32 frames the
    frames, the warped references and the recons (the image chain) stay
    float32 beside bfloat16 features, and the distortion is taken against
    the float32 frames."""
    return torch.promote_types(frames.dtype, module.dtype) if training else module.dtype


class SameConvTranspose(nn.ConvTranspose2d):
    """flax ``nn.ConvTranspose((k, k), strides=(s, s), padding="SAME")``:
    the stride-dilated input padded (before, after) and correlated with the
    kernel as it is, unflipped; s*H x s*W out. Not ``polyphase_deconv``
    (torch's padding k//2 with output_padding 1), which is another map: at
    stride 2 flax pads (ceil(k/2), floor(k/2)). Computed as torch's
    transposed conv of the spatially flipped kernel, whose full output is
    the dilated input padded k-1 on each side, cropped to start at
    k-1-before. The weight is torch's [in, out, k, k], the flax kernel
    [k, k, in, out] transposed, as ``weights.load_flat`` maps it."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 2):
        super().__init__(cin, cout, k, stride=stride)
        self.crop = k - 1 - same_transpose_padding(k, stride)[0]

    def forward(self, x):
        H, W = x.shape[-2:]
        s, c = self.stride[0], self.crop
        w, b = compute_params(self)
        y = low_precision(lambda x, w, b: F.conv_transpose2d(x, w.flip(-1, -2), b, stride=s),
                          x.to(w.dtype), w, b)
        return y[..., c:c + s * H, c:c + s * W].contiguous()


LSTM_FORGET_BIAS = 1.0


class ConvLSTM(nn.Module):
    """Convolutional LSTM cell of C channels in and out: one 3x3 conv over
    cat(x, h) (2C) to 4C channels split (j, i, f, o), the forget gate
    biased by LSTM_FORGET_BIAS; the state is cat(c, h) on the channel axis.
    ``forward(x, state)`` returns (h, new state)."""

    def __init__(self, channels: int):
        super().__init__()
        self.Conv_0 = conv(2 * channels, 4 * channels, 3)

    def forward(self, x, state):
        c, h = state.chunk(2, dim=1)
        j, i, f, o = self.Conv_0(torch.cat([x, h.to(x.dtype)], dim=1)).chunk(4, dim=1)
        f = torch.sigmoid(f + LSTM_FORGET_BIAS)
        c = c * f + torch.sigmoid(i) * F.relu(j)
        h = torch.sigmoid(o) * F.relu(c)
        return h, torch.cat([c, h], dim=1)


class ResBlock(nn.Module):
    """relu-conv-relu-conv residual block; a 1x1 conv matches the skip's
    channels when they differ."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3):
        super().__init__()
        self.Conv_0 = conv(in_channels, out_channels, kernel_size)
        self.Conv_1 = conv(out_channels, out_channels, kernel_size)
        self.Conv_2 = conv(in_channels, out_channels, 1) if in_channels != out_channels else None

    def forward(self, x):
        h = self.Conv_1(F.relu(self.Conv_0(F.relu(x))))
        if self.Conv_2 is not None:
            x = self.Conv_2(x)
        return x + h


class WarpNet(nn.Module):
    """Motion-compensation refinement U-net: concat(warped, ref) ->
    correction to the warped frame."""

    def __init__(self, in_channels: int, out_channels: int = 3, width: int = 64):
        super().__init__()
        w = width
        self.Conv_0 = conv(in_channels, w, 3)
        for i in range(6):
            self.add_module(f"ResBlock_{i}", ResBlock(w, w))
        self.Conv_1 = conv(w, out_channels, 3)

    def forward(self, x):
        f = F.relu(self.Conv_0(x))
        c0 = self.ResBlock_0(f)
        c1 = self.ResBlock_1(avg_pool2(c0))
        c2 = self.ResBlock_2(avg_pool2(c1))
        c3 = self.ResBlock_3(c2)
        c3_u = c1 + bilinear_upsample_x2_ac(c3)
        c4 = self.ResBlock_4(c3_u)
        c4_u = c0 + bilinear_upsample_x2_ac(c4)
        c5 = self.ResBlock_5(c4_u)
        return self.Conv_1(c5)


class WarpNetTPU(nn.Module):
    """The strided-trunk motion-compensation refinement of LSVC-TPU-WT: a
    5x5 stem conv of stride ``stem_stride`` (symmetric padding 2) and ReLU,
    ``depth`` ResBlocks of ``width`` at 1/stem_stride of the input, and a
    3x3 conv to out_channels * s * s channels depth-to-spaced by s in the
    (ry, rx, c) order back to the input's resolution."""

    def __init__(self, in_channels: int, out_channels: int = 12, width: int = 128,
                 depth: int = 4, stem_stride: int = 4):
        super().__init__()
        self.depth, self.stride = depth, stem_stride
        self.Conv_0 = nn.Conv2d(in_channels, width, 5, stride=stem_stride, padding=2)
        for i in range(depth):
            self.add_module(f"ResBlock_{i}", ResBlock(width, width))
        self.Conv_1 = conv(width, out_channels * stem_stride ** 2, 3)

    def forward(self, x):
        c = F.relu(self.Conv_0(x))
        for i in range(self.depth):
            c = getattr(self, f"ResBlock_{i}")(c)
        return depth_to_space(self.Conv_1(c), self.stride)


class MEBasic(nn.Module):
    """One SpyNet refinement level: relu convs of `widths`, then an output conv."""

    def __init__(self, in_channels: int, widths: tuple = (32, 64, 32, 16),
                 kernel: int = 7, out_channels: int = 2):
        super().__init__()
        self.n = len(widths)
        cin = in_channels
        for i, w in enumerate(widths):
            self.add_module(f"Conv_{i}", conv(cin, w, kernel))
            cin = w
        self.add_module(f"Conv_{self.n}", conv(cin, out_channels, kernel))

    def forward(self, x):
        for i in range(self.n):
            x = F.relu(getattr(self, f"Conv_{i}")(x))
        return getattr(self, f"Conv_{self.n}")(x)


_QRELU_ALPHA = 0.9943258522851727
_QRELU_MAX = 255  # 2^8 - 1: compressai's QReLU at 8 bits
_QRELU_BETA = 100


class _QReLU(torch.autograd.Function):
    """clamp(x, 0, 255) with compressai's smooth surrogate gradient: g
    inside [0, 255] (the bounds included), exp(-a + a*|2x/255 - 1|) * g
    outside it, a = _QRELU_ALPHA ** 100 (the JAX package's ``_qrelu_bwd``)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.clamp(x, 0.0, float(_QRELU_MAX))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        scale = _QRELU_ALPHA ** _QRELU_BETA
        grad_sub = torch.exp(-scale + scale * torch.abs(2.0 * x / _QRELU_MAX - 1.0)) * g
        return torch.where((x < 0) | (x > _QRELU_MAX), grad_sub, g)


def qrelu(x: torch.Tensor) -> torch.Tensor:
    """clamp(x, 0, 255), compressai's QReLU at 8 bits, with its surrogate
    gradient outside [0, 255] (``_QReLU``)."""
    return _QReLU.apply(x)


# ---------------------------------------------------------------------------
# Super-precision SPnet (reference super_precision.py) and its blocks
# ---------------------------------------------------------------------------

NORM_EPS = 1e-5  # the LayerNorm, GroupNorm and weight-standardization eps


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channel axis with a scale ``g`` and the biased
    variance. The statistics are taken in float32 and rounded to x's dtype,
    as jnp.mean and jnp.var give them; the float32 ``g`` makes the output
    float32."""

    def __init__(self, dim: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(1, keepdim=True)
        var = ((xf - mean) ** 2).mean(1, keepdim=True)
        mean, var = mean.to(x.dtype), var.to(x.dtype)
        return (x - mean) * torch.rsqrt(var + NORM_EPS) * self.g[None, :, None, None]


class GroupNorm(nn.Module):
    """flax GroupNorm with its params ``scale`` and ``bias``, float32
    statistics; returns float32. Not ``F.group_norm``: its moments kernel
    gives each (item, group) one thread block, 8 blocks at batch 1, and
    took 0.16 ms a call on an H100 for the SPnet's [1, 512, 64, 128]
    (``tools/profile_rollout.py``); ``var_mean`` spreads that reduction
    over the card."""

    def __init__(self, channels: int, groups: int = 8):
        super().__init__()
        self.groups = groups
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        B, C, H, W = x.shape
        g = x.float().reshape(B, self.groups, C // self.groups, H * W)
        var, mean = torch.var_mean(g, dim=(2, 3), keepdim=True, correction=0)
        scale, bias = (p.reshape(1, self.groups, -1, 1) for p in (self.scale, self.bias))
        return ((g - mean) * (torch.rsqrt(var + NORM_EPS) * scale) + bias).reshape(B, C, H, W)


class WSConvBlock(nn.Module):
    """3x3 weight-standardized conv (mean and biased variance of the kernel
    over (cin, kh, kw) per output channel), its float32 bias, GroupNorm(8)
    and SiLU. Not an nn.Conv2d: the registry casts those to the model
    dtype, and this kernel stays float32 until after its standardization."""

    def __init__(self, in_channels: int, out_channels: int, groups: int = 8):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_channels, in_channels, 3, 3))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.GroupNorm_0 = GroupNorm(out_channels, groups)

    def forward(self, x):
        w = self.weight
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        var = ((w - mean) ** 2).mean(dim=(1, 2, 3), keepdim=True)
        w = (w - mean) * torch.rsqrt(var + NORM_EPS)
        y = low_precision(F.conv2d, x, w.to(x.dtype), None, 1, 1) + self.bias[None, :, None, None]
        return F.silu(self.GroupNorm_0(y).to(x.dtype))


class ResnetBlock(nn.Module):
    """Two WSConvBlocks and a skip, through a 1x1 conv when the widths
    differ."""

    def __init__(self, in_channels: int, out_channels: int, groups: int = 8):
        super().__init__()
        self.WSConvBlock_0 = WSConvBlock(in_channels, out_channels, groups)
        self.WSConvBlock_1 = WSConvBlock(out_channels, out_channels, groups)
        self.Conv_0 = conv(in_channels, out_channels, 1) if in_channels != out_channels else None

    def forward(self, x):
        h = self.WSConvBlock_1(self.WSConvBlock_0(x))
        if self.Conv_0 is not None:
            x = self.Conv_0(x)
        return h + x


def plain_attention(q, k, v):
    """Softmax attention over [B, heads, N, d]: q scaled by d^-1/2, then two
    matmuls and a softmax over the keys (the JAX package's ``_mha``)."""
    q = q * q.shape[-1] ** -0.5
    return torch.softmax(q @ k.transpose(-1, -2), dim=-1) @ v


def attention(q, k, v):
    """``plain_attention`` for CPU tensors; on the card PyTorch's fused
    scaled_dot_product_attention, which never holds the N x N scores (4 x
    8192 x 8192 for the SPnet at 1024x2048; 8 x 32768 x 32768 for MCVC-IA
    at 4 views of 1024x2048)."""
    if q.device.type == "cpu":
        return plain_attention(q, k, v)
    return F.scaled_dot_product_attention(q, k, v)


# ---------------------------------------------------------------------------
# Factorized space/time attention (LSVC's -A and -S forms)
# ---------------------------------------------------------------------------

LAYER_NORM_EPS = 1e-6  # flax LayerNorm's epsilon (torch's default is 1e-5)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis, with its params ``scale``
    and ``bias``: float32 statistics with the fast variance
    max(E[x^2] - E[x]^2, 0), eps 1e-6, the result in x's dtype."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
        y = (xf - mean) * (torch.rsqrt(var + LAYER_NORM_EPS) * self.scale) + self.bias
        return y.to(x.dtype)


class GEGLUFeedForward(nn.Module):
    """Dense to 2 * mult * dim, split in (h, gates), h * gelu(gates) with
    the tanh approximation (``jax.nn.gelu``'s default), Dense back to dim.
    A flax ``Dense`` is an ``nn.Linear``: weights.load_flat transposes its
    kernel [in, out] into the weight [out, in]."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.Dense_0 = nn.Linear(dim, dim * mult * 2)
        self.Dense_1 = nn.Linear(dim * mult, dim)

    def forward(self, x):
        h, gates = self.Dense_0(x).chunk(2, dim=-1)
        return self.Dense_1(h * F.gelu(gates, approximate="tanh"))


class TokenAttention(nn.Module):
    """Multi-head attention over the token axis of [B, N, dim]: a qkv
    Dense without bias to 3 * heads * dim_head (channel head * dim_head + i
    of each third), ``attention`` (q scaled by dim_head^-1/2), and an output
    Dense with bias."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.Dense_0 = nn.Linear(dim, 3 * inner, bias=False)
        self.Dense_1 = nn.Linear(inner, dim)

    def forward(self, x):
        B, N, _ = x.shape
        qkv = self.Dense_0(x).reshape(B, N, 3, self.heads, self.dim_head)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).contiguous().unbind(0)  # [B, heads, N, d]
        out = attention(q, k, v).transpose(1, 2).reshape(B, N, -1)
        return self.Dense_1(out)


class SpaceTimeAttention(nn.Module):
    """``depth`` steps over a feature map [F, dim, H, W], F the frames of the
    batch: time attention (tokens = the F frames, batched over the H*W
    pixels), space attention (tokens = the pixels, batched over the frames)
    and a GEGLU feed-forward, each after a LayerNorm and added back. The
    frames of one call attend to each other, so the batch a caller forms is
    part of the result."""

    def __init__(self, dim: int, depth: int = 12, heads: int = 8, dim_head: int = 64):
        super().__init__()
        self.depth = depth
        for d in range(depth):
            for i in range(3):
                self.add_module(f"LayerNorm_{3 * d + i}", LayerNorm(dim))
            for i in range(2):
                self.add_module(f"TokenAttention_{2 * d + i}",
                                TokenAttention(dim, heads, dim_head))
            self.add_module(f"GEGLUFeedForward_{d}", GEGLUFeedForward(dim))

    def forward(self, x):
        F_, C, H, W = x.shape
        t = x.reshape(F_, C, H * W).transpose(1, 2)  # [F, HW, C]
        for d in range(self.depth):
            norm = [getattr(self, f"LayerNorm_{3 * d + i}") for i in range(3)]
            time_attn, space_attn = (getattr(self, f"TokenAttention_{2 * d + i}")
                                     for i in range(2))
            t = t + time_attn(norm[0](t).transpose(0, 1)).transpose(0, 1)
            t = t + space_attn(norm[1](t))
            t = t + getattr(self, f"GEGLUFeedForward_{d}")(norm[2](t))
        return t.transpose(1, 2).reshape(F_, C, H, W).contiguous()


class ConvAttention(nn.Module):
    """1x1-conv qkv attention. With ``num_views`` 1 (the JAX package's
    ``atype=0``, the SPnet's) the tokens are the pixels of each item; with
    V views (``atype=2``, MCVC-IA's cross-view attention) they are the
    (view, y, x) of each V consecutive items of the batch axis, which holds
    the views folded as b*V + v. A zeroed (failed) view stays a token, its
    k and v 0 (the qkv conv has no bias), as in the JAX package."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32, num_views: int = 1):
        super().__init__()
        self.heads, self.dim_head, self.num_views = heads, dim_head, num_views
        inner = heads * dim_head
        self.Conv_0 = nn.Conv2d(dim, 3 * inner, 1, bias=False)
        self.Conv_1 = conv(inner, dim, 1)

    def forward(self, x):
        B, _, H, W = x.shape
        V = self.num_views
        if B % V:
            raise ValueError(f"batch {B} is not a whole number of {V} views")
        b, N = B // V, V * H * W
        conv_in = getattr(self.Conv_0, "compute_dtype", None) or self.Conv_0.weight.dtype
        qkv = self.Conv_0(x.to(conv_in))
        # channel head*d + i of each third, tokens in (view, y, x) order; q, k
        # and v contiguous [b, heads, N, d], which the fused attention needs
        # (on a view whose last dim is strided it falls back to its float32
        # math form)
        qkv = qkv.reshape(b, V, 3, self.heads, self.dim_head, H * W)
        qkv = qkv.permute(2, 0, 3, 1, 5, 4).contiguous()
        q, k, v = qkv.reshape(3, b, self.heads, N, self.dim_head).unbind(0)
        out = attention(q, k, v).reshape(b, self.heads, V, H * W, self.dim_head)
        return self.Conv_1(out.permute(0, 2, 1, 4, 3).reshape(B, -1, H, W))


class SPnet(nn.Module):
    """Predicts a dequantization correction from cat(round_y, Q_y_prior):
    a 7x7 conv to 8*dim, a ResnetBlock, a pre-norm attention residual, a
    ResnetBlock, a concat skip from the 7x7 conv, a ResnetBlock down to dim
    and a 1x1 conv out."""

    def __init__(self, in_channels: int, output_channels: int = 192, dim: int = 64,
                 groups: int = 8):
        super().__init__()
        mid = 8 * dim
        self.Conv_0 = conv(in_channels, mid, 7)
        self.ResnetBlock_0 = ResnetBlock(mid, mid, groups)
        self.ChannelLayerNorm_0 = ChannelLayerNorm(mid)
        self.ConvAttention_0 = ConvAttention(mid)
        self.ResnetBlock_1 = ResnetBlock(mid, mid, groups)
        self.ResnetBlock_2 = ResnetBlock(2 * mid, dim, groups)
        self.Conv_1 = conv(dim, output_channels, 1)

    def forward(self, x):
        x = r = self.Conv_0(x)
        x = self.ResnetBlock_0(x)
        x = x + self.ConvAttention_0(self.ChannelLayerNorm_0(x))
        x = self.ResnetBlock_1(x)
        x = self.ResnetBlock_2(torch.cat([x, r], dim=1))
        return self.Conv_1(x)
