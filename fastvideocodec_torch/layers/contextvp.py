"""Context-based view prediction transformer (ContextVP / VPCT), ported
from fastvideocodec_tpu/layers/contextvp.py (reference
super_precision.py:250-444).

A GPT-style causal transformer over a (view, h, w) token grid with the
Entroformer shift-token trick: each token predicts the next token's latent
from the causal prefix, so that the surviving views' latents can predict
the failed views'. The reference defines and imports it (models.py:2126)
but wires it into no forward; the port keeps it as the same library
capability.

The children carry the flax module names (``Dense_i``, ``LayerNorm_i``,
``TransformerBlock_i``, ``CausalSelfAttention_0``, ``VPCT_0``) and the
parameters ``wpe`` and ``param_token`` theirs, so a flax checkpoint loads
through ``weights.load_flat`` (each Dense kernel transposed into its
``nn.Linear``). The causal attention runs PyTorch's fused
``scaled_dot_product_attention`` with ``is_causal=True`` on the card and
its plain two-matmul form, with -inf above the diagonal, on the CPU; JAX
fills the masked scores with the dtype's lowest finite value. No row is
wholly masked (token 0 sees itself), so both give the same softmax.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fastvideocodec_torch.layers.blocks import LayerNorm


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal softmax attention over [B, heads, T, d], the scores scaled by
    d^-1/2: the fused kernel on the card, the plain form on the CPU."""
    if q.device.type != "cpu":
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)
    T = q.shape[-2]
    att = (q @ k.transpose(-1, -2)) / float(q.shape[-1]) ** 0.5
    keep = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    att = att.masked_fill(~keep, float("-inf"))
    return torch.softmax(att, dim=-1) @ v


class CausalSelfAttention(nn.Module):
    def __init__(self, n_embd: int, n_head: int):
        super().__init__()
        self.n_embd, self.n_head = n_embd, n_head
        self.Dense_0 = nn.Linear(n_embd, 3 * n_embd)
        self.Dense_1 = nn.Linear(n_embd, n_embd)

    def forward(self, x):
        B, T, C = x.shape
        hd = self.n_embd // self.n_head
        q, k, v = (t.reshape(B, T, self.n_head, hd).transpose(1, 2)
                   for t in self.Dense_0(x).split(self.n_embd, dim=-1))
        y = causal_attention(q, k, v).transpose(1, 2).reshape(B, T, C)
        return self.Dense_1(y)


class TransformerBlock(nn.Module):
    """Pre-norm block: x + attention(LN(x)), then x + MLP(LN(x)) with a
    4x-wide GELU (tanh approximation, ``jax.nn.gelu``'s default)."""

    def __init__(self, n_embd: int, n_head: int):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(n_embd)
        self.CausalSelfAttention_0 = CausalSelfAttention(n_embd, n_head)
        self.LayerNorm_1 = LayerNorm(n_embd)
        self.Dense_0 = nn.Linear(n_embd, 4 * n_embd)
        self.Dense_1 = nn.Linear(4 * n_embd, n_embd)

    def forward(self, x):
        x = x + self.CausalSelfAttention_0(self.LayerNorm_0(x))
        h = F.gelu(self.Dense_0(self.LayerNorm_1(x)), approximate="tanh")
        return x + self.Dense_1(h)


class VPCT(nn.Module):
    """gpt-nano by default, as the reference's active configuration:
    idx [B, T, vocab_size] -> shifted predictions [B, T, out_size]."""

    def __init__(self, vocab_size: int, block_size: int, out_size: int, n_layer: int = 3,
                 n_head: int = 3, n_embd: int = 48):
        super().__init__()
        self.n_layer = n_layer
        self.Dense_0 = nn.Linear(vocab_size, n_embd)
        self.wpe = nn.Parameter(torch.zeros(block_size, n_embd))
        for i in range(n_layer):
            self.add_module(f"TransformerBlock_{i}", TransformerBlock(n_embd, n_head))
        self.LayerNorm_0 = LayerNorm(n_embd)
        self.Dense_1 = nn.Linear(n_embd, out_size, bias=False)
        self.param_token = nn.Parameter(torch.zeros(1, 1, out_size))

    def forward(self, idx):
        B, T, _ = idx.shape
        x = self.Dense_0(idx) + self.wpe[None, :T].to(idx.dtype)
        for i in range(self.n_layer):
            x = getattr(self, f"TransformerBlock_{i}")(x)
        logits = self.Dense_1(self.LayerNorm_0(x))
        # the Entroformer shift token: token t gets the prediction made from
        # tokens < t; token 0 gets the learned start token
        start = self.param_token.to(logits.dtype).expand(B, 1, logits.shape[-1])
        return torch.cat([start, logits[:, :-1]], dim=1)


class ContextVP(nn.Module):
    """VPCT over [B*V, C, H, W] feature maps (the views folded into the
    batch, index b*V + v): the tokens of a batch item are its views' pixels
    in (view, y, x) order, C channels each; returns [B*V, out_channels, H,
    W]. ``width`` x ``height`` is the largest map a view may have (the
    position table's size)."""

    def __init__(self, in_channels: int, out_channels: int, num_views: int = 4,
                 width: int = 16, height: int = 16):
        super().__init__()
        self.num_views, self.out_channels = num_views, out_channels
        self.VPCT_0 = VPCT(vocab_size=in_channels, block_size=num_views * width * height,
                           out_size=out_channels)

    def forward(self, x):
        BV, C, H, W = x.shape
        B = BV // self.num_views
        tokens = x.reshape(B, self.num_views, C, H * W).permute(0, 1, 3, 2)
        out = self.VPCT_0(tokens.reshape(B, self.num_views * H * W, C))
        out = out.reshape(B, self.num_views, H, W, self.out_channels).permute(0, 1, 4, 2, 3)
        return out.reshape(BV, self.out_channels, H, W)
