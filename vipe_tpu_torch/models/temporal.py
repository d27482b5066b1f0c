"""Temporal attention of Video Depth Anything (port of
``vipe_tpu/models/temporal.py``), in ViPE's motion-module key layout
(``temporal_transformer.{norm, proj_in, proj_out}``,
``temporal_transformer.transformer_blocks.0.{attention_blocks.i.{to_q,
to_k, to_v, to_out.0}, norms.i, ff_norm, ff.net.0.proj, ff.net.2}``).

A ``TemporalModule(C)`` mixes each spatial location across the frames of
a clip: GroupNorm(32, eps 1e-6) → ``proj_in`` → one block of two
self-attentions over time (pre-LayerNorm eps 1e-5, sinusoidal positions
added to the attention's input, 8 heads, no q/k/v bias) and a GEGLU
feed-forward (exact GELU), each residual → ``proj_out`` → plus the input.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def sinusoidal_pe(max_len: int, d_model: int) -> torch.Tensor:
    position = np.arange(max_len)[:, None]
    div = np.exp(np.arange(0, d_model, 2) * (-np.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), np.float32)
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return torch.from_numpy(pe)


@functools.lru_cache(maxsize=None)
def _pe_on(T: int, dim: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return sinusoidal_pe(T, dim).to(device, dtype)


class TemporalAttention(nn.Module):
    def __init__(self, dim: int, heads: int = 8, max_len: int = 32):
        super().__init__()
        self.heads, self.max_len = heads, max_len
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(dim, dim, bias=False)
        self.to_v = nn.Linear(dim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])

    def forward(self, x):
        """x (N, T, C): attention across T."""
        N, T, C = x.shape
        if T > self.max_len:
            raise ValueError(f"{T} frames exceed the positional table's {self.max_len}")
        x = x + _pe_on(T, C, x.device, x.dtype)
        q, k, v = (f(x).reshape(N, T, self.heads, C // self.heads).transpose(1, 2)
                   for f in (self.to_q, self.to_k, self.to_v))
        out = F.scaled_dot_product_attention(q, k, v)
        return self.to_out[0](out.transpose(1, 2).reshape(N, T, C))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        a, g = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(g)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(),
                                  nn.Linear(dim * mult, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class TemporalTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int = 8, num_attention_blocks: int = 2,
                 max_len: int = 32):
        super().__init__()
        self.attention_blocks = nn.ModuleList(TemporalAttention(dim, heads, max_len)
                                              for _ in range(num_attention_blocks))
        self.norms = nn.ModuleList(nn.LayerNorm(dim, eps=1e-5)
                                   for _ in range(num_attention_blocks))
        self.ff_norm = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x):
        for attn, norm in zip(self.attention_blocks, self.norms):
            x = attn(norm(x)) + x
        return self.ff(self.ff_norm(x)) + x


class TemporalTransformer3D(nn.Module):
    def __init__(self, channels: int, heads: int = 8, num_layers: int = 1,
                 num_attention_blocks: int = 2, max_len: int = 32):
        super().__init__()
        self.norm = nn.GroupNorm(32, channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, channels)
        self.transformer_blocks = nn.ModuleList(
            TemporalTransformerBlock(channels, heads, num_attention_blocks, max_len)
            for _ in range(num_layers))
        self.proj_out = nn.Linear(channels, channels)


class TemporalModule(nn.Module):
    def __init__(self, channels: int, heads: int = 8, num_layers: int = 1,
                 num_attention_blocks: int = 2, max_len: int = 32):
        super().__init__()
        self.temporal_transformer = TemporalTransformer3D(channels, heads, num_layers,
                                                          num_attention_blocks, max_len)

    def forward(self, x, T: int):
        """x (B·T, C, H, W), clips of T frames → the same, mixed over time."""
        tt = self.temporal_transformer
        BT, C, H, W = x.shape
        B = BT // T
        y = tt.proj_in(tt.norm(x).permute(0, 2, 3, 1).reshape(BT, H * W, C))
        y = y.reshape(B, T, H * W, C).transpose(1, 2).reshape(B * H * W, T, C)
        for blk in tt.transformer_blocks:
            y = blk(y)
        y = y.reshape(B, H * W, T, C).transpose(1, 2).reshape(BT, H * W, C)
        return tt.proj_out(y).reshape(BT, H, W, C).permute(0, 3, 1, 2) + x
