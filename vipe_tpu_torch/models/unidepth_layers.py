"""UniDepth v2 building blocks (port of ``vipe_tpu/models/unidepth_layers.py``):
pre-norm cross-attention blocks with LayerScale, sine position embeddings,
Fourier ray embeddings and the convolutional upsampling stack of the
decoder.  Token tensors are (B, N, C), feature maps NCHW.

Parameters use ViPE's UniDepth key layout (``norm_attnx``, ``kv``, ``q``,
``out``, ``ls1.gamma``, ``mlp.proj1``, ``convs.0.conv1``, ``up.0``).  Every
LayerNorm has eps 1e-6 (flax's default, which the JAX package runs), not
PyTorch's 1e-5.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .vit import LayerScale

LN_EPS = 1e-6


class MLP(nn.Module):
    """LayerNorm → proj1 → GELU → proj2."""

    def __init__(self, dim: int, expansion: int = 4, output_dim: Optional[int] = None):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.proj1 = nn.Linear(dim, int(dim * expansion))
        self.proj2 = nn.Linear(int(dim * expansion), output_dim or dim)

    def forward(self, x):
        return self.proj2(F.gelu(self.proj1(self.norm(x))))


class AttentionBlock(nn.Module):
    """Pre-norm (cross-)attention and an MLP, each LayerScaled when
    ``layer_scale > 0``.  ``pos_embed`` is added to the projected queries,
    ``pos_embed_context`` to the projected keys."""

    def __init__(self, dim: int, num_heads: int = 8, expansion: int = 4,
                 layer_scale: float = 1.0, use_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.norm_attnx = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm_attnctx = nn.LayerNorm(dim, eps=LN_EPS)
        self.kv = nn.Linear(dim, 2 * dim, bias=use_bias)
        self.q = nn.Linear(dim, dim, bias=use_bias)
        self.out = nn.Linear(dim, dim, bias=use_bias)
        self.mlp = MLP(dim, expansion)
        if layer_scale > 0:
            self.ls1 = LayerScale(dim, layer_scale)
            self.ls2 = LayerScale(dim, layer_scale)
        else:
            self.ls1 = self.ls2 = nn.Identity()

    def forward(self, x, context=None, pos_embed=None, pos_embed_context=None):
        ctx = x if context is None else context
        B, N, C = x.shape
        M, h = ctx.shape[1], self.num_heads
        kv = self.kv(self.norm_attnctx(ctx)).reshape(B, M, 2, h, C // h)
        k, v = kv[:, :, 0], kv[:, :, 1]
        q = self.q(self.norm_attnx(x)).reshape(B, N, h, C // h)
        if pos_embed is not None:
            q = q + pos_embed.reshape(B, N, h, C // h)
        if pos_embed_context is not None:
            k = k + pos_embed_context.reshape(B, M, h, C // h)
        o = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        x = x + self.ls1(self.out(o.transpose(1, 2).reshape(B, N, C)))
        return x + self.ls2(self.mlp(x))


class AttentionLayer(nn.Module):
    """A stack of ``AttentionBlock``s sharing the context and embeddings."""

    def __init__(self, num_blocks: int, dim: int, num_heads: int = 8, expansion: int = 4,
                 layer_scale: float = 1.0, use_bias: bool = True):
        super().__init__()
        self.layers = nn.ModuleList(
            AttentionBlock(dim, num_heads, expansion, layer_scale, use_bias)
            for _ in range(num_blocks))

    def forward(self, x, context=None, pos_embed=None, pos_embed_context=None):
        for blk in self.layers:
            x = blk(x, context, pos_embed, pos_embed_context)
        return x


def position_embedding_sine(h: int, w: int, dim: int, device=None) -> torch.Tensor:
    """DETR's normalised sine embedding: (h·w, 2·dim), y half then x half."""
    eps = 1e-6
    y = (torch.arange(h, dtype=torch.float32, device=device) + 1.0) / (h + eps) * 2 * math.pi
    x = (torch.arange(w, dtype=torch.float32, device=device) + 1.0) / (w + eps) * 2 * math.pi
    dim_t = torch.arange(dim, dtype=torch.float32, device=device)
    dim_t = 10000.0 ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / dim)

    def half(p):
        return torch.stack([torch.sin(p[:, 0::2]), torch.cos(p[:, 1::2])], -1).reshape(len(p), -1)

    py, px = half(y[:, None] / dim_t), half(x[:, None] / dim_t)
    pos = torch.cat([py[:, None].expand(h, w, dim), px[None, :].expand(h, w, dim)], -1)
    return pos.reshape(h * w, 2 * dim)


def fourier_features(x: torch.Tensor, dim: int, max_freq: float,
                     use_log: bool = True) -> torch.Tensor:
    """x (..., C) → (..., dim): sin(x·f·π) over ``dim // C`` frequencies per
    channel, log-spaced from 1 to ``max_freq`` (linear from 1 to
    ``max_freq/2`` when not ``use_log``), channel-major."""
    C = x.shape[-1]
    n = dim // C
    top = max(float(max_freq), 2.0)
    # the bands in f64, then rounded once
    if use_log:
        freqs = 2.0 ** torch.linspace(0.0, math.log2(top), n, dtype=torch.float64)
    else:
        freqs = torch.linspace(1.0, top / 2.0, n, dtype=torch.float64)
    ang = x[..., None] * freqs.float().to(x.device) * math.pi
    return torch.sin(ang).reshape(*x.shape[:-1], C * n)


class ResidualConvUnit(nn.Module):
    """x + γ·conv2(lrelu(conv1(lrelu(x)))), 'same' padding."""

    def __init__(self, dim: int, kernel_size: int = 3, layer_scale: float = 1.0):
        super().__init__()
        self.conv1 = nn.Conv2d(dim, dim, kernel_size, padding=kernel_size // 2)
        self.conv2 = nn.Conv2d(dim, dim, kernel_size, padding=kernel_size // 2)
        self.gamma = nn.Parameter(torch.full((1, dim, 1, 1), layer_scale)) if layer_scale > 0 else None

    def forward(self, x):
        y = self.conv2(F.leaky_relu(self.conv1(F.leaky_relu(x, 0.01)), 0.01))
        return x + (y if self.gamma is None else y * self.gamma)


class ResUpsampleBil(nn.Module):
    """``num_layers`` residual units → 1×1 conv → ×2 bilinear (half-pixel)."""

    def __init__(self, dim: int, output_dim: int, num_layers: int = 2, kernel_size: int = 3,
                 layer_scale: float = 1.0):
        super().__init__()
        self.convs = nn.ModuleList(ResidualConvUnit(dim, kernel_size, layer_scale)
                                   for _ in range(num_layers))
        self.up = nn.Sequential(nn.Conv2d(dim, output_dim, 1))

    def forward(self, x):
        for unit in self.convs:
            x = unit(x)
        x = self.up(x)
        return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


def orthonormal_init(num_tokens: int, dims: int, seed: int = 0) -> np.ndarray:
    """Gram-Schmidt orthonormal rows from a seeded normal draw (UniDepth's
    fixed, non-trainable token embedding)."""
    rng = np.random.default_rng(seed)
    pe = rng.normal(size=(num_tokens, dims)).astype(np.float32)
    for i in range(num_tokens):
        for j in range(i):
            pe[i] -= pe[i] @ pe[j] * pe[j]
        pe[i] /= np.linalg.norm(pe[i]) + 1e-9
    return pe
