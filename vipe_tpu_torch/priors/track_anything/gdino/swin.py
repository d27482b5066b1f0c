"""Swin Transformer backbone of GroundingDINO (port of
``vipe_tpu/priors/track_anything/gdino/swin.py``) in the reference's key
layout (``patch_embed.*``, ``layers.{i}.blocks.{b}.*``,
``layers.{i}.downsample.*``, ``norm{i}``).  ``swin_T_224_1k``: patch 4,
embed 96, depths (2, 2, 6, 2), heads (3, 6, 12, 24), window 7, no absolute
position embedding; stages 1-3 are returned, each through its LayerNorm.

Windows are formed by reshapes, shifted windows by ``torch.roll`` with the
shifted-window mask (−100 between regions), the relative-position bias by
a gather from the (2w − 1)² table.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@functools.lru_cache(maxsize=None)
def relative_position_index(wh: int, ww: int) -> np.ndarray:
    """(wh·ww, wh·ww) indices into the (2wh − 1)(2ww − 1) bias table."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=None)
def shifted_window_mask(Hp: int, Wp: int, w: int, s: int) -> np.ndarray:
    """(nW, w², w²) additive mask of shifted-window attention: −100 between
    tokens of different regions of the rolled map."""
    img = np.zeros((Hp, Wp), np.int32)
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -s), slice(-s, None)):
        for ws in (slice(0, -w), slice(-w, -s), slice(-s, None)):
            img[hs, ws] = cnt
            cnt += 1
    m = img.reshape(Hp // w, w, Wp // w, w).transpose(0, 2, 1, 3).reshape(-1, w * w)
    return np.where(m[:, :, None] != m[:, None, :], -100.0, 0.0).astype(np.float32)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window: int, num_heads: int):
        super().__init__()
        self.window = window
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))

    def forward(self, x, mask=None):
        """x (nW·B, N, C); mask (nW, N, N) additive or None."""
        Bn, N, C = x.shape
        h = self.num_heads
        qkv = self.qkv(x).reshape(Bn, N, 3, h, C // h).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * (C // h) ** -0.5, qkv[1], qkv[2]
        attn = q @ k.transpose(-1, -2)
        idx = torch.as_tensor(relative_position_index(self.window, self.window).reshape(-1),
                              device=x.device)
        bias = self.relative_position_bias_table[idx].reshape(N, N, h).permute(2, 0, 1)
        attn = attn + bias[None]
        if mask is not None:
            nW = mask.shape[0]
            attn = (attn.reshape(Bn // nW, nW, h, N, N) + mask[None, :, None]).reshape(Bn, h, N, N)
        out = torch.softmax(attn, -1) @ v
        return self.proj(out.transpose(1, 2).reshape(Bn, N, C))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, shift: int):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, window, num_heads)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, 4 * dim)

    def forward(self, x, H: int, W: int):
        """x (B, H·W, C)."""
        B, L, C = x.shape
        w, s = self.window, self.shift
        shortcut = x
        x = self.norm1(x).reshape(B, H, W, C)
        pad_b, pad_r = (w - H % w) % w, (w - W % w) % w
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        Hp, Wp = H + pad_b, W + pad_r
        mask = None
        if s > 0:
            x = torch.roll(x, (-s, -s), (1, 2))
            mask = torch.as_tensor(shifted_window_mask(Hp, Wp, w, s), device=x.device)
        x = x.reshape(B, Hp // w, w, Wp // w, w, C).permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, C)
        x = self.attn(x, mask)
        x = x.reshape(B, Hp // w, Wp // w, w, w, C).permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
        if s > 0:
            x = torch.roll(x, (s, s), (1, 2))
        x = shortcut + x[:, :H, :W].reshape(B, H * W, C)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x, H: int, W: int):
        B, L, C = x.shape
        x = F.pad(x.reshape(B, H, W, C), (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      -1)
        Hh, Wh = x.shape[1], x.shape[2]
        return self.reduction(self.norm(x.reshape(B, Hh * Wh, 4 * C))), Hh, Wh


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, 4, stride=4)
        self.norm = nn.LayerNorm(dim)


class BasicLayer(nn.Module):
    def __init__(self, dim: int, depth: int, num_heads: int, window: int, downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window, 0 if b % 2 == 0 else window // 2)
            for b in range(depth))
        if downsample:
            self.downsample = PatchMerging(dim)


class SwinTransformer(nn.Module):
    """(B, 3, H, W) → the NCHW maps of stages ``out_indices``."""

    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window: int = 7,
                 out_indices: Sequence[int] = (1, 2, 3)):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.patch_embed = PatchEmbed(embed_dim)
        self.layers = nn.ModuleList(
            BasicLayer(embed_dim * 2 ** i, d, num_heads[i], window, i < len(depths) - 1)
            for i, d in enumerate(depths))
        for i in self.out_indices:
            self.add_module(f"norm{i}", nn.LayerNorm(embed_dim * 2 ** i))

    def forward(self, x):
        H0, W0 = x.shape[-2:]
        x = F.pad(x, (0, (4 - W0 % 4) % 4, 0, (4 - H0 % 4) % 4))
        x = self.patch_embed.proj(x)
        B, C, H, W = x.shape
        x = self.patch_embed.norm(x.flatten(2).transpose(1, 2))
        outs = []
        for i, layer in enumerate(self.layers):
            for blk in layer.blocks:
                x = blk(x, H, W)
            if i in self.out_indices:
                y = getattr(self, f"norm{i}")(x)
                outs.append(y.transpose(1, 2).reshape(B, -1, H, W))
            if hasattr(layer, "downsample"):
                x, H, W = layer.downsample(x, H, W)
        return outs
