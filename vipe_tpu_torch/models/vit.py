"""DINOv2 vision transformer (port of ``vipe_tpu/models/vit.py``): the
backbone that UniDepth, Depth Anything v2, Video Depth Anything, Metric3D
and PriorDA share.

Parameters use DINOv2's state-dict layout (``patch_embed.proj.weight``,
``blocks.3.attn.qkv.weight``, ``blocks.3.ls1.gamma``, …), so a ViPE
checkpoint's encoder loads with ``load_state_dict(strict=True)``.

* patch 14, base image 518 → a 37×37 positional grid and a cls token;
* pre-norm blocks (LayerNorm eps 1e-6, exact GELU) with LayerScale on both
  branches; attention is ``scaled_dot_product_attention``;
* the positional grid is resized for other inputs by torch's bicubic
  interpolation with ``scale_factor = (grid + 0.1)/37``, DINOv2's own
  quirk (the JAX package rebuilds those weights by hand);
* ``forward(x, tap_layers)`` applies the final norm to each tapped block's
  output and splits it into patch tokens and the extra tokens (cls, then
  registers).

``cond_dim > 0`` adds PriorDA's conditioned patch projection
(``patch_embed.alpha_proj``, zero at init); ``num_register_tokens`` adds
DINOv2-reg's register tokens (Metric3D), which take no positional term.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

VIT_CONFIGS = {
    "vits": dict(embed_dim=384, depth=12, num_heads=6),
    "vitb": dict(embed_dim=768, depth=12, num_heads=12),
    "vitl": dict(embed_dim=1024, depth=24, num_heads=16),
    "vitg": dict(embed_dim=1536, depth=40, num_heads=24),
}


def interpolate_pos_grid(pos_patch: torch.Tensor, base: int, ph: int, pw: int,
                         offset: float = 0.1) -> torch.Tensor:
    """(1, base², D) positional embeddings → (1, ph·pw, D) by bicubic
    interpolation (a = −0.75, half-pixel, clamped borders) at the scale
    ``(n + offset)/base`` of DINOv2's ``interpolate_pos_encoding``.  Runs in
    f32 and returns ``pos_patch``'s dtype."""
    D = pos_patch.shape[-1]
    grid = pos_patch.float().reshape(1, base, base, D).permute(0, 3, 1, 2)
    out = F.interpolate(grid, scale_factor=((ph + offset) / base, (pw + offset) / base),
                        mode="bicubic", align_corners=False)
    return out.permute(0, 2, 3, 1).reshape(1, ph * pw, D).to(pos_patch.dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, N, D = x.shape
        qkv = self.qkv(x).reshape(B, N, 3, self.num_heads, D // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)  # each (B, heads, N, d)
        out = F.scaled_dot_product_attention(q, k, v)
        return self.proj(out.transpose(1, 2).reshape(B, N, D))


class LayerScale(nn.Module):
    def __init__(self, dim: int, init: float = 1.0):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init))

    def forward(self, x):
        return x * self.gamma


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.ls2 = LayerScale(dim)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int, cond_dim: int = 0):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)
        if cond_dim > 0:
            self.alpha_proj = nn.Conv2d(cond_dim, embed_dim, patch_size, stride=patch_size)


class DinoViT(nn.Module):
    def __init__(self, embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 patch_size: int = 14, img_size: int = 518, cond_dim: int = 0,
                 num_register_tokens: int = 0):
        super().__init__()
        self.embed_dim, self.patch_size = embed_dim, patch_size
        self.base = img_size // patch_size
        self.cond_dim = cond_dim
        self.patch_embed = PatchEmbed(patch_size, embed_dim, cond_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, self.base * self.base + 1, embed_dim))
        if num_register_tokens:
            self.register_tokens = nn.Parameter(torch.zeros(1, num_register_tokens, embed_dim))
        else:
            self.register_tokens = None
        self.blocks = nn.ModuleList(Block(embed_dim, num_heads) for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def forward(self, x: torch.Tensor, tap_layers: Sequence[int] = (),
                condition: torch.Tensor = None) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """x: (B, 3, H, W) normalised image, H and W multiples of the patch;
        ``condition``: (B, cond_dim, H, W) when ``cond_dim > 0``.

        Returns per tap layer (patch tokens (B, N, D), extras): extras are
        the cls token (B, D), or with register tokens (B, 1 + R, D)."""
        B, _, H, W = x.shape
        ph, pw = H // self.patch_size, W // self.patch_size
        t = self.patch_embed.proj(x)
        if self.cond_dim > 0:
            t = t + self.patch_embed.alpha_proj(condition)
        t = t.flatten(2).transpose(1, 2)  # (B, ph·pw, D)
        pos_cls, pos_patch = self.pos_embed[:, :1], self.pos_embed[:, 1:]
        if (ph, pw) != (self.base, self.base):
            pos_patch = interpolate_pos_grid(pos_patch, self.base, ph, pw)
        t = t + pos_patch
        extras = [(self.cls_token + pos_cls).expand(B, -1, -1)]
        R = 0
        if self.register_tokens is not None:
            R = self.register_tokens.shape[1]
            extras.append(self.register_tokens.expand(B, -1, -1))
        t = torch.cat(extras + [t], dim=1)

        taps = {}
        for i, blk in enumerate(self.blocks):
            t = blk(t)
            if i in tap_layers:
                taps[i] = t
        outs = []
        for i in tap_layers:
            y = self.norm(taps[i])
            outs.append((y[:, 1 + R:], y[:, :1 + R] if R else y[:, 0]))
        return outs


def make_vit(variant: str, **kwargs) -> DinoViT:
    return DinoViT(**{**VIT_CONFIGS[variant], **kwargs})


def init_seeded_(net: nn.Module, seed: int = 0, gamma: float = 1.0) -> torch.Generator:
    """Seeded random init from one ``torch.Generator``, as flax initialises
    the JAX package's nets: dense and conv weights normal with variance
    1/fan_in (every one, zero-initialised projections too), biases 0,
    norms at identity, layer scales at ``gamma``; each ViT's positional
    embedding and register tokens normal(0.02), its cls token 0.  Returns
    the generator, for a caller's further draws."""
    g = torch.Generator().manual_seed(seed)

    def normal(t, std):
        t.copy_(torch.randn(t.shape, generator=g) * std)

    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                fan_in = m.weight[0].numel() if not isinstance(m, nn.ConvTranspose2d) \
                    else m.weight.shape[0] * m.weight[0, 0].numel()
                normal(m.weight, fan_in ** -0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
                m.reset_parameters()
        for vit in (m for m in net.modules() if isinstance(m, DinoViT)):
            normal(vit.pos_embed, 0.02)
            vit.cls_token.zero_()
            if vit.register_tokens is not None:
                normal(vit.register_tokens, 0.02)
        for name, p in net.named_parameters():
            if name.endswith("gamma"):
                p.fill_(gamma)
    return g
