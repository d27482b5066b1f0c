"""GroundingDINO's feature-enhancer encoder and cross-modality decoder
layers (port of ``vipe_tpu/priors/track_anything/gdino/transformer.py``),
in the reference's key layout.

As in the JAX package, one image of a /32 canvas is the only input: every
image token is valid, the valid ratios are 1 and no key-padding mask
exists; text is padded to a bucket and masked by ``text_token_mask``.
LayerNorms and GroupNorms use eps 1e-6, the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .msda import ms_deform_attn

EPS = 1e-6


def layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=EPS)


# ------------------------------------------------------------ position math


def sine_embed_hw(h: int, w: int, dim: int, temp_h: float = 20.0,
                  temp_w: float = 20.0) -> np.ndarray:
    """The normalised 2-D sine embedding of an (h, w) map → (h, w, dim),
    y features first."""
    n = dim // 2
    y = (np.arange(h, dtype=np.float64) + 1.0) / (h + 1e-6) * 2 * np.pi
    x = (np.arange(w, dtype=np.float64) + 1.0) / (w + 1e-6) * 2 * np.pi
    dim_tw = temp_w ** (2 * (np.arange(n) // 2) / n)
    dim_th = temp_h ** (2 * (np.arange(n) // 2) / n)
    px = x[:, None] / dim_tw
    py = y[:, None] / dim_th
    px = np.stack([np.sin(px[:, 0::2]), np.cos(px[:, 1::2])], -1).reshape(w, -1)
    py = np.stack([np.sin(py[:, 0::2]), np.cos(py[:, 1::2])], -1).reshape(h, -1)
    pos = np.concatenate([np.broadcast_to(py[:, None], (h, w, n)),
                          np.broadcast_to(px[None, :], (h, w, n))], -1)
    return pos.astype(np.float32)


def sine_pos_embed(pos: torch.Tensor, num_pos_feats: int, temperature: float = 10000.0,
                   exchange_xy: bool = True) -> torch.Tensor:
    """(..., n) → (..., n·num_pos_feats): interleaved sin/cos features of
    each coordinate, x and y swapped when ``exchange_xy``."""
    dim_t = temperature ** (2 * (torch.arange(num_pos_feats, device=pos.device) // 2)
                            / num_pos_feats)

    def one(x):
        sx = x * (2 * np.pi) / dim_t
        return torch.stack([torch.sin(sx[..., 0::2]), torch.cos(sx[..., 1::2])],
                           -1).flatten(-2)

    parts = [one(pos[..., i: i + 1]) for i in range(pos.shape[-1])]
    if exchange_xy and len(parts) >= 2:
        parts[0], parts[1] = parts[1], parts[0]
    return torch.cat(parts, -1)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    x = x.clamp(eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


def encoder_reference_points(spatial_shapes) -> np.ndarray:
    """(1, S, L, 2): every token's normalised pixel centre, for each level."""
    pts = []
    for h, w in spatial_shapes:
        yy, xx = np.meshgrid((np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w, indexing="ij")
        pts.append(np.stack([xx, yy], -1).reshape(-1, 2))
    ref = np.concatenate(pts, 0).astype(np.float32)
    return np.broadcast_to(ref[None, :, None], (1, ref.shape[0], len(spatial_shapes), 2)).copy()


def output_proposals(spatial_shapes):
    """(S, 4) unsigmoided two-stage proposals (the token's centre, width and
    height 0.05·2^level; +inf where a coordinate leaves (0.01, 0.99)) and
    their (S,) validity."""
    props = []
    for lvl, (h, w) in enumerate(spatial_shapes):
        yy, xx = np.meshgrid((np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w, indexing="ij")
        wh = np.full((h, w, 2), 0.05 * (2.0 ** lvl))
        props.append(np.concatenate([np.stack([xx, yy], -1), wh], -1).reshape(-1, 4))
    p = np.concatenate(props, 0)
    valid = ((p > 0.01) & (p < 0.99)).all(-1)
    eps = 1e-6
    p = np.log(np.clip(p, eps, 1) / np.clip(1 - p, eps, 1))
    p[~valid] = np.inf
    return p.astype(np.float32), valid


# ------------------------------------------------------------------ modules


class MLP(nn.Module):
    """DETR's MLP: ``layers.{j}`` with ReLU between them."""

    def __init__(self, i: int, hidden: int, out: int, num_layers: int):
        super().__init__()
        dims = [i] + [hidden] * (num_layers - 1) + [out]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for j, layer in enumerate(self.layers):
            x = layer(x)
            if j < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MultiheadAttention(nn.Module):
    """``nn.MultiheadAttention``'s keys (packed ``in_proj_weight``,
    ``out_proj``) with an additive mask, batch first."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, q, k, v, mask=None):
        B, Lq, D = q.shape
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)

        def heads(t):
            return t.reshape(B, -1, self.heads, D // self.heads).transpose(1, 2)

        qh, kh, vh = heads(F.linear(q, wq, bq)), heads(F.linear(k, wk, bk)), \
            heads(F.linear(v, wv, bv))
        attn = qh @ kh.transpose(-1, -2) / np.sqrt(D // self.heads)
        if mask is not None:
            attn = attn + mask
        out = torch.softmax(attn, -1) @ vh
        return self.out_proj(out.transpose(1, 2).reshape(B, Lq, D))


class MSDeformAttn(nn.Module):
    """Learned offsets and weights around reference points; the sampling
    is ``ms_deform_attn``."""

    def __init__(self, dim: int, heads: int, levels: int, points: int):
        super().__init__()
        self.heads, self.levels, self.points = heads, levels, points
        self.sampling_offsets = nn.Linear(dim, heads * levels * points * 2)
        self.attention_weights = nn.Linear(dim, heads * levels * points)
        self.value_proj = nn.Linear(dim, dim)
        self.output_proj = nn.Linear(dim, dim)

    def forward(self, query, reference_points, value, spatial_shapes):
        """query (B, Q, C); reference_points (B, Q, L, 2 or 4), normalised;
        value (B, S, C)."""
        B, Q, C = query.shape
        H, L, P = self.heads, self.levels, self.points
        v = self.value_proj(value).reshape(B, -1, H, C // H)
        off = self.sampling_offsets(query).reshape(B, Q, H, L, P, 2)
        w = torch.softmax(self.attention_weights(query).reshape(B, Q, H, L * P), -1)
        w = w.reshape(B, Q, H, L, P)
        if reference_points.shape[-1] == 2:
            norm = torch.tensor([[wi, hi] for hi, wi in spatial_shapes], dtype=query.dtype,
                                device=query.device)
            loc = reference_points[:, :, None, :, None] + off / norm[None, None, None, :, None]
        else:
            loc = (reference_points[:, :, None, :, None, :2]
                   + off / P * reference_points[:, :, None, :, None, 2:] * 0.5)
        return self.output_proj(ms_deform_attn(v, list(spatial_shapes), loc, w))


class BiMultiHeadAttention(nn.Module):
    """Image ↔ text attention.  The logits less their one global max,
    clipped at ±50000; text → image softmax per row (less its max, clipped),
    image → text softmax over the real text tokens."""

    def __init__(self, v_dim: int, l_dim: int, embed_dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.v_proj = nn.Linear(v_dim, embed_dim)
        self.l_proj = nn.Linear(l_dim, embed_dim)
        self.values_v_proj = nn.Linear(v_dim, embed_dim)
        self.values_l_proj = nn.Linear(l_dim, embed_dim)
        self.out_v_proj = nn.Linear(embed_dim, v_dim)
        self.out_l_proj = nn.Linear(embed_dim, l_dim)

    def forward(self, v, l, text_token_mask):
        H = self.heads
        B, Nv, _ = v.shape
        Nl = l.shape[1]
        E = self.v_proj.out_features
        hd = E // H
        q = (self.v_proj(v) * hd ** -0.5).reshape(B, Nv, H, hd).transpose(1, 2)
        k = self.l_proj(l).reshape(B, Nl, H, hd).transpose(1, 2)
        attn = q @ k.transpose(-1, -2)                      # (B, H, Nv, Nl)
        attn = (attn - attn.max()).clamp(-50000, 50000)
        attn_l = attn.transpose(-1, -2)
        attn_l = (attn_l - attn_l.amax(-1, keepdim=True)).clamp(-50000, 50000)
        attn_l = torch.softmax(attn_l, -1)
        neg = torch.where(text_token_mask[:, None, None, :], 0.0, -1e9)
        attn_v = torch.softmax(attn + neg, -1)
        vl = self.values_l_proj(l).reshape(B, Nl, H, hd).transpose(1, 2)
        vv = self.values_v_proj(v).reshape(B, Nv, H, hd).transpose(1, 2)
        out_v = (attn_v @ vl).transpose(1, 2).reshape(B, Nv, E)
        out_l = (attn_l @ vv).transpose(1, 2).reshape(B, Nl, E)
        return self.out_v_proj(out_v), self.out_l_proj(out_l)


class BiAttentionBlock(nn.Module):
    """Pre-LN fusion with layer-scale gammas: the normed inputs replace the
    inputs in the residual (out = ln(v) + γ_v·Δv)."""

    def __init__(self, v_dim: int, l_dim: int, embed_dim: int, heads: int):
        super().__init__()
        self.layer_norm_v = layer_norm(v_dim)
        self.layer_norm_l = layer_norm(l_dim)
        self.attn = BiMultiHeadAttention(v_dim, l_dim, embed_dim, heads)
        self.gamma_v = nn.Parameter(torch.full((v_dim,), 1e-4))
        self.gamma_l = nn.Parameter(torch.full((l_dim,), 1e-4))

    def forward(self, v, l, text_token_mask):
        vn, ln = self.layer_norm_v(v), self.layer_norm_l(l)
        dv, dl = self.attn(vn, ln, text_token_mask)
        return vn + self.gamma_v * dv, ln + self.gamma_l * dl


class TextEnhancerLayer(nn.Module):
    """Post-LN self-attention layer over the text, with the phrase mask."""

    def __init__(self, dim: int, heads: int, ffn: int):
        super().__init__()
        self.self_attn = MultiheadAttention(dim, heads)
        self.linear1 = nn.Linear(dim, ffn)
        self.linear2 = nn.Linear(ffn, dim)
        self.norm1 = layer_norm(dim)
        self.norm2 = layer_norm(dim)

    def forward(self, text, pos, mask3d):
        q = text + pos
        bias = torch.where(mask3d, 0.0, -1e9)[:, None]
        text = self.norm1(text + self.self_attn(q, q, text, bias))
        return self.norm2(text + self.linear2(F.relu(self.linear1(text))))


class DeformableEncoderLayer(nn.Module):
    def __init__(self, dim: int, heads: int, levels: int, points: int, ffn: int):
        super().__init__()
        self.self_attn = MSDeformAttn(dim, heads, levels, points)
        self.norm1 = layer_norm(dim)
        self.linear1 = nn.Linear(dim, ffn)
        self.linear2 = nn.Linear(ffn, dim)
        self.norm2 = layer_norm(dim)

    def forward(self, src, pos, reference_points, spatial_shapes):
        src = self.norm1(src + self.self_attn(src + pos, reference_points, src, spatial_shapes))
        return self.norm2(src + self.linear2(F.relu(self.linear1(src))))


class DeformableDecoderLayer(nn.Module):
    """Self-attention → text cross-attention → deformable cross-attention →
    FFN, each post-LN."""

    def __init__(self, dim: int, heads: int, levels: int, points: int, ffn: int):
        super().__init__()
        self.self_attn = MultiheadAttention(dim, heads)
        self.norm2 = layer_norm(dim)
        self.ca_text = MultiheadAttention(dim, heads)
        self.catext_norm = layer_norm(dim)
        self.cross_attn = MSDeformAttn(dim, heads, levels, points)
        self.norm1 = layer_norm(dim)
        self.linear1 = nn.Linear(dim, ffn)
        self.linear2 = nn.Linear(ffn, dim)
        self.norm3 = layer_norm(dim)

    def forward(self, tgt, query_pos, reference_points, memory, spatial_shapes, memory_text,
                text_token_mask):
        q = tgt + query_pos
        tgt = self.norm2(tgt + self.self_attn(q, q, tgt))
        tmask = torch.where(text_token_mask[:, None, None, :], 0.0, -1e9)
        tgt = self.catext_norm(tgt + self.ca_text(tgt + query_pos, memory_text, memory_text,
                                                  tmask))
        tgt = self.norm1(tgt + self.cross_attn(tgt + query_pos, reference_points, memory,
                                               spatial_shapes))
        return self.norm3(tgt + self.linear2(F.relu(self.linear1(tgt))))
