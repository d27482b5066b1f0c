"""Segment Anything, box-prompted (port of
``vipe_tpu/priors/track_anything/sam.py``), in the key layout of Meta's
checkpoints (``image_encoder.*``, ``prompt_encoder.*``, ``mask_decoder.*``).

  vit_b: embed 768,  depth 12, 12 heads, global attention at (2, 5, 8, 11)
  vit_l: embed 1024, depth 24, 16 heads, global attention at (5, 11, 17, 23)
  vit_h: embed 1280, depth 32, 16 heads, global attention at (7, 15, 23, 31)

The image encoder is a ViT over 16×16 patches of a 1024² canvas with a
decomposed relative-position bias, attention in 14×14 windows except at its
global layers, and a two-convolution neck (a (256, 64, 64) embedding).  Box
corners are encoded with random Fourier features and two learned corner
embeddings; the mask decoder is the two-way transformer, a 4× transposed
upscaling and hypernetwork heads (four masks and their predicted IoU).

``SamPredictor`` runs on one device, in f32 (TF32 off): ``set_image``
resizes the uint8 frame on the device (bilinear, half-pixel centres, as
``cv2.resize``; rounded back to uint8), normalises and pads it and encodes
it once; ``segment_with_boxes`` and ``segment_composite`` decode up to
``SEG_CHUNK`` boxes per batch in two passes (the second takes the first's
best low-resolution logits as a mask prompt), pick the best of masks 1-3 by
predicted IoU, resize the logits to the frame (``jax.image.resize``'s
bilinear: antialiased where it shrinks) and threshold them at 0.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...models import zoo
from ...ops.resize import resize_bilinear, resize_u8_linear
from ...utils.device import resolve_device, true_f32
from .gdino.transformer import MLP

PROMPT_DIM = 256
IMAGE_SIZE = 1024
PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)

SAM_CONFIGS = {
    "vit_b": dict(embed_dim=768, depth=12, num_heads=12, global_attn=(2, 5, 8, 11)),
    "vit_l": dict(embed_dim=1024, depth=24, num_heads=16, global_attn=(5, 11, 17, 23)),
    "vit_h": dict(embed_dim=1280, depth=32, num_heads=16, global_attn=(7, 15, 23, 31)),
}


def layer_norm_2d(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """Meta's ``LayerNorm2d``: a LayerNorm over the channels of an NCHW map."""
    return norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def rel_pos_table(rel_pos: torch.Tensor, size: int) -> torch.Tensor:
    """(2·size − 1, d) table → (size, size, d): entry (q, k) is the
    embedding of the offset q − k.  The tables are held at their input
    size, so no interpolation is needed."""
    assert rel_pos.shape[0] == 2 * size - 1, (rel_pos.shape, size)
    idx = torch.arange(size, device=rel_pos.device)
    return rel_pos[idx[:, None] - idx[None, :] + size - 1]


class SamAttention(nn.Module):
    """Multi-head attention over an (H, W) grid of tokens with the
    decomposed relative-position bias: the bias of (q, k) is q·R_h[qh − kh]
    + q·R_w[qw − kw], from the unscaled query."""

    def __init__(self, dim: int, num_heads: int, input_size: Tuple[int, int]):
        super().__init__()
        self.num_heads = num_heads
        hd = dim // num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, hd))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, C)."""
        B, H, W, C = x.shape
        h = self.num_heads
        qkv = self.qkv(x).reshape(B, H * W, 3, h, C // h).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]                       # (B, h, N, d)
        q_r = q.reshape(B, h, H, W, -1)
        bias_h = torch.einsum("bnhwd,hkd->bnhwk", q_r, rel_pos_table(self.rel_pos_h, H))
        bias_w = torch.einsum("bnhwd,wkd->bnhwk", q_r, rel_pos_table(self.rel_pos_w, W))
        bias = (bias_h[..., :, None] + bias_w[..., None, :]).reshape(B, h, H * W, H * W)
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
        return self.proj(out.transpose(1, 2).reshape(B, H, W, C))


def window_partition(x: torch.Tensor, ws: int):
    """(B, H, W, C) → (B·nW, ws, ws, C), zero-padded to multiples of ws;
    also the padded size."""
    B, H, W, C = x.shape
    ph, pw = (ws - H % ws) % ws, (ws - W % ws) % ws
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    x = x.reshape(B, Hp // ws, ws, Wp // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, C), (Hp, Wp)


def window_unpartition(wins: torch.Tensor, ws: int, pad_hw, hw) -> torch.Tensor:
    Hp, Wp = pad_hw
    H, W = hw
    B = wins.shape[0] // (Hp * Wp // ws // ws)
    x = wins.reshape(B, Hp // ws, Wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, Hp, Wp, -1)[:, :H, :W]


class MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int, act):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)
        self.act = act

    def forward(self, x):
        return self.lin2(self.act(self.lin1(x)))


class SamBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int, grid: int):
        super().__init__()
        self.window_size = window_size  # 0: global attention
        size = (window_size, window_size) if window_size else (grid, grid)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = SamAttention(dim, num_heads, size)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, 4 * dim, F.gelu)

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        if self.window_size:
            hw = x.shape[1:3]
            x, pad_hw = window_partition(x, self.window_size)
            x = window_unpartition(self.attn(x), self.window_size, pad_hw, hw)
        else:
            x = self.attn(x)
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, 16, stride=16)


class ImageEncoderViT(nn.Module):
    """(B, 3, S, S) normalised canvas → (B, 256, S/16, S/16)."""

    def __init__(self, embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 global_attn=(2, 5, 8, 11), window_size: int = 14, img_size: int = IMAGE_SIZE):
        super().__init__()
        g = img_size // 16
        self.patch_embed = PatchEmbed(embed_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, g, g, embed_dim))
        self.blocks = nn.ModuleList(
            SamBlock(embed_dim, num_heads, 0 if i in global_attn else window_size, g)
            for i in range(depth))
        self.neck = nn.Sequential(
            nn.Conv2d(embed_dim, PROMPT_DIM, 1, bias=False), nn.LayerNorm(PROMPT_DIM, eps=1e-6),
            nn.Conv2d(PROMPT_DIM, PROMPT_DIM, 3, padding=1, bias=False),
            nn.LayerNorm(PROMPT_DIM, eps=1e-6))

    def forward(self, x):
        x = self.patch_embed.proj(x).permute(0, 2, 3, 1) + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        x = self.neck[0](x.permute(0, 3, 1, 2))
        x = self.neck[2](layer_norm_2d(x, self.neck[1]))
        return layer_norm_2d(x, self.neck[3])


class PositionEmbeddingRandom(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.zeros(2, PROMPT_DIM // 2))

    def forward(self, pts01: torch.Tensor) -> torch.Tensor:
        """(..., 2) in [0, 1] → (..., 256) Fourier features."""
        proj = (2 * pts01 - 1) @ self.positional_encoding_gaussian_matrix * (2 * math.pi)
        return torch.cat([torch.sin(proj), torch.cos(proj)], -1)


class PromptEncoder(nn.Module):
    """Box prompts (the two corner embeddings, ``point_embeddings`` 2 and
    3), the no-mask embedding, the dense positional grid and the mask
    prompt's downscaling stack."""

    def __init__(self, img_size: int = IMAGE_SIZE, mask_in_chans: int = 16):
        super().__init__()
        self.img_size = img_size
        self.pe_layer = PositionEmbeddingRandom()
        self.point_embeddings = nn.ModuleDict({k: nn.Embedding(1, PROMPT_DIM) for k in "23"})
        self.no_mask_embed = nn.Embedding(1, PROMPT_DIM)
        c = mask_in_chans
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, c // 4, 2, stride=2), nn.LayerNorm(c // 4, eps=1e-6), nn.GELU(),
            nn.Conv2d(c // 4, c, 2, stride=2), nn.LayerNorm(c, eps=1e-6), nn.GELU(),
            nn.Conv2d(c, PROMPT_DIM, 1))

    def sparse(self, boxes: torch.Tensor) -> torch.Tensor:
        """(B, 2, 2) corners in canvas pixels → (B, 2, 256)."""
        corners = torch.cat([self.point_embeddings["2"].weight, self.point_embeddings["3"].weight])
        return self.pe_layer((boxes + 0.5) / self.img_size) + corners

    def dense_pe(self) -> torch.Tensor:
        """(g·g, 256) positional encoding of the embedding's grid, row-major."""
        g = self.img_size // 16
        w = self.no_mask_embed.weight
        c = (torch.arange(g, dtype=w.dtype, device=w.device) + 0.5) / g
        gy, gx = torch.meshgrid(c, c, indexing="ij")
        return self.pe_layer(torch.stack([gx, gy], -1)).reshape(g * g, PROMPT_DIM)

    def mask_embed(self, mask: torch.Tensor) -> torch.Tensor:
        """(B, 1, 4g, 4g) logits → (B, 256, g, g)."""
        m = self.mask_downscaling
        x = F.gelu(layer_norm_2d(m[0](mask), m[1]))
        x = F.gelu(layer_norm_2d(m[3](x), m[4]))
        return m[6](x)


class TwoWayAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, downsample: int = 1):
        super().__init__()
        d = dim // downsample
        self.num_heads = num_heads
        self.q_proj = nn.Linear(dim, d)
        self.k_proj = nn.Linear(dim, d)
        self.v_proj = nn.Linear(dim, d)
        self.out_proj = nn.Linear(d, dim)

    def _heads(self, x):
        B, N, d = x.shape
        return x.reshape(B, N, self.num_heads, d // self.num_heads).transpose(1, 2)

    def forward(self, q, k, v):
        o = F.scaled_dot_product_attention(self._heads(self.q_proj(q)),
                                           self._heads(self.k_proj(k)),
                                           self._heads(self.v_proj(v)))
        return self.out_proj(o.transpose(1, 2).flatten(2))


class TwoWayBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_dim: int, skip_first_pe: bool):
        super().__init__()
        self.skip_first_pe = skip_first_pe
        self.self_attn = TwoWayAttention(dim, num_heads)
        self.norm1 = nn.LayerNorm(dim)
        self.cross_attn_token_to_image = TwoWayAttention(dim, num_heads, 2)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = MLPBlock(dim, mlp_dim, F.relu)
        self.norm3 = nn.LayerNorm(dim)
        self.norm4 = nn.LayerNorm(dim)
        self.cross_attn_image_to_token = TwoWayAttention(dim, num_heads, 2)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_pe:
            # the first layer replaces the queries, with no residual
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        a = self.cross_attn_token_to_image(queries + query_pe, keys + key_pe, keys)
        queries = self.norm2(queries + a)
        queries = self.norm3(queries + self.mlp(queries))
        a = self.cross_attn_image_to_token(keys + key_pe, queries + query_pe, queries)
        return queries, self.norm4(keys + a)


class TwoWayTransformer(nn.Module):
    def __init__(self, dim: int = PROMPT_DIM):
        super().__init__()
        self.layers = nn.ModuleList(TwoWayBlock(dim, 8, 2048, i == 0) for i in range(2))
        self.final_attn_token_to_image = TwoWayAttention(dim, 8, 2)
        self.norm_final_attn = nn.LayerNorm(dim)


class MaskDecoder(nn.Module):
    def __init__(self, num_multimask: int = 3):
        super().__init__()
        D = PROMPT_DIM
        self.n_masks = num_multimask + 1
        self.iou_token = nn.Embedding(1, D)
        self.mask_tokens = nn.Embedding(self.n_masks, D)
        self.transformer = TwoWayTransformer(D)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(D, D // 4, 2, stride=2), nn.LayerNorm(D // 4, eps=1e-6), nn.GELU(),
            nn.ConvTranspose2d(D // 4, D // 8, 2, stride=2), nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(D, D, D // 8, 3) for _ in range(self.n_masks))
        self.iou_prediction_head = MLP(D, 256, self.n_masks, 3)

    def forward(self, image_embed, dense_pe, sparse, dense):
        """image_embed (B, 256, g, g); dense_pe (g·g, 256); sparse (B, P,
        256); dense: the (256,) no-mask embedding or a (B, 256, g, g) mask
        embedding.  Returns masks (B, 4, 4g, 4g) and IoU (B, 4)."""
        B, D, g, _ = image_embed.shape
        tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight])
        tokens = torch.cat([tokens[None].expand(B, -1, -1), sparse], 1)
        keys = image_embed.flatten(2).transpose(1, 2)
        keys = keys + (dense if dense.dim() == 1 else dense.flatten(2).transpose(1, 2))
        key_pe = dense_pe[None]
        t = self.transformer
        queries = tokens
        for layer in t.layers:
            queries, keys = layer(queries, keys, tokens, key_pe)
        a = t.final_attn_token_to_image(queries + tokens, keys + key_pe, keys)
        queries = t.norm_final_attn(queries + a)

        up = self.output_upscaling
        x = keys.transpose(1, 2).reshape(B, D, g, g)
        x = F.gelu(layer_norm_2d(up[0](x), up[1]))
        x = F.gelu(up[3](x))                                   # (B, 32, 4g, 4g)
        hyper = torch.stack([mlp(queries[:, 1 + k])
                             for k, mlp in enumerate(self.output_hypernetworks_mlps)], 1)
        masks = torch.einsum("bchw,bkc->bkhw", x, hyper)
        return masks, self.iou_prediction_head(queries[:, 0])


class Sam(nn.Module):
    def __init__(self, variant: str = "vit_b", img_size: int = IMAGE_SIZE, cfg=None):
        super().__init__()
        c = dict(SAM_CONFIGS[variant], **(cfg or {}))
        self.image_encoder = ImageEncoderViT(img_size=img_size, **c)
        self.prompt_encoder = PromptEncoder(img_size)
        self.mask_decoder = MaskDecoder()

    def decode(self, image_embed, boxes, mask_logits=None):
        """Both prompts of one pass: (B, 2, 2) boxes, and either no mask or
        (B, 4g, 4g) low-resolution logits."""
        pe = self.prompt_encoder
        dense = (pe.no_mask_embed.weight[0] if mask_logits is None
                 else pe.mask_embed(mask_logits[:, None]))
        return self.mask_decoder(image_embed, pe.dense_pe(), pe.sparse(boxes), dense)


def init_sam_(net: Sam, seed: int = 0) -> Sam:
    """Seeded random weights (``models.vit.init_seeded_``), the token and
    prompt embeddings and the Fourier matrix normal(1), the position
    embedding and relative-position tables normal(0.02)."""
    from ...models.vit import init_seeded_

    g = init_seeded_(net, seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, nn.Embedding):
                m.weight.copy_(torch.randn(m.weight.shape, generator=g))
        for name, p in net.named_parameters():
            if name.endswith(("rel_pos_h", "rel_pos_w", "pos_embed")):
                p.copy_(torch.randn(p.shape, generator=g) * 0.02)
        buf = net.prompt_encoder.pe_layer.positional_encoding_gaussian_matrix
        buf.copy_(torch.randn(buf.shape, generator=g))
    return net


def build_sam(variant: str = "vit_b", state_dict=None, seed: int = 0, device="cpu",
              img_size: int = IMAGE_SIZE, cfg=None) -> Sam:
    with torch.device("meta"):
        net = Sam(variant, img_size, cfg)
    return zoo.load_net(net, state_dict, seed, init=init_sam_).to(device)


def composite_first_wins(masks: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(B, H, W) bool and (B,) int32 ids (0: dropped) → (H, W) int32: each
    pixel takes the id of the first kept mask that covers it (the
    reference's sequential ``instance[mask & (instance == 0)] = id``)."""
    valid = masks & (ids[:, None, None] > 0)
    sel = torch.argmax(valid.to(torch.uint8), 0)
    return torch.where(valid.any(0), ids[sel], 0).to(torch.int32)


def to_uint8(rgb) -> np.ndarray:
    """A frame as uint8: float frames in [0, 1] are clipped and truncated."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8:
        rgb = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
    return rgb


class SamPredictor:
    """Box-prompted segmentation on one device (see the module docstring).
    ``state_dict`` None reads the zoo's ``sam_<variant>``, else seeded
    random weights; ``cfg`` overrides the encoder's width and depth."""

    # boxes per decoder batch: bounds the full-resolution resize transient
    SEG_CHUNK = 32

    def __init__(self, variant: str = "vit_b", state_dict=None, seed: int = 0,
                 img_size: int = IMAGE_SIZE, device=None, cfg=None):
        self.device = resolve_device(device)
        self.img_size = img_size
        if state_dict is None:
            state_dict = zoo.load_state_dict(f"sam_{variant}")
        self.net = build_sam(variant, state_dict, seed, self.device, img_size, cfg)
        self._image_embed = None
        self._orig_hw = None
        self._scaled_hw = None

    def canvas(self, rgb) -> torch.Tensor:
        """The normalised, padded (1, 3, S, S) canvas of a frame."""
        rgb = to_uint8(rgb)
        h, w = rgb.shape[:2]
        scale = self.img_size / max(h, w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        x = torch.as_tensor(rgb, device=self.device).permute(2, 0, 1)[None]
        x = resize_u8_linear(x, (nh, nw))
        mean = torch.tensor(PIXEL_MEAN, device=self.device)[:, None, None]
        std = torch.tensor(PIXEL_STD, device=self.device)[:, None, None]
        return F.pad((x - mean) / std, (0, self.img_size - nw, 0, self.img_size - nh))

    def set_image(self, rgb):
        """rgb: (H, W, 3) float in [0, 1] or uint8."""
        h, w = np.asarray(rgb).shape[:2]
        scale = self.img_size / max(h, w)
        self._scaled_hw = (int(round(h * scale)), int(round(w * scale)))
        self._orig_hw = (h, w)
        with torch.no_grad(), true_f32():
            self._image_embed = self.net.image_encoder(self.canvas(rgb))

    def _best(self, masks, iou):
        best = 1 + torch.argmax(iou[:, 1:], -1)
        return masks[torch.arange(len(masks), device=masks.device), best]

    def mask_logits(self, boxes: torch.Tensor) -> torch.Tensor:
        """(B, 2, 2) canvas corners → (B, H, W) logits of each box's best
        mask at the frame's size."""
        nh, nw = self._scaled_hw
        embed = self._image_embed.expand(len(boxes), -1, -1, -1)
        with torch.no_grad(), true_f32():
            sel = self._best(*self.net.decode(embed, boxes))
            sel = self._best(*self.net.decode(embed, boxes, sel))
            m = resize_bilinear(sel[:, None], (self.img_size, self.img_size))[:, :, :nh, :nw]
            return resize_bilinear(m, self._orig_hw)[:, 0]

    def canvas_boxes(self, boxes_xyxy) -> torch.Tensor:
        """(B, 4) frame-pixel boxes → (B, 2, 2) corners on the canvas."""
        boxes = np.asarray(boxes_xyxy, np.float32).reshape(-1, 4)
        h, w = self._orig_hw
        nh, nw = self._scaled_hw
        sx, sy = nw / w, nh / h
        pts = np.stack([boxes[:, 0] * sx, boxes[:, 1] * sy, boxes[:, 2] * sx, boxes[:, 3] * sy],
                       -1).reshape(-1, 2, 2)
        return torch.as_tensor(pts, device=self.device)

    def _segment_chunks(self, boxes_xyxy):
        assert self._image_embed is not None, "call set_image first"
        pts = self.canvas_boxes(boxes_xyxy)
        return [self.mask_logits(pts[s: s + self.SEG_CHUNK]) > 0.0
                for s in range(0, len(pts), self.SEG_CHUNK)]

    def segment_with_boxes(self, boxes_xyxy) -> np.ndarray:
        """(B, 4) frame-pixel boxes → (B, H, W) bool masks (host)."""
        chunks = self._segment_chunks(boxes_xyxy)
        if not chunks:
            return np.zeros((0,) + self._orig_hw, bool)
        return torch.cat(chunks).cpu().numpy()

    def segment_composite(self, boxes_xyxy, min_area: int, first_id: int):
        """Every box segmented and the masks whose area reaches
        ``min_area`` composited into one instance map on the device, ids
        given in box order from ``first_id``; only the areas and the map
        come back.  Returns (instance (H, W) int32, ids (B,) int32, 0 where
        dropped)."""
        chunks = self._segment_chunks(boxes_xyxy)
        if not chunks:
            return np.zeros(self._orig_hw, np.int32), np.zeros((0,), np.int32)
        masks = torch.cat(chunks)
        areas = masks.sum((1, 2)).cpu().numpy().astype(np.int64)
        ids = np.zeros(len(areas), np.int32)
        next_id = first_id
        for i, a in enumerate(areas):
            if a >= min_area:
                ids[i] = next_id
                next_id += 1
        inst = composite_first_wins(masks, torch.as_tensor(ids, device=self.device))
        return inst.cpu().numpy(), ids
