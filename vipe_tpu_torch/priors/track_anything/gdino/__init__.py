"""GroundingDINO: open-vocabulary detection (port of
``vipe_tpu/priors/track_anything/gdino/__init__.py``), in the reference's
key layout (``backbone.0.*``, ``bert.*``, ``feat_map``, ``input_proj.*``,
``transformer.*``, ``bbox_embed.0.*``).

Swin-T backbone and BERT-base text encoder; a feature enhancer of 6
layers (image ↔ text fusion, text self-attention, deformable
self-attention over 4 levels); two-stage query selection of 900 queries by
their best text logit; a 6-layer cross-modality decoder with iterative box
refinement, the box head, reference-point head and final norm shared
across layers; logits are the dot products of query and text features.

The detector's host side (caption, tokens, phrase masks, threshold, the
score-ordered cap, boxes to pixels and phrase decoding) is numpy, as the
JAX package's; the image is resized and normalised on the device, the net
runs in f32 (TF32 off).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....models import zoo
from ....utils.device import resolve_device, true_f32
from .bert import BertConfig, BertEncoder, generate_special_token_masks, make_tokenizer
from .swin import SwinTransformer
from .transformer import (EPS, MLP, BiAttentionBlock, DeformableDecoderLayer,
                          DeformableEncoderLayer, TextEnhancerLayer, encoder_reference_points,
                          inverse_sigmoid, layer_norm, output_proposals, sine_embed_hw,
                          sine_pos_embed)


@dataclasses.dataclass(frozen=True)
class GDINOConfig:
    """``swin_T_224_1k`` GroundingDINO."""

    hidden_dim: int = 256
    nheads: int = 8
    enc_layers: int = 6
    dec_layers: int = 6
    ffn_dim: int = 2048
    num_queries: int = 900
    num_levels: int = 4
    enc_points: int = 4
    dec_points: int = 4
    max_text_len: int = 256
    swin_embed_dim: int = 96
    swin_depths: Tuple[int, ...] = (2, 2, 6, 2)
    swin_heads: Tuple[int, ...] = (3, 6, 12, 24)
    swin_window: int = 7
    bert: BertConfig = dataclasses.field(default_factory=BertConfig)

    @staticmethod
    def tiny() -> "GDINOConfig":
        """The same topology at small widths (CPU tests)."""
        return GDINOConfig(
            hidden_dim=32, nheads=4, enc_layers=2, dec_layers=2, ffn_dim=64,
            num_queries=20, swin_embed_dim=16, swin_depths=(1, 1, 1, 1),
            swin_heads=(1, 2, 4, 8), swin_window=4, max_text_len=64,
            bert=BertConfig(vocab_size=30522, hidden_size=48, num_layers=2, num_heads=4,
                            intermediate_size=96))


class _Encoder(nn.Module):
    def __init__(self, c: GDINOConfig):
        super().__init__()
        d = c.hidden_dim
        self.fusion_layers = nn.ModuleList(
            BiAttentionBlock(d, d, c.ffn_dim // 2, c.nheads // 2) for _ in range(c.enc_layers))
        self.text_layers = nn.ModuleList(
            TextEnhancerLayer(d, c.nheads // 2, c.ffn_dim // 2) for _ in range(c.enc_layers))
        self.layers = nn.ModuleList(
            DeformableEncoderLayer(d, c.nheads, c.num_levels, c.enc_points, c.ffn_dim)
            for _ in range(c.enc_layers))


class _Decoder(nn.Module):
    def __init__(self, c: GDINOConfig):
        super().__init__()
        d = c.hidden_dim
        self.layers = nn.ModuleList(
            DeformableDecoderLayer(d, c.nheads, c.num_levels, c.dec_points, c.ffn_dim)
            for _ in range(c.dec_layers))
        self.ref_point_head = MLP(2 * d, d, d, 2)
        self.norm = layer_norm(d)


class _Transformer(nn.Module):
    def __init__(self, c: GDINOConfig):
        super().__init__()
        d = c.hidden_dim
        self.level_embed = nn.Parameter(torch.zeros(c.num_levels, d))
        self.encoder = _Encoder(c)
        self.enc_output = nn.Linear(d, d)
        self.enc_output_norm = layer_norm(d)
        self.enc_out_bbox_embed = MLP(d, d, 4, 3)
        self.tgt_embed = nn.Embedding(c.num_queries, d)
        self.decoder = _Decoder(c)


def contrastive(x, text, text_token_mask):
    """Query · text dot products, −1e9 at padded text tokens."""
    return torch.where(text_token_mask[:, None, :], x @ text.transpose(1, 2), -1e9)


class GroundingDINOModel(nn.Module):
    def __init__(self, cfg: Optional[GDINOConfig] = None):
        super().__init__()
        c = self.cfg = cfg or GDINOConfig()
        d = c.hidden_dim
        self.backbone = nn.ModuleList([SwinTransformer(c.swin_embed_dim, c.swin_depths,
                                                       c.swin_heads, c.swin_window)])
        self.bert = BertEncoder(c.bert)
        self.feat_map = nn.Linear(c.bert.hidden_size, d)
        chans = [c.swin_embed_dim * 2 ** i for i in (1, 2, 3)]
        gn = min(32, d)
        self.input_proj = nn.ModuleList(
            nn.Sequential(nn.Conv2d(chans[i] if i < 3 else chans[-1], d, 1 if i < 3 else 3,
                                    stride=1 if i < 3 else 2, padding=0 if i < 3 else 1),
                          nn.GroupNorm(gn, d, eps=EPS))
            for i in range(c.num_levels))
        self.transformer = _Transformer(c)
        self.bbox_embed = nn.ModuleList([MLP(d, d, 4, 3)])

    def forward(self, image, input_ids, text_mask3d, position_ids, text_token_mask):
        """image (B, 3, H, W) normalised; input_ids (B, Lt); text_mask3d (B,
        Lt, Lt) bool; position_ids (B, Lt); text_token_mask (B, Lt) bool.
        Returns logits (B, nq, max_text_len) and boxes (B, nq, 4), cxcywh
        in [0, 1]."""
        enc = self.encode(image, input_ids, text_mask3d, position_ids, text_token_mask)
        return self.decode(enc, self.select(enc["scores"]), text_token_mask)

    def encode(self, image, input_ids, text_mask3d, position_ids, text_token_mask) -> dict:
        """The feature enhancer and the two-stage proposals: ``memory`` (B, S,
        d), ``text`` (B, Lt, d), the maps' ``shapes``, each token's best text
        logit ``scores`` (B, S) and its unsigmoided box ``boxes`` (B, S, 4)."""
        d = self.cfg.hidden_dim
        dev = image.device
        t = self.transformer

        text = self.feat_map(self.bert(input_ids, text_mask3d, position_ids))

        feats = self.backbone[0](image)
        srcs = [proj(f) for proj, f in zip(self.input_proj, feats)]
        srcs.append(self.input_proj[len(feats)](feats[-1]))
        shapes = tuple((s.shape[2], s.shape[3]) for s in srcs)
        src = torch.cat([s.flatten(2).transpose(1, 2) for s in srcs], 1)
        pos = torch.cat([torch.as_tensor(sine_embed_hw(h, w, d), device=dev).reshape(1, h * w, d)
                         + t.level_embed[lvl] for lvl, (h, w) in enumerate(shapes)], 1)

        ref_pts = torch.as_tensor(encoder_reference_points(shapes), device=dev)
        pos_text = sine_pos_embed(position_ids[..., None].float(), d, exchange_xy=False)
        out = src
        enc = t.encoder
        for fusion, text_layer, layer in zip(enc.fusion_layers, enc.text_layers, enc.layers):
            out, text = fusion(out, text, text_token_mask)
            text = text_layer(text, pos_text, text_mask3d)
            out = layer(out, pos, ref_pts, shapes)

        props, valid = output_proposals(shapes)
        om = torch.where(torch.as_tensor(valid, device=dev)[None, :, None], out, 0.0)
        om = t.enc_output_norm(t.enc_output(om))
        scores = contrastive(om, text, text_token_mask).amax(-1)
        boxes = torch.as_tensor(props, device=dev)[None] + t.enc_out_bbox_embed(om)
        return {"memory": out, "text": text, "shapes": shapes, "scores": scores, "boxes": boxes}

    def select(self, scores) -> torch.Tensor:
        """The (B, nq) tokens of the best scores, in descending order; a
        stable sort ranks tied tokens by index, as ``lax.top_k``."""
        order = torch.sort(scores, dim=-1, descending=True, stable=True)[1]
        return order[:, : self.cfg.num_queries]

    def decode(self, enc: dict, topk_idx, text_token_mask):
        """The decoder on the selected tokens' proposals: logits and boxes."""
        c = self.cfg
        d = c.hidden_dim
        t = self.transformer
        ref_unsig = torch.gather(enc["boxes"], 1, topk_idx[..., None].expand(-1, -1, 4))
        hs = t.tgt_embed.weight[None].expand(topk_idx.shape[0], -1, -1)
        dec = t.decoder
        bbox_embed = self.bbox_embed[0]
        reference = torch.sigmoid(ref_unsig)
        for layer in dec.layers:
            query_pos = dec.ref_point_head(sine_pos_embed(reference, d // 2))
            hs = layer(hs, query_pos, reference[:, :, None].expand(-1, -1, c.num_levels, -1),
                       enc["memory"], enc["shapes"], enc["text"], text_token_mask)
            # box refinement from the raw layer output; the final norm is
            # the classification path's only
            reference = torch.sigmoid(bbox_embed(hs) + inverse_sigmoid(reference))
        logits = contrastive(dec.norm(hs), enc["text"], text_token_mask)
        logits = F.pad(logits, (0, c.max_text_len - logits.shape[-1]), value=-1e9)
        return logits, reference


def init_gdino_(net: GroundingDINOModel, seed: int = 0) -> GroundingDINOModel:
    """Seeded random weights: ``models.vit.init_seeded_`` for the dense,
    convolution and norm layers, the packed attention projections likewise
    (variance 1/fan_in, bias 0), the word, position and type embeddings
    normal(0.02), the level and query embeddings normal(1), the
    relative-position tables normal(0.02), the layer scales 1e-4."""
    from ....models.vit import init_seeded_

    g = init_seeded_(net, seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "in_proj_weight":
                p.copy_(torch.randn(p.shape, generator=g) * p.shape[1] ** -0.5)
            elif leaf == "in_proj_bias":
                p.zero_()
            elif leaf in ("gamma_v", "gamma_l"):
                p.fill_(1e-4)
            elif name.startswith("bert.embeddings") and "LayerNorm" not in name:
                p.copy_(torch.randn(p.shape, generator=g) * 0.02)
            elif leaf == "relative_position_bias_table":
                p.copy_(torch.randn(p.shape, generator=g) * 0.02)
            elif name in ("transformer.level_embed", "transformer.tgt_embed.weight"):
                p.copy_(torch.randn(p.shape, generator=g))
    return net


def build_gdino(cfg: Optional[GDINOConfig] = None, state_dict=None, seed: int = 0,
                device="cpu") -> GroundingDINOModel:
    with torch.device("meta"):
        net = GroundingDINOModel(cfg)
    return zoo.load_net(net, state_dict, seed, init=init_gdino_).to(device)


# ------------------------------------------------------------- host glue


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def text_bucket(n: int, cap: int) -> int:
    """The padded text length: a power of two from 32, at most ``cap``."""
    b = 32
    while b < n:
        b *= 2
    return min(b, cap)


def canvas_hw(h: int, w: int, short_side: int, max_side: int) -> Tuple[int, int]:
    """The /32 canvas of an (h, w) frame: the short side to ``short_side``
    unless the long side would pass ``max_side``."""
    s = short_side / min(h, w)
    if max(h, w) * s > max_side:
        s = max_side / max(h, w)
    return max(32, int(round(h * s / 32)) * 32), max(32, int(round(w * s / 32)) * 32)


class GroundingDINODetector:
    """``run_grounding(rgb, phrases) -> list of xyxy pixel boxes`` (and the
    phrase of each), on one device.  ``state_dict`` None reads the zoo's
    ``gdino``, else seeded random weights."""

    def __init__(self, cfg: Optional[GDINOConfig] = None, state_dict=None,
                 box_threshold: float = 0.35, short_side: int = 800, max_side: int = 1333,
                 seed: int = 0, max_detections: int = 100, device=None):
        self.cfg = cfg or GDINOConfig()
        self.device = resolve_device(device)
        self.box_threshold = box_threshold
        self.max_detections = max_detections
        self.short_side = short_side
        self.max_side = max_side
        self.tokenizer = make_tokenizer()
        if state_dict is None:
            state_dict = zoo.load_state_dict("gdino")
        self.net = build_gdino(self.cfg, state_dict, seed, self.device)

    def preprocess(self, rgb) -> torch.Tensor:
        """(1, 3, h1, w1) normalised canvas: a float bilinear resize (half-
        pixel centres, as ``cv2.resize``), /255 when the pixels pass 1.5."""
        rgb = np.asarray(rgb)
        h1, w1 = canvas_hw(*rgb.shape[:2], self.short_side, self.max_side)
        x = torch.as_tensor(rgb, device=self.device).float().permute(2, 0, 1)[None]
        if tuple(x.shape[-2:]) != (h1, w1):
            x = F.interpolate(x, size=(h1, w1), mode="bilinear", align_corners=False)
        if float(x.max()) > 1.5:
            x = x / 255.0
        mean = torch.tensor(IMAGENET_MEAN, device=self.device)[:, None, None]
        std = torch.tensor(IMAGENET_STD, device=self.device)[:, None, None]
        return (x - mean) / std

    def text_inputs(self, phrases: List[str]):
        """(ids, ids_pad, mask3d, position ids, token mask) of the caption
        'p1 . p2 . … .'."""
        caption = " . ".join(p.strip().lower() for p in phrases) + " ."
        ids = self.tokenizer(caption)[: self.cfg.max_text_len]
        Lb = text_bucket(len(ids), self.cfg.max_text_len)
        ids_pad = np.zeros((1, Lb), np.int64)
        ids_pad[0, : len(ids)] = ids
        m3, pid = generate_special_token_masks(ids_pad)
        tmask = np.zeros((1, Lb), bool)
        tmask[0, : len(ids)] = True
        return ids, ids_pad, m3, pid, tmask

    def forward(self, rgb, phrases: List[str]):
        """The net's sigmoid logits (nq, max_text_len) and cxcywh boxes
        (nq, 4) for one frame, on the host; also the caption's ids."""
        ids, *text = self.text_inputs(phrases)
        args = [self.preprocess(rgb)] + [torch.as_tensor(a, device=self.device) for a in text]
        with torch.no_grad(), true_f32():
            logits, boxes = self.net(*args)
        return torch.sigmoid(logits[0]).cpu().numpy(), boxes[0].cpu().numpy(), ids

    def run_grounding(self, rgb, phrases: List[str], return_phrases: bool = False):
        H0, W0 = np.asarray(rgb).shape[:2]
        logits, boxes, ids = self.forward(rgb, phrases)
        scores = logits.max(-1)
        keep = scores > self.box_threshold
        boxes, logits, scores = boxes[keep], logits[keep], scores[keep]
        if len(boxes) > self.max_detections:
            # score-ordered cap: bounds the per-box work downstream when an
            # uncalibrated model floods proposals past the threshold
            order = np.argsort(-scores)[: self.max_detections]
            boxes, logits = boxes[order], logits[order]
        cx, cy, bw, bh = boxes.T * np.asarray([[W0], [H0], [W0], [H0]])
        xyxy = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1)
        if not return_phrases:
            return [b for b in xyxy]
        return [b for b in xyxy], self.phrases_for(logits, ids, phrases)

    @staticmethod
    def phrases_for(logits: np.ndarray, ids: List[int], phrases: List[str]) -> List[str]:
        """Each detection's phrase: the '.'-delimited token segment with the
        largest summed probability."""
        from .bert import CLS_ID, DOT_ID, SEP_ID

        segments, cur = [], []
        for t, tok in enumerate(ids):
            if tok in (CLS_ID, SEP_ID):
                continue
            if tok == DOT_ID:
                if cur:
                    segments.append(cur)
                    cur = []
            else:
                cur.append(t)
        if cur:
            segments.append(cur)
        out = []
        for lg in logits:
            scores = [lg[seg].sum() for seg in segments]
            k = int(np.argmax(scores)) if scores else 0
            out.append(phrases[k] if k < len(phrases) else "")
        return out
