"""DeAOT (R50-DeAOT-L), decoupled gated-propagation video object
segmentation (port of ``vipe_tpu/priors/track_anything/deaot/network.py``),
in the reference's key layout (``encoder.*``, ``encoder_projector``,
``LSTT.layers.{i}.*``, ``LSTT.decoder_norms.0.gn``, ``patch_wise_id_bank``,
``id_norm``, ``decoder.*``).

* Encoder: ResNet-50 stages 1-3 (frozen batch norms), output stride 16,
  the stride-16 map given twice and the last projected to d_model.
* Identity embedding: a 17×17 stride-16 convolution of the one-hot slot map
  and a LayerNorm.
* Three gated-propagation layers, each with a long-term branch (global
  attention over every reference frame's tokens), a short-term branch
  (attention in a 15×15 window of the previous frame) and gated
  self-attention, over a visual and an identity stream.
* An FPN decoder to stride 4 with align-corners upsampling.

Sequences are (tokens, B, C), the reference's layout; maps are NCHW.  The
short-term branch forms its window dots from an unfold of the keys and
aggregates the values through a dense (hw, padded hw) matrix that the
window's weights are scattered into, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....ops.resize import resize_align_corners


@dataclasses.dataclass(frozen=True)
class DeAOTConfig:
    """R50_DeAOTL."""

    d_model: int = 256
    lstt_num: int = 3
    self_heads: int = 1
    att_heads: int = 1
    ffn_dim: int = 1024
    max_obj_num: int = 10
    max_dis: int = 7          # local window 15
    expand_ratio: float = 2.0
    encoder_dims: Tuple[int, ...] = (256, 512, 1024, 1024)
    resnet_blocks: Tuple[int, ...] = (3, 4, 6)

    @property
    def d_att(self) -> int:
        return self.d_model // 2 if self.att_heads == 1 else self.d_model // self.att_heads

    @staticmethod
    def tiny() -> "DeAOTConfig":
        return DeAOTConfig(d_model=32, lstt_num=2, ffn_dim=64, max_obj_num=10, max_dis=2,
                           encoder_dims=(16, 24, 32, 32), resnet_blocks=(1, 1, 1))


# ---------------------------------------------------------------- encoder


class FrozenBN(nn.Module):
    """An affine map from stored batch statistics (eps 1e-5)."""

    def __init__(self, n: int):
        super().__init__()
        for name in ("weight", "bias", "running_mean", "running_var"):
            self.register_buffer(name, torch.zeros(n))

    def forward(self, x):
        scale = self.weight * torch.rsqrt(self.running_var + 1e-5)
        return (x - self.running_mean[:, None, None]) * scale[:, None, None] \
            + self.bias[:, None, None]


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBN(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = FrozenBN(planes)
        self.conv3 = nn.Conv2d(planes, 4 * planes, 1, bias=False)
        self.bn3 = FrozenBN(4 * planes)
        if downsample:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, 4 * planes, 1, stride=stride, bias=False), FrozenBN(4 * planes))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        r = self.downsample(x) if hasattr(self, "downsample") else x
        return F.relu(y + r)


class ResNetEncoder(nn.Module):
    """ResNet-50 stages 1-3 → [4×, 8×, 16×, 16×] maps."""

    def __init__(self, cfg: DeAOTConfig):
        super().__init__()
        stem = cfg.encoder_dims[0] // 4
        self.conv1 = nn.Conv2d(3, stem, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBN(stem)
        inplanes = stem
        for s, (blocks, planes4) in enumerate(zip(cfg.resnet_blocks, cfg.encoder_dims[:3])):
            planes = planes4 // 4
            layer = nn.Sequential(*(
                Bottleneck(inplanes if b == 0 else 4 * planes, planes,
                           (1, 2, 2)[s] if b == 0 else 1, b == 0) for b in range(blocks)))
            self.add_module(f"layer{s + 1}", layer)
            inplanes = 4 * planes

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        xs = []
        for s in range(3):
            x = getattr(self, f"layer{s + 1}")(x)
            xs.append(x)
        xs.append(x)
        return xs


# ------------------------------------------------------------- attention


class DWConv2d(nn.Module):
    """Depthwise 5×5 over a (hw, B, C) sequence."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 5, padding=2, groups=channels, bias=False)

    def forward(self, x, size_2d):
        h, w = size_2d
        L, B, C = x.shape
        y = self.conv(x.permute(1, 2, 0).reshape(B, C, h, w))
        return y.reshape(B, C, L).permute(2, 0, 1)


class GatedPropagation(nn.Module):
    """Global gated attention: softmax(q·k/√d_att)·v, gated by u, then a
    depthwise convolution and a projection.  ``use_linear``: the
    self-attention's own Q/K, V and U projections."""

    def __init__(self, d_qk: int, d_vu: int, num_head: int, d_att: int, use_linear: bool,
                 expand_ratio: float = 2.0):
        super().__init__()
        self.num_head, self.d_att, self.use_linear = num_head, d_att, use_linear
        self.expand_d_vu = int(d_vu * expand_ratio)
        self.hidden = self.expand_d_vu // num_head
        if use_linear:
            half = self.hidden * num_head // 2
            self.linear_QK = nn.Linear(d_qk, d_att * num_head)
            self.linear_V1 = nn.Linear(d_vu // 2, half)
            self.linear_V2 = nn.Linear(d_vu // 2, half)
            self.linear_U1 = nn.Linear(d_vu // 2, half)
            self.linear_U2 = nn.Linear(d_vu // 2, half)
        self.dw_conv = DWConv2d(self.expand_d_vu)
        self.projection = nn.Linear(self.expand_d_vu, d_vu)

    def _cat_halves(self, x1, x2, B):
        if self.num_head > 1:
            x1 = x1.reshape(-1, B, self.num_head, self.hidden // 2)
            x2 = x2.reshape(-1, B, self.num_head, self.hidden // 2)
            return torch.cat([x1, x2], -1).reshape(-1, B, self.expand_d_vu)
        return torch.cat([x1, x2], -1)

    def forward(self, Q, K, V, U, size_2d):
        L, B, _ = Q.shape
        if self.use_linear:
            Q = K = self.linear_QK(Q)
            V1, V2 = V.chunk(2, -1)
            V = F.silu(self._cat_halves(self.linear_V1(V1), self.linear_V2(V2), B))
            U1, U2 = U.chunk(2, -1)
            U = F.silu(self._cat_halves(self.linear_U1(U1), self.linear_U2(U2), B))
        q = Q.reshape(L, B, self.num_head, self.d_att).permute(1, 2, 0, 3)
        k = K.reshape(-1, B, self.num_head, self.d_att).permute(1, 2, 0, 3)
        v = V.reshape(-1, B, self.num_head, self.hidden).permute(1, 2, 0, 3)
        out = F.scaled_dot_product_attention(q, k, v)       # (B, h, L, hidden)
        out = out.permute(2, 0, 1, 3).reshape(L, B, -1) * U
        return self.projection(self.dw_conv(out, size_2d))


@functools.lru_cache(maxsize=None)
def local_scatter_indices(h: int, w: int, max_dis: int) -> np.ndarray:
    """(hw, win²) flat indices into the padded (h + 2m)(w + 2m) key plane of
    each query's window positions."""
    m = max_dis
    win = 2 * m + 1
    qy, qx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    dy, dx = np.meshgrid(np.arange(win), np.arange(win), indexing="ij")
    ky = qy.reshape(-1, 1) + dy.reshape(1, -1)
    kx = qx.reshape(-1, 1) + dx.reshape(1, -1)
    return (ky * (w + 2 * m) + kx).astype(np.int64)


class LocalGatedPropagation(nn.Module):
    """Gated attention in a (2m + 1)² window: the dots of the query with the
    unfolded keys plus a relative embedding projected from the unscaled
    query, keys outside the frame at −1e8, a softmax over the window; the
    values aggregated through the scattered dense matrix."""

    def __init__(self, d_qk: int, d_vu: int, num_head: int, d_att: int, max_dis: int = 7,
                 expand_ratio: float = 2.0):
        super().__init__()
        self.num_head, self.d_att, self.max_dis = num_head, d_att, max_dis
        win = 2 * max_dis + 1
        self.expand_d_vu = int(d_vu * expand_ratio)
        self.relative_emb_k = nn.Conv2d(d_att * num_head, num_head * win * win, 1,
                                        groups=num_head)
        self.dw_conv = DWConv2d(self.expand_d_vu)
        self.projection = nn.Linear(self.expand_d_vu, d_vu)

    def forward(self, q, k, v, u, size_2d):
        """q, k: (B, d_att·heads, h, w); v: (B, Cv, h, w); u: (hw, B, Cv)."""
        m = self.max_dis
        win = 2 * m + 1
        B, _, h, w = q.shape
        nh = self.num_head
        rel = self.relative_emb_k(q).reshape(B, nh, win * win, h * w)
        kp = F.unfold(k, win, padding=m).reshape(B, nh, self.d_att, win * win, h * w)
        qh = (q / self.d_att ** 0.5).reshape(B, nh, self.d_att, 1, h * w)
        qk = (qh * kp).sum(2) + rel                          # (B, nh, win², hw)
        valid = F.unfold(torch.ones((1, 1, h, w), dtype=q.dtype, device=q.device), win,
                         padding=m).reshape(1, 1, win * win, h * w)
        attn = torch.softmax(qk - (1.0 - valid) * 1e8, 2)

        idx = torch.as_tensor(local_scatter_indices(h, w, m), device=q.device)
        pad_hw = (h + 2 * m) * (w + 2 * m)
        dense = q.new_zeros(B, nh, h * w, pad_hw)
        dense.scatter_(-1, idx.expand(B, nh, -1, -1), attn.transpose(2, 3))
        vp = F.pad(v, (m, m, m, m)).reshape(B, nh, self.expand_d_vu // nh, pad_hw)
        agg = dense @ vp.transpose(2, 3)                     # (B, nh, hw, Cv/nh)
        out = agg.permute(2, 0, 1, 3).reshape(h * w, B, -1) * u
        return self.projection(self.dw_conv(out, (h, w)))


# -------------------------------------------------------------- LSTT block


class GatedPropagationModule(nn.Module):
    """One dual-branch block of DeAOT's LSTT."""

    def __init__(self, cfg: DeAOTConfig, layer_idx: int):
        super().__init__()
        c = cfg
        d = c.d_model
        self.cfg = c
        ed = int(d * c.expand_ratio)
        self.norm1 = nn.LayerNorm(d)
        self.linear_QV = nn.Linear(d, c.d_att * c.att_heads + ed)
        self.linear_U = nn.Linear(d, ed)
        self.linear_ID_V = nn.Linear(d if layer_idx == 0 else 2 * d, ed)
        if layer_idx > 0:
            self.id_norm1 = nn.LayerNorm(d)
            self.linear_ID_U = nn.Linear(d, ed)
        self.long_term_attn = GatedPropagation(d, 2 * d, c.att_heads, c.d_att, False,
                                               c.expand_ratio)
        self.short_term_attn = LocalGatedPropagation(d, 2 * d, c.att_heads, c.d_att, c.max_dis,
                                                     c.expand_ratio)
        self.norm2 = nn.LayerNorm(d)
        self.id_norm2 = nn.LayerNorm(d)
        self.self_attn = GatedPropagation(2 * d, 2 * d, c.self_heads, c.d_att, True,
                                          c.expand_ratio)

    def fuse_key_value_id(self, value, id_emb):
        if value is not None:
            return F.silu(self.linear_ID_V(torch.cat([value, id_emb], -1)))
        return F.silu(self.linear_ID_V(id_emb))

    def forward(self, tgt, tgt_id, memory, size_2d):
        """memory: ``curr_id_emb`` (a reference frame: it matches itself),
        or the long-term ``global_K/V/ID_V`` (tokens, B, C) and the
        short-term ``local_K/V/ID_V`` (B, C, h, w)."""
        c = self.cfg
        h, w = size_2d
        na = c.d_att * c.att_heads
        _tgt = self.norm1(tgt)
        qv = self.linear_QV(_tgt)
        curr_Q, curr_V = qv[..., :na], F.silu(qv[..., na:])
        curr_U = self.linear_U(_tgt)
        if tgt_id is None:
            cat_curr_U = torch.cat([F.silu(curr_U), torch.ones_like(curr_U)], -1)
            curr_ID_V = None
        else:
            curr_ID_V = self.id_norm1(tgt_id)
            cat_curr_U = F.silu(torch.cat([curr_U, self.linear_ID_U(curr_ID_V)], -1))

        def plane(x):
            return x.permute(1, 2, 0).reshape(x.shape[1], -1, h, w)

        if memory.get("curr_id_emb") is not None:
            global_K, global_V = curr_Q, curr_V
            global_ID_V = self.fuse_key_value_id(curr_ID_V, memory["curr_id_emb"])
            local_K, local_V, local_ID_V = plane(global_K), plane(global_V), plane(global_ID_V)
        else:
            global_K, global_V, global_ID_V = (memory["global_K"], memory["global_V"],
                                               memory["global_ID_V"])
            local_K, local_V, local_ID_V = (memory["local_K"], memory["local_V"],
                                            memory["local_ID_V"])
        tgt2 = self.long_term_attn(curr_Q, global_K, torch.cat([global_V, global_ID_V], -1),
                                   cat_curr_U, size_2d)
        tgt3 = self.short_term_attn(plane(curr_Q), local_K, torch.cat([local_V, local_ID_V], 1),
                                    cat_curr_U, size_2d)
        t2, ti2 = tgt2.chunk(2, -1)
        t3, ti3 = tgt3.chunk(2, -1)
        tgt = tgt + t2 + t3
        tgt_id = (ti2 + ti3) if tgt_id is None else tgt_id + ti2 + ti3
        qkvu = torch.cat([self.norm2(tgt), self.id_norm2(tgt_id)], -1)
        t2, ti2 = self.self_attn(qkvu, qkvu, qkvu, qkvu, size_2d).chunk(2, -1)
        new_memory = {"curr_K": curr_Q, "curr_V": curr_V, "curr_ID_V": curr_ID_V,
                      "global_K": global_K, "global_V": global_V, "global_ID_V": global_ID_V}
        return tgt + t2, tgt_id + ti2, new_memory


# ------------------------------------------------------------- full model


class _GN(nn.Module):
    def __init__(self, groups: int, channels: int):
        super().__init__()
        self.gn = nn.GroupNorm(groups, channels, eps=1e-5)


class _LSTT(nn.Module):
    def __init__(self, cfg: DeAOTConfig):
        super().__init__()
        self.layers = nn.ModuleList(GatedPropagationModule(cfg, i) for i in range(cfg.lstt_num))
        self.decoder_norms = nn.ModuleList([_GN(2, 2 * cfg.d_model)])


class _ConvGN(nn.Module):
    def __init__(self, i: int, o: int, k: int):
        super().__init__()
        self.conv = nn.Conv2d(i, o, k, padding=k // 2)
        self.gn = nn.GroupNorm(8, o, eps=1e-5)

    def forward(self, x):
        return F.relu(self.gn(self.conv(x)))


class FPNDecoder(nn.Module):
    def __init__(self, cfg: DeAOTConfig):
        super().__init__()
        hd = cfg.d_model
        self.conv_in = _ConvGN(2 * hd, hd, 1)
        self.conv_16x = _ConvGN(hd, hd, 3)
        self.conv_8x = _ConvGN(hd, hd // 2, 3)
        self.conv_4x = _ConvGN(hd // 2, hd // 2, 3)
        self.adapter_16x = nn.Conv2d(cfg.encoder_dims[-2], hd, 1)
        self.adapter_8x = nn.Conv2d(cfg.encoder_dims[-3], hd, 1)
        self.adapter_4x = nn.Conv2d(cfg.encoder_dims[-4], hd // 2, 1)
        self.conv_out = nn.Conv2d(hd // 2, cfg.max_obj_num + 1, 1)

    def forward(self, x, enc):
        x = self.conv_in(x)
        x = self.conv_16x(self.adapter_16x(enc[-2]) + x)
        x = resize_align_corners(x, enc[-3].shape[-2:])
        x = self.conv_8x(self.adapter_8x(enc[-3]) + x)
        x = resize_align_corners(x, enc[-4].shape[-2:])
        x = self.conv_4x(self.adapter_4x(enc[-4]) + x)
        return self.conv_out(x)


class DeAOTNet(nn.Module):
    def __init__(self, cfg: DeAOTConfig = None):
        super().__init__()
        c = self.cfg = cfg or DeAOTConfig()
        self.encoder = ResNetEncoder(c)
        self.encoder_projector = nn.Conv2d(c.encoder_dims[-1], c.d_model, 1)
        self.LSTT = _LSTT(c)
        self.patch_wise_id_bank = nn.Conv2d(c.max_obj_num + 1, c.d_model, 17, stride=16,
                                            padding=8)
        self.id_norm = nn.LayerNorm(c.d_model)
        self.decoder = FPNDecoder(c)

    def encode_image(self, img):
        """(B, 3, H, W) ImageNet-normalised → 4 maps, the last projected to
        d_model."""
        xs = self.encoder(img)
        xs[-1] = self.encoder_projector(xs[-1])
        return xs

    def get_id_emb(self, one_hot):
        """(B, max_obj + 1, H, W) one-hot → (hw, B, d)."""
        e = self.patch_wise_id_bank(one_hot)
        return self.id_norm(e.flatten(2).permute(2, 0, 1))

    def lstt_forward(self, enc, memories, curr_id_emb, size_2d):
        """The LSTT over the last encoder map: the final (visual ‖ identity)
        output, group-normed over the whole sequence, and every layer's new
        memory."""
        tgt = enc[-1].flatten(2).permute(2, 0, 1)
        tgt_id = None
        new_memories = []
        for i, layer in enumerate(self.LSTT.layers):
            mem = dict(memories[i]) if memories is not None else {}
            if curr_id_emb is not None:
                mem["curr_id_emb"] = curr_id_emb
            tgt, tgt_id, new_mem = layer(tgt, tgt_id, mem, size_2d)
            new_memories.append(new_mem)
        out = torch.cat([tgt, tgt_id], -1)                  # (L, B, 2d)
        out = self.LSTT.decoder_norms[0].gn(out.permute(1, 2, 0))
        return out, new_memories

    def decode_logits(self, lstt_out, enc, size_2d):
        """(B, 2d, L) → (B, max_obj + 1, H/4, W/4) logits."""
        h, w = size_2d
        return self.decoder(lstt_out.reshape(lstt_out.shape[0], -1, h, w), enc)


def init_deaot_(net: DeAOTNet, seed: int = 0) -> DeAOTNet:
    """Seeded random weights (``models.vit.init_seeded_``), frozen batch
    norms at identity."""
    from ....models.vit import init_seeded_

    init_seeded_(net, seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, FrozenBN):
                m.weight.fill_(1.0)
                m.running_var.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
    return net
