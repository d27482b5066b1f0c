"""GeoCalib network in PyTorch, NCHW (port of
``vipe_tpu/priors/geocalib/network.py``): an MSCAN (SegNeXt) backbone, a
low-level encoder at full resolution and two LightHamHead decoders that
predict an up-vector field, a latitude field and per-pixel confidences for
the LM fit (``optimizer.py``).

Parameters and buffers use the key layout of ViPE's GeoCalib state dict
(``backbone.block3.7.attn.spatial_gating_unit.conv2_1.weight``,
``perspective_decoder.up_head.decoder.hamburger.ham_in.conv.weight``, …),
so a ViPE checkpoint loads with ``load_state_dict(strict=True)``.
BatchNorms run in eval mode on their running statistics.  The NMF bases of
the Hamburgers are an input: the caller draws them once.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

EMBED_DIMS = (64, 128, 320, 512)
DEPTHS = (3, 3, 12, 3)
MLP_RATIOS = (8, 8, 4, 4)
HAM_CHANNELS = 512
NMF_RANK = 64
NMF_STEPS = 7


def _dw(dim: int, kh: int, kw: int) -> nn.Conv2d:
    """Depthwise conv with 'same' padding."""
    return nn.Conv2d(dim, dim, (kh, kw), padding=(kh // 2, kw // 2), groups=dim)


class ConvModule(nn.Module):
    """conv + ReLU (GeoCalib's ConvModules use no norm)."""

    def __init__(self, cin: int, cout: int, kernel: int = 1, bias: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, padding=kernel // 2, bias=bias)

    def forward(self, x):
        return F.relu(self.conv(x))


class DWConv(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = _dw(dim, 3, 3)

    def forward(self, x):
        return self.dwconv(x)


class MscanMlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Conv2d(dim, hidden, 1)
        self.dwconv = DWConv(hidden)
        self.fc2 = nn.Conv2d(hidden, dim, 1)

    def forward(self, x):
        return self.fc2(F.gelu(self.dwconv(self.fc1(x))))


class AttentionModule(nn.Module):
    """Large-kernel strip-convolution attention."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv0 = _dw(dim, 5, 5)
        self.conv0_1, self.conv0_2 = _dw(dim, 1, 7), _dw(dim, 7, 1)
        self.conv1_1, self.conv1_2 = _dw(dim, 1, 11), _dw(dim, 11, 1)
        self.conv2_1, self.conv2_2 = _dw(dim, 1, 21), _dw(dim, 21, 1)
        self.conv3 = nn.Conv2d(dim, dim, 1)

    def forward(self, x):
        attn = self.conv0(x)
        a0 = self.conv0_2(self.conv0_1(attn))
        a1 = self.conv1_2(self.conv1_1(attn))
        a2 = self.conv2_2(self.conv2_1(attn))
        return self.conv3(attn + a0 + a1 + a2) * x


class SpatialAttention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj_1 = nn.Conv2d(dim, dim, 1)
        self.spatial_gating_unit = AttentionModule(dim)
        self.proj_2 = nn.Conv2d(dim, dim, 1)

    def forward(self, x):
        y = self.proj_2(self.spatial_gating_unit(F.gelu(self.proj_1(x))))
        return y + x


class MscanBlock(nn.Module):
    def __init__(self, dim: int, mlp_ratio: float):
        super().__init__()
        self.norm1 = nn.BatchNorm2d(dim, eps=1e-5)
        self.attn = SpatialAttention(dim)
        self.norm2 = nn.BatchNorm2d(dim, eps=1e-5)
        self.mlp = MscanMlp(dim, int(dim * mlp_ratio))
        self.layer_scale_1 = nn.Parameter(torch.full((dim,), 1e-2))
        self.layer_scale_2 = nn.Parameter(torch.full((dim,), 1e-2))

    def forward(self, x):
        x = x + self.layer_scale_1[:, None, None] * self.attn(self.norm1(x))
        return x + self.layer_scale_2[:, None, None] * self.mlp(self.norm2(x))


class StemConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.proj = nn.Sequential(
            nn.Conv2d(cin, cout // 2, 3, stride=2, padding=1),
            nn.BatchNorm2d(cout // 2, eps=1e-5), nn.GELU(),
            nn.Conv2d(cout // 2, cout, 3, stride=2, padding=1),
            nn.BatchNorm2d(cout, eps=1e-5),
        )

    def forward(self, x):
        return self.proj(x)


class OverlapPatchEmbed(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.proj = nn.Conv2d(cin, cout, 3, stride=2, padding=1)
        self.norm = nn.BatchNorm2d(cout, eps=1e-5)

    def forward(self, x):
        return self.norm(self.proj(x))


def _channel_layer_norm(ln: nn.LayerNorm, x):
    return ln(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class MSCAN(nn.Module):
    def __init__(self):
        super().__init__()
        for i, d in enumerate(EMBED_DIMS):
            embed = (StemConv(3, d) if i == 0
                     else OverlapPatchEmbed(EMBED_DIMS[i - 1], d))
            setattr(self, f"patch_embed{i + 1}", embed)
            setattr(self, f"block{i + 1}", nn.ModuleList(
                MscanBlock(d, MLP_RATIOS[i]) for _ in range(DEPTHS[i])))
            setattr(self, f"norm{i + 1}", nn.LayerNorm(d, eps=1e-5))

    def forward(self, x):
        """x: (B, 3, H, W) RGB in [0, 1] → features at /4, /8, /16, /32.
        The network reads BGR·255."""
        x = x.flip(1) * 255.0
        outs = []
        for i in range(len(EMBED_DIMS)):
            x = getattr(self, f"patch_embed{i + 1}")(x)
            for blk in getattr(self, f"block{i + 1}"):
                x = blk(x)
            x = _channel_layer_norm(getattr(self, f"norm{i + 1}"), x)
            outs.append(x)
        return outs


def nmf2d(x: torch.Tensor, bases: torch.Tensor, steps: int = NMF_STEPS) -> torch.Tensor:
    """Non-negative matrix factorisation attention by multiplicative updates.
    x: (B, N, D) non-negative; bases: (B, D, r), columns of unit norm."""
    xT = x.transpose(1, 2)                                   # (B, D, N)
    coef = torch.softmax(torch.einsum("bdn,bdr->bnr", xT, bases), dim=-1)
    for _ in range(steps):
        num = torch.einsum("bdn,bdr->bnr", xT, bases)
        den = coef @ (bases.transpose(1, 2) @ bases)
        coef = coef * num / (den + 1e-6)
        num = torch.einsum("bdn,bnr->bdr", xT, coef)
        den = bases @ (coef.transpose(1, 2) @ coef)
        bases = bases * num / (den + 1e-6)
    num = torch.einsum("bdn,bdr->bnr", xT, bases)
    den = coef @ (bases.transpose(1, 2) @ bases)
    coef = coef * num / (den + 1e-6)
    return torch.einsum("bdr,bnr->bnd", bases, coef)


def nmf_bases(generator: torch.Generator) -> torch.Tensor:
    """(1, 512, 64) uniform bases with unit-norm columns."""
    bases = torch.rand((1, HAM_CHANNELS, NMF_RANK), generator=generator)
    return bases / torch.clamp(torch.linalg.vector_norm(bases, dim=1, keepdim=True), min=1e-6)


class Hamburger(nn.Module):
    def __init__(self, channels: int = HAM_CHANNELS):
        super().__init__()
        self.ham_in = ConvModule(channels, channels)
        self.ham_out = ConvModule(channels, channels)

    def forward(self, x, bases):
        B, C, H, W = x.shape
        y = self.ham_in(x)
        y = nmf2d(y.flatten(2).transpose(1, 2), bases.expand(B, -1, -1))
        y = self.ham_out(y.transpose(1, 2).reshape(B, C, H, W))
        return F.relu(x + y)


class ResidualConvUnit(nn.Module):
    """Adds ``relu(x)``, not ``x``: ViPE's first ReLU runs in place on its
    input."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        y0 = F.relu(x)
        return y0 + self.conv2(F.relu(self.conv1(y0)))


class FeatureFusion(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)


def _resize(x, size):
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False)


class LightHamHead(nn.Module):
    """HamNet decoder with the low-level fusion; returns features and the
    confidence logits."""

    def __init__(self, out_channels: int = 64, ham_channels: int = HAM_CHANNELS):
        super().__init__()
        self.squeeze = ConvModule(sum(EMBED_DIMS), ham_channels)
        self.hamburger = Hamburger(ham_channels)
        self.align = ConvModule(ham_channels, out_channels)
        self.out_conv = ConvModule(out_channels, out_channels, 3, bias=False)
        self.ll_fusion = FeatureFusion(out_channels)
        self.linear_pred_uncertainty = nn.Sequential(
            ConvModule(out_channels, out_channels, 3, bias=False),
            nn.Conv2d(out_channels, 1, 1),
        )

    def forward(self, hl_feats, ll_feat, bases):
        size = hl_feats[0].shape[-2:]
        x = torch.cat([_resize(f, size) for f in hl_feats], dim=1)
        x = self.hamburger(self.squeeze(x), bases)
        feats = self.align(x)
        H, W = feats.shape[-2:]
        feats = self.out_conv(_resize(feats, (2 * H, 2 * W)))
        feats = _resize(feats, (4 * H, 4 * W))
        feats = feats + self.ll_fusion.resConfUnit1(ll_feat)
        feats = self.ll_fusion.resConfUnit2(feats)
        return feats, self.linear_pred_uncertainty(feats)[:, 0]


class LowLevelEncoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = ConvModule(3, 64, 3)
        self.conv2 = ConvModule(64, 64, 3)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class UpHead(nn.Module):
    def __init__(self):
        super().__init__()
        self.decoder = LightHamHead()
        self.linear_pred_up = nn.Conv2d(64, 2, 1)


class LatitudeHead(nn.Module):
    def __init__(self):
        super().__init__()
        self.decoder = LightHamHead()
        self.linear_pred_latitude = nn.Conv2d(64, 1, 1)


class PerspectiveDecoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.up_head = UpHead()
        self.latitude_head = LatitudeHead()


class GeoCalibNet(nn.Module):
    """Backbone, low-level encoder, up and latitude decoders."""

    def __init__(self):
        super().__init__()
        self.backbone = MSCAN()
        self.ll_enc = LowLevelEncoder()
        self.perspective_decoder = PerspectiveDecoder()

    def forward(self, image, bases):
        """image (B, 3, H, W) RGB in [0, 1], H and W multiples of 32;
        bases (1 or B, 512, 64) → up_field (B, 2, H, W) of unit vectors,
        latitude_field (B, H, W) in radians, up_confidence and
        latitude_confidence (B, H, W) in (0, 1)."""
        hl = self.backbone(image)
        ll = self.ll_enc(image)
        up_head = self.perspective_decoder.up_head
        up_feats, up_logconf = up_head.decoder(hl, ll, bases)
        up = up_head.linear_pred_up(up_feats)
        up = up / torch.clamp(torch.linalg.vector_norm(up, dim=1, keepdim=True), min=1e-12)
        lat_head = self.perspective_decoder.latitude_head
        lat_feats, lat_logconf = lat_head.decoder(hl, ll, bases)
        lat = lat_head.linear_pred_latitude(lat_feats)[:, 0]
        eps = 1e-5
        lat = torch.arcsin(torch.clamp(torch.tanh(lat), -1 + eps, 1 - eps))
        return {
            "up_field": up,
            "up_confidence": torch.sigmoid(up_logconf),
            "latitude_field": lat,
            "latitude_confidence": torch.sigmoid(lat_logconf),
        }


def init_geocalib_(model: GeoCalibNet, seed: int = 0) -> GeoCalibNet:
    """Seeded random init: convolutions uniform in ±1/√fan_in (PyTorch's
    default bounds) from one ``torch.Generator``; norms at identity, layer
    scales at 1e-2, BatchNorm statistics at (0, 1)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                bound = 1.0 / float(m.weight[0].numel()) ** 0.5
                m.weight.copy_((torch.rand(m.weight.shape, generator=g) * 2 - 1) * bound)
                if m.bias is not None:
                    m.bias.copy_((torch.rand(m.bias.shape, generator=g) * 2 - 1) * bound)
            elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
                m.reset_parameters()
            elif isinstance(m, MscanBlock):
                m.layer_scale_1.fill_(1e-2)
                m.layer_scale_2.fill_(1e-2)
    return model
