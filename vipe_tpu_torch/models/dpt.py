"""DPT head of Depth Anything v2 (port of ``vipe_tpu/models/dpt.py``), in
ViPE's key layout (``projects.i``, ``resize_layers.{0,1,3}``,
``scratch.layerN_rn``, ``scratch.refinenetN.resConfUnitU.conv{1,2}``,
``scratch.refinenetN.out_conv``, ``scratch.output_conv1``,
``scratch.output_conv2.{0,2}``):

* per tap a 1×1 projection, then a ×4 or ×2 transposed convolution, the
  identity, or a stride-2 3×3 convolution padded (1, 1);
* bias-free 3×3 convolutions into a common ``features`` width;
* a top-down chain of fusion blocks (residual units, an align-corners
  upsample to the next skip's size, a 1×1 convolution);
* a 3×3 convolution to half width, an align-corners upsample to the
  image size, a 3×3 convolution to 32, ReLU, a 1×1 convolution to one
  channel, then ReLU (relative disparity) or a sigmoid (metric).

``refinenet4`` takes no skip input and holds no ``resConfUnit1`` (ViPE's
checkpoints carry one that is never run; the loaders drop it).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_align_corners


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FeatureFusionBlock(nn.Module):
    def __init__(self, features: int, has_skip: bool = True):
        super().__init__()
        if has_skip:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None, out_hw=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        if out_hw is None:
            out_hw = (x.shape[-2] * 2, x.shape[-1] * 2)
        return self.out_conv(resize_align_corners(x, tuple(out_hw)))


class _Scratch(nn.Module):
    def __init__(self, out_channels: Sequence[int], features: int, is_metric: bool):
        super().__init__()
        for i, oc in enumerate(out_channels):
            setattr(self, f"layer{i + 1}_rn", nn.Conv2d(oc, features, 3, padding=1, bias=False))
        for r in range(1, 5):
            setattr(self, f"refinenet{r}", FeatureFusionBlock(features, has_skip=r != 4))
        self.output_conv1 = nn.Conv2d(features, features // 2, 3, padding=1)
        self.output_conv2 = nn.Sequential(
            nn.Conv2d(features // 2, 32, 3, padding=1), nn.ReLU(), nn.Conv2d(32, 1, 1),
            nn.Sigmoid() if is_metric else nn.ReLU())


class DPTHead(nn.Module):
    """``forward(taps, ph, pw)``: taps are the ViT's four (patch tokens
    (B, ph·pw, D), extras); returns (B, 14·ph, 14·pw)."""

    def __init__(self, in_dim: int, features: int = 256,
                 out_channels: Sequence[int] = (256, 512, 1024, 1024),
                 patch_size: int = 14, is_metric: bool = False):
        super().__init__()
        oc = tuple(out_channels)
        self.patch_size = patch_size
        self.projects = nn.ModuleList(nn.Conv2d(in_dim, c, 1) for c in oc)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4),
            nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2),
            nn.Identity(),
            nn.Conv2d(oc[3], oc[3], 3, stride=2, padding=1),
        ])
        self.scratch = _Scratch(oc, features, is_metric)

    def levels(self, taps, ph: int, pw: int) -> List[torch.Tensor]:
        """The four projected and resized levels, NCHW."""
        out = []
        for proj, resize, (tokens, _extras) in zip(self.projects, self.resize_layers, taps):
            B, _, D = tokens.shape
            f = tokens.transpose(1, 2).reshape(B, D, ph, pw)
            out.append(resize(proj(f)))
        return out

    def rn(self, levels) -> Tuple[torch.Tensor, ...]:
        s = self.scratch
        return tuple(getattr(s, f"layer{i + 1}_rn")(f) for i, f in enumerate(levels))

    def output(self, p1, ph: int, pw: int) -> torch.Tensor:
        s = self.scratch
        out = resize_align_corners(s.output_conv1(p1), (ph * self.patch_size, pw * self.patch_size))
        return s.output_conv2(out)[:, 0]

    def forward(self, taps, ph: int, pw: int) -> torch.Tensor:
        s = self.scratch
        l1, l2, l3, l4 = self.rn(self.levels(taps, ph, pw))
        p4 = s.refinenet4(l4, out_hw=l3.shape[-2:])
        p3 = s.refinenet3(p4, l3, out_hw=l2.shape[-2:])
        p2 = s.refinenet2(p3, l2, out_hw=l1.shape[-2:])
        return self.output(s.refinenet1(p2, l1), ph, pw)
