"""Depth Anything v2 (port of ``vipe_tpu/priors/depth/dav2.py``): the DINOv2
ViT tapped at four depths and the DPT head, in ViPE's key layout
(``pretrained.*``, ``depth_head.*``).

  vits: features 64,  out_channels (48, 96, 192, 384),    taps (2, 5, 8, 11)
  vitb: features 128, out_channels (96, 192, 384, 768),   taps (2, 5, 8, 11)
  vitl: features 256, out_channels (256, 512, 1024, 1024), taps (4, 11, 17, 23)

Relative checkpoints give a ReLU disparity (``AFFINE_DISP``), metric ones
sigmoid·max_depth.  ``cond_dim = 3`` is PriorDA's conditioned network
(``pretrained.patch_embed.alpha_proj``).

Preprocessing runs on the device: the frame is resized so that its short
side is about ``input_size``, each side a multiple of 14, by bicubic
interpolation in float (a = −0.75, half-pixel centres, clamped borders,
no antialiasing: ``cv2.INTER_CUBIC``'s), then normalised with the
ImageNet statistics.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...models import zoo
from ...models.dpt import DPTHead
from ...models.vit import VIT_CONFIGS, make_vit
from ...ops.resize import resize_align_corners
from ...utils.device import resolve_device, true_f32
from .base import (IMAGENET_MEAN, IMAGENET_STD, DepthEstimationInput, DepthEstimationModel,
                   DepthEstimationResult, DepthType)

DAV2_CONFIGS = {
    "vits": dict(features=64, out_channels=(48, 96, 192, 384), taps=(2, 5, 8, 11)),
    "vitb": dict(features=128, out_channels=(96, 192, 384, 768), taps=(2, 5, 8, 11)),
    "vitl": dict(features=256, out_channels=(256, 512, 1024, 1024), taps=(4, 11, 17, 23)),
}


def input_hw(h: int, w: int, input_size: int):
    """The net's input size for an (h, w) frame: the short side scaled to
    ``input_size``, each side rounded to a multiple of 14."""
    scale = input_size / min(h, w)
    return (max(int(round(h * scale / 14)) * 14, 14), max(int(round(w * scale / 14)) * 14, 14))


def resize_cubic(x: torch.Tensor, size) -> torch.Tensor:
    """(N, C, H, W) float → (N, C, *size), as ``cv2.resize(...,
    INTER_CUBIC)`` on float pixels."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bicubic", align_corners=False)


def normalize(x: torch.Tensor) -> torch.Tensor:
    """(N, 3, H, W) in [0, 1] → ImageNet-normalised."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)[:, None, None]
    return (x - mean) / std


def preprocess(rgbs, input_size: int = 518, device="cpu") -> torch.Tensor:
    """(N, H, W, 3) float frames in [0, 1] (numpy or torch) → the net's
    (N, 3, nh, nw) f32 input on ``device``."""
    x = torch.as_tensor(np.asarray(rgbs, np.float32) if not torch.is_tensor(rgbs) else rgbs,
                        dtype=torch.float32).to(device)
    x = x.permute(0, 3, 1, 2)
    return normalize(resize_cubic(x, input_hw(x.shape[-2], x.shape[-1], input_size)))


class DepthAnythingV2Net(nn.Module):
    """``forward(x, condition=None)``: x (B, 3, H, W) normalised, H and W
    multiples of 14 (``condition``: (B, cond_dim, H, W)) → (B, H, W)."""

    def __init__(self, variant: str = "vitl", max_depth: Optional[float] = None,
                 cond_dim: int = 0):
        super().__init__()
        cfg = DAV2_CONFIGS[variant]
        self.variant, self.taps, self.max_depth = variant, cfg["taps"], max_depth
        self.pretrained = make_vit(variant, cond_dim=cond_dim)
        self.depth_head = DPTHead(VIT_CONFIGS[variant]["embed_dim"], cfg["features"],
                                  cfg["out_channels"], is_metric=max_depth is not None)

    def forward(self, x, condition=None):
        taps = self.pretrained(x, self.taps, condition)
        out = self.depth_head(taps, x.shape[-2] // 14, x.shape[-1] // 14)
        return out * self.max_depth if self.max_depth is not None else out


def variant_of(state_dict, default: str) -> str:
    """The ViT size of a DAv2 state dict, from its cls token's width."""
    if state_dict is None:
        return default
    dim = int(state_dict["pretrained.cls_token"].shape[-1])
    return {384: "vits", 768: "vitb", 1024: "vitl"}.get(dim, default)


def build_dav2_net(variant: str, state_dict=None, seed: int = 0, device="cpu",
                   max_depth=None, cond_dim: int = 0) -> DepthAnythingV2Net:
    """A frozen ``DepthAnythingV2Net`` on ``device`` with ``state_dict``, or
    seeded random weights when it is None."""
    with torch.device("meta"):
        net = DepthAnythingV2Net(variant, max_depth, cond_dim)
    return zoo.load_net(net, state_dict, seed).to(device)


class DepthAnythingV2Model(DepthEstimationModel):
    """ViPE's Depth Anything v2 adapter: ``estimate`` runs the f32 net on
    the preprocessed frame and resizes its output back to the frame's size
    (align-corners).  ``state_dict`` None reads the zoo's
    ``dav2_<variant>``, else seeded random weights."""

    def __init__(self, variant: str = "vitl", ckpt: str = "default", input_size: int = 518,
                 state_dict=None, seed: int = 0, device=None):
        self.is_metric = ckpt.startswith("metric")
        self.max_depth = (20.0 if ckpt == "metric-indoor" else 80.0) if self.is_metric else None
        self.depth_type = DepthType.METRIC_DEPTH if self.is_metric else DepthType.AFFINE_DISP
        self.input_size = input_size
        self.device = resolve_device(device)
        if state_dict is None:
            state_dict = zoo.load_state_dict(f"dav2_{variant}")
        self.net = build_dav2_net(variant, state_dict, seed, self.device, self.max_depth)

    @torch.no_grad()
    def estimate(self, inp: DepthEstimationInput) -> DepthEstimationResult:
        rgb = np.asarray(inp.rgb, np.float32)
        x = preprocess(rgb[None], self.input_size, self.device)
        with true_f32():
            out = self.net(x)
        return DepthEstimationResult(depth=resize_align_corners(out[:, None], rgb.shape[:2])[0, 0])
