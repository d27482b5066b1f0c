"""Depth-prior interface (port of ``vipe_tpu/priors/depth/base.py``).

``DepthType`` says how a prior's output may be used:
  METRIC_DEPTH          — metric, focal-scalable without re-running the model
  MODEL_METRIC_DEPTH    — metric, but needs a re-run if intrinsics change
  MODEL_METRIC_DISTANCE — metric ray distance (not plane depth)
  AFFINE_DISP           — disparity up to affine transform
  SCALE_DISP            — disparity up to scale
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Optional

import torch

# ImageNet statistics that the ViT-based priors normalise their input with
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class DepthType(Enum):
    METRIC_DEPTH = "metric_depth"
    MODEL_METRIC_DEPTH = "model_metric_depth"
    MODEL_METRIC_DISTANCE = "model_metric_distance"
    AFFINE_DISP = "affine_disp"
    SCALE_DISP = "scale_disp"


@dataclass
class DepthEstimationInput:
    rgb: torch.Tensor  # (H, W, 3) float in [0, 1]
    focal_length: Optional[float] = None


@dataclass
class DepthEstimationResult:
    depth: torch.Tensor  # (H, W), interpreted as ``depth_type`` says
    confidence: Optional[torch.Tensor] = None


class DepthEstimationModel:
    depth_type: DepthType = DepthType.METRIC_DEPTH

    def estimate(self, inp: DepthEstimationInput) -> DepthEstimationResult:
        raise NotImplementedError

    def estimate_depth(self, rgb, focal_length=None):
        return self.estimate(DepthEstimationInput(rgb=rgb, focal_length=focal_length)).depth

    def estimate_depth_batch(self, rgbs, focal_length=None):
        """Depth for several same-shaped frames with one shared focal; this
        default runs them one by one, a model with a batched forward
        overrides it."""
        return [self.estimate_depth(r, focal_length) for r in rgbs]


class ConstantDepthModel(DepthEstimationModel):
    """Constant metric depth everywhere: a prior with no weights, for tests
    and for driving the keyframe-depth path."""

    depth_type = DepthType.METRIC_DEPTH

    def __init__(self, depth: float = 2.0):
        self.depth = depth

    def estimate(self, inp):
        h, w = inp.rgb.shape[0], inp.rgb.shape[1]
        return DepthEstimationResult(
            depth=torch.full((h, w), self.depth, dtype=torch.float32, device=inp.rgb.device))
