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
