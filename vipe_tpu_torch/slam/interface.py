"""SLAM outputs (port of ``vipe_tpu/slam/interface.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..ops import cameras as cam


@dataclass
class SLAMMap:
    """Coloured keyframe point cloud: dense per-keyframe grids; ``mask``
    selects the depth-consistent points."""

    xyz: np.ndarray         # (N, h, w, 3) world-space points
    rgb: np.ndarray         # (N, h, w, 3)
    mask: np.ndarray        # (N, h, w) bool
    frame_inds: np.ndarray  # (N,) original frame index per keyframe

    def masked_points(self):
        return self.xyz[self.mask], self.rgb[self.mask]


@dataclass
class SLAMOutput:
    trajectory: np.ndarray  # (T, 7) camera-to-world SE3
    intrinsics: np.ndarray  # (D,) full-res intrinsics
    camera_type: cam.CameraType
    slam_map: Optional[SLAMMap] = None
    ba_residual: float = 0.0
    keyframes: Optional[np.ndarray] = None  # (K,) frame index per keyframe
