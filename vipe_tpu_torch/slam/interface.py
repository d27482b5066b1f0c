"""SLAM outputs (port of ``vipe_tpu/slam/interface.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops import cameras as cam
from ..ops import lie


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

    def project_map(self, pose_w2c: np.ndarray, intrinsics: np.ndarray,
                    camera_type: cam.CameraType, image_size: tuple,
                    frame_idx: Optional[int] = None, window: int = 60) -> np.ndarray:
        """Render the map's depth from one camera: the points of keyframes
        within ``window`` frames of ``frame_idx``, z-buffered; returns
        (H, W) depth, 0 where empty.  A panorama's depth is the range, and
        it projects with the pixel-unit scales of ``image_size``."""
        if frame_idx is not None:
            sel = np.abs(self.frame_inds - frame_idx) <= window
        else:
            sel = np.ones(len(self.frame_inds), bool)
        pts = self.xyz[sel][self.mask[sel]]
        H, W = image_size
        if len(pts) == 0:
            return np.zeros(image_size, np.float32)
        pts_c = lie.se3_act(torch.as_tensor(np.asarray(pose_w2c), dtype=torch.float32),
                            torch.as_tensor(pts, dtype=torch.float32))
        pano = camera_type == cam.CameraType.PANORAMA
        z = torch.linalg.norm(pts_c, dim=-1) if pano else pts_c[:, 2]
        keep = z > 0.01
        pts_c, z = pts_c[keep], z[keep]
        if len(pts_c) == 0:
            return np.zeros(image_size, np.float32)
        intr = (cam.panorama_intrinsics(H, W) if pano
                else torch.as_tensor(np.asarray(intrinsics), dtype=torch.float32))
        homog = torch.cat([pts_c, torch.ones_like(z[:, None])], -1)
        uv = cam.proj_points(camera_type, intr, homog, limit_min_depth=False).numpy()
        z = z.numpy()
        ui = np.round(uv[:, 0]).astype(np.int64)
        vi = np.round(uv[:, 1]).astype(np.int64)
        ok = (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
        depth = np.full(H * W, np.inf, np.float32)
        np.minimum.at(depth, vi[ok] * W + ui[ok], z[ok])  # z-buffer
        depth[~np.isfinite(depth)] = 0.0
        return depth.reshape(H, W)


@dataclass
class SLAMOutput:
    trajectory: np.ndarray  # (T, 7) camera-to-world SE3
    intrinsics: np.ndarray  # (D,) full-res intrinsics
    camera_type: cam.CameraType
    slam_map: Optional[SLAMMap] = None
    ba_residual: float = 0.0
    keyframes: Optional[np.ndarray] = None  # (K,) frame index per keyframe
    # frontend counts: keyframes removed, removed late, waits on deferred reads
    frontend_stats: Optional[dict] = None
