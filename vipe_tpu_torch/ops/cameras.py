"""Camera models (port of ``vipe_tpu/ops/cameras.py``): the pinhole model.

Homogeneous disparity points have layout ``[X, Y, Z, d]`` and denote the 3-D
point ``(X, Y, Z) / d``; ``iproj_disp`` returns ``[X, Y, 1, disp]`` and
``proj_points`` clamps ``Z < MIN_DEPTH`` to 1, as in the JAX package.
MEI and panorama cameras are not ported yet: they raise
``NotImplementedError``.
"""

from __future__ import annotations

from enum import Enum

import torch

MIN_DEPTH = 0.1


class CameraType(Enum):
    PINHOLE = "pinhole"
    PANORAMA = "panorama"
    SIMPLE_DIVISIONAL = "simple_divisional"
    MEI = "mei"

    def intrinsics_dim(self) -> int:
        if self == CameraType.MEI:
            return 5
        if self == CameraType.SIMPLE_DIVISIONAL:
            raise ValueError(f"Un-implemented camera type: {self}")
        return 4

    @property
    def n_distortion(self) -> int:
        """Number of trailing distortion parameters after (fx, fy, cx, cy)."""
        return self.intrinsics_dim() - 4


def require_pinhole(camera_type: CameraType):
    if camera_type != CameraType.PINHOLE:
        raise NotImplementedError(
            f"camera type {camera_type.value!r} is not ported yet (pinhole only)"
        )


def _expand(intrinsics, ref):
    """Broadcast (..., D) intrinsics against a (..., spatial...) field."""
    extra = ref.dim() - (intrinsics.dim() - 1)
    shape = intrinsics.shape[:-1] + (1,) * extra + intrinsics.shape[-1:]
    return intrinsics.reshape(shape)


def iproj_disp(camera_type: CameraType, intrinsics, u, v, disp):
    """Pixel coords + disparity → homogeneous ``[X, Y, 1, disp]``."""
    require_pinhole(camera_type)
    k = _expand(intrinsics, disp)
    fx, fy, cx, cy = k.unbind(-1)
    X = (u - cx) / fx
    Y = (v - cy) / fy
    X, Y, disp = torch.broadcast_tensors(X, Y, disp)
    return torch.stack([X, Y, torch.ones_like(disp), disp], dim=-1)


def proj_points(camera_type: CameraType, intrinsics, pts, limit_min_depth=True):
    """Homogeneous ``[X, Y, Z, d]`` points → pixel coords (..., 2)."""
    require_pinhole(camera_type)
    k = _expand(intrinsics, pts[..., 0])
    fx, fy, cx, cy = k.unbind(-1)
    X, Y, Z = pts[..., 0], pts[..., 1], pts[..., 2]
    if limit_min_depth:
        Z = torch.where(Z < MIN_DEPTH, torch.ones_like(Z), Z)
    d = 1.0 / Z
    return torch.stack([fx * X * d + cx, fy * Y * d + cy], dim=-1)


def pinhole_equivalent(camera_type: CameraType, intrinsics):
    require_pinhole(camera_type)
    return intrinsics


def scaled_intrinsics(camera_type: CameraType, intrinsics, scale):
    """Rescale intrinsics for a resized image (distortion params untouched)."""
    return torch.cat([intrinsics[..., :4] * scale, intrinsics[..., 4:]], dim=-1)
