"""Camera models (port of ``vipe_tpu/ops/cameras.py``): pinhole, MEI and
panorama.

Homogeneous disparity points have layout ``[X, Y, Z, d]`` and denote the 3-D
point ``(X, Y, Z) / d``; ``iproj_disp`` returns unit-depth (pinhole, MEI) or
unit-range (panorama) rays with the disparity appended, and ``proj_points``
clamps ``Z < MIN_DEPTH`` to 1 (pinhole, MEI), as in the JAX package.

* MEI is the 5-parameter unified model ``(fx, fy, cx, cy, k1)`` whose
  projection denominator is ``Z + k1·|P|``.
* Panorama is equirectangular in pixel units: ``u = fx·θ + cx``,
  ``v = fy·φ + cy`` with ``x = sinφ sinθ, y = −cosφ, z = sinφ cosθ``; its
  intrinsics follow from the frame size (``panorama_intrinsics``).

The BA differentiates these forward functions with ``jacfwd``; the
panorama's pole guards keep those derivatives finite.
"""

from __future__ import annotations

import math
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


def _expand(intrinsics, ref):
    """Broadcast (..., D) intrinsics against a (..., spatial...) field."""
    extra = ref.dim() - (intrinsics.dim() - 1)
    shape = intrinsics.shape[:-1] + (1,) * extra + intrinsics.shape[-1:]
    return intrinsics.reshape(shape)


def _pinhole_iproj(intr, u, v, disp):
    fx, fy, cx, cy = _expand(intr, disp).unbind(-1)
    X, Y, disp = torch.broadcast_tensors((u - cx) / fx, (v - cy) / fy, disp)
    return torch.stack([X, Y, torch.ones_like(disp), disp], dim=-1)


def _pinhole_proj(intr, pts, limit_min_depth):
    fx, fy, cx, cy = _expand(intr, pts[..., 0]).unbind(-1)
    X, Y, Z = pts[..., 0], pts[..., 1], pts[..., 2]
    if limit_min_depth:
        Z = torch.where(Z < MIN_DEPTH, torch.ones_like(Z), Z)
    d = torch.reciprocal(Z)
    return torch.stack([fx * X * d + cx, fy * Y * d + cy], dim=-1)


def _mei_iproj(intr, u, v, disp):
    fx, fy, cx, cy, k1 = _expand(intr, disp).unbind(-1)
    ub = (u - cx) / fx
    vb = (v - cy) / fy
    r2 = ub * ub + vb * vb
    q = torch.sqrt(torch.clamp(1.0 + (1.0 - k1 * k1) * r2, min=1e-12))
    factor = (k1 + q) / (1.0 + r2)
    scale = factor / (factor - k1)
    X, Y, disp = torch.broadcast_tensors(ub * scale, vb * scale, disp)
    return torch.stack([X, Y, torch.ones_like(disp), disp], dim=-1)


def _mei_proj(intr, pts, limit_min_depth):
    fx, fy, cx, cy, k1 = _expand(intr, pts[..., 0]).unbind(-1)
    X, Y, Z = pts[..., 0], pts[..., 1], pts[..., 2]
    if limit_min_depth:
        Z = torch.where(Z < MIN_DEPTH, torch.ones_like(Z), Z)
    r = torch.sqrt(X * X + Y * Y + Z * Z)
    d = torch.reciprocal(Z + k1 * r)
    return torch.stack([fx * X * d + cx, fy * Y * d + cy], dim=-1)


def panorama_intrinsics(h: int, w: int, device=None):
    """Pixel-unit equirect parameters ``(w/2π, h/π, w/2, 0)``: the SLAM grid
    stays in pixel units (flow, correlation windows and BA targets).  The
    artifacts keep the all-zero panorama intrinsics."""
    return torch.tensor([w / (2.0 * math.pi), h / math.pi, w / 2.0, 0.0],
                        dtype=torch.float32, device=device)


def _panorama_iproj(intr, u, v, disp):
    fx, fy, cx, cy = _expand(intr, disp).unbind(-1)
    theta = (u - cx) / fx
    phi = (v - cy) / fy
    sin_phi = torch.sin(phi)
    x, y, z, disp = torch.broadcast_tensors(sin_phi * torch.sin(theta), -torch.cos(phi),
                                            sin_phi * torch.cos(theta), disp)
    return torch.stack([x, y, z, disp], dim=-1)


def _panorama_proj(intr, pts, limit_min_depth):
    fx, fy, cx, cy = _expand(intr, pts[..., 0]).unbind(-1)
    X, Y, Z = pts[..., 0], pts[..., 1], pts[..., 2]
    r = torch.sqrt(torch.clamp(X * X + Y * Y + Z * Z, min=1e-12))
    # pole guards: at X = Z = 0 the derivative of atan2 is 0/0, and at
    # |Y/r| = 1 that of acos is infinite; either would put NaN into the BA
    # Hessian even under zero weights
    safe = X * X + Z * Z > 1e-12
    theta = torch.atan2(torch.where(safe, X, torch.zeros_like(X)),
                        torch.where(safe, Z, torch.ones_like(Z)))
    phi = torch.acos(torch.clamp(-Y / r, -1.0 + 1e-6, 1.0 - 1e-6))
    return torch.stack([fx * theta + cx, fy * phi + cy], dim=-1)


_IPROJ = {
    CameraType.PINHOLE: _pinhole_iproj,
    CameraType.MEI: _mei_iproj,
    CameraType.PANORAMA: _panorama_iproj,
}
_PROJ = {
    CameraType.PINHOLE: _pinhole_proj,
    CameraType.MEI: _mei_proj,
    CameraType.PANORAMA: _panorama_proj,
}


def _model(table, camera_type: CameraType):
    if camera_type not in table:
        raise ValueError(f"Un-implemented camera type: {camera_type}")
    return table[camera_type]


def iproj_disp(camera_type: CameraType, intrinsics, u, v, disp):
    """Pixel coords + disparity → homogeneous ``[X, Y, Z, disp]``."""
    return _model(_IPROJ, camera_type)(intrinsics, u, v, disp)


def proj_points(camera_type: CameraType, intrinsics, pts, limit_min_depth=True):
    """Homogeneous ``[X, Y, Z, d]`` points → pixel coords (..., 2)."""
    return _model(_PROJ, camera_type)(intrinsics, pts, limit_min_depth)


def pinhole_equivalent(camera_type: CameraType, intrinsics):
    """Pinhole intrinsics standing in for a camera where a pinhole is
    assumed (frame distances, depth filter): MEI's focal over ``1 + k1``;
    for the panorama the fixed 512×256, 90° virtual camera."""
    if camera_type == CameraType.PINHOLE:
        return intrinsics
    if camera_type == CameraType.MEI:
        f = intrinsics[..., 0:2] / (1.0 + intrinsics[..., 4:5])
        return torch.cat([f, intrinsics[..., 2:4]], dim=-1)
    if camera_type == CameraType.PANORAMA:
        base = torch.tensor([256.0, 256.0, 256.0, 128.0], dtype=intrinsics.dtype,
                            device=intrinsics.device)
        return base.expand(intrinsics.shape[:-1] + (4,))
    raise ValueError(f"Un-implemented camera type: {camera_type}")


def scaled_intrinsics(camera_type: CameraType, intrinsics, scale):
    """Rescale intrinsics for a resized image (distortion params untouched;
    the panorama's pixel-unit scales rescale like a pinhole's)."""
    return torch.cat([intrinsics[..., :4] * scale, intrinsics[..., 4:]], dim=-1)


def intrinsics_matrix(intrinsics):
    """(..., 4+) pinhole part → (..., 3, 3) K matrix."""
    fx, fy, cx, cy = intrinsics[..., :4].unbind(-1)
    z, o = torch.zeros_like(fx), torch.ones_like(fx)
    K = torch.stack([fx, z, cx, z, fy, cy, z, z, o], dim=-1)
    return K.reshape(K.shape[:-1] + (3, 3))
