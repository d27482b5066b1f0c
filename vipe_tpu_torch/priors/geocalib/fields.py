"""Perspective fields (up vector and latitude) for GeoCalib, in PyTorch
(port of ``vipe_tpu/priors/geocalib/fields.py``).

Conventions, as in the JAX package:

* gravity from (roll, pitch): ``(−sin r·cos p, −cos r·cos p, sin p)``; at
  rest (0, −1, 0), the image-up direction (y grows downward in images);
* up field: ``normalize((g_x, g_y) − g_z · uv)`` over normalized image
  coordinates uv;
* latitude: ``asin(bearing(uv) · g)``.

Plain f32 tensor functions on the device of their tensor arguments; a
batch of (roll, pitch) broadcasts in front of the (h, w) grid.
"""

from __future__ import annotations

import torch


def _device(*xs) -> torch.device:
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


def gravity_from_rp(roll, pitch) -> torch.Tensor:
    """(…,) roll, pitch → (…, 3) unit gravity vector."""
    dev = _device(roll, pitch)
    roll = torch.as_tensor(roll, dtype=torch.float32, device=dev)
    pitch = torch.as_tensor(pitch, dtype=torch.float32, device=dev)
    sr, cr = torch.sin(roll), torch.cos(roll)
    sp, cp = torch.sin(pitch), torch.cos(pitch)
    return torch.stack([-sr * cp, -cr * cp, sp], dim=-1)


def rp_from_gravity(g: torch.Tensor):
    """Inverse of ``gravity_from_rp`` for unit vectors."""
    pitch = torch.arcsin(torch.clamp(g[..., 2], -1.0, 1.0))
    roll = torch.atan2(-g[..., 0], -g[..., 1])
    return roll, pitch


def normalized_grid(h: int, w: int, focal, cx=None, cy=None, device=None) -> torch.Tensor:
    """(h, w, 2) normalized image coords ``uv = (pix − c) / f`` on the
    integer pixel grid, with the principal point at (w/2, h/2) unless
    given."""
    dev = device if device is not None else _device(focal, cx, cy)
    cx = w / 2.0 if cx is None else cx
    cy = h / 2.0 if cy is None else cy
    x = torch.arange(w, dtype=torch.float32, device=dev) - cx
    y = torch.arange(h, dtype=torch.float32, device=dev) - cy
    v, u = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([u, v], dim=-1) / focal


# Scalar distortion scale s(r²) with uv_d = s·uv_u, its derivative and the
# undistortion, per model:
#   simple_radial      s = 1 + k1·r²                  (undistort: fixed point)
#   simple_divisional  s = (1−√(1−4k1r²))/(2k1r²)     (undistort: 1/(1+k1r²))
#   simple_mei         s = 1/(1 + k1·√(1+r²))         (closed-form undistort)


def _sqrt_rounded(x: torch.Tensor) -> torch.Tensor:
    """f32 square root rounded correctly, as XLA's and CUDA's are: PyTorch's
    vectorised CPU kernel is at times an ulp off, and the divisional
    model's ``1 − √(1 − 4k1r²)`` cancels that ulp into a ~1e-4 relative
    error near the principal point."""
    return torch.sqrt(x.double()).float()


def distort_scale(model: str, uv: torch.Tensor, k1) -> torch.Tensor:
    r2 = torch.sum(uv ** 2, -1, keepdim=True)
    if model == "simple_radial":
        return 1.0 + k1 * r2
    if model == "simple_divisional":
        t0 = _sqrt_rounded(torch.clamp(1.0 - 4.0 * k1 * r2, min=0.0))
        denom = 2.0 * k1 * r2
        small = torch.abs(denom) < 1e-9
        return torch.where(small, torch.ones_like(denom),
                           (1.0 - t0) / torch.where(small, torch.ones_like(denom), denom))
    if model == "simple_mei":
        return 1.0 / (1.0 + k1 * torch.sqrt(1.0 + r2))
    raise ValueError(model)


def distort_scale_grad(model: str, uv: torch.Tensor, k1) -> torch.Tensor:
    """∂s/∂uv, (…, 2)."""
    r2 = torch.sum(uv ** 2, -1, keepdim=True)
    if model == "simple_radial":
        return 2.0 * k1 * uv
    if model == "simple_divisional":
        t0 = _sqrt_rounded(torch.clamp(1.0 - 4.0 * k1 * r2, min=1e-6))
        d1 = t0 * 2.0 * r2
        d2 = k1 * r2 ** 2
        denom = d1 * d2
        small = torch.abs(denom) < 1e-12
        return uv * torch.where(small, torch.zeros_like(denom),
                                (4.0 * d2 - (1.0 - t0) * d1)
                                / torch.where(small, torch.ones_like(denom), denom))
    if model == "simple_mei":
        sq = torch.sqrt(1.0 + r2)
        d2 = (1.0 + k1 * sq) ** 2
        return -uv * k1 / (d2 * sq)
    raise ValueError(model)


def undistort(model: str, uv: torch.Tensor, k1) -> torch.Tensor:
    """Distorted normalized coords → undistorted."""
    r2 = torch.sum(uv ** 2, -1, keepdim=True)
    if model == "simple_radial":
        # fixed point on uv_u = uv_d / (1 + k1·|uv_u|²)
        out = uv
        for _ in range(5):
            out = uv / (1.0 + k1 * torch.sum(out ** 2, -1, keepdim=True))
        return out
    if model == "simple_divisional":
        return uv / (1.0 + k1 * r2)
    if model == "simple_mei":
        fac = (k1 + torch.sqrt(1.0 + (1.0 - k1 ** 2) * r2)) / (1.0 + r2)
        fac = fac / (fac - k1)
        return uv * fac
    raise ValueError(model)


def up_field(h: int, w: int, focal, roll, pitch, cx=None, cy=None, k1=None,
             model: str = "pinhole") -> torch.Tensor:
    """(…, h, w, 2) normalized projected-up vectors.  A distorted model maps
    the projection through the distortion's Jacobian
    ``s·I + (∂s/∂uv)·uvᵀ``."""
    g = gravity_from_rp(roll, pitch)
    uv = normalized_grid(h, w, focal, cx, cy, device=g.device)
    proj = g[..., None, None, :2] - g[..., 2, None, None, None] * uv
    if model != "pinhole":
        s = distort_scale(model, uv, k1)
        off = distort_scale_grad(model, uv, k1)
        proj = s * proj + off * torch.sum(uv * proj, -1, keepdim=True)
    norm = torch.linalg.vector_norm(proj, dim=-1, keepdim=True)
    return proj / torch.clamp(norm, min=1e-9)


def latitude_field(h: int, w: int, focal, roll, pitch, cx=None, cy=None, k1=None,
                   model: str = "pinhole") -> torch.Tensor:
    """(…, h, w) latitude in radians: the angle between the pixel's bearing
    and the horizon, +π/2 straight up.  A distorted model undistorts the
    grid before forming the bearings."""
    g = gravity_from_rp(roll, pitch)
    uv = normalized_grid(h, w, focal, cx, cy, device=g.device)
    if model != "pinhole":
        uv = undistort(model, uv, k1)
    rays = torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)
    rays = rays / torch.linalg.vector_norm(rays, dim=-1, keepdim=True)
    lat = torch.einsum("hwj,...j->...hw", rays, g)
    return torch.arcsin(torch.clamp(lat, -1 + 1e-6, 1 - 1e-6))
