"""Levenberg–Marquardt camera and gravity fit to perspective fields (port
of ``vipe_tpu/priors/geocalib/optimizer.py``).

At most ``max_iters`` LM steps over ``[roll_1..B, pitch_1..B, focal(, k1)]``
(B frames with their own gravity share one focal and, for a distorted
model, one k1) minimise the confidence-weighted up-field and latitude
residuals.  λ is ×0.1 after an accepted step and ×10 after a rejected one,
clamped to [1e-6, 1e2]; the damping is ``diag(H)·λ + 1e-6·I``; the loop
stops after an accepted step with ``|Δcost| < atol + rtol·|cost|``.

The residuals' Jacobian comes from ``torch.func.jacfwd``.  Every step runs
on the device of the fields; the host reads one flag per step to stop.
The normal equations are formed and solved in IEEE f32 (TF32 off whatever
the caller set), as the JAX package forms them: the focal is ~1e3 px while
its residual derivatives are ~1e-4.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.func import jacfwd

from ...utils.device import true_f32
from .fields import latitude_field, up_field


class LMResult(NamedTuple):
    roll: torch.Tensor     # (B,)
    pitch: torch.Tensor    # (B,)
    focal: torch.Tensor    # ()
    cost: torch.Tensor     # ()
    n_iters: int
    k1: torch.Tensor       # () shared distortion (0 for pinhole)


def lm_calibrate(h: int, w: int, max_iters: int, model: str, up_obs, lat_obs, up_conf,
                 lat_conf, focal_init, roll_init, pitch_init, k1_init,
                 lambda_init: float = 0.1, atol: float = 1e-8,
                 rtol: float = 1e-8) -> LMResult:
    """``up_obs`` (B, h, w, 2), ``lat_obs``/``up_conf``/``lat_conf`` (B, h, w),
    ``roll_init``/``pitch_init`` (B,), ``focal_init`` and ``k1_init``
    scalars, all on one device."""
    B = up_obs.shape[0]
    dev = up_obs.device
    has_dist = model != "pinhole"
    w_up = torch.sqrt(torch.clamp(up_conf, min=0.0))[..., None]
    w_lat = torch.sqrt(torch.clamp(lat_conf, min=0.0))

    def residuals(theta):
        roll, pitch, focal = theta[:B], theta[B:2 * B], theta[2 * B]
        k1 = theta[2 * B + 1] if has_dist else None
        up = up_field(h, w, focal, roll, pitch, k1=k1, model=model)
        lat = latitude_field(h, w, focal, roll, pitch, k1=k1, model=model)
        r_up = (up - up_obs) * w_up
        r_lat = (lat - lat_obs) * w_lat
        return torch.cat([r_up.reshape(B, -1), r_lat.reshape(B, -1)], dim=1).reshape(-1)

    def cost_of(theta):
        r = residuals(theta)
        return torch.sum(r * r)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(-1)

    parts = [f32(roll_init), f32(pitch_init), f32(focal_init)]
    if has_dist:
        parts.append(f32(k1_init))
    theta = torch.cat(parts)
    eye = torch.eye(theta.shape[0], device=dev)
    lamb = torch.tensor(lambda_init, dtype=torch.float32, device=dev)
    n_iters = 0
    with true_f32():
        cost = cost_of(theta)
        for n_iters in range(1, max_iters + 1):
            J = jacfwd(residuals)(theta)                    # (N, P)
            r = residuals(theta)
            H = J.T @ J
            g = J.T @ r
            damped = H + torch.diag(torch.diagonal(H)) * lamb + 1e-6 * eye
            new_theta = theta + torch.linalg.solve(damped, -g)
            new_cost = cost_of(new_theta)
            accept = new_cost < cost
            converged = torch.abs(new_cost - cost) < atol + rtol * torch.abs(cost)
            theta = torch.where(accept, new_theta, theta)
            lamb = torch.clamp(lamb * torch.where(accept, 0.1, 10.0), 1e-6, 1e2)
            cost = torch.where(accept, new_cost, cost)
            if bool(accept & converged):
                break
    return LMResult(roll=theta[:B], pitch=theta[B:2 * B], focal=theta[2 * B], cost=cost,
                    n_iters=n_iters,
                    k1=theta[2 * B + 1] if has_dist else torch.zeros((), device=dev))


def calibrate_from_fields(up_obs, lat_obs, up_conf=None, lat_conf=None,
                          focal_init: Optional[float] = None, max_iters: int = 30,
                          model: str = "pinhole", k1_init: float = 0.0) -> LMResult:
    """Observed fields (B, h, w, ·) (or one frame's, without B) → the LM fit
    from roll = pitch = 0 and ``focal_init`` (default: the width, ≈53°
    horizontal FOV)."""
    up_obs = torch.as_tensor(up_obs, dtype=torch.float32)
    if up_obs.dim() == 3:
        up_obs = up_obs[None]
    dev = up_obs.device
    lat_obs = torch.as_tensor(lat_obs, dtype=torch.float32, device=dev)
    if lat_obs.dim() == 2:
        lat_obs = lat_obs[None]
    B, h, w = lat_obs.shape
    ones = torch.ones((B, h, w), device=dev)
    up_conf = ones if up_conf is None else torch.as_tensor(up_conf, dtype=torch.float32,
                                                           device=dev)
    lat_conf = ones if lat_conf is None else torch.as_tensor(lat_conf, dtype=torch.float32,
                                                             device=dev)
    if focal_init is None:
        focal_init = float(w)
    zeros = torch.zeros((B,), device=dev)
    return lm_calibrate(h, w, max_iters, model, up_obs, lat_obs, up_conf, lat_conf,
                        focal_init, zeros, zeros, k1_init)
