"""Batched SO3 / SE3 operations in PyTorch (port of ``vipe_tpu/ops/lie.py``).

Same storage conventions as the JAX package (and lietorch):
  * quaternion ``(x, y, z, w)``; SE3 data ``(..., 7)`` = ``[t(3), q(4)]``;
  * SE3 tangent ``(..., 6)`` = ``[rho(3), phi(3)]`` (translation first);
  * ``retr(X, xi) = exp(xi) * X`` (left-multiplicative).

Small-angle branches use ``torch.where`` on safe inputs, so the functions
stay differentiable under ``torch.func.jacfwd`` (the BA Jacobians).
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _safe_norm(v):
    """Norm over the last axis (kept), finite gradient at 0."""
    sq = torch.sum(v * v, dim=-1, keepdim=True)
    return torch.sqrt(torch.clamp(sq, min=_EPS * _EPS))


# ---------------------------------------------------------------------------
# Quaternions (x, y, z, w)
# ---------------------------------------------------------------------------


def quat_mul(q1, q2):
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def quat_conj(q):
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_rotate(q, p):
    """Rotate 3-vectors ``p`` by unit quaternions ``q`` (broadcasts)."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    qv, p = torch.broadcast_tensors(qv, p)
    uv = _cross(qv, p)
    uuv = _cross(qv, uv)
    w = qw * uv + uuv
    return p + (w + w)  # 2·w exactly, without a scalar operand (slow under jacfwd)


def quat_to_matrix(q):
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


# ---------------------------------------------------------------------------
# SO3
# ---------------------------------------------------------------------------


def so3_exp(phi):
    """Axis-angle (..., 3) → quaternion (..., 4)."""
    theta = _safe_norm(phi)
    half = 0.5 * theta
    small = theta < 1e-4
    k = torch.where(small, 0.5 - theta * theta / 48.0, torch.sin(half) / theta)
    return torch.cat([k * phi, torch.cos(half)], dim=-1)


def so3_log(q):
    """Quaternion → axis-angle (short rotation)."""
    w = q[..., 3:4]
    q = q * torch.sign(torch.where(w == 0, torch.ones_like(w), w))
    qv = q[..., :3]
    qw = torch.clamp(q[..., 3:4], -1.0, 1.0)
    n = _safe_norm(qv)
    theta = 2.0 * torch.atan2(n, qw)
    small = n < 1e-6
    k = torch.where(small, 2.0 / torch.clamp(qw, min=0.5), theta / n)
    return k * qv


def _so3_left_jacobian_apply(phi, rho):
    """V(phi) @ rho, V the SO3 left Jacobian."""
    theta = _safe_norm(phi)
    t2 = theta * theta
    small = theta < 1e-4
    a = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(theta)) / t2)
    b = torch.where(
        small, 1.0 / 6.0 - t2 / 120.0, (theta - torch.sin(theta)) / (t2 * theta)
    )
    c1 = _cross(phi, rho)
    c2 = _cross(phi, c1)
    return rho + a * c1 + b * c2


def _so3_left_jacobian_inv_apply(phi, rho):
    """V(phi)^-1 @ rho."""
    theta = _safe_norm(phi)
    t2 = theta * theta
    small = theta < 1e-4
    half = 0.5 * theta
    cot_term = torch.where(
        small,
        1.0 / 12.0 + t2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.clamp(torch.sin(half), min=_EPS))
        / t2,
    )
    c1 = _cross(phi, rho)
    c2 = _cross(phi, c1)
    return rho - 0.5 * c1 + cot_term * c2


# ---------------------------------------------------------------------------
# SE3: data = [t(3), q(4)], tangent = [rho(3), phi(3)]
# ---------------------------------------------------------------------------


def se3_identity(shape=(), dtype=torch.float32, device=None):
    d = torch.zeros(tuple(shape) + (7,), dtype=dtype, device=device)
    d[..., 6] = 1.0
    return d


def se3_exp(xi):
    rho, phi = xi[..., :3], xi[..., 3:6]
    return torch.cat([_so3_left_jacobian_apply(phi, rho), so3_exp(phi)], dim=-1)


def se3_log(X):
    t, q = X[..., :3], X[..., 3:7]
    phi = so3_log(q)
    return torch.cat([_so3_left_jacobian_inv_apply(phi, t), phi], dim=-1)


def se3_inv(X):
    qi = quat_conj(X[..., 3:7])
    return torch.cat([-quat_rotate(qi, X[..., :3]), qi], dim=-1)


def se3_mul(X1, X2):
    t1, q1 = X1[..., :3], X1[..., 3:7]
    t2, q2 = X2[..., :3], X2[..., 3:7]
    return torch.cat([t1 + quat_rotate(q1, t2), quat_mul(q1, q2)], dim=-1)


def se3_act(X, p):
    """Apply (..., 7) transforms to (..., 3) points (broadcasts)."""
    return quat_rotate(X[..., 3:7], p) + X[..., :3]


def se3_matrix(X):
    R = quat_to_matrix(X[..., 3:7])
    top = torch.cat([R, X[..., :3, None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def se3_retr(X, xi):
    """exp(xi) * X — the BA retraction."""
    return se3_mul(se3_exp(xi), X)
