"""Depth alignment: least-squares scale and shift in inverse-depth space
(port of ``vipe_tpu/priors/depth/alignment.py``; host numpy in f64)."""

from __future__ import annotations

import numpy as np


def _quantile_mask(x, lo=0.1, hi=0.9):
    ql, qh = np.quantile(x, [lo, hi])
    return (x >= ql) & (x <= qh)


def align_inv_depth_to_depth(inv_depth, depth, mask=None):
    """Fit (scale, bias) with scale·inv_depth + bias ≈ 1/depth on the
    overlap, both sides cut to their 10-90 % quantiles.  Returns
    (scale, bias); too few points or a failed solve give (1, 0)."""
    inv_depth = np.asarray(inv_depth, np.float64).reshape(-1)
    depth = np.asarray(depth, np.float64).reshape(-1)
    valid = (depth > 0) & np.isfinite(inv_depth) & np.isfinite(depth)
    if mask is not None:
        valid &= np.asarray(mask).reshape(-1)
    if valid.sum() < 16:
        return 1.0, 0.0
    x = inv_depth[valid]
    y = 1.0 / depth[valid]
    m = _quantile_mask(x) & _quantile_mask(y)
    if m.sum() < 16:
        return 1.0, 0.0
    A = np.stack([x[m], np.ones_like(x[m])], -1)
    try:
        sol, *_ = np.linalg.lstsq(A, y[m], rcond=None)
    except np.linalg.LinAlgError:
        return 1.0, 0.0
    return float(sol[0]), float(sol[1])


def align_depth_to_depth(src_depth, dst_depth, mask=None):
    """Fit a scale with scale·src ≈ dst: the median ratio on the
    quantile-cut overlap (1 when too few points)."""
    src = np.asarray(src_depth, np.float64).reshape(-1)
    dst = np.asarray(dst_depth, np.float64).reshape(-1)
    valid = (src > 0) & (dst > 0) & np.isfinite(src) & np.isfinite(dst)
    if mask is not None:
        valid &= np.asarray(mask).reshape(-1)
    if valid.sum() < 16:
        return 1.0
    s, d = src[valid], dst[valid]
    m = _quantile_mask(s) & _quantile_mask(d)
    if m.sum() < 16:
        return 1.0
    return float(np.median(d[m] / s[m]))


def apply_inv_depth_alignment(inv_depth, scale, bias, min_disp=1e-4):
    """metric_depth = 1 / max(scale·inv + bias, min_disp), f32."""
    aligned = scale * np.asarray(inv_depth, np.float64) + bias
    return (1.0 / np.maximum(aligned, min_disp)).astype(np.float32)
