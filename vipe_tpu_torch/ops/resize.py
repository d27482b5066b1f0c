"""Bilinear resizes with the JAX package's grid conventions (port of
``vipe_tpu/ops/resize.py``, plus ``jax.image.resize``'s bilinear mode).

* ``resize_align_corners``: torch's ``align_corners=True`` grid, output
  coordinate ``o`` sampling input position ``o·(n_in − 1)/(n_out − 1)``.
* ``resize_bilinear``: half-pixel centres, and on an axis that shrinks a
  triangle filter widened by the shrink factor with weights renormalised at
  the borders, which is what ``jax.image.resize(..., "bilinear")`` does by
  default (``antialias=True``).  PyTorch's ``antialias=True`` bilinear
  computes the same weights; on an axis that grows, both are plain bilinear
  with border clamping.

Both take NCHW tensors and interpolate in their dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _axis(n_in: int, n_out: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    if n_out == 1 or n_in == 1:
        # torch guards the 0/0 scale with source position 0
        return (torch.zeros(n_out, dtype=torch.float64, device=device),
                torch.zeros(n_out, dtype=torch.long, device=device))
    pos = torch.arange(n_out, dtype=torch.float64, device=device) * (n_in - 1) / (n_out - 1)
    i0 = pos.floor().long().clamp(0, n_in - 2)
    return pos - i0, i0


def resize_align_corners(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """(N, C, H, W) → (N, C, *out_hw), align_corners=True, in ``x``'s dtype
    (the weights are rounded to it, as the JAX package's are)."""
    H, W = x.shape[-2:]
    Ho, Wo = out_hw
    if (H, W) == (Ho, Wo):
        return x
    fy, y0 = _axis(H, Ho, x.device)
    fx, x0 = _axis(W, Wo, x.device)
    fy = fy.float().to(x.dtype)[:, None]
    fx = fx.float().to(x.dtype)
    y1, x1 = (y0 + 1).clamp(max=H - 1), (x0 + 1).clamp(max=W - 1)
    x = x[..., y0, :] * (1 - fy) + x[..., y1, :] * fy
    return x[..., x0] * (1 - fx) + x[..., x1] * fx


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """(N, C, H, W) → (N, C, *out_hw) as ``jax.image.resize(..., "bilinear")``:
    half-pixel centres, antialiased where an axis shrinks."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    shrinks = out_hw[0] < x.shape[-2] or out_hw[1] < x.shape[-1]
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=False,
                         antialias=shrinks)
