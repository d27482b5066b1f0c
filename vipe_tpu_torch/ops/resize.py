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
* ``resize_u8_linear``: ``cv2.resize``'s INTER_LINEAR on uint8 pixels, in
  its fixed-point arithmetic.
* ``resize_nearest``: ``jax.image.resize(..., "nearest")``, output index
  ``o`` taking input ``floor((o + 0.5)·n_in/n_out)`` (torch's
  ``nearest-exact`` rule, not its ``nearest``).

They take NCHW tensors; the first two interpolate in their dtype.
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


def _u8_linear_taps(n_in: int, n_out: int, clamp: bool, device):
    """One axis of OpenCV's uint8 bilinear: the two source indices and their
    11-bit fixed-point weights (positions in f32, weights rounded to
    2048ths).  Along x a position off the border takes the edge pixel whole
    (``clamp``); along y the weights stay and the rows are clamped."""
    pos = ((torch.arange(n_out, dtype=torch.float64, device=device) + 0.5)
           * (1.0 / (n_out / n_in)) - 0.5).float()
    i0 = torch.floor(pos)
    frac = pos - i0
    i0 = i0.long()
    if clamp:
        out = (i0 < 0) | (i0 >= n_in - 1)
        frac = torch.where(out, 0.0, frac)
        i0 = i0.clamp(0, n_in - 1)
    w0 = torch.round((1.0 - frac) * 2048.0).long()
    return i0.clamp(0, n_in - 1), (i0 + 1).clamp(0, n_in - 1), w0, 2048 - w0


def resize_u8_linear(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """(N, C, H, W) uint8 → f32 holding uint8 values at ``out_hw``, bit for
    bit ``cv2.resize(..., INTER_LINEAR)`` on uint8: half-pixel centres, the
    weights in 11-bit fixed point, a horizontal pass in integers, then
    OpenCV's vertical rounding ((b0·(S0 >> 4)) >> 16 + (b1·(S1 >> 4)) >> 16
    + 2) >> 2; a halving of both sides is OpenCV's 2×2 area mean."""
    H, W = img.shape[-2:]
    Ho, Wo = out_hw
    a = img.long()
    if (H, W) == (Ho, Wo):
        return img.float()
    if (H, W) == (2 * Ho, 2 * Wo):
        s = a[..., 0::2, 0::2] + a[..., 1::2, 0::2] + a[..., 0::2, 1::2] + a[..., 1::2, 1::2]
        return ((s + 2) >> 2).float()
    x0, x1, cx0, cx1 = _u8_linear_taps(W, Wo, True, img.device)
    y0, y1, cy0, cy1 = _u8_linear_taps(H, Ho, False, img.device)
    rows = a[..., x0] * cx0 + a[..., x1] * cx1
    cy0, cy1 = cy0[:, None], cy1[:, None]
    out = ((cy0 * (rows[..., y0, :] >> 4)) >> 16) + ((cy1 * (rows[..., y1, :] >> 4)) >> 16)
    return ((out + 2) >> 2).float()


def _nearest_idx(n_in: int, n_out: int, device) -> torch.Tensor:
    # in f32 and in this order, as jax.image.resize computes its offsets
    pos = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * n_in / n_out
    return pos.floor().long().clamp(max=n_in - 1)


def resize_nearest(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """(N, C, H, W) → (N, C, *out_hw) as ``jax.image.resize(...,
    "nearest")``: half-pixel centres, each output pixel a copy of one
    input pixel."""
    H, W = x.shape[-2:]
    if (H, W) == tuple(out_hw):
        return x
    return x[..., _nearest_idx(H, out_hw[0], x.device)[:, None],
             _nearest_idx(W, out_hw[1], x.device)]
