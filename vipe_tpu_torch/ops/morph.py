"""Binary morphology by box counts (port of ``vipe_tpu/ops/morph.py``):
square erosion and dilation of host masks, from an integral image of the
mask.  The counts are small integers in f32 and so exact; the result equals
the JAX package's bit for bit."""

from __future__ import annotations

import numpy as np


def _box_count(mask: np.ndarray, radius: int) -> np.ndarray:
    """Per pixel, the number of set pixels in its (2r+1)² box (zero outside
    the mask's bounds)."""
    m = np.asarray(mask, np.float32)
    ii = np.pad(np.pad(m, radius).cumsum(0).cumsum(1), ((1, 0), (1, 0)))
    k = 2 * radius + 1
    h, w = m.shape
    return ii[k: k + h, k: k + w] - ii[:h, k: k + w] - ii[k: k + h, :w] + ii[:h, :w]


def dilate(mask: np.ndarray, radius: int) -> np.ndarray:
    if radius <= 0:
        return np.asarray(mask, bool)
    return _box_count(mask, radius) > 0


def erode(mask: np.ndarray, radius: int) -> np.ndarray:
    """True where the whole box around a pixel is set (pixels outside the
    frame count as unset)."""
    if radius <= 0:
        return np.asarray(mask, bool)
    k = 2 * radius + 1
    return _box_count(mask, radius) >= k * k - 1e-3
