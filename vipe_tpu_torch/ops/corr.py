"""Correlation pyramid and windowed lookup (port of ``vipe_tpu/ops/corr.py``,
volume mode).

Feature maps are NHWC ``(E, H, W, C)``; volumes ``(E, h1, w1, h2, w2)``;
coords ``(u, v)`` at level-0 scale (divided by 2^l per level).  Both fmaps
are scaled by 1/4 before the product, so correlations carry the reference's
1/16 normalisation.  The lookup itself is ``ops.corr_kernels.corr_lookup``:
the CUDA kernel on CUDA tensors, its plain version on CPU tensors.
"""

from __future__ import annotations

import torch

from .corr_kernels import corr_lookup


def quantize_volume(vol):
    """Symmetric per-edge int8 quantisation: ``vol ≈ q · s[:, None, ...]``.
    Returns ``(q int8, s f32 (E,))``."""
    v = vol.float()
    absmax = v.abs().amax(dim=tuple(range(1, v.dim())))
    s = torch.clamp(absmax, min=1e-12) / 127.0
    q = torch.clamp(
        torch.round(v / s.reshape((-1,) + (1,) * (v.dim() - 1))), -127, 127
    ).to(torch.int8)
    return q, s


def level_dims(ht: int, wd: int, level: int):
    """Target-plane dims at a pyramid level, clamped at 1 px so tiny grids
    still produce all 4 levels (196 channels)."""
    return max(ht >> level, 1), max(wd >> level, 1)


def avg_pool2(x):
    """2×2 average pool, stride 2, over the trailing (..., H, W) dims; dims
    already at 1 are left unpooled.  Rows are pooled before columns, each
    mean rounded to ``x.dtype`` (the JAX package's order)."""
    h0, w0 = x.shape[-2], x.shape[-1]
    h, w = max(h0 // 2, 1), max(w0 // 2, 1)
    if h0 >= 2:
        x = x[..., : 2 * h, :].reshape(x.shape[:-2] + (h, 2, x.shape[-1]))
        x = x.mean(dim=-2)
    if w0 >= 2:
        x = x[..., : 2 * w].reshape(x.shape[:-1] + (w, 2))
        x = x.mean(dim=-1)
    return x


def avg_pool2_nhwc(x):
    """(E, H, W, C) → (E, max(H//2, 1), max(W//2, 1), C)."""
    return avg_pool2(x.movedim(-1, 1)).movedim(1, -1)


def corr_pyramid(fmap1, fmap2, num_levels: int = 4):
    """Pyramid over the TARGET dims: level l correlates ``fmap1`` with
    ``avgpool^l(fmap2)`` (pooling the volume is linear in ``fmap2``).  bf16
    operands, f32 accumulation, bf16 volumes."""
    E, H, W, C = fmap1.shape
    f1 = (fmap1.float() / 4.0).to(torch.bfloat16).reshape(E, H * W, C)
    f2 = (fmap2.float() / 4.0).to(torch.bfloat16)
    pyramid = []
    for _ in range(num_levels):
        h2, w2 = f2.shape[1], f2.shape[2]
        vol = torch.bmm(f1, f2.reshape(E, h2 * w2, C).transpose(1, 2))
        pyramid.append(vol.reshape(E, H, W, h2, w2))
        f2 = avg_pool2_nhwc(f2)
    return pyramid


def corr_lookup_pyramid(pyramid, coords, radius: int = 3, scales=None):
    """Bilinear (2r+1)² window of every level at ``coords / 2^l``, channels
    level-major and ``dy·(2r+1) + dx`` within a level → (E, h1, w1, L·49)
    f32.  ``scales``: per-level (E,) dequantisation factors for int8
    volumes."""
    return corr_lookup(list(pyramid), coords, scales=scales, radius=radius)
