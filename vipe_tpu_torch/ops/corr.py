"""Correlation pyramid and windowed lookup (port of ``vipe_tpu/ops/corr.py``).

Feature maps are NHWC ``(E, H, W, C)``; volumes ``(E, h1, w1, h2, w2)``;
coords ``(u, v)`` at level-0 scale (divided by 2^l per level).  Both fmaps
are scaled by 1/4 before the product, so correlations carry the reference's
1/16 normalisation.  Two formulations, as in the JAX package:

* volume mode: ``corr_pyramid`` stores the volumes, looked up by K1
  (``ops.corr_kernels.corr_lookup``);
* alt mode: ``corr_feat_pack`` stores per-edge features, and K2
  (``ops.corr_kernels.corr_fused``) recomputes the windowed dots at every
  lookup.

Each kernel runs on CUDA tensors and its plain version on CPU tensors.
"""

from __future__ import annotations

import torch

from .corr_kernels import corr_fused, corr_lookup


def quantize_volume(vol):
    """Symmetric per-edge int8 quantisation: ``vol ≈ q · s[:, None, ...]``.
    Returns ``(q int8, s f32 (E,))``.  Works in place on one f32 copy of
    the volume: the frontend quantises 16 level-0 volumes at a time, and
    each f32 temporary of that chunk is ~0.6 GB at 720p."""
    v = vol.to(torch.float32, copy=True)
    dims = tuple(range(1, v.dim()))
    absmax = torch.maximum(v.amax(dim=dims), -v.amin(dim=dims))
    s = torch.clamp(absmax, min=1e-12) / 127.0
    v.div_(s.reshape((-1,) + (1,) * (v.dim() - 1))).round_().clamp_(-127, 127)
    return v.to(torch.int8), s


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


def corr_feat_pack(fmap1, fmap2, num_levels: int = 4):
    """Packed per-edge correlation features for alt mode: ``[f1, pool⁰(f2),
    …, pool^{L-1}(f2)]``, each /4-scaled and bf16, pooled in bf16.  Every
    entry is a per-edge row, so the graph's row machinery applies as for
    volumes, at ~1/13 of their memory."""
    f1 = (fmap1.float() / 4.0).to(torch.bfloat16)
    f2 = (fmap2.float() / 4.0).to(torch.bfloat16)
    packed = [f1]
    for _ in range(num_levels):
        packed.append(f2)
        f2 = avg_pool2_nhwc(f2).contiguous()
    return packed


def corr_lookup_pyramid(pyramid, coords, radius: int = 3, scales=None):
    """Bilinear (2r+1)² window of every level at ``coords / 2^l``, channels
    level-major and ``dy·(2r+1) + dx`` within a level → (E, h1, w1, L·49)
    f32.  Dispatches on the entry rank: packed features from
    ``corr_feat_pack`` (rank 4) go to K2, volumes (rank 5) to K1.
    ``scales``: per-level (E,) dequantisation factors for int8 volumes."""
    pyramid = list(pyramid)
    if pyramid[0].dim() == 4:
        if scales is not None:
            raise ValueError("packed features take no dequantisation scales")
        return corr_fused(pyramid[0], pyramid[1:], coords, radius=radius, prescaled=True)
    return corr_lookup(pyramid, coords, scales=scales, radius=radius)
