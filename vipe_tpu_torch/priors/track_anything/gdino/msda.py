"""Multi-scale deformable attention sampling (port of
``vipe_tpu/priors/track_anything/gdino/msda.py``): per query, head, level
and point, the value map is sampled bilinearly (``grid_sample``:
``align_corners=False``, zero padding) and the samples are summed with the
softmaxed attention weights."""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F


def ms_deform_attn(value: torch.Tensor, spatial_shapes: List[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """value (B, S, H, C) over the flattened levels; sampling_locations
    (B, Q, H, L, P, 2) in [0, 1] (x, y); attention_weights (B, Q, H, L, P).
    Returns (B, Q, H·C)."""
    B, S, H, C = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    assert L == len(spatial_shapes)
    grids = 2 * sampling_locations - 1
    out = value.new_zeros(B * H, C, Q)
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        v = value[:, start: start + h * w].permute(0, 2, 3, 1).reshape(B * H, C, h, w)
        start += h * w
        g = grids[:, :, :, lvl].transpose(1, 2).reshape(B * H, Q, P, 2)
        samp = F.grid_sample(v, g, mode="bilinear", padding_mode="zeros", align_corners=False)
        wgt = attention_weights[:, :, :, lvl].transpose(1, 2).reshape(B * H, 1, Q, P)
        out = out + (samp * wgt).sum(-1)                     # (B·H, C, Q)
    return out.reshape(B, H * C, Q).transpose(1, 2)
