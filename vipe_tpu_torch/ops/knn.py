"""Brute-force k nearest neighbours (port of ``vipe_tpu/ops/knn.py``): a
chunked distance matmul and a top-k, in torch ops.

Distances are ``|q|² + |p|² − 2q·p`` in f32, as the JAX package computes
them, with TF32 off: on integer pixel coordinates (the callers' case, up to
a few thousand) every term is an integer below 2²⁴, so the distances are
exact.  Equal distances are common on a pixel grid, and ``lax.top_k``
returns the lower index first, where ``torch.topk`` promises no order; so
the top-k runs on one int64 key per pair, the distance's order-preserving
bits above the point's index, which makes the neighbours and their order
those of the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import true_f32

# pairs per chunk of queries: f32 distances and int64 keys, ~0.8 GB
CHUNK_PAIRS = 1 << 26


def _order_key(d2: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """int64 keys ordered as (d2, idx): the f32 bits as an int32 of the
    same order (a negative float's magnitude bits flipped), times 2³², plus
    the index."""
    bits = d2.contiguous().view(torch.int32)
    bits = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    return torch.add(idx, bits, alpha=1 << 32)


@torch.no_grad()
def knn(query: torch.Tensor, points: torch.Tensor, k: int = 1):
    """query (Q, D), points (P, D), f32 on one device → (squared distances
    (Q, k) f32, indices (Q, k) int64), nearest first, ties by lower index.
    The distances are made for ``CHUNK_PAIRS`` pairs at a time."""
    query, points = query.float(), points.float()
    P = points.shape[0]
    chunk = max(1, CHUNK_PAIRS // max(P, 1))
    idx = torch.arange(P, dtype=torch.int64, device=points.device)
    out_d, out_i = [], []
    with true_f32():
        p_sq = torch.sum(points * points, dim=-1)
        for q in query.split(chunk):
            q_sq = torch.sum(q * q, dim=-1, keepdim=True)
            d2 = q_sq + p_sq[None, :] - (2.0 * q) @ points.T
            sel = torch.topk(_order_key(d2, idx), k, dim=1, largest=False, sorted=True).indices
            out_d.append(torch.gather(d2, 1, sel))
            out_i.append(sel)
    return torch.cat(out_d), torch.cat(out_i)


def knn_infill_depth(depth: np.ndarray, max_dist_px: float = 8.0) -> np.ndarray:
    """Fill the zero pixels of a sparse depth map from the nearest valid
    pixel within ``max_dist_px``."""
    depth = np.asarray(depth, np.float32)
    vy, vx = np.nonzero(depth > 0)
    if len(vy) == 0:
        return depth
    zy, zx = np.nonzero(depth == 0)
    if len(zy) == 0:
        return depth
    pts = torch.as_tensor(np.stack([vx, vy], -1), dtype=torch.float32)
    qs = torch.as_tensor(np.stack([zx, zy], -1), dtype=torch.float32)
    d2, idx = knn(qs, pts, 1)
    d2, idx = d2[:, 0].numpy(), idx[:, 0].numpy()
    out = depth.copy()
    ok = d2 <= max_dist_px ** 2
    out[zy[ok], zx[ok]] = depth[vy[idx[ok]], vx[idx[ok]]]
    return out
