"""``chip_smoke.py``'s bound counts against a brute-force numpy count.

The least bytes and operations of one K1 or K2 call on given coords decide
every ``bound_ms`` the chip run reports, so they are checked here on a
2-edge 3×4 grid whose windows are partly clipped, wholly inside and wholly
outside the planes.  CPU only; no JAX.
"""

import numpy as np
import torch

import chip_smoke

RADIUS = 3
SPAN = 2 * RADIUS + 2
PLANES = [(10, 12), (5, 6), (2, 3), (1, 1)]  # per level: wide enough for whole windows


def _coords():
    rng = np.random.default_rng(21)
    E, H, W = 2, 3, 4
    c = np.stack([rng.uniform(-6.0, 16.0, (E, H, W)), rng.uniform(-6.0, 14.0, (E, H, W))], -1)
    c[0, 0, 0] = [-1.0e6, 2.0]   # no window in any plane
    c[0, 0, 1] = [5.0, 4.0]      # whole window inside level 0
    c[1, 2, 3] = [11.5, 9.5]     # clipped at the far corner
    c[1, 1, 1] = [3.0, 3.0]      # integer coords
    return torch.from_numpy(c.astype(np.float32))


def _window(c, lvl, h2, w2):
    """In-plane (y, x) cells of one pixel's 8×8 bilinear neighbourhood."""
    x0 = int(np.floor(c[0] / 2 ** lvl)) - RADIUS
    y0 = int(np.floor(c[1] / 2 ** lvl)) - RADIUS
    return {(y, x) for y in range(y0, y0 + SPAN) for x in range(x0, x0 + SPAN)
            if 0 <= y < h2 and 0 <= x < w2}


def test_lookup_bound_matches_brute_force():
    coords = _coords()
    E, H, W = coords.shape[:3]
    volumes = [torch.zeros((E, H, W, h2, w2), dtype=torch.bfloat16) for h2, w2 in PLANES]
    c = coords.numpy()
    read = sum(len(_window(c[e, i, j], lvl, h2, w2))
               for lvl, (h2, w2) in enumerate(PLANES)
               for e in range(E) for i in range(H) for j in range(W)) * 2
    n_out = E * H * W * len(PLANES) * 49
    moved, ops = chip_smoke._lookup_bound(volumes, coords)
    assert moved == read + coords.numel() * 4 + n_out * 4
    assert ops == 8 * n_out
    assert 0 < read < E * H * W * len(PLANES) * SPAN * SPAN * 2  # some windows clipped


def test_fused_bound_matches_brute_force():
    coords = _coords()
    E, H, W = coords.shape[:3]
    C = 6
    f1 = torch.zeros((E, H, W, C), dtype=torch.bfloat16)
    f2 = [torch.zeros((E, h2, w2, C), dtype=torch.bfloat16) for h2, w2 in PLANES]
    c = coords.numpy()
    touched = dots = 0
    for lvl, (h2, w2) in enumerate(PLANES):
        for e in range(E):
            cells = [_window(c[e, i, j], lvl, h2, w2) for i in range(H) for j in range(W)]
            dots += sum(len(s) for s in cells)
            touched += len(set().union(*cells))  # rows shared by pixels of one edge
    n_out = E * H * W * len(PLANES) * 49
    moved, ops = chip_smoke._fused_bound([f1] + f2, coords)
    assert moved == f1.numel() * 2 + touched * C * 2 + coords.numel() * 4 + n_out * 4
    assert ops == 2 * C * dots + 8 * n_out
    assert touched < dots  # neighbourhoods overlap, each row is counted once
