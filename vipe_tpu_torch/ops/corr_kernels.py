"""K1, the correlation-window lookup: its CUDA kernel's wrapper and its
plain PyTorch version.

``corr_lookup`` is the lookup of every volume-mode GRU round (motion filter,
frontend, backend, inner filler).  On CUDA tensors it launches
``csrc/corr_lookup.cu`` (which replaces the Pallas TPU kernel
``vipe_tpu/ops/pallas_corr.py::corr_lookup_pyramid_pallas``); on CPU
tensors it runs ``corr_lookup_plain``.  Nothing on the card's main path
uses the plain version; ``chip_smoke.py`` holds the kernel against it.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

RADIUS = 3
TAPS = (2 * RADIUS + 1) ** 2  # 49
MAX_LEVELS = 4
_COORD_CLAMP = 1048576.0  # 2^20, as in the kernel: far outside any plane
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}


def _check(volumes, coords, scales, radius):
    if radius != RADIUS:
        raise ValueError(f"corr_lookup supports radius {RADIUS}, got {radius}")
    if not 1 <= len(volumes) <= MAX_LEVELS:
        raise ValueError(f"corr_lookup takes 1..{MAX_LEVELS} levels, got {len(volumes)}")
    if coords.dtype != torch.float32:
        raise TypeError(f"coords must be float32, got {coords.dtype}")
    if coords.dim() != 4 or coords.shape[-1] != 2:
        raise ValueError(f"coords must be (E, h1, w1, 2), got {tuple(coords.shape)}")
    if not coords.is_contiguous():
        raise ValueError("coords must be contiguous")
    E, h1, w1 = coords.shape[:3]
    dtype = volumes[0].dtype
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"volume dtype must be bf16, f32 or int8, got {dtype}")
    for lvl, v in enumerate(volumes):
        if v.dtype != dtype:
            raise TypeError(f"level {lvl} dtype {v.dtype} != level 0 dtype {dtype}")
        if v.dim() != 5 or tuple(v.shape[:3]) != (E, h1, w1):
            raise ValueError(
                f"level {lvl} volume must be (E, h1, w1, h2, w2) = "
                f"({E}, {h1}, {w1}, ·, ·), got {tuple(v.shape)}"
            )
        if not v.is_contiguous():
            raise ValueError(f"level {lvl} volume must be contiguous")
        if v.device != coords.device:
            raise ValueError(f"level {lvl} volume on {v.device}, coords on {coords.device}")
    if scales is not None:
        if len(scales) != len(volumes):
            raise ValueError("one scale vector per level is required")
        for lvl, s in enumerate(scales):
            if s.dtype != torch.float32 or tuple(s.shape) != (E,):
                raise ValueError(f"level {lvl} scale must be float32 (E,) = ({E},)")
            if not s.is_contiguous() or s.device != coords.device:
                raise ValueError(f"level {lvl} scale must be contiguous on {coords.device}")


def corr_lookup_plain(volumes, coords, scales=None, radius: int = RADIUS):
    """Direct bilinear gather in f32 from the same volumes.

    volumes: L × (E, h1, w1, h2_l, w2_l); coords: (E, h1, w1, 2) level-0
    ``(u, v)``; scales: optional L × (E,).  Returns (E, h1, w1, L·49) f32,
    level-major, ``dy·7 + dx`` within a level."""
    E, h1, w1 = coords.shape[:3]
    P = h1 * w1
    S = 2 * radius + 2
    offs = torch.arange(S, device=coords.device) - radius
    c = coords.reshape(E * P, 2)
    outs = []
    for lvl, vol in enumerate(volumes):
        h2, w2 = vol.shape[-2:]
        u = c[:, 0] / float(2 ** lvl)
        v = c[:, 1] / float(2 ** lvl)
        x0 = torch.clamp(torch.floor(u), -_COORD_CLAMP, _COORD_CLAMP)
        y0 = torch.clamp(torch.floor(v), -_COORD_CLAMP, _COORD_CLAMP)
        fx = (u - x0)[:, None, None]
        fy = (v - y0)[:, None, None]
        xs = x0.long()[:, None] + offs                       # (EP, S)
        ys = y0.long()[:, None] + offs
        ok = ((ys >= 0) & (ys < h2))[:, :, None] & ((xs >= 0) & (xs < w2))[:, None, :]
        idx = ys.clamp(0, h2 - 1)[:, :, None] * w2 + xs.clamp(0, w2 - 1)[:, None, :]
        patch = torch.gather(vol.reshape(E * P, h2 * w2), 1, idx.reshape(E * P, S * S))
        patch = torch.where(ok, patch.reshape(E * P, S, S).float(), 0.0)
        out = (
            (1 - fy) * (1 - fx) * patch[:, :-1, :-1]
            + (1 - fy) * fx * patch[:, :-1, 1:]
            + fy * (1 - fx) * patch[:, 1:, :-1]
            + fy * fx * patch[:, 1:, 1:]
        )
        if scales is not None:
            out = out * scales[lvl].repeat_interleave(P)[:, None, None]
        outs.append(out.reshape(E, h1, w1, (S - 1) ** 2))
    return torch.cat(outs, dim=-1)


def corr_lookup(volumes, coords, scales=None, radius: int = RADIUS):
    """K1.  On CUDA tensors: one launch of the CUDA kernel for all levels
    (counted in ``corr_lookup.launches``); on CPU tensors: the plain
    version.  Raises on any input the kernel does not take."""
    volumes = list(volumes)
    _check(volumes, coords, scales, radius)
    if coords.device.type == "cpu":
        return corr_lookup_plain(volumes, coords, scales, radius)
    if coords.device.type != "cuda":
        raise ValueError(f"corr_lookup runs on cuda or cpu tensors, not {coords.device}")
    lib = _lib()
    E, h1, w1 = coords.shape[:3]
    L = len(volumes)
    out = torch.empty((E, h1, w1, L * TAPS), dtype=torch.float32, device=coords.device)
    vptr = [v.data_ptr() for v in volumes] + [None] * (MAX_LEVELS - L)
    dims = []
    for lvl in range(MAX_LEVELS):
        dims += list(volumes[lvl].shape[-2:]) if lvl < L else [0, 0]
    sptr = ([s.data_ptr() for s in scales] if scales is not None else []) + [None] * (
        MAX_LEVELS - (L if scales is not None else 0)
    )
    with torch.cuda.device(coords.device):
        stream = torch.cuda.current_stream().cuda_stream
    rc = lib.vipe_corr_lookup(
        _DTYPE_CODE[volumes[0].dtype], *vptr, *dims, *sptr,
        coords.data_ptr(), out.data_ptr(), E * h1 * w1, h1 * w1, L, stream,
    )
    if rc != 0:
        raise RuntimeError(f"corr_lookup kernel failed to launch: CUDA error {rc}")
    corr_lookup.launches += 1
    return out


corr_lookup.launches = 0


def _lib():
    lib = _build.load("corr_lookup")
    fn = lib.vipe_corr_lookup
    if fn.argtypes is None:
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [ci, vp, vp, vp, vp] + [ci] * 8 + [vp] * 4 + [vp, vp, cll, cll, ci, vp]
        fn.restype = ci
    return lib
