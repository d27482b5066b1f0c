"""The correlation kernels' wrappers and their plain PyTorch versions.

* K1, ``corr_lookup``: the window lookup from stored volumes, used by every
  volume-mode GRU round (motion filter, frontend, backend, inner filler).
  On CUDA tensors it launches ``csrc/corr_lookup.cu``, which replaces the
  Pallas TPU kernel ``vipe_tpu/ops/pallas_corr.py::corr_lookup_pyramid_pallas``.
* K2, ``corr_fused``: the same 196-channel window with no stored volume
  (alt mode: frontend, backend, inner filler).  On CUDA tensors it launches
  ``csrc/corr_fused.cu``, which replaces
  ``vipe_tpu/ops/pallas_corr.py::corr_fused_pallas``.

On CPU tensors each wrapper runs its plain version (``corr_lookup_plain``,
``corr_fused_plain``).  Nothing on the card's main path uses a plain
version; ``chip_smoke.py`` holds each kernel against its plain version.
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
    (counted in ``corr_lookup.launches``, and those on int8 volumes also in
    ``corr_lookup.int8_launches``); on CPU tensors: the plain version.
    Raises on any input the kernel does not take."""
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
    corr_lookup.int8_launches += volumes[0].dtype == torch.int8
    return out


corr_lookup.launches = 0
corr_lookup.int8_launches = 0


def _lib():
    lib = _build.load("corr_lookup")
    fn = lib.vipe_corr_lookup
    if fn.argtypes is None:
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [ci, vp, vp, vp, vp] + [ci] * 8 + [vp] * 4 + [vp, vp, cll, cll, ci, vp]
        fn.restype = ci
    return lib


# ------------------------------------------------------------------- K2

MAX_CHANNELS = 256  # shared memory holds 256 rows of C bf16 channels and the dots
PLAIN_CHUNK_BYTES = 1 << 24  # f32 neighbourhood gather per plain chunk (cache-sized)


def _check_fused(f1, f2_pyr, coords, radius):
    if radius != RADIUS:
        raise ValueError(f"corr_fused supports radius {RADIUS}, got {radius}")
    if not 1 <= len(f2_pyr) <= MAX_LEVELS:
        raise ValueError(f"corr_fused takes 1..{MAX_LEVELS} levels, got {len(f2_pyr)}")
    if coords.dtype != torch.float32:
        raise TypeError(f"coords must be float32, got {coords.dtype}")
    if coords.dim() != 4 or coords.shape[-1] != 2:
        raise ValueError(f"coords must be (E, h1, w1, 2), got {tuple(coords.shape)}")
    if not coords.is_contiguous():
        raise ValueError("coords must be contiguous")
    E, h1, w1 = coords.shape[:3]
    if f1.dim() != 4 or tuple(f1.shape[:3]) != (E, h1, w1):
        raise ValueError(f"f1 must be (E, h1, w1, C) = ({E}, {h1}, {w1}, ·), "
                         f"got {tuple(f1.shape)}")
    C = f1.shape[-1]
    if C % 2 or not 2 <= C <= MAX_CHANNELS:
        raise ValueError(f"corr_fused takes an even C in 2..{MAX_CHANNELS}, got {C}")
    for name, t in [("f1", f1)] + [(f"level {l} f2", f) for l, f in enumerate(f2_pyr)]:
        if t.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"{name} must be bf16 or float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != coords.device:
            raise ValueError(f"{name} on {t.device}, coords on {coords.device}")
    for lvl, f in enumerate(f2_pyr):
        if f.dim() != 4 or f.shape[0] != E or f.shape[-1] != C or min(f.shape) < 1:
            raise ValueError(f"level {lvl} f2 must be (E, h2, w2, C) = ({E}, ·, ·, {C}), "
                             f"got {tuple(f.shape)}")


def _fused_operands(f1, f2_pyr, prescaled):
    """bf16 operands carrying the /4 scaling: cast as they are when
    ``prescaled`` (``corr_feat_pack`` state), else scaled first."""
    if prescaled:
        return f1.to(torch.bfloat16), [f.to(torch.bfloat16) for f in f2_pyr]
    return ((f1.float() / 4.0).to(torch.bfloat16),
            [(f.float() / 4.0).to(torch.bfloat16) for f in f2_pyr])


def corr_fused_plain(f1, f2_pyr, coords, radius: int = RADIUS, prescaled: bool = True):
    """Direct on-the-fly correlation window, in f32 from the same bf16
    operands (the JAX package's ``alt_corr_lookup_level`` per level).

    f1: (E, h1, w1, C); f2_pyr: L × (E, h2_l, w2_l, C); coords: (E, h1, w1, 2)
    level-0 ``(u, v)``.  Per level: the f32 dots of f1 with f2 at the
    (2r+2)² integer neighbours of ``coords / 2^l`` (0 outside the plane),
    then the bilinear (2r+1)² window.  Edges are taken in chunks so the
    gathered neighbourhoods stay under ``PLAIN_CHUNK_BYTES``.
    Returns (E, h1, w1, L·49) f32."""
    f1, f2_pyr = _fused_operands(f1, f2_pyr, prescaled)
    E, h1, w1, C = f1.shape
    P = h1 * w1
    S = 2 * radius + 2
    k = 2 * radius + 1
    chunk = max(1, PLAIN_CHUNK_BYTES // (P * S * S * C * 4))
    offs = torch.arange(S, device=coords.device) - radius
    out = torch.empty((E, h1, w1, len(f2_pyr) * k * k), dtype=torch.float32,
                      device=coords.device)
    for e0 in range(0, E, chunk):
        e1 = min(e0 + chunk, E)
        n = (e1 - e0) * P
        c = coords[e0:e1].reshape(n, 2)
        a = f1[e0:e1].reshape(n, C, 1).float()
        edge = torch.arange(e1 - e0, device=coords.device).repeat_interleave(P)
        for lvl, f2 in enumerate(f2_pyr):
            h2, w2 = f2.shape[1:3]
            u = c[:, 0] / float(2 ** lvl)
            v = c[:, 1] / float(2 ** lvl)
            x0 = torch.clamp(torch.floor(u), -_COORD_CLAMP, _COORD_CLAMP)
            y0 = torch.clamp(torch.floor(v), -_COORD_CLAMP, _COORD_CLAMP)
            fx = (u - x0)[:, None, None]
            fy = (v - y0)[:, None, None]
            xs = x0.long()[:, None] + offs                       # (n, S)
            ys = y0.long()[:, None] + offs
            ok = ((ys >= 0) & (ys < h2))[:, :, None] & ((xs >= 0) & (xs < w2))[:, None, :]
            idx = (edge[:, None, None] * (h2 * w2)
                   + ys.clamp(0, h2 - 1)[:, :, None] * w2 + xs.clamp(0, w2 - 1)[:, None, :])
            patch = torch.index_select(f2[e0:e1].reshape(-1, C).float(), 0,
                                       idx.reshape(-1)).reshape(n, S * S, C)
            dots = torch.bmm(patch, a).reshape(n, S, S)
            del patch
            dots = torch.where(ok, dots, 0.0)
            win = (
                (1 - fy) * (1 - fx) * dots[:, :-1, :-1]
                + (1 - fy) * fx * dots[:, :-1, 1:]
                + fy * (1 - fx) * dots[:, 1:, :-1]
                + fy * fx * dots[:, 1:, 1:]
            )
            out[e0:e1, ..., lvl * k * k:(lvl + 1) * k * k] = win.reshape(e1 - e0, h1, w1, k * k)
    return out


def corr_fused(f1, f2_pyr, coords, radius: int = RADIUS, prescaled: bool = True):
    """K2.  ``f1`` (E, h1, w1, C) and the per-level ``f2_pyr`` (E, h2_l,
    w2_l, C) as ``corr_feat_pack`` stores them (``prescaled``), or raw
    features that get the /4 scaling and the bf16 cast here.  On CUDA
    tensors: one launch of the CUDA kernel for all levels (counted in
    ``corr_fused.launches``); on CPU tensors: the plain version.  Raises on
    any input the kernel does not take."""
    f2_pyr = list(f2_pyr)
    _check_fused(f1, f2_pyr, coords, radius)
    if coords.device.type == "cpu":
        return corr_fused_plain(f1, f2_pyr, coords, radius, prescaled)
    if coords.device.type != "cuda":
        raise ValueError(f"corr_fused runs on cuda or cpu tensors, not {coords.device}")
    f1, f2_pyr = _fused_operands(f1, f2_pyr, prescaled)
    if any(t.data_ptr() % 4 for t in [f1] + f2_pyr):
        raise ValueError("corr_fused reads channel pairs: features must be 4-byte aligned")
    lib = _fused_lib()
    E, h1, w1, C = f1.shape
    L = len(f2_pyr)
    out = torch.empty((E, h1, w1, L * TAPS), dtype=torch.float32, device=coords.device)
    fptr = [f.data_ptr() for f in f2_pyr] + [None] * (MAX_LEVELS - L)
    dims = []
    for lvl in range(MAX_LEVELS):
        dims += list(f2_pyr[lvl].shape[1:3]) if lvl < L else [0, 0]
    with torch.cuda.device(coords.device):
        stream = torch.cuda.current_stream().cuda_stream
    rc = lib.vipe_corr_fused(
        f1.data_ptr(), *fptr, *dims, coords.data_ptr(), out.data_ptr(),
        E, h1, w1, C, L, stream,
    )
    if rc != 0:
        raise RuntimeError(f"corr_fused kernel failed to launch: CUDA error {rc}")
    corr_fused.launches += 1
    return out


corr_fused.launches = 0


def _fused_lib():
    lib = _build.load("corr_fused")
    fn = lib.vipe_corr_fused
    if fn.argtypes is None:
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp] * 5 + [ci] * 8 + [vp, vp, cll, ci, ci, ci, ci, vp]
        fn.restype = ci
    return lib
