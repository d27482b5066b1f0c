#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (``vipe_tpu_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every CUDA kernel of the main path from ``vipe_tpu_torch/csrc``
   (one ``nvcc`` per source, all started together) and prints the time;
3. holds K1 (``corr_lookup``) against its plain PyTorch version at the
   frontend shape of a 720p video (E = 48 edges, 41×73 grid, bf16 volumes),
   with int8 volumes + per-edge scales, and on an odd 7×9 grid with clamped
   levels and out-of-bounds coords; times the kernel, the plain version and
   ``grid_sample`` (the yardstick, never used by the port);
4. holds K2 (``corr_fused``) against its plain version at the same frontend
   shape (packed features, C = 128) and on the odd grid; times the kernel
   (also on coords of a pure shift and on coords uniform over the plane),
   the plain version and the route it replaces (``corr_pyramid`` + K1);
5. checks the SLAM machinery on the card against ground truth: tiny
   synthetic scenes whose update operator is a geometric oracle (GT flow,
   unit weights) must give back the GT trajectory, through the pinhole,
   the MEI and the panorama camera;
6. drives six main paths, each a seeded synthetic 720p stream through
   ``DefaultAnnotationPipeline`` on ``cuda`` (random DroidNet weights from a
   seed), with the kernels' launch counts set to 0 just before and read
   just after: the default (volume, bf16, speculative keyframe ordering),
   ``slam.corr_mode: alt``, ``slam.corr_dtype: int8``, the default again,
   the reference ordering (``keyframe_spec_depth: 1``, ``proximity_spec:
   false``), and an MEI camera with the stream's own intrinsics
   (``init.intrinsics: gt``), masks with an invalid band and the constant
   keyframe depth prior; prints frames, keyframes, removals (late ones
   too), waits on deferred reads, wall seconds, fps, peak memory (overall
   and per stage), stage host seconds and launches of each.  A spy copies
   to host memory the coords of the first frontend call (at the largest
   edge count) and of the first backend call that reach each kernel;
7. times K1 (volume run) and K2 (alt run) on those captured coords, with
   seeded features of the same shapes, warm and with a cold L2 cache;
8. prints the ``kernels`` JSON line and, last, the ``ok`` JSON line.

Kernel times come from CUDA events: the mean of back-to-back launches
(warm L2) as ``ms``, and the median of launches each preceded by a 128 MB
write (cold L2, as the main path calls them) as ``cold_ms``;
``bound_share`` is ``bound_ms / ms``.

It exits non-zero without a result when no CUDA card is present, and in a
directory that does not hold the ``vipe_tpu_torch`` package.
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_TENSOR_FLOPS_PER_S = 989e12

MAIN_FRAMES = 32
MAIN_KEYFRAMES = 12  # about one frame in three, the rate trained weights give on footage
MAIN_H, MAIN_W = 720, 1280
FRONTEND_EDGES = 48  # FactorGraph max_factors of the frontend
# a 720p fisheye-like MEI camera: focal, principal point, k1
MEI_INTRINSICS = [900.0, 900.0, MAIN_W / 2.0, MAIN_H / 2.0, 0.6]


def _require_environment():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device available; this script runs only on the card")
    if not (ROOT / "vipe_tpu_torch" / "__init__.py").is_file():
        sys.exit(f"chip_smoke: {ROOT} does not hold the vipe_tpu_torch package")
    sys.path.insert(0, str(ROOT))


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


SLEEP_CYCLES_PER_LAUNCH = 200_000  # ~0.1 ms of card time per queued launch


def _cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back launches, by
    CUDA events.  The card first sleeps while the host queues every launch,
    so a kernel shorter than its wrapper's host time is still timed
    back to back (the L2 cache stays warm between launches)."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES_PER_LAUNCH * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


FLUSH_BYTES = 128 << 20  # written between cold launches: 2.5x the H100's 50 MB L2


def _cuda_ms_cold(fn, iters: int) -> float:
    """Median device time of ``fn`` with a cold L2 cache, as the main path
    meets it: before each launch the card writes ``FLUSH_BYTES``, then
    sleeps while the host queues the launch; each launch is bracketed by
    its own CUDA events.  The median, because a launch that the host
    queues after the sleep has ended times the host's delay too."""
    import torch

    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.fill_(1.0)
        torch.cuda._sleep(SLEEP_CYCLES_PER_LAUNCH)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    del flush
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


# ------------------------------------------------------------------- kernels


def _lookup_bound(volumes, coords, radius: int = 3):
    """Least bytes and operations of one lookup on this data: the distinct
    volume entries the (2r+2)² bilinear neighbourhoods touch (clipped to
    each plane), the coords, and the f32 output; 4 multiply-adds per output
    element."""
    import torch

    E, h1, w1 = coords.shape[:3]
    n_out = E * h1 * w1 * len(volumes) * (2 * radius + 1) ** 2
    read = 0
    for lvl, vol in enumerate(volumes):
        h2, w2 = vol.shape[-2:]
        c = coords.reshape(-1, 2) / float(2 ** lvl)
        x0 = torch.floor(c[:, 0]) - radius
        y0 = torch.floor(c[:, 1]) - radius
        span = 2 * radius + 2
        nx = (torch.clamp(x0 + span, max=w2) - torch.clamp(x0, min=0)).clamp(min=0)
        ny = (torch.clamp(y0 + span, max=h2) - torch.clamp(y0, min=0)).clamp(min=0)
        read += int((nx * ny).sum().item()) * vol.element_size()
    moved = read + coords.numel() * 4 + n_out * 4
    ops = 8 * n_out
    return moved, ops


def _grid_sample_lookup(volumes, coords, radius: int = 3):
    """The same function as one ``grid_sample`` call per level (f32
    volumes; align_corners=True maps pixel i to -1 + 2i/(w-1))."""
    import torch
    import torch.nn.functional as F

    E, h1, w1 = coords.shape[:3]
    P = E * h1 * w1
    k = 2 * radius + 1
    offs = torch.arange(k, device=coords.device, dtype=torch.float32) - radius
    calls = []
    for lvl, vol in enumerate(volumes):
        h2, w2 = vol.shape[-2:]
        c = coords.reshape(P, 2) / float(2 ** lvl)
        gx = (c[:, 0, None, None] + offs[None, None, :]) * (2.0 / (w2 - 1)) - 1.0
        gy = (c[:, 1, None, None] + offs[None, :, None]) * (2.0 / (h2 - 1)) - 1.0
        grid = torch.stack([gx.expand(P, k, k), gy.expand(P, k, k)], dim=-1).contiguous()
        calls.append((vol.float().reshape(P, 1, h2, w2), grid))

    def run():
        return [
            F.grid_sample(v, g, mode="bilinear", padding_mode="zeros", align_corners=True)
            for v, g in calls
        ]

    def result():
        return torch.cat([o.reshape(E, h1, w1, k * k) for o in run()], dim=-1)

    return run, result


def kernel_phase():
    """K1 against its plain version; returns the K1 record (without its
    main-path launch count) and the case errors."""
    import torch

    from vipe_tpu_torch.ops import corr as corr_ops
    from vipe_tpu_torch.ops import corr_kernels as ck

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    E, ht, wd = FRONTEND_EDGES, 41, 73  # 720p → 328×584 SLAM frames → 1/8 grid
    f1 = torch.randn((E, ht, wd, 128), generator=g, device=dev).to(torch.bfloat16)
    f2 = torch.randn((E, ht, wd, 128), generator=g, device=dev).to(torch.bfloat16)
    pyr = corr_ops.corr_pyramid(f1, f2)
    grid = torch.stack(torch.meshgrid(
        torch.arange(wd, device=dev, dtype=torch.float32),
        torch.arange(ht, device=dev, dtype=torch.float32), indexing="xy"), dim=-1)
    coords = (grid + 2.0 * torch.randn((E, ht, wd, 2), generator=g, device=dev)).contiguous()

    cases = {}
    out_k = ck.corr_lookup(pyr, coords)
    out_p = ck.corr_lookup_plain(pyr, coords)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    cases["frontend_bf16"] = {"max_abs_err": err, "tol": 1e-4,
                              "shape": [E, ht, wd, 196]}

    q, s = zip(*(corr_ops.quantize_volume(v) for v in pyr))
    q = [x.contiguous() for x in q]
    s = [x.contiguous() for x in s]
    out_k8 = ck.corr_lookup(q, coords, scales=s)
    out_p8 = ck.corr_lookup_plain(q, coords, scales=s)
    err8 = float((out_k8 - out_p8).abs().max())
    cases["frontend_int8_scales"] = {"max_abs_err": err8, "tol": 1e-4}

    # odd grid, clamped 1-px levels, coords far outside and on integers
    Eo, ho, wo = 3, 7, 9
    vols = [torch.randn((Eo, ho, wo) + corr_ops.level_dims(ho, wo, lvl), generator=g,
                        device=dev) for lvl in range(4)]
    co = torch.rand((Eo, ho, wo, 2), generator=g, device=dev) * 32.0 - 12.0
    co[0, 0, 0] = torch.tensor([-1.0e6, 3.0])
    co[0, 0, 1] = torch.tensor([4.0, 1.0e6])
    co[1, 2] = torch.round(co[1, 2])
    co[2, 3] = float("-40.0")
    out_ko = ck.corr_lookup(vols, co.contiguous())
    out_po = ck.corr_lookup_plain(vols, co.contiguous())
    erro = float((out_ko - out_po).abs().max())
    oob_rows = out_ko[2, 3]
    cases["odd_grid_oob_f32"] = {
        "max_abs_err": erro, "tol": 1e-5,
        "oob_exact_zero": bool((oob_rows == 0).all()),
    }
    for name, c in cases.items():
        if not c["max_abs_err"] <= c["tol"]:
            raise AssertionError(f"K1 {name}: max abs err {c['max_abs_err']} > {c['tol']}")
    if not cases["odd_grid_oob_f32"]["oob_exact_zero"]:
        raise AssertionError("K1: fully out-of-bounds windows are not exactly 0")

    iters = 20
    ms = _cuda_ms(lambda: ck.corr_lookup(pyr, coords), iters)
    cold_ms = _cuda_ms_cold(lambda: ck.corr_lookup(pyr, coords), iters)
    plain_ms = _cuda_ms(lambda: ck.corr_lookup_plain(pyr, coords), 5)
    gs_run, gs_result = _grid_sample_lookup(pyr, coords)
    library_ms = _cuda_ms(gs_run, iters)
    lib_err = float((gs_result() - out_p).abs().max())
    moved, ops = _lookup_bound(pyr, coords)
    bound_s = max(moved / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S)
    record = {
        "name": "corr_lookup (K1)",
        "route": "cuda",
        "source": "vipe_tpu_torch/csrc/corr_lookup.cu",
        "replaces": "vipe_tpu/ops/pallas_corr.py:312",
        "launches": None,
        "max_abs_err": err,
        "ms": ms,
        "cold_ms": cold_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_s * 1e3,
        "bound_share": bound_s * 1e3 / ms,
        "bound_us": bound_s * 1e6,
        "bound_by": "bytes" if moved / HBM_BYTES_PER_S >= ops / F32_FLOPS_PER_S else "operations",
        "library_ms": library_ms,
        "library": "torch.nn.functional.grid_sample, f32 volumes, one call per level",
        "library_max_abs_err": lib_err,
        "bound_bytes": moved,
        "bound_ops": ops,
        "shape": {"E": E, "h1": ht, "w1": wd,
                  "levels": [list(v.shape[-2:]) for v in pyr], "dtype": "bf16"},
        "cases": cases,
    }
    del pyr, q, s, out_k, out_p, out_k8, out_p8
    torch.cuda.empty_cache()
    return record


def _fused_bound(packed, coords, radius: int = 3):
    """Least bytes and operations of one K2 call on this data: f1, the
    distinct f2 entries the (2r+2)² neighbourhoods of each edge touch
    (clipped to each plane), the coords and the f32 output; 2·C per
    in-plane dot plus 4 multiply-adds per output element."""
    import torch

    f1, f2_pyr = packed[0], packed[1:]
    E, h1, w1, C = f1.shape
    span = 2 * radius + 2
    n_out = E * h1 * w1 * len(f2_pyr) * (2 * radius + 1) ** 2
    offs = torch.arange(span, device=coords.device) - radius
    edge = torch.arange(E, device=coords.device).repeat_interleave(h1 * w1)
    touched = dots = 0
    for lvl, f2 in enumerate(f2_pyr):
        h2, w2 = f2.shape[1:3]
        c = coords.reshape(-1, 2) / float(2 ** lvl)
        xs = torch.floor(c[:, 0]).long()[:, None] + offs
        ys = torch.floor(c[:, 1]).long()[:, None] + offs
        okx, oky = (xs >= 0) & (xs < w2), (ys >= 0) & (ys < h2)
        ok = oky[:, :, None] & okx[:, None, :]
        dots += int(ok.sum().item())
        idx = edge[:, None, None] * (h2 * w2) + ys[:, :, None] * w2 + xs[:, None, :]
        seen = torch.zeros(E * h2 * w2, dtype=torch.bool, device=coords.device)
        seen[idx[ok]] = True
        touched += int(seen.sum().item())
    moved = f1.numel() * 2 + touched * C * 2 + coords.numel() * 4 + n_out * 4
    ops = 2 * C * dots + 8 * n_out
    return moved, ops


def fused_kernel_phase():
    """K2 against its plain version; returns the K2 record (without its
    main-path launch count)."""
    import torch

    from vipe_tpu_torch.ops import corr as corr_ops
    from vipe_tpu_torch.ops import corr_kernels as ck

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    E, ht, wd, C = FRONTEND_EDGES, 41, 73, 128
    f1 = torch.randn((E, ht, wd, C), generator=g, device=dev).to(torch.bfloat16)
    f2 = torch.randn((E, ht, wd, C), generator=g, device=dev).to(torch.bfloat16)
    packed = corr_ops.corr_feat_pack(f1, f2)
    grid = torch.stack(torch.meshgrid(
        torch.arange(wd, device=dev, dtype=torch.float32),
        torch.arange(ht, device=dev, dtype=torch.float32), indexing="xy"), dim=-1)
    coords = (grid + 2.0 * torch.randn((E, ht, wd, 2), generator=g, device=dev)).contiguous()

    cases = {}
    out_k = ck.corr_fused(packed[0], packed[1:], coords)
    out_p = ck.corr_fused_plain(packed[0], packed[1:], coords)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    cases["frontend_packed_bf16"] = {"max_abs_err": err, "tol": 1e-4,
                                     "shape": [E, ht, wd, 196]}

    # odd grid, clamped 1-px levels, coords far outside and on integers
    Eo, ho, wo = 3, 7, 9
    po = corr_ops.corr_feat_pack(
        torch.randn((Eo, ho, wo, C), generator=g, device=dev),
        torch.randn((Eo, ho, wo, C), generator=g, device=dev))
    co = torch.rand((Eo, ho, wo, 2), generator=g, device=dev) * 32.0 - 12.0
    co[0, 0, 0] = torch.tensor([-1.0e6, 3.0])
    co[0, 0, 1] = torch.tensor([4.0, 1.0e6])
    co[1, 2] = torch.round(co[1, 2])
    co[2, 3] = float("-40.0")
    out_ko = ck.corr_fused(po[0], po[1:], co.contiguous())
    out_po = ck.corr_fused_plain(po[0], po[1:], co.contiguous())
    cases["odd_grid_oob"] = {
        "max_abs_err": float((out_ko - out_po).abs().max()), "tol": 1e-5,
        "levels": [list(p.shape[1:3]) for p in po[1:]],
        "oob_exact_zero": bool((out_ko[2, 3] == 0).all()),
    }
    for name, c in cases.items():
        if not c["max_abs_err"] <= c["tol"]:
            raise AssertionError(f"K2 {name}: max abs err {c['max_abs_err']} > {c['tol']}")
    if not cases["odd_grid_oob"]["oob_exact_zero"]:
        raise AssertionError("K2: fully out-of-plane windows are not exactly 0")

    ms = _cuda_ms(lambda: ck.corr_fused(packed[0], packed[1:], coords), 20)
    cold_ms = _cuda_ms_cold(lambda: ck.corr_fused(packed[0], packed[1:], coords), 20)
    # K2's time follows the coords: how coherent each tile's neighbourhoods are
    sweep = {}
    for name, co in (("shift", grid.expand(E, ht, wd, 2) + 0.5),
                     ("uniform", torch.rand((E, ht, wd, 2), generator=g, device=dev)
                      * torch.tensor([wd, ht], device=dev, dtype=torch.float32))):
        co = co.contiguous()
        sweep[name] = _cuda_ms(lambda: ck.corr_fused(packed[0], packed[1:], co), 20)  # noqa: B023
    plain_ms = _cuda_ms(lambda: ck.corr_fused_plain(packed[0], packed[1:], coords), 3)
    volume_route_ms = _cuda_ms(
        lambda: ck.corr_lookup(corr_ops.corr_pyramid(f1, f2), coords), 10)
    moved, ops = _fused_bound(packed, coords)
    bytes_s, ops_s = moved / HBM_BYTES_PER_S, ops / BF16_TENSOR_FLOPS_PER_S
    record = {
        "name": "corr_fused (K2)",
        "route": "cuda",
        "source": "vipe_tpu_torch/csrc/corr_fused.cu",
        "replaces": "vipe_tpu/ops/pallas_corr.py:161",
        "launches": None,
        "max_abs_err": err,
        "ms": ms,
        "cold_ms": cold_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_s, ops_s) * 1e3,
        "bound_share": max(bytes_s, ops_s) * 1e3 / ms,
        "bound_by": "bytes" if bytes_s >= ops_s else "operations",
        "library_ms": None,
        "library": "none: no single PyTorch call forms the windowed dots without the "
                   "volume",
        "coords_sweep_ms": {"grid_plus_2N(0,1)": ms, **sweep},
        "replaced_route_ms": volume_route_ms,
        "replaced_route": "corr_pyramid (cuBLAS bmm, bf16 volumes) + K1, same features",
        "cuda_core_bound_ms": ops / F32_FLOPS_PER_S * 1e3,
        "bound_bytes": moved,
        "bound_ops": ops,
        "shape": {"E": E, "h1": ht, "w1": wd, "C": C,
                  "levels": [list(p.shape[1:3]) for p in packed[1:]], "dtype": "bf16"},
        "cases": cases,
    }
    del packed, out_k, out_p, f1, f2
    torch.cuda.empty_cache()
    return record


# ------------------------------------------------------- oracle (ground truth)


def aligned_ate(traj: np.ndarray, gt: np.ndarray) -> float:
    """Position RMSE after the Umeyama similarity that best aligns ``traj``
    to ``gt`` (both (T, 7) camera-to-world)."""
    src, dst = traj[:, :3].astype(np.float64), gt[:, :3].astype(np.float64)
    xs, xd = src - src.mean(0), dst - dst.mean(0)
    U, D, Vt = np.linalg.svd(xd.T @ xs / len(src))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = np.trace(np.diag(D) @ S) / max((xs ** 2).sum() / len(src), 1e-12)
    aligned = s * xs @ R.T + dst.mean(0)
    return float(np.sqrt(((aligned - dst) ** 2).sum(-1).mean()))


def oracle_phase(camera: str = "pinhole"):
    """Tiny synthetic scene, geometric-oracle update operator, on the card:
    the recovered camera-to-world trajectory must match ground truth.  The
    pinhole scene's translations to 0.02 RMSE; the MEI (k1 = 0.6) and
    panorama scenes of the JAX package's tests to their aligned-ATE limit
    of 0.03 (the panorama's pole row carries no weight, as there)."""
    import torch

    from vipe_tpu_torch.ops import cameras as cam
    from vipe_tpu_torch.ops import geom, lie
    from vipe_tpu_torch.slam import system as slam_system
    from vipe_tpu_torch.streams.base import FrameAttribute, VideoFrame, VideoStream

    H, W, T, depth = 48, 64, 12, 2.0
    ht, wd = H // 8, W // 8
    camera_type = cam.CameraType(camera)
    rng = np.random.default_rng({"pinhole": 3, "mei": 5, "panorama": 11}[camera])
    c2w = [lie.se3_identity()]
    for _ in range(1, T):
        xi = torch.tensor([0.06, 0.005 * rng.normal(), 0.004 * rng.normal(),
                           0.002 * rng.normal(), 0.004 * rng.normal(),
                           0.002 * rng.normal()], dtype=torch.float32)
        c2w.append(lie.se3_mul(c2w[-1], lie.se3_exp(xi)))
    gt_c2w = torch.stack(c2w)
    gt_w2c = lie.se3_inv(gt_c2w)
    u, v = geom.pixel_grid(ht, wd)
    gt_disps = ((1.0 / depth) * (1.0 + 0.1 * torch.sin(u / 2.0) * torch.cos(v / 1.5))).expand(T, ht, wd)
    if camera == "panorama":
        intr_full = np.zeros(4, np.float32)  # panorama streams carry all-zero intrinsics
        intr_grid = cam.panorama_intrinsics(ht, wd)
    else:
        intr_full = np.asarray([W * 1.2, W * 1.2, W / 2.0, H / 2.0] + ([0.6] if camera == "mei" else []),
                               np.float32)
        intr_grid = cam.scaled_intrinsics(camera_type, torch.from_numpy(intr_full), 1 / 8.0)
    images = [rng.random((H, W, 3)).astype(np.float32) for _ in range(T)]

    class Scene(VideoStream):
        def __len__(self):
            return T

        def frame_size(self):
            return (H, W)

        def attributes(self):
            return {FrameAttribute.RGB, FrameAttribute.INTRINSICS, FrameAttribute.METRIC_DEPTH}

        def __iter__(self):
            for k in range(T):
                yield VideoFrame(
                    raw_frame_idx=k, rgb=images[k],
                    metric_depth=np.kron(1.0 / gt_disps[k].numpy(), np.ones((8, 8), np.float32)),
                    intrinsics=intr_full.copy(),
                )

    dev = torch.device("cuda")
    P, D = gt_w2c.to(dev), gt_disps.contiguous().to(dev)
    I_grid = intr_grid.to(dev)
    live = {}

    class SpyBuffer(slam_system.GraphBuffer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            live["buf"] = self

    def oracle(net, inp, corr, motn, ii, jj, num_frames):
        buf = live["buf"]
        coords1 = motn[..., :2] + geom.coords_grid(ht, wd, dev)
        fi = torch.as_tensor(buf.tstamp[ii.cpu().numpy()], device=dev)
        fj = torch.as_tensor(buf.tstamp[jj.cpu().numpy()], device=dev)
        gt_coords, gt_valid = geom.reproject(P, D, I_grid, camera_type, fi, fj)
        delta = gt_coords - coords1
        weight = gt_valid[..., None].float().expand_as(delta).clone()
        if camera == "panorama":
            weight[:, 0] = 0.0
        return net, delta, weight, torch.full((num_frames, ht, wd), 0.01, device=dev)

    oracle.host_only = True  # reads host state: the sequential frontend

    def zeros(images):
        return torch.zeros((images.shape[0], ht, wd, 128), dtype=torch.bfloat16, device=dev)

    orig = slam_system.GraphBuffer
    slam_system.GraphBuffer = SpyBuffer
    try:
        out = slam_system.SLAMSystem(
            config=dict(resize_area=H * W, filter_thresh=-1.0, keyframe_thresh=0.0,
                        warmup=4, buffer=64, infill_chunk_size=6,
                        backend_iters=12 if camera == "pinhole" else 8),
            device=dev, update_fn=oracle, encode_features=zeros,
            encode_context=lambda im: (zeros(im), zeros(im)),
        ).run(Scene(), camera_type=camera_type)
    finally:
        slam_system.GraphBuffer = orig
    finite = out.trajectory.shape == (T, 7) and np.isfinite(out.trajectory).all()
    if camera == "pinhole":
        err = float(np.sqrt(np.mean(np.sum((out.trajectory[:, :3] - gt_c2w[:, :3].numpy()) ** 2, -1))))
        metric, limit = "translation_rmse", 0.02
    else:
        err, metric, limit = aligned_ate(out.trajectory, gt_c2w.numpy()), "aligned_ate", 0.03
    if not (finite and err < limit):
        raise AssertionError(f"{camera} oracle SLAM on the card: {metric} {err} (limit {limit})")
    if out.intrinsics.shape != (camera_type.intrinsics_dim(),):
        raise AssertionError(f"{camera} oracle SLAM: intrinsics {out.intrinsics.shape}")
    return {"camera": camera, "frames": T, "keyframes": len(out.keyframes), metric: err,
            "limit": limit}


# ------------------------------------------------------------------ main path


def synth_stream(n_frames: int, h: int = MAIN_H, w: int = MAIN_W, seed: int = 0,
                 intrinsics=None, mask_rows: int = 0):
    """A textured canvas translated frame by frame (real flow, no parallax),
    made from ``seed``.  With ``intrinsics`` every frame carries them; with
    ``mask_rows`` every frame's validity mask marks that many bottom rows
    invalid (a band, like a car's hood)."""
    from vipe_tpu_torch.streams.base import FrameAttribute, VideoFrame, VideoStream

    rng = np.random.default_rng(seed)
    base = rng.random((h + 64, w + 64, 3)).astype(np.float32)
    mask = None
    if mask_rows:
        mask = np.ones((h, w), bool)
        mask[h - mask_rows:] = False

    class Synth(VideoStream):
        _name = f"synth{seed}"

        def __len__(self):
            return n_frames

        def frame_size(self):
            return (h, w)

        def attributes(self):
            attrs = {FrameAttribute.RGB}
            if intrinsics is not None:
                attrs.add(FrameAttribute.INTRINSICS)
            if mask is not None:
                attrs.add(FrameAttribute.MASK)
            return attrs

        def __iter__(self):
            for k in range(n_frames):
                ox, oy = (k * 5) % 64, (k * 3) % 64
                yield VideoFrame(
                    raw_frame_idx=k, rgb=base[oy: oy + h, ox: ox + w], mask=mask,
                    intrinsics=None if intrinsics is None else np.array(intrinsics, np.float32))

    return Synth()


def calibrate_filter_thresh(stream, n_keyframes: int) -> float:
    """With random DroidNet weights the motion-filter scores have no fixed
    scale.  Score every frame against every earlier frame as reference, then
    pick the threshold whose filter pass (the first and the last frame are
    always keyframes) gives the keyframe count nearest ``n_keyframes``."""
    import torch

    from vipe_tpu_torch.models.droidnet import build_droidnet
    from vipe_tpu_torch.slam.motion_filter import MotionFilter
    from vipe_tpu_torch.slam.system import StandardResizeStreamProcessor, droidnet_fns
    from vipe_tpu_torch.streams.base import ProcessedVideoStream

    model = build_droidnet("cuda")
    ef, ec, uf = droidnet_fns(model)
    mf = MotionFilter(ef, ec, uf, thresh=1e9)
    frames = ProcessedVideoStream(stream, [StandardResizeStreamProcessor()])
    with torch.no_grad():
        toks = [mf.submit(torch.from_numpy((np.clip(f.rgb, 0, 1) * 255).astype(np.uint8)).cuda())
                for f in frames]
        n = len(toks)
        score = np.full((n, n), -np.inf)
        for i in range(n - 1):
            mf._promote(toks[i])
            for j in range(i + 1, n):
                score[i, j] = mf._score(toks[j].fmap)
    del model, mf, toks

    def n_kf(thresh):
        ref, count = 0, 1
        for j in range(1, n):
            if score[ref, j] > thresh or j == n - 1:
                ref, count = j, count + 1
        return count

    cands = np.unique(score[np.isfinite(score)])
    return float(min(cands, key=lambda t: (abs(n_kf(t) - n_keyframes), -t)))


@contextlib.contextmanager
def stage_peaks():
    """While active, every ``profiling.stage`` also records the device's
    peak allocated bytes inside it (nested stages fold into their parent's
    peak); yields the dict {stage: peak GiB}.  The peak counter is reset at
    each stage boundary, so read the run's overall peak from the dict's
    maximum and ``torch.cuda.max_memory_allocated()`` together."""
    import torch

    from vipe_tpu_torch.utils import profiling

    orig = profiling.stage
    peaks: dict = {}
    stack = [0]

    @contextlib.contextmanager
    def stage(name):
        stack[-1] = max(stack[-1], torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        stack.append(0)
        try:
            with orig(name):
                yield
        finally:
            peak = max(stack.pop(), torch.cuda.max_memory_allocated())
            peaks[name] = max(peaks.get(name, 0.0), peak / 2 ** 30)
            stack[-1] = max(stack[-1], peak)
            torch.cuda.reset_peak_memory_stats()

    profiling.stage = stage
    try:
        yield peaks, stack
    finally:
        profiling.stage = orig


@contextlib.contextmanager
def coords_spy():
    """While active, copies to host memory the coords that the main path
    hands to the correlation lookup: per kernel (K1 on volumes, K2 on packed
    features), the first frontend call at the largest edge count seen in
    ``slam_pass1`` and the first call in ``slam_backend``; yields the dict
    {(kernel, role): {"coords": cpu tensor, ...}} and counts every call.
    Only host copies are made, so device peaks do not change."""
    from vipe_tpu_torch.ops import corr as corr_ops
    from vipe_tpu_torch.utils import profiling

    orig_stage, orig_lookup = profiling.stage, corr_ops.corr_lookup_pyramid
    names: list = []
    seen: dict = {}

    @contextlib.contextmanager
    def stage(name):
        names.append(name)
        try:
            with orig_stage(name):
                yield
        finally:
            names.pop()

    def lookup(pyramid, coords, *args, **kwargs):
        pyramid = list(pyramid)
        kernel = "K2" if pyramid[0].dim() == 4 else "K1"
        role = {"slam_pass1": "frontend", "slam_backend": "backend"}.get(names[-1] if names else "")
        if role is not None:
            rec = seen.setdefault((kernel, role), {"calls": 0, "edges": set()})
            E = int(coords.shape[0])
            rec["calls"] += 1
            rec["edges"].add(E)
            if "coords" not in rec or (role == "frontend" and E > rec["coords"].shape[0]):
                rec["coords"] = coords.detach().to("cpu", copy=True)
        return orig_lookup(pyramid, coords, *args, **kwargs)

    profiling.stage, corr_ops.corr_lookup_pyramid = stage, lookup
    try:
        yield seen
    finally:
        profiling.stage, corr_ops.corr_lookup_pyramid = orig_stage, orig_lookup


def mainpath_coords_phase(kernels):
    """Times K1 and K2 on the coords the main path gave them, with seeded
    features of the same shapes: a kernel's time depends on the coords, not
    on the values.  ``kernels`` maps "K1"/"K2" to (record, what
    ``coords_spy`` captured in the run that launches it); adds
    ``mainpath_coords`` to each record."""
    import torch

    from vipe_tpu_torch.ops import corr as corr_ops
    from vipe_tpu_torch.ops import corr_kernels as ck

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    for kernel, (rec, captured) in kernels.items():
        rec["mainpath_coords"] = {}
        for role in ("frontend", "backend"):
            cap = captured.get((kernel, role))
            if cap is None:
                raise AssertionError(f"the main path made no {kernel} call in its {role}")
            coords = cap["coords"].to(dev).contiguous()
            E, ht, wd = coords.shape[:3]
            f1 = torch.randn((E, ht, wd, 128), generator=g, device=dev).to(torch.bfloat16)
            f2 = torch.randn((E, ht, wd, 128), generator=g, device=dev).to(torch.bfloat16)
            if kernel == "K1":
                ops = corr_ops.corr_pyramid(f1, f2)
                run = lambda: ck.corr_lookup(ops, coords)  # noqa: E731
                plain = lambda: ck.corr_lookup_plain(ops, coords)  # noqa: E731
                moved, n_ops = _lookup_bound(ops, coords)
                bound_s = max(moved / HBM_BYTES_PER_S, n_ops / F32_FLOPS_PER_S)
            else:
                ops = corr_ops.corr_feat_pack(f1, f2)
                run = lambda: ck.corr_fused(ops[0], ops[1:], coords)  # noqa: E731
                plain = lambda: ck.corr_fused_plain(ops[0], ops[1:], coords)  # noqa: E731
                moved, n_ops = _fused_bound(ops, coords)
                bound_s = max(moved / HBM_BYTES_PER_S, n_ops / BF16_TENSOR_FLOPS_PER_S)
            err = float((run() - plain()).abs().max())
            if not err <= 1e-4:
                raise AssertionError(f"{kernel} on the main path's {role} coords: "
                                     f"max abs err {err} > 1e-4")
            ms = _cuda_ms(run, 20)
            rec["mainpath_coords"][role] = {
                "E": E, "grid": [ht, wd], "calls": cap["calls"], "edges_seen": sorted(cap["edges"]),
                "max_abs_err": err, "tol": 1e-4,
                "ms": ms, "cold_ms": _cuda_ms_cold(run, 20),
                "bound_ms": bound_s * 1e3, "bound_share": bound_s * 1e3 / ms,
                "bound_bytes": moved,
            }
            del ops, f1, f2, coords
            torch.cuda.empty_cache()


def main_path_phase(label, slam_cfg, n_frames, thresh, required, stream_kw=None,
                    init=None):
    """One run of the main path with ``slam_cfg`` over ``n_frames`` of the
    seeded stream (``stream_kw``: its intrinsics and mask band).
    ``required`` names the launch counts that must be > 0."""
    import gc

    import torch

    from vipe_tpu_torch.ops import cameras as cam
    from vipe_tpu_torch.ops import corr_kernels as ck
    from vipe_tpu_torch.pipeline.default import DefaultAnnotationPipeline
    from vipe_tpu_torch.utils import profiling

    stream = synth_stream(n_frames, **(stream_kw or {}))
    pipe = DefaultAnnotationPipeline(
        init=init or {"intrinsics": "fov", "fov_deg": 60.0},
        slam={"optimize_intrinsics": True, "filter_thresh": thresh, **slam_cfg},
        output={"path": None}, device="cuda", return_payload=True,
    )
    n_intr = cam.CameraType(slam_cfg.get("camera_type", "pinhole")).intrinsics_dim()
    gc.collect()
    torch.cuda.empty_cache()
    profiling.snapshot(reset=True)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ck.corr_lookup.launches = ck.corr_lookup.int8_launches = ck.corr_fused.launches = 0
    with stage_peaks() as (peaks, top), coords_spy() as captured:
        t0 = time.perf_counter()
        out = pipe.run(stream)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {"corr_lookup": ck.corr_lookup.launches,
                "corr_lookup_int8": ck.corr_lookup.int8_launches,
                "corr_fused": ck.corr_fused.launches}
    peak = max(top[0], torch.cuda.max_memory_allocated())
    stages = profiling.snapshot(reset=True)

    slam_out = out.payload["slam_output"]
    traj = np.asarray(out.trajectory)
    if traj.shape != (n_frames, 7) or not np.isfinite(traj).all():
        raise AssertionError(f"{label} main path: trajectory {traj.shape} not finite / wrong shape")
    if not np.isfinite(out.intrinsics).all() or out.intrinsics.shape != (n_intr,):
        raise AssertionError(f"{label} main path: intrinsics {out.intrinsics}")
    quat_norm = np.linalg.norm(traj[:, 3:], axis=-1)
    if not np.allclose(quat_norm, 1.0, atol=1e-3):
        raise AssertionError(f"{label} main path: rotations are not unit quaternions")
    for name in required:
        if launches[name] <= 0:
            raise AssertionError(f"{label} main path did not launch {name}")
    return {
        "label": label, "slam": slam_cfg,
        "frames": n_frames, "resolution": [MAIN_H, MAIN_W],
        "keyframes": int(len(slam_out.keyframes)), "filter_thresh": thresh,
        "wall_s": wall, "fps": n_frames / wall,
        "peak_mem_gib": peak / 2 ** 30, "resident_before_gib": resident / 2 ** 30,
        "stage_peak_mem_gib": peaks,
        "launches": launches,
        "stages_host_s": stages,
        "intrinsics": [float(x) for x in out.intrinsics],
        "ba_residual": float(out.ba_residual),
        # frontend: keyframes removed, removed late, waits on deferred reads
        **slam_out.frontend_stats,
    }, captured


def main():
    _require_environment()
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print(_card_line(), flush=True)
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "python": sys.version.split()[0]}), flush=True)

    from vipe_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "libraries": [p.name for p in built]}), flush=True)

    k1 = kernel_phase()
    print(json.dumps({"kernel_check": {"K1": k1["cases"]}}), flush=True)
    k2 = fused_kernel_phase()
    print(json.dumps({"kernel_check": {"K2": k2["cases"]}}), flush=True)
    for camera in ("pinhole", "mei", "panorama"):
        print(json.dumps({"oracle": oracle_phase(camera)}), flush=True)

    thresh = calibrate_filter_thresh(synth_stream(MAIN_FRAMES), MAIN_KEYFRAMES)
    # the default ordering (keyframe_spec_depth 2, proximity_spec true)
    # unless a run says otherwise
    mei = {"intrinsics": MEI_INTRINSICS, "mask_rows": MAIN_H // 6}
    runs = [
        ("volume", {}, MAIN_FRAMES, ["corr_lookup"], {}),
        ("alt", {"corr_mode": "alt"}, MAIN_FRAMES, ["corr_lookup", "corr_fused"], {}),
        ("int8", {"corr_dtype": "int8"}, MAIN_FRAMES, ["corr_lookup", "corr_lookup_int8"], {}),
        # the first run again: how far host-bound times drift within one call
        ("volume_again", {}, MAIN_FRAMES, ["corr_lookup"], {}),
        # the reference ordering, beside the default one
        ("volume_reference_order", {"keyframe_spec_depth": 1, "proximity_spec": False},
         MAIN_FRAMES, ["corr_lookup"], {}),
        # MEI camera, the stream's own 5-parameter intrinsics, an invalid
        # band in every frame's mask, the constant keyframe depth prior
        ("mei_masks_depth", {"camera_type": "mei", "keyframe_depth": "constant-2.0"},
         MAIN_FRAMES, ["corr_lookup"], {"stream_kw": mei, "init": {"intrinsics": "gt"}}),
    ]
    main_paths, captured = {}, {}
    for label, cfg, n_frames, required, kw in runs:
        main_paths[label], captured[label] = main_path_phase(label, cfg, n_frames, thresh,
                                                             required, **kw)
        print(json.dumps({"main_path": main_paths[label]}), flush=True)

    k1["launches"] = main_paths["volume"]["launches"]["corr_lookup"]
    k2["launches"] = main_paths["alt"]["launches"]["corr_fused"]
    mainpath_coords_phase({"K1": (k1, captured["volume"]), "K2": (k2, captured["alt"])})
    print(json.dumps({"kernels": [k1, k2]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
